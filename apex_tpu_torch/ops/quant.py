"""Quantized weights and KV pages: the Hopper kernels of
``csrc/dequant_matmul.cu`` and their plain PyTorch twin, and the
quantization helpers the serving path needs.

Counterpart of ``apex_tpu/ops/quant.py``, a torch copy of its weight
surface (``resolve_weight_dtype``, ``weight_storage_dtype``,
``validate_int4_group``, ``quantize_weight``, ``quantize_weight_fp8``,
``pack_int4``/``unpack_int4``, ``quantize_weight_int4``,
``dequantize_weight``, ``WeightPrecisionPolicy``, ``fused_dequant_matmul``)
and of its KV surface (``resolve_kv_dtype``, ``kv_qmax``,
``is_quantized_kv``, ``kv_cast``, ``kv_quantize``). The arithmetic is the
reference's, step for step, so that quantization is bit-equal to it:
weights divide by their scale (``w / scale``); KV values multiply by
``inv = where(scale > 0, 1 / max(scale, 1e-30), 0)``; ``round`` is
half-to-even; values are clipped, then cast.

``fused_dequant_matmul(x, qw, scale)`` is ``x @ dequant(qw).T`` with the
dequantization inside the kernel: int8 or fp8 e4m3 weights ``(out, in)``
with per-channel fp32 scales ``(out,)`` (kernel ``dequant_matmul``), or
int4 nibbles packed group-locally ``(out, in // 2)`` uint8 with fp32 scales
``(in // group_size, out)`` (kernel ``dequant_matmul_w4``). A bf16 ``x``
runs the kernels' tensor-core form, whose sum order (``mma_k_split``) the
shape alone fixes, so a row's value does not depend on the rows beside
it. Inference only: a call under autograd on an ``x`` that requires grad
raises on either device. A tensor on the CPU takes the twin; a CUDA tensor
always takes the kernel. Not ported: the W8A8 ``int8_matmul`` (ROADMAP),
which no model calls and which is no Pallas kernel in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from apex_tpu_torch.ops import _build

# --- quantized KV pages -----------------------------------------------------

_KV_QMAX = {"int8": 127.0, "fp8": 448.0}          # e4m3 finite max


def _dtype_name(dtype) -> str:
    """``torch.int8`` -> ``"int8"``, ``torch.float8_e4m3fn`` ->
    ``"float8_e4m3fn"``; a string passes through."""
    return dtype if isinstance(dtype, str) else str(dtype).split(".")[-1]


def resolve_kv_dtype(kv_dtype):
    """Map a user-facing ``kv_dtype`` to ``(torch dtype, qmax)``; ``None``
    -> ``None`` (a full-precision pool). Accepts ``"int8"``/``torch.int8``
    and ``"fp8"``/``"e4m3"``/``torch.float8_e4m3fn``; anything else is a
    named ``ValueError``, never a silent full-precision pool."""
    if kv_dtype is None:
        return None
    name = _dtype_name(kv_dtype)
    if name == "int8":
        return torch.int8, _KV_QMAX["int8"]
    if name in ("fp8", "e4m3", "float8_e4m3fn"):
        return torch.float8_e4m3fn, _KV_QMAX["fp8"]
    raise ValueError(
        f"kv-dtype-unsupported: kv_dtype={kv_dtype!r} is not a "
        f"quantized page dtype (expected None, 'int8', or 'fp8'/'e4m3')")


def kv_qmax(dtype) -> float:
    """qmax of a quantized page dtype already in the pool (int8 -> 127,
    e4m3 -> 448); raises on a non-quantized dtype."""
    name = _dtype_name(dtype)
    if name == "int8":
        return _KV_QMAX["int8"]
    if name == "float8_e4m3fn":
        return _KV_QMAX["fp8"]
    raise ValueError(f"kv-dtype-unsupported: {name} is not a quantized "
                     f"KV page dtype")


def is_quantized_kv(dtype) -> bool:
    name = _dtype_name(dtype)
    return name == "int8" or name.startswith("float8")


def kv_cast(x: torch.Tensor, qdtype, qmax: float) -> torch.Tensor:
    """Cast an already scale-normalized tensor to the page dtype: round
    (half to even) and clip for int8, clip for fp8 (the cast rounds)."""
    if qdtype == torch.int8:
        return torch.clamp(torch.round(x), -qmax, qmax).to(torch.int8)
    return torch.clamp(x, -qmax, qmax).to(qdtype)


def kv_inverse(scale: torch.Tensor) -> torch.Tensor:
    """``where(scale > 0, 1 / max(scale, 1e-30), 0)``: an all-zero group
    (scale 0) quantizes to exact zeros."""
    return torch.where(scale > 0, 1.0 / torch.clamp(scale, min=1e-30),
                       torch.zeros_like(scale))


def kv_quantize(x: torch.Tensor, qdtype, qmax: float, *, axes):
    """Symmetric quantization over ``axes``: ``(q, scale)`` with
    ``x ~= q.float() * scale`` (scale kept with size 1 on ``axes``)."""
    xf = x.float()
    amax = torch.amax(xf.abs(), dim=axes, keepdim=True)
    scale = amax / qmax
    return kv_cast(xf * kv_inverse(scale), qdtype, qmax), scale


# --- quantized weights ------------------------------------------------------

_WEIGHT_QMAX = {"int8": 127.0, "fp8": 448.0, "int4": 7.0}


def resolve_weight_dtype(mode) -> Optional[str]:
    """Map a weight-quantization ``mode`` to ``"int8"``, ``"fp8"`` or
    ``"int4"``. ``None``/``False`` -> ``None`` (full-precision weights);
    ``True`` is the ``quantize_int8`` alias for ``"int8"``. Anything else
    is a named ``ValueError``."""
    if mode is None or mode is False:
        return None
    if mode is True:
        return "int8"
    name = _dtype_name(mode)
    if name == "int8":
        return "int8"
    if name in ("fp8", "e4m3", "float8_e4m3fn"):
        return "fp8"
    if name == "int4":
        return "int4"
    raise ValueError(
        f"weight-dtype-unsupported: mode={mode!r} is not a quantized "
        f"weight dtype (expected None, 'int8', 'fp8'/'e4m3', or 'int4')")


def weight_storage_dtype(kind: str):
    """The torch dtype a quantized weight buffer is stored as (int4 packs
    two nibbles per uint8 byte)."""
    return {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
            "int4": torch.uint8}[kind]


def _check_group_size(group_size: int) -> None:
    if group_size < 2 or (group_size & (group_size - 1)) != 0:
        raise ValueError(
            f"int4-group-invalid: group_size={group_size} must be a "
            "power of two >= 2")


def validate_int4_group(in_features: int, group_size: int) -> None:
    """Named errors for the int4 grouping contract: a power-of-two group,
    ``in_features`` an exact multiple of it."""
    _check_group_size(group_size)
    if in_features % group_size:
        raise ValueError(
            f"int4-group-invalid: in_features={in_features} is not a "
            f"multiple of group_size={group_size}")


def quantize_weight(w: torch.Tensor):
    """Symmetric per-output-channel int8: ``w (out, in) -> (q int8 (out,
    in), scale f32 (out,))`` with ``w ~= q * scale[:, None]``."""
    w = w.float()
    qmax = _WEIGHT_QMAX["int8"]
    amax = torch.amax(w.abs(), dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / qmax
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return q, scale[:, 0]


def quantize_weight_fp8(w: torch.Tensor):
    """Symmetric per-output-channel fp8 e4m3: ``w (out, in) -> (q e4m3,
    scale f32 (out,))``."""
    w = w.float()
    qmax = _WEIGHT_QMAX["fp8"]
    amax = torch.amax(w.abs(), dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / qmax
    q = torch.clamp(w / scale, -qmax, qmax).to(torch.float8_e4m3fn)
    return q, scale[:, 0]


def pack_int4(q: torch.Tensor, *, group_size: int) -> torch.Tensor:
    """Pack int4 values ``q (out, in)`` (each in [-8, 7]) into uint8,
    group-locally: byte ``j`` of a group's ``group_size // 2`` bytes holds
    the group's value ``j`` in its low nibble and value ``j + group_size //
    2`` in its high nibble, both biased by +8. A slice of whole groups
    along the packed axis is the packed form of those groups."""
    out, n = q.shape
    validate_int4_group(n, group_size)
    h = group_size // 2
    qg = q.to(torch.int32).reshape(out, n // group_size, group_size)
    packed = (qg[..., :h] + 8) | ((qg[..., h:] + 8) << 4)
    return packed.to(torch.uint8).reshape(out, n // 2)


def unpack_int4(packed: torch.Tensor, *, group_size: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``(out, n // 2) uint8 -> (out, n)``
    int8 values in [-8, 7]."""
    out, half = packed.shape
    h = group_size // 2
    p = packed.to(torch.int32).reshape(out, half // h, h)
    lo = (p & 15) - 8
    hi = (p >> 4) - 8
    return torch.cat([lo, hi], dim=-1).to(torch.int8).reshape(out, 2 * half)


def quantize_weight_int4(w: torch.Tensor, *, group_size: int = 128):
    """Symmetric per-(out channel, group) int4: ``w (out, in) -> (packed
    uint8 (out, in // 2), scales f32 (in // group_size, out))``, group axis
    major, with ``w[o, g*gs:(g+1)*gs] ~= q * scales[g, o]``."""
    w = w.float()
    out, n = w.shape
    validate_int4_group(n, group_size)
    ng = n // group_size
    wg = w.reshape(out, ng, group_size)
    amax = torch.amax(wg.abs(), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / _WEIGHT_QMAX["int4"]
    q = torch.clamp(torch.round(wg / scale), -_WEIGHT_QMAX["int4"],
                    _WEIGHT_QMAX["int4"]).reshape(out, n)
    return (pack_int4(q.to(torch.int8), group_size=group_size),
            scale[:, :, 0].T.contiguous())


def dequantize_weight(qw: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 ``(out, in)`` from any storage kind: int8/fp8 ``(out, in)``
    with ``(out,)`` scales, or packed int4 ``(out, in // 2)`` uint8 with
    ``(n_groups, out)`` scales."""
    if qw.dtype == torch.uint8:
        out, half = qw.shape
        ng = scale.shape[0]
        gs = 2 * half // ng
        vals = unpack_int4(qw, group_size=gs).reshape(out, ng, gs)
        return (vals.float() * scale.float().T[:, :, None]).reshape(
            out, 2 * half)
    return qw.float() * scale.float()[:, None]


def fused_dequant_matmul_reference(x: torch.Tensor, qw: torch.Tensor,
                                   scale: torch.Tensor) -> torch.Tensor:
    """Plain twin: ``x.float() @ dequantize_weight(qw, scale).T`` in x's
    dtype."""
    return (x.float() @ dequantize_weight(qw, scale).T).to(x.dtype)


def _weight_dims(qw, scale):
    """``(kind, out, in, group_size)`` of a quantized weight."""
    if qw.dtype == torch.uint8:
        out, n_in = qw.shape[0], 2 * qw.shape[1]
        if scale.ndim != 2 or scale.shape[1] != out or n_in % scale.shape[0]:
            raise ValueError(f"int4 scales must be (n_groups, {out}) with "
                             f"n_groups dividing {n_in}, got "
                             f"{tuple(scale.shape)}")
        return "int4", out, n_in, n_in // scale.shape[0]
    if qw.dtype not in (torch.int8, torch.float8_e4m3fn):
        raise TypeError(f"quantized weights are int8, float8_e4m3fn or "
                        f"uint8 (packed int4), got {qw.dtype}")
    out, n_in = qw.shape
    if tuple(scale.shape) != (out,):
        raise ValueError(f"per-channel scales must be ({out},), got "
                         f"{tuple(scale.shape)}")
    return ("int8" if qw.dtype == torch.int8 else "fp8"), out, n_in, 0


#: the bf16 tensor-core kernels' tiling (``csrc/dequant_matmul.cu``): a
#: pipeline stage holds 256 K values (4 warps x 64), a block owns 32 output
#: channels and 32 rows of x, and the blocks of a K split form one cluster
#: of at most 8
MMA_STAGE_K = 256
MMA_CHANNELS = 32
MMA_TOKENS = 32
MMA_MAX_PARTS = 8
#: the blocks a decode step's one token tile should give the card (the
#: H100's SMs), which sets how far K is split across blocks; a grid that
#: has as many (channel tile, token tile) blocks without the split walks
#: the parts in turn in each block instead of in a cluster of blocks (the
#: same sums in the same order, so that choice, unlike the split, may
#: follow the rows)
MMA_FILL_BLOCKS = 132


def mma_k_split(n_in: int, n_out: int) -> tuple:
    """``(parts, stages per part)``: how the bf16 kernels split K across
    blocks. Enough parts that ``ceil(n_out / 32) * parts`` blocks reach
    ``MMA_FILL_BLOCKS``, at most one a stage and ``MMA_MAX_PARTS``, and of
    those the fewest that divide the stages evenly, where one does. A
    function of the shape alone, never of the number of rows, so a row's
    sum runs in one order at every batch size."""
    stages = -(-n_in // MMA_STAGE_K)
    tiles = -(-n_out // MMA_CHANNELS)
    most = min(stages, MMA_MAX_PARTS)
    parts = min(most, max(1, -(-MMA_FILL_BLOCKS // tiles)))
    parts = next((p for p in range(parts, most + 1) if stages % p == 0),
                 parts)
    per = -(-stages // parts)
    return -(-stages // per), per


def _dequant_matmul_kernel(x2, qw, scale, kind, out, n_in, gs):
    m = x2.shape[0]
    if kind == "int4":
        if not 16 <= gs <= 512:
            raise NotImplementedError(
                f"the int4 kernel takes group sizes 16..512, got {gs}")
    elif n_in % 8:
        raise NotImplementedError(f"the dequant kernel takes in_features "
                                  f"that are multiples of 8, got {n_in}")
    x2 = x2.contiguous()
    qw = qw.contiguous()
    if qw.data_ptr() % 8:
        raise ValueError("quantized weights must be 8-byte aligned")
    sc = scale.float().contiguous()
    _build.check_cuda(x2, qw, sc)
    dtype = _build.dtype_code(x2)
    y = torch.empty((m, out), dtype=x2.dtype, device=x2.device)
    if m == 0:
        return y
    parts, per, seq = 1, 1, 1
    if x2.dtype == torch.bfloat16:
        if x2.data_ptr() % 16:             # cp.async takes 16-byte rows
            x2 = x2.clone()
        parts, per = mma_k_split(n_in, out)
        tiles = -(-out // MMA_CHANNELS) * -(-m // MMA_TOKENS)
        seq = int(tiles >= MMA_FILL_BLOCKS)
    P, I = _build.P, _build.I
    if kind == "int4":
        _build.launch(
            "dequant_matmul_w4", "apex_dequant_matmul_w4",
            (P, P, P, P, I, I, I, I, I, I, I, I, P),
            x2.data_ptr(), qw.data_ptr(), sc.data_ptr(), y.data_ptr(), m,
            n_in, out, gs, dtype, parts, per, seq, _build.stream_of(x2))
    else:
        _build.launch(
            "dequant_matmul", "apex_dequant_matmul",
            (P, P, P, P, I, I, I, I, I, I, I, I, P),
            x2.data_ptr(), qw.data_ptr(), sc.data_ptr(), y.data_ptr(), m,
            n_in, out, dtype, _build.dtype_code(qw, _build.NARROW_DTYPES),
            parts, per, seq, _build.stream_of(x2))
    return y


def fused_dequant_matmul(x: torch.Tensor, qw: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """``y = x @ dequant(qw).T`` with the dequantization fused into the
    kernel; ``x`` is ``(..., in)``, the storage kind follows ``qw``'s dtype,
    the result is ``(..., out)`` in x's dtype."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            "fused_dequant_matmul has no backward (quantized weights serve "
            "inference only, as in the reference): call it under "
            "torch.no_grad() or on an input that does not require grad")
    kind, out, n_in, gs = _weight_dims(qw, scale)
    if x.shape[-1] != n_in:
        raise ValueError(
            f"fused_dequant_matmul: x has {x.shape[-1]} features, the "
            f"quantized weight dequantizes to (out={out}, in={n_in})")
    lead = x.shape[:-1]
    if x.device.type == "cpu":
        return fused_dequant_matmul_reference(x, qw, scale)
    y = _dequant_matmul_kernel(x.reshape(-1, n_in), qw, scale, kind, out,
                               n_in, gs)
    return y.reshape(*lead, out)


# --- per-layer-class precision policy ---------------------------------------

@dataclasses.dataclass(frozen=True)
class WeightPrecisionPolicy:
    """Which precision each layer class serves at: embeddings, norms,
    biases and the tied LM head stay in ``param_dtype``; the block linears
    take ``linears`` (None, ``"int8"``, ``"fp8"`` or ``"int4"``).
    ``group_size`` is the int4 grouping (a power of two)."""

    linears: Optional[str] = "int8"
    group_size: int = 128

    def __post_init__(self):
        kind = resolve_weight_dtype(self.linears)
        object.__setattr__(self, "linears", kind)
        if kind == "int4":
            _check_group_size(self.group_size)

    @staticmethod
    def resolve(policy: Optional["WeightPrecisionPolicy"],
                quantize_int8: bool) -> Optional["WeightPrecisionPolicy"]:
        """One rule for a config that carries both ``quantize_int8`` and
        ``weight_policy``: the flag is the int8-everywhere policy, and two
        conflicting answers are a named error."""
        if policy is not None and policy.linears is None:
            policy = None
        if policy is None:
            return WeightPrecisionPolicy("int8") if quantize_int8 else None
        if quantize_int8 and policy.linears != "int8":
            raise ValueError(
                "weight-policy-conflict: quantize_int8=True is the "
                f"int8-everywhere policy but weight_policy asks for "
                f"{policy.linears!r} — set one, not both")
        return policy
