"""Flash attention, forward and backward: the Hopper kernels
``csrc/flash_fwd.cu`` (O and LSE) and ``csrc/flash_bwd.cu`` (dq; dk and dv)
and their plain PyTorch twins.

Counterpart of ``apex_tpu/ops/flash_attention.py`` (``_fwd_kernel``,
``_dq_kernel``, ``_dkdv_kernel``, ``_fa_bwd_impl``, ``flash_attention``,
``flash_attention_with_lse``, ``mha_reference``), causal or not, with
``segment_ids``/``kv_segment_ids``, attention dropout and a causal sliding
window at the default diagonal; no bias and no ``causal_offset``. Layout as
in the reference: q ``[B, H, Sq, D]``, k/v ``[B, Hkv, Sk, D]`` with ``Hkv``
dividing ``H`` (GQA reads kv head ``h // (H / Hkv)``, never repeated in the
kernels). A :class:`Masking` says which (query, key) pairs a row sees: under
``causal`` row ``r`` sees keys ``j <= r + (Sk - Sq)``; under a ``window``
``w`` (causal only) also ``j >= r + (Sk - Sq) - (w - 1)``; under segment
ids only keys of its own segment. A row that sees no key outputs 0. The
forward returns O in q's dtype and the fp32 log-sum-exp.

Dropout is the reference's counter-based keep mask, exactly: each global
position ``(seed, b * H + h, row, col)`` (H the query heads) hashes through
the murmur3 finalizer to a ``uint32`` that is kept when at least
``min(int(rate * 2^32), 2^32 - 1)``, and a kept probability is scaled by
``1 / (1 - rate)``. The forward's denominator sums the undropped
probabilities and only the PV product sees the dropped ones; the backward
regenerates the same mask. Nothing is stored.

``flash_attention`` and ``flash_attention_with_lse`` are differentiable
through ``_FlashAttentionFunction``: it saves ``q, k, v, o, lse`` and its
backward is the FA-2 recompute of the reference (an LSE cotangent folds
into ``delta``, as ``_flash_with_lse_bwd`` does). Under a window each
kernel walks only the band, as the reference's band-restricted grids do,
and counts under a launch name of its own (``flash_fwd_window``,
``flash_bwd_dq_window``, ``flash_bwd_dkdv_window``).

A tensor on the CPU takes the twins; a CUDA tensor always takes the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from apex_tpu_torch.ops import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_UNSUPPORTED = ("flash attention in this port takes no bias or "
                "causal_offset (ROADMAP queue B item 8: the rest of the flash "
                "surface; item 9 for its backward)")

_M32 = 0xFFFFFFFF


def _gqa_rep(heads: int, kv_heads: int) -> int:
    if heads % kv_heads != 0:
        raise ValueError(
            f"q heads ({heads}) must be a multiple of kv heads ({kv_heads})")
    return heads // kv_heads


def _check_shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,H,Sq,D] and k/v [B,Hkv,Sk,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"batch/head_dim mismatch: q {tuple(q.shape)} vs "
                         f"k {tuple(k.shape)}")
    return _gqa_rep(q.shape[1], k.shape[1])


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in ``[0, 2^32)``, in two 16-bit
    halves of ``c`` so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def dropout_hash(seed: int, bh, rows, cols) -> torch.Tensor:
    """The reference's keep-mask hash (``_dropout_keep``) as int64 values in
    ``[0, 2^32)``, broadcast over int64 tensors ``bh``, ``rows`` and
    ``cols``: ``x = row * 0x9E3779B1 + col * 0x85EBCA77 + bh * 0xC2B2AE3D +
    seed`` in ``uint32``, then the murmur3 finalizer."""
    x = (_mul32(rows, 0x9E3779B1) + _mul32(cols, 0x85EBCA77)
         + _mul32(bh, 0xC2B2AE3D) + (int(seed) & _M32)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


@dataclasses.dataclass(frozen=True, eq=False)
class Masking:
    """Which (query, key) pairs each query row sees, and the attention
    dropout: ``causal`` (key ``j <= r + Sk - Sq``), a sliding ``window``
    (with ``causal``, key ``j >= r + Sk - Sq - (window - 1)``), int32
    ``segment_ids`` ``[B, Sq]`` and ``kv_segment_ids`` ``[B, Sk]`` (a row
    sees keys of its own segment), ``dropout_rate`` in ``[0, 1)`` with
    ``dropout_seed``."""

    causal: bool = True
    segment_ids: Optional[torch.Tensor] = None
    kv_segment_ids: Optional[torch.Tensor] = None
    dropout_rate: float = 0.0
    dropout_seed: int = 0
    window: Optional[int] = None

    @property
    def threshold(self) -> int:
        """The uint32 below which a hashed position is dropped."""
        return min(int(self.dropout_rate * (2.0 ** 32)), 2 ** 32 - 1)

    @property
    def keep_scale(self) -> float:
        """``1 / (1 - rate)`` in fp32, as the reference divides its fp32
        keep mask by the rate's complement."""
        return (torch.tensor(1.0)
                / torch.tensor(1.0 - self.dropout_rate)).item()

    def check(self, q, k) -> None:
        if self.window is not None:
            if not self.causal:
                raise ValueError("window requires causal=True (Mistral-style "
                                 "sliding window over a causal sequence)")
            if self.window < 1:
                raise ValueError(f"window must be >= 1, got {self.window}")
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got "
                             f"{self.dropout_rate}")
        if (self.segment_ids is None) != (self.kv_segment_ids is None):
            raise ValueError("segment_ids and kv_segment_ids go together")
        if self.segment_ids is not None:
            want = ((q.shape[0], q.shape[2]), (k.shape[0], k.shape[2]))
            got = (tuple(self.segment_ids.shape),
                   tuple(self.kv_segment_ids.shape))
            if got != want:
                raise ValueError(f"segment ids {got} do not fit q/k "
                                 f"{want}")

    def visible(self, q_len: int, kv_len: int, device) -> torch.Tensor:
        """bool ``[B or 1, 1, Sq, Sk]``: the pairs a row sees."""
        rows = torch.arange(q_len, device=device)[:, None]
        cols = torch.arange(kv_len, device=device)[None, :]
        mask = torch.ones(q_len, kv_len, dtype=torch.bool, device=device)
        if self.causal:
            mask = rows + (kv_len - q_len) >= cols
        if self.window is not None:
            mask = mask & (cols >= rows + (kv_len - q_len) - (self.window - 1))
        mask = mask[None, None]
        if self.segment_ids is not None:
            qs = self.segment_ids.to(device)
            ks = self.kv_segment_ids.to(device)
            mask = mask & (qs[:, None, :, None] == ks[:, None, None, :])
        return mask

    def keep(self, batch: int, heads: int, q_len: int, kv_len: int,
             device) -> Optional[torch.Tensor]:
        """fp32 ``[B, H, Sq, Sk]``: 0 where dropped, ``keep_scale`` where
        kept; None without dropout."""
        if self.dropout_rate <= 0.0:
            return None
        i64 = dict(dtype=torch.int64, device=device)
        bh = torch.arange(batch * heads, **i64).reshape(batch, heads, 1, 1)
        x = dropout_hash(self.dropout_seed, bh,
                         torch.arange(q_len, **i64)[:, None],
                         torch.arange(kv_len, **i64)[None, :])
        return torch.where(x >= self.threshold, self.keep_scale,
                           0.0).to(torch.float32)

    def kernel_args(self, device):
        """The C arguments ``(q_seg, kv_seg, causal, dropout, seed,
        threshold, keep_scale)`` and the segment tensors to keep alive (each
        kernel takes the window after them)."""
        segs = []
        if self.segment_ids is not None:
            segs = [t.to(device=device, dtype=torch.int32).contiguous()
                    for t in (self.segment_ids, self.kv_segment_ids)]
        ptrs = [t.data_ptr() for t in segs] or [None, None]
        drop = self.dropout_rate > 0.0
        return ((*ptrs, int(self.causal), int(drop),
                 int(self.dropout_seed) & _M32, self.threshold,
                 self.keep_scale if drop else 1.0), segs)


CAUSAL = Masking()
_MASK_ARGTYPES = (_build.P, _build.P, _build.I, _build.I, ctypes.c_uint,
                  ctypes.c_uint, _build.F)


def flash_attention_reference(q, k, v, *, scale: float,
                              masking: Masking = CAUSAL):
    """Plain twin: dense attention with fp32 scores, invisible pairs'
    probabilities exactly 0, a row that sees no key output 0 (its LSE the
    mask value, as the reference's), and dropout applied to the normalised
    probabilities before the PV product."""
    rep = _check_shapes(q, k, v)
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    mask = masking.visible(q.shape[2], k.shape[2], q.device)
    s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    denom = e.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)
    p = e / denom
    keep = masking.keep(q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                        q.device)
    if keep is not None:
        p = p * keep
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    lse = (m + torch.log(denom))[..., 0]
    return o.to(q.dtype), lse


def _flash_fwd_kernel(q, k, v, scale: float, masking: Masking = CAUSAL):
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d > 128:
        raise NotImplementedError(f"flash kernel takes head_dim <= 128, "
                                  f"got {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    mask_args, segs = masking.kernel_args(q.device)
    _build.check_cuda(q, k, v, *segs)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return o, lse
    P, I, F = _build.P, _build.I, _build.F
    window = masking.window
    _build.launch(
        "flash_fwd" if window is None else "flash_fwd_window",
        "apex_flash_fwd",
        (P, P, P, P, P) + _MASK_ARGTYPES + (I,) * 7 + (F, I, P),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *mask_args, int(window or 0), b, h, hkv, sq, sk, d,
        float(scale), _build.dtype_code(q), _build.stream_of(q))
    return o, lse


def flash_fwd(q, k, v, *, scale: float, masking: Masking = CAUSAL):
    """``(o, lse)``: the kernel on a CUDA tensor, the twin on a CPU one."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale=scale,
                                         masking=masking)
    return _flash_fwd_kernel(q, k, v, scale, masking)


def flash_bwd_delta(o, do, dlse=None) -> torch.Tensor:
    """``delta = sum(do * o)`` over the head dim, fp32 ``[B, H, Sq]``, less
    ``dlse`` (an LSE cotangent); a torch reduction, outside the kernels as
    in the reference."""
    delta = (do.float() * o.float()).sum(dim=-1)
    return delta if dlse is None else delta - dlse.float()


def _bwd_p_ds(q, k, v, do, lse, delta, scale, masking):
    """The recompute both backward twins share: fp32 ``(p * keep, ds)``
    over the visible pairs, with k and v repeated over each GQA group:
    ``ds = p (dp keep - delta) scale`` with the undropped ``p``."""
    rep = _check_shapes(q, k, v)
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    mask = masking.visible(q.shape[2], k.shape[2], q.device)
    p = torch.exp(torch.where(mask, s - lse.float()[..., None],
                              float("-inf")))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vf)
    keep = masking.keep(q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                        q.device)
    if keep is not None:
        dp = dp * keep
        p_drop = p * keep
    else:
        p_drop = p
    return p_drop, p * (dp - delta[..., None]) * scale, kf


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, scale: float,
                           masking: Masking = CAUSAL):
    """Plain twin of the dq kernel: ``dq = ds k`` with ``P = exp(scale q
    k^T - lse)`` on the visible pairs and ``ds = P (do v^T keep - delta)
    scale``; fp32 math, dq in q's dtype."""
    _, ds, kf = _bwd_p_ds(q, k, v, do, lse, delta, scale, masking)
    return torch.einsum("bhqk,bhkd->bhqd", ds, kf).to(q.dtype)


def flash_bwd_dkdv_reference(q, k, v, do, lse, delta, *, scale: float,
                             masking: Masking = CAUSAL):
    """Plain twin of the dk/dv kernel: ``dv = (P keep)^T do`` and ``dk =
    ds^T q``, each GQA group's per-q-head sums added into its kv head; fp32
    math, dk/dv in k's/v's dtype."""
    p, ds, _ = _bwd_p_ds(q, k, v, do, lse, delta, scale, masking)
    b, h, _, d = q.shape
    kv_heads, kv_len = k.shape[1], k.shape[2]
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    if h != kv_heads:
        dk = dk.reshape(b, kv_heads, h // kv_heads, kv_len, d).sum(dim=2)
        dv = dv.reshape(b, kv_heads, h // kv_heads, kv_len, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, scale: float,
                                  dlse=None, masking: Masking = CAUSAL):
    """Plain twin of the whole backward: ``(dq, dk, dv)`` by the FA-2
    recompute of ``_fa_bwd_impl`` (``delta = sum(do * o)``, less ``dlse``)."""
    delta = flash_bwd_delta(o, do, dlse)
    kw = dict(scale=scale, masking=masking)
    return (flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw),
            *flash_bwd_dkdv_reference(q, k, v, do, lse, delta, **kw))


def _bwd_operands(q, k, v, do, lse, delta, masking):
    d = q.shape[3]
    if d > 128:
        raise NotImplementedError(f"flash kernel takes head_dim <= 128, "
                                  f"got {d}")
    if not (q.dtype == k.dtype == v.dtype == do.dtype):
        raise TypeError(f"q/k/v/do dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {do.dtype}")
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"do {tuple(do.shape)} != q {tuple(q.shape)}")
    ops = [t.contiguous() for t in (q, k, v, do)]
    ops += [lse.float().contiguous(), delta.float().contiguous()]
    mask_args, segs = masking.kernel_args(q.device)
    _build.check_cuda(*ops, *segs)
    b, h, sq, d = q.shape
    args = (b, h, k.shape[1], sq, k.shape[2], d)
    return ops, (*mask_args, int(masking.window or 0)), segs, args


def _bwd_name(kernel: str, masking: Masking) -> str:
    return kernel if masking.window is None else f"{kernel}_window"


def flash_bwd_dq(q, k, v, do, lse, delta, *, scale: float,
                 masking: Masking = CAUSAL):
    """dq: the kernel on a CUDA tensor, the twin on a CPU one."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, scale=scale,
                                      masking=masking)
    ops, mask_args, _segs, args = _bwd_operands(q, k, v, do, lse, delta,
                                                masking)
    dq = torch.empty_like(ops[0])
    if dq.numel() == 0 or args[4] == 0:
        return dq.zero_()
    P, I, F = _build.P, _build.I, _build.F
    _build.launch(_bwd_name("flash_bwd_dq", masking), "apex_flash_bwd_dq",
                  (P,) * 7 + _MASK_ARGTYPES + (I,) * 7 + (F, I, P),
                  *(t.data_ptr() for t in ops), dq.data_ptr(), *mask_args,
                  *args, float(scale), _build.dtype_code(dq),
                  _build.stream_of(dq))
    return dq


def flash_bwd_dkdv(q, k, v, do, lse, delta, *, scale: float,
                   masking: Masking = CAUSAL):
    """``(dk, dv)``: the kernel on a CUDA tensor, the twin on a CPU one."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                        scale=scale, masking=masking)
    ops, mask_args, _segs, args = _bwd_operands(q, k, v, do, lse, delta,
                                                masking)
    dk, dv = torch.empty_like(ops[1]), torch.empty_like(ops[2])
    if dk.numel() == 0 or args[3] == 0:
        return dk.zero_(), dv.zero_()
    P, I, F = _build.P, _build.I, _build.F
    _build.launch(_bwd_name("flash_bwd_dkdv", masking),
                  "apex_flash_bwd_dkdv",
                  (P,) * 8 + _MASK_ARGTYPES + (I,) * 7 + (F, I, P),
                  *(t.data_ptr() for t in ops), dk.data_ptr(), dv.data_ptr(),
                  *mask_args, *args, float(scale), _build.dtype_code(dk),
                  _build.stream_of(dk))
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, scale: float, dlse=None,
                        masking: Masking = CAUSAL):
    """``(dq, dk, dv)``: the two kernels on a CUDA tensor, the twins on a
    CPU one."""
    delta = flash_bwd_delta(o, do, dlse)
    kw = dict(scale=scale, masking=masking)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_bwd_dkdv(q, k, v, do, lse, delta, **kw))


class _FlashAttentionFunction(torch.autograd.Function):
    """Autograd over the kernels: ``(o, lse)``; saves ``q, k, v, o, lse`` as
    the reference's ``_flash_fwd`` does (the masking rides on ``ctx``). On
    the card the backward always launches the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, scale, masking):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd(q, k, v, scale=scale, masking=masking)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.masking = masking
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         scale=ctx.scale, dlse=dlse,
                                         masking=ctx.masking)
        return dq, dk, dv, None, None


def _attend(q, k, v, scale, masking):
    _check_shapes(q, k, v)
    masking.check(q, k)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _FlashAttentionFunction.apply(q, k, v, float(scale), masking)


def flash_attention_with_lse(q, k, v, *, scale: Optional[float] = None,
                             causal: bool = False,
                             window: Optional[int] = None,
                             causal_offset=None,
                             dropout_rate: float = 0.0,
                             dropout_seed: int = 0):
    """``(o, lse)``: the kernel on a CUDA tensor, the twin on a CPU one;
    differentiable in q, k and v through both outputs. The keep mask is
    drawn at global positions from row and column 0; ``causal_offset``
    raises."""
    if causal_offset is not None:
        raise NotImplementedError(_UNSUPPORTED)
    return _attend(q, k, v, scale, Masking(
        causal=bool(causal), dropout_rate=float(dropout_rate),
        dropout_seed=int(dropout_seed), window=window))


def flash_attention(q, k, v, bias=None, segment_ids=None,
                    kv_segment_ids=None, *, causal: bool = False,
                    scale: Optional[float] = None, dropout_rate: float = 0.0,
                    dropout_seed: int = 0, window: Optional[int] = None):
    """Flash attention ``softmax(scale * q @ k^T [masked]) @ v`` with the
    reference's signature. ``kv_segment_ids`` defaults to ``segment_ids``
    (self attention); ``window`` requires ``causal``; ``bias`` raises
    ``NotImplementedError``."""
    if bias is not None:
        raise NotImplementedError(_UNSUPPORTED)
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    return _attend(q, k, v, scale, Masking(
        causal=bool(causal), segment_ids=segment_ids,
        kv_segment_ids=kv_segment_ids, dropout_rate=float(dropout_rate),
        dropout_seed=int(dropout_seed), window=window))[0]


def mha_reference(q, k, v, segment_ids=None, kv_segment_ids=None, *,
                  causal: bool = True, scale: Optional[float] = None):
    """The unfused ground truth (the twin's O), as ``mha_reference`` is in
    the reference; no dropout (the reference's raises on it too)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    masking = Masking(causal=causal, segment_ids=segment_ids,
                      kv_segment_ids=kv_segment_ids)
    masking.check(q, k)
    return flash_attention_reference(q, k, v, scale=scale,
                                     masking=masking)[0]
