"""Flash attention, forward and backward: the Hopper kernels
``csrc/flash_fwd.cu`` (O and LSE) and ``csrc/flash_bwd.cu`` (dq; dk and dv)
and their plain PyTorch twins.

Counterpart of ``apex_tpu/ops/flash_attention.py`` (``_fwd_kernel``,
``_dq_kernel``, ``_dkdv_kernel``, ``_fa_bwd_impl``, ``flash_attention``,
``flash_attention_with_lse``, ``mha_reference``), causal or not, with an
additive ``bias``, ``segment_ids``/``kv_segment_ids``, attention dropout,
a causal sliding window, and ring attention's ``causal_offset`` and
dropout origins. Layout as in the reference: q ``[B, H, Sq, D]``, k/v
``[B, Hkv, Sk, D]`` with ``Hkv`` dividing ``H`` (GQA reads kv head ``h //
(H / Hkv)``, never repeated in the kernels). A :class:`Masking` says which
(query, key) pairs a row sees: under ``causal`` row ``r`` sees keys ``j <=
r + offset``; under a ``window`` ``w`` (causal only) also ``j >= r +
offset - (w - 1)``; under segment ids only keys of its own segment. The
offset is ``Sk - Sq`` unless ``causal_offset`` gives another (a ring step's
chunk ``r`` hops upstream sits at ``r * S_loc``; a negative one hides the
whole chunk's diagonal). A row that sees no key outputs 0, its LSE the
mask value. The forward returns O in q's dtype and the fp32 log-sum-exp.

The bias is any tensor, in q's dtype or fp32, that broadcasts to ``[B, H,
Sq, Sk]`` (T5's ``(1, H, S, S)`` relative-position table, a ``(B, 1, 1,
Sk)`` padding mask, a full ``(B, H, Sq, Sk)``): each visible score becomes
``scale * q . k + bias`` in fp32, before the masks, as the reference's
``_fwd_kernel`` and ``_recompute_p`` add it. The kernels read it in place
through the strides of ``bias.expand(B, H, Sq, Sk)``, 0 on a broadcast
dimension; it is never expanded in memory. As in the reference it is not
differentiated: its gradient is zeros.

Dropout is the reference's counter-based keep mask, exactly: each global
position ``(seed, b * H + h, row, col)`` (H the query heads) hashes through
the murmur3 finalizer to a ``uint32`` that is kept when at least
``min(int(rate * 2^32), 2^32 - 1)``, and a kept probability is scaled by
``1 / (1 - rate)``. ``dropout_row0``/``dropout_col0`` shift the row and
column to a chunk's global position (added in ``uint32``), so a ring of
chunked calls draws exactly the keep mask of one unsharded call. The
forward's denominator sums the undropped probabilities and only the PV
product sees the dropped ones; the backward regenerates the same mask.
Nothing is stored.

``flash_attention`` and ``flash_attention_with_lse`` are differentiable
through ``_FlashAttentionFunction``: it saves ``q, k, v, o, lse`` and its
backward is the FA-2 recompute of the reference (an LSE cotangent folds
into ``delta``, as ``_flash_with_lse_bwd`` does). Under a window each
kernel walks only the band, as the reference's band-restricted grids do,
and counts under a launch name of its own (``flash_fwd_window``,
``flash_bwd_dq_window``, ``flash_bwd_dkdv_window``); with a bias each
counts under its name with ``_bias`` after it (``flash_fwd_bias``,
``flash_fwd_window_bias``, ...); a call whose causal diagonal is not
``Sk - Sq``, or whose dropout is drawn at a non-zero origin (a ring
attention step), counts under its name with ``_ring`` after it
(``flash_fwd_ring``, ``flash_fwd_window_ring``, ``flash_bwd_dq_ring``,
...). Every offset and origin is a host int and a launch argument: the
reference's traced offset (an SMEM scalar that runs its grid unbanded)
has no separate branch here.

A tensor on the CPU takes the twins; a CUDA tensor always takes the kernels.
On the card each kernel routes by dtype: bf16 runs on the tensor cores
(``flash_fwd_mma_kernel``, ``flash_bwd_dq_mma_kernel``,
``flash_bwd_dkdv_mma_kernel``), fp32 on the CUDA cores
(``flash_fwd_kernel``, ``flash_bwd_dq_kernel``, ``flash_bwd_dkdv_kernel``),
each under the same launch names. A head dim above 128 (any d, as the
reference pads to a multiple of 128) runs ``flash_fwd_wide_kernel``,
``flash_bwd_dq_wide_kernel`` and ``flash_bwd_dkdv_wide_kernel`` in either
dtype: the output's 128-column chunks on the grid, the scores formed over
the full d a chunk at a time, on the CUDA cores.
"""

from __future__ import annotations

import ctypes
import dataclasses
import numbers
from typing import Optional

import torch

from apex_tpu_torch.ops import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

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


def _check_bias(bias, q, k) -> None:
    """A bias must broadcast to ``[B, H, Sq, Sk]``, lie on q's device and be
    in q's dtype or fp32."""
    if bias is None:
        return
    full = (q.shape[0], q.shape[1], q.shape[2], k.shape[2])
    if bias.ndim > 4 or any(n not in (1, m) for n, m in
                            zip(bias.shape[::-1], full[::-1])):
        raise ValueError(f"bias {tuple(bias.shape)} does not broadcast to "
                         f"[B, H, Sq, Sk] = {full}")
    if bias.dtype not in (q.dtype, torch.float32):
        raise TypeError(f"bias must be in q's dtype ({q.dtype}) or float32, "
                        f"got {bias.dtype}")
    if bias.device != q.device:
        raise ValueError(f"bias on {bias.device}, q on {q.device}")


def _add_bias(s: torch.Tensor, bias) -> torch.Tensor:
    """fp32 scores plus the bias read as fp32 (broadcast)."""
    return s if bias is None else s + bias.float()


def _bias_args(bias, q, k):
    """The C arguments ``(bias, bias_bf16, sb, sh, sq, sk)``: the pointer
    and the element strides of ``bias.expand(B, H, Sq, Sk)`` (0 on a
    broadcast dimension), or a null pointer."""
    if bias is None:
        return (None, 0, 0, 0, 0, 0)
    full = bias.expand(q.shape[0], q.shape[1], q.shape[2], k.shape[2])
    return (bias.data_ptr(), int(bias.dtype == torch.bfloat16),
            *full.stride())


_BIAS_ARGTYPES = (ctypes.c_void_p, ctypes.c_int) + (ctypes.c_longlong,) * 4


def _host_int(name: str, val):
    """``val`` as a Python int (None stays None); a tensor or any other
    type raises ``TypeError``."""
    if val is None or (isinstance(val, numbers.Integral)
                       and not isinstance(val, bool)):
        return None if val is None else int(val)
    raise TypeError(f"{name} must be a host int in this port (a ring "
                    f"rank's index is known on the host), got "
                    f"{type(val).__name__}")


def launch_name(kernel: str, masking, bias, q_len: int,
                kv_len: int) -> str:
    """The launch name of a flash kernel's branch on ``q_len`` queries and
    ``kv_len`` keys: ``_window`` under a window, then ``_ring`` in ring
    attention's branch (``Masking.is_ring``), or ``_bias`` with a bias (no
    ring call carries one: that raises)."""
    ring = masking.is_ring(q_len, kv_len)
    if ring and bias is not None:
        raise ValueError("a causal_offset or a dropout origin does not "
                         "combine with a bias (ring attention has none)")
    return (kernel + ("" if masking.window is None else "_window")
            + ("_ring" if ring else "")
            + ("" if bias is None else "_bias"))


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
    dropout: ``causal`` (key ``j <= r + offset``), a sliding ``window``
    (with ``causal``, key ``j >= r + offset - (window - 1)``), int32
    ``segment_ids`` ``[B, Sq]`` and ``kv_segment_ids`` ``[B, Sk]`` (a row
    sees keys of its own segment), ``dropout_rate`` in ``[0, 1)`` with
    ``dropout_seed``. ``causal_offset`` is the diagonal (None: ``Sk -
    Sq``); ``dropout_row0``/``dropout_col0`` the global row and column of
    the call's first query and key in the keep mask's hash. All host
    ints."""

    causal: bool = True
    segment_ids: Optional[torch.Tensor] = None
    kv_segment_ids: Optional[torch.Tensor] = None
    dropout_rate: float = 0.0
    dropout_seed: int = 0
    window: Optional[int] = None
    causal_offset: Optional[int] = None
    dropout_row0: int = 0
    dropout_col0: int = 0

    def is_ring(self, q_len: int, kv_len: int) -> bool:
        """Whether a call on ``q_len`` queries and ``kv_len`` keys takes
        ring attention's branch, counted under its own launch names: a
        causal diagonal other than ``Sk - Sq``, or dropout drawn at a
        non-zero origin. An offset or an origin that changes nothing (the
        default diagonal given explicitly, an origin without dropout) runs
        the plain branch."""
        shifted = (self.causal and self.causal_offset is not None
                   and self.causal_offset != kv_len - q_len)
        moved = self.dropout_rate > 0.0 and (self.dropout_row0 != 0
                                             or self.dropout_col0 != 0)
        return shifted or moved

    def offset(self, q_len: int, kv_len: int) -> int:
        """The causal diagonal: row ``r`` sees keys ``<= r + offset``."""
        return (kv_len - q_len if self.causal_offset is None
                else self.causal_offset)

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
        for name in ("causal_offset", "dropout_row0", "dropout_col0"):
            _host_int(name, getattr(self, name))
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
        off = self.offset(q_len, kv_len)
        if self.causal:
            mask = rows + off >= cols
        if self.window is not None:
            mask = mask & (cols >= rows + off - (self.window - 1))
        mask = mask[None, None]
        if self.segment_ids is not None:
            qs = self.segment_ids.to(device)
            ks = self.kv_segment_ids.to(device)
            mask = mask & (qs[:, None, :, None] == ks[:, None, None, :])
        return mask

    def keep(self, batch: int, heads: int, q_len: int, kv_len: int,
             device) -> Optional[torch.Tensor]:
        """fp32 ``[B, H, Sq, Sk]``: 0 where dropped, ``keep_scale`` where
        kept; None without dropout. Rows and columns hash at the origins'
        global positions, modulo 2^32."""
        if self.dropout_rate <= 0.0:
            return None
        i64 = dict(dtype=torch.int64, device=device)
        bh = torch.arange(batch * heads, **i64).reshape(batch, heads, 1, 1)
        rows = (torch.arange(q_len, **i64) + self.dropout_row0) & _M32
        cols = (torch.arange(kv_len, **i64) + self.dropout_col0) & _M32
        x = dropout_hash(self.dropout_seed, bh, rows[:, None],
                         cols[None, :])
        return torch.where(x >= self.threshold, self.keep_scale,
                           0.0).to(torch.float32)

    @property
    def kernel_seed(self) -> int:
        """The seed the kernels hash with: the hash adds ``row * 0x9E3779B1
        + col * 0x85EBCA77`` to the seed in uint32, so the origins' share
        of a pair's global position is a constant of the call, folded into
        the seed here."""
        return (int(self.dropout_seed) + self.dropout_row0 * 0x9E3779B1
                + self.dropout_col0 * 0x85EBCA77) & _M32

    def kernel_args(self, q_len: int, kv_len: int, device):
        """The C arguments ``(q_seg, kv_seg, causal, dropout, seed,
        threshold, keep_scale, window, offset)`` and the segment tensors to
        keep alive."""
        segs = []
        if self.segment_ids is not None:
            segs = [t.to(device=device, dtype=torch.int32).contiguous()
                    for t in (self.segment_ids, self.kv_segment_ids)]
        ptrs = [t.data_ptr() for t in segs] or [None, None]
        drop = self.dropout_rate > 0.0
        return ((*ptrs, int(self.causal), int(drop), self.kernel_seed,
                 self.threshold, self.keep_scale if drop else 1.0,
                 int(self.window or 0), self.offset(q_len, kv_len)), segs)


CAUSAL = Masking()
_MASK_ARGTYPES = (_build.P, _build.P, _build.I, _build.I, ctypes.c_uint,
                  ctypes.c_uint, _build.F, _build.I, _build.I)


def flash_attention_reference(q, k, v, *, scale: float,
                              masking: Masking = CAUSAL, bias=None):
    """Plain twin: dense attention with fp32 scores ``scale * q . k +
    bias``, invisible pairs' probabilities exactly 0, a row that sees no
    key output 0 (its LSE the mask value, as the reference's), and dropout
    applied to the normalised probabilities before the PV product."""
    rep = _check_shapes(q, k, v)
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = _add_bias(torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale,
                  bias)
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


def _flash_fwd_kernel(q, k, v, scale: float, masking: Masking = CAUSAL,
                      bias=None):
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    mask_args, segs = masking.kernel_args(sq, sk, q.device)
    _build.check_cuda(q, k, v, *segs)
    _check_bias(bias, q, k)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return o, lse
    P, I, F = _build.P, _build.I, _build.F
    _build.launch(
        launch_name("flash_fwd", masking, bias, sq, sk), "apex_flash_fwd",
        (P, P, P, P, P) + _MASK_ARGTYPES + _BIAS_ARGTYPES + (I,) * 6
        + (F, I, P),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *mask_args, *_bias_args(bias, q, k), b, h, hkv, sq,
        sk, d, float(scale), _build.dtype_code(q), _build.stream_of(q))
    return o, lse


def flash_fwd(q, k, v, *, scale: float, masking: Masking = CAUSAL,
              bias=None):
    """``(o, lse)``: the kernel on a CUDA tensor, the twin on a CPU one."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale=scale,
                                         masking=masking, bias=bias)
    return _flash_fwd_kernel(q, k, v, scale, masking, bias)


def flash_bwd_delta(o, do, dlse=None) -> torch.Tensor:
    """``delta = sum(do * o)`` over the head dim, fp32 ``[B, H, Sq]``, less
    ``dlse`` (an LSE cotangent); a torch reduction, outside the kernels as
    in the reference."""
    delta = (do.float() * o.float()).sum(dim=-1)
    return delta if dlse is None else delta - dlse.float()


def _bwd_p_ds(q, k, v, do, lse, delta, scale, masking, bias):
    """The recompute both backward twins share: fp32 ``(p * keep, ds)``
    over the visible pairs, with k and v repeated over each GQA group:
    ``p = exp(scale q . k + bias - lse)``, ``ds = p (dp keep - delta)
    scale`` with the undropped ``p``."""
    rep = _check_shapes(q, k, v)
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = _add_bias(torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale,
                  bias)
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
                           masking: Masking = CAUSAL, bias=None):
    """Plain twin of the dq kernel: ``dq = ds k`` with ``P = exp(scale q
    k^T + bias - lse)`` on the visible pairs and ``ds = P (do v^T keep -
    delta) scale``; fp32 math, dq in q's dtype."""
    _, ds, kf = _bwd_p_ds(q, k, v, do, lse, delta, scale, masking, bias)
    return torch.einsum("bhqk,bhkd->bhqd", ds, kf).to(q.dtype)


def flash_bwd_dkdv_reference(q, k, v, do, lse, delta, *, scale: float,
                             masking: Masking = CAUSAL, bias=None):
    """Plain twin of the dk/dv kernel: ``dv = (P keep)^T do`` and ``dk =
    ds^T q``, each GQA group's per-q-head sums added into its kv head; fp32
    math, dk/dv in k's/v's dtype."""
    p, ds, _ = _bwd_p_ds(q, k, v, do, lse, delta, scale, masking, bias)
    b, h, _, d = q.shape
    kv_heads, kv_len = k.shape[1], k.shape[2]
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    if h != kv_heads:
        dk = dk.reshape(b, kv_heads, h // kv_heads, kv_len, d).sum(dim=2)
        dv = dv.reshape(b, kv_heads, h // kv_heads, kv_len, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, scale: float,
                                  dlse=None, masking: Masking = CAUSAL,
                                  bias=None):
    """Plain twin of the whole backward: ``(dq, dk, dv)`` by the FA-2
    recompute of ``_fa_bwd_impl`` (``delta = sum(do * o)``, less ``dlse``)."""
    delta = flash_bwd_delta(o, do, dlse)
    kw = dict(scale=scale, masking=masking, bias=bias)
    return (flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw),
            *flash_bwd_dkdv_reference(q, k, v, do, lse, delta, **kw))


def _bwd_operands(q, k, v, do, lse, delta, masking, bias):
    if not (q.dtype == k.dtype == v.dtype == do.dtype):
        raise TypeError(f"q/k/v/do dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {do.dtype}")
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"do {tuple(do.shape)} != q {tuple(q.shape)}")
    ops = [t.contiguous() for t in (q, k, v, do)]
    ops += [lse.float().contiguous(), delta.float().contiguous()]
    b, h, sq, d = q.shape
    mask_args, segs = masking.kernel_args(sq, k.shape[2], q.device)
    _build.check_cuda(*ops, *segs)
    _check_bias(bias, q, k)
    args = (b, h, k.shape[1], sq, k.shape[2], d)
    return ops, (*mask_args, *_bias_args(bias, q, k)), segs, args


_BWD_ARGTYPES = _MASK_ARGTYPES + _BIAS_ARGTYPES \
    + (_build.I,) * 6 + (_build.F, _build.I, _build.P)


def flash_bwd_dq(q, k, v, do, lse, delta, *, scale: float,
                 masking: Masking = CAUSAL, bias=None):
    """dq: the kernel on a CUDA tensor, the twin on a CPU one."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, scale=scale,
                                      masking=masking, bias=bias)
    ops, mask_args, _segs, args = _bwd_operands(q, k, v, do, lse, delta,
                                                masking, bias)
    dq = torch.empty_like(ops[0])
    if dq.numel() == 0 or args[4] == 0:
        return dq.zero_()
    _build.launch(launch_name("flash_bwd_dq", masking, bias, q.shape[2],
                              k.shape[2]),
                  "apex_flash_bwd_dq", (_build.P,) * 7 + _BWD_ARGTYPES,
                  *(t.data_ptr() for t in ops), dq.data_ptr(), *mask_args,
                  *args, float(scale), _build.dtype_code(dq),
                  _build.stream_of(dq))
    return dq


def flash_bwd_dkdv(q, k, v, do, lse, delta, *, scale: float,
                   masking: Masking = CAUSAL, bias=None):
    """``(dk, dv)``: the kernel on a CUDA tensor, the twin on a CPU one."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                        scale=scale, masking=masking,
                                        bias=bias)
    ops, mask_args, _segs, args = _bwd_operands(q, k, v, do, lse, delta,
                                                masking, bias)
    dk, dv = torch.empty_like(ops[1]), torch.empty_like(ops[2])
    if dk.numel() == 0 or args[3] == 0:
        return dk.zero_(), dv.zero_()
    _build.launch(launch_name("flash_bwd_dkdv", masking, bias, q.shape[2],
                              k.shape[2]),
                  "apex_flash_bwd_dkdv", (_build.P,) * 8 + _BWD_ARGTYPES,
                  *(t.data_ptr() for t in ops), dk.data_ptr(), dv.data_ptr(),
                  *mask_args, *args, float(scale), _build.dtype_code(dk),
                  _build.stream_of(dk))
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, scale: float, dlse=None,
                        masking: Masking = CAUSAL, bias=None):
    """``(dq, dk, dv)``: the two kernels on a CUDA tensor, the twins on a
    CPU one."""
    delta = flash_bwd_delta(o, do, dlse)
    kw = dict(scale=scale, masking=masking, bias=bias)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_bwd_dkdv(q, k, v, do, lse, delta, **kw))


class _FlashAttentionFunction(torch.autograd.Function):
    """Autograd over the kernels: ``(o, lse)``; saves ``q, k, v, bias, o,
    lse`` as the reference's ``_flash_fwd`` does (the masking rides on
    ``ctx``). On the card the backward always launches the backward
    kernels. The bias's gradient is zeros, as the reference's
    ``_flash_bwd`` returns: the bias is not differentiated."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, masking):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        bias = None if bias is None else bias.detach()
        o, lse = flash_fwd(q, k, v, scale=scale, masking=masking, bias=bias)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.scale = scale
        ctx.masking = masking
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         scale=ctx.scale, dlse=dlse,
                                         masking=ctx.masking, bias=bias)
        dbias = torch.zeros_like(bias) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias, None, None


def _attend(q, k, v, scale, masking, bias=None):
    _check_shapes(q, k, v)
    masking.check(q, k)
    _check_bias(bias, q, k)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _FlashAttentionFunction.apply(q, k, v, bias, float(scale),
                                         masking)


def flash_attention_with_lse(q, k, v, *, scale: Optional[float] = None,
                             causal: bool = False,
                             window: Optional[int] = None,
                             causal_offset: Optional[int] = None,
                             dropout_rate: float = 0.0,
                             dropout_seed: int = 0,
                             dropout_row0: int = 0,
                             dropout_col0: int = 0):
    """``(o, lse)``: the kernel on a CUDA tensor, the twin on a CPU one;
    differentiable in q, k and v through both outputs, with the
    reference's signature. ``causal_offset`` places the causal diagonal
    and the window at global positions (None: ``Sk - Sq``); the keep mask
    is drawn at global positions from ``dropout_row0`` and
    ``dropout_col0``. Offsets and origins are host ints (a tensor raises
    ``TypeError``): the port reads a ring rank's index on the host, so no
    step syncs on the card."""
    return _attend(q, k, v, scale, Masking(
        causal=bool(causal), dropout_rate=float(dropout_rate),
        dropout_seed=int(dropout_seed), window=window,
        causal_offset=_host_int("causal_offset", causal_offset),
        dropout_row0=_host_int("dropout_row0", dropout_row0),
        dropout_col0=_host_int("dropout_col0", dropout_col0)))


def flash_attention(q, k, v, bias=None, segment_ids=None,
                    kv_segment_ids=None, *, causal: bool = False,
                    scale: Optional[float] = None, dropout_rate: float = 0.0,
                    dropout_seed: int = 0, window: Optional[int] = None):
    """Flash attention ``softmax(scale * q @ k^T + bias [masked]) @ v``
    with the reference's signature. ``bias`` broadcasts to ``[B, H, Sq,
    Sk]`` and gets a zero gradient; ``kv_segment_ids`` defaults to
    ``segment_ids`` (self attention); ``window`` requires ``causal``."""
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    return _attend(q, k, v, scale, Masking(
        causal=bool(causal), segment_ids=segment_ids,
        kv_segment_ids=kv_segment_ids, dropout_rate=float(dropout_rate),
        dropout_seed=int(dropout_seed), window=window), bias)[0]


def mha_reference(q, k, v, bias=None, segment_ids=None, kv_segment_ids=None,
                  *, causal: bool = False, scale: Optional[float] = None,
                  window: Optional[int] = None):
    """The unfused ground truth (the twin's O), with the reference's
    ``mha_reference`` signature and defaults (non-causal; ``bias`` added to
    the scaled scores); no dropout (the reference's raises on it too)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    masking = Masking(causal=causal, segment_ids=segment_ids,
                      kv_segment_ids=kv_segment_ids, window=window)
    masking.check(q, k)
    _check_bias(bias, q, k)
    return flash_attention_reference(q, k, v, scale=scale, masking=masking,
                                     bias=bias)[0]
