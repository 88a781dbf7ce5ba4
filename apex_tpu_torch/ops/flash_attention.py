"""Causal flash attention, forward and backward: the Hopper kernels
``csrc/flash_fwd.cu`` (O and LSE) and ``csrc/flash_bwd.cu`` (dq; dk and dv)
and their plain PyTorch twins.

Counterpart of ``apex_tpu/ops/flash_attention.py`` (``_fwd_kernel``,
``_dq_kernel``, ``_dkdv_kernel``, ``_fa_bwd_impl``, ``flash_attention``,
``flash_attention_with_lse``, ``mha_reference``) in its causal subset: no
bias, no segment ids, no dropout, no window. Layout as in the reference: q
``[B, H, Sq, D]``, k/v ``[B, Hkv, Sk, D]`` with ``Hkv`` dividing ``H`` (GQA
reads kv head ``h // (H / Hkv)``, never repeated in the kernels). Query row
``r`` sees keys ``j <= r + (Sk - Sq)``. The forward returns O in q's dtype
and the fp32 log-sum-exp. ``flash_attention`` and
``flash_attention_with_lse`` are differentiable through
``_FlashAttentionFunction``: it saves ``q, k, v, o, lse`` and its backward
is the FA-2 recompute of the reference (an LSE cotangent folds into
``delta``, as ``_flash_with_lse_bwd`` does).

A tensor on the CPU takes the twins; a CUDA tensor always takes the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_UNSUPPORTED = ("flash attention in this port supports causal=True only, "
                "without bias, segment ids, dropout or window (ROADMAP "
                "queue B item 8: the full flash surface; item 9 for its "
                "backward)")


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


def _causal_mask(q_len: int, kv_len: int, device) -> torch.Tensor:
    rows = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    return rows >= torch.arange(kv_len, device=device)[None, :]


def flash_attention_reference(q, k, v, *, scale: float):
    """Plain twin: dense causal attention with fp32 scores, masked
    probabilities exactly 0 and a fully-masked row output 0."""
    rep = _check_shapes(q, k, v)
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    mask = _causal_mask(q.shape[2], k.shape[2], q.device)
    s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    denom = e.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)
    o = torch.einsum("bhqk,bhkd->bhqd", e / denom, vf)
    lse = (m + torch.log(denom))[..., 0]
    return o.to(q.dtype), lse


def _flash_fwd_kernel(q, k, v, scale: float):
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d > 128:
        raise NotImplementedError(f"flash kernel takes head_dim <= 128, "
                                  f"got {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    _build.check_cuda(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return o, lse
    P, I, F = _build.P, _build.I, _build.F
    _build.launch(
        "flash_fwd", "apex_flash_fwd",
        (P, P, P, P, P, I, I, I, I, I, I, F, I, P),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, hkv, sq, sk, d, float(scale),
        _build.dtype_code(q), _build.stream_of(q))
    return o, lse


def flash_bwd_delta(o, do, dlse=None) -> torch.Tensor:
    """``delta = sum(do * o)`` over the head dim, fp32 ``[B, H, Sq]``, less
    ``dlse`` (an LSE cotangent); a torch reduction, outside the kernels as
    in the reference."""
    delta = (do.float() * o.float()).sum(dim=-1)
    return delta if dlse is None else delta - dlse.float()


def _bwd_p_ds(q, k, v, do, lse, delta, scale):
    """The recompute both backward twins share: fp32 ``(p, ds)`` over the
    causal pairs, with k and v repeated over each GQA group."""
    rep = _check_shapes(q, k, v)
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    mask = _causal_mask(q.shape[2], k.shape[2], q.device)
    p = torch.exp(torch.where(mask, s - lse.float()[..., None],
                              float("-inf")))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vf)
    return p, p * (dp - delta[..., None]) * scale, kf


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, scale: float):
    """Plain twin of the dq kernel: ``dq = ds k`` with ``P = exp(scale q
    k^T - lse)`` on the causal pairs and ``ds = P (do v^T - delta) scale``;
    fp32 math, dq in q's dtype."""
    _, ds, kf = _bwd_p_ds(q, k, v, do, lse, delta, scale)
    return torch.einsum("bhqk,bhkd->bhqd", ds, kf).to(q.dtype)


def flash_bwd_dkdv_reference(q, k, v, do, lse, delta, *, scale: float):
    """Plain twin of the dk/dv kernel: ``dv = P^T do`` and ``dk = ds^T q``,
    each GQA group's per-q-head sums added into its kv head; fp32 math,
    dk/dv in k's/v's dtype."""
    p, ds, _ = _bwd_p_ds(q, k, v, do, lse, delta, scale)
    b, h, _, d = q.shape
    kv_heads, kv_len = k.shape[1], k.shape[2]
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    if h != kv_heads:
        dk = dk.reshape(b, kv_heads, h // kv_heads, kv_len, d).sum(dim=2)
        dv = dv.reshape(b, kv_heads, h // kv_heads, kv_len, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, scale: float,
                                  dlse=None):
    """Plain twin of the whole backward: ``(dq, dk, dv)`` by the FA-2
    recompute of ``_fa_bwd_impl`` (``delta = sum(do * o)``, less ``dlse``)."""
    delta = flash_bwd_delta(o, do, dlse)
    return (flash_bwd_dq_reference(q, k, v, do, lse, delta, scale=scale),
            *flash_bwd_dkdv_reference(q, k, v, do, lse, delta, scale=scale))


def _bwd_operands(q, k, v, do, lse, delta):
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
    _build.check_cuda(*ops)
    b, h, sq, d = q.shape
    args = (b, h, k.shape[1], sq, k.shape[2], d)
    return ops, args


def flash_bwd_dq(q, k, v, do, lse, delta, *, scale: float):
    """dq: the kernel on a CUDA tensor, the twin on a CPU one."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, scale=scale)
    ops, args = _bwd_operands(q, k, v, do, lse, delta)
    dq = torch.empty_like(ops[0])
    if dq.numel() == 0 or args[4] == 0:
        return dq.zero_()
    P, I, F = _build.P, _build.I, _build.F
    _build.launch("flash_bwd_dq", "apex_flash_bwd_dq",
                  (P,) * 7 + (I,) * 6 + (F, I, P),
                  *(t.data_ptr() for t in ops), dq.data_ptr(), *args,
                  float(scale), _build.dtype_code(dq), _build.stream_of(dq))
    return dq


def flash_bwd_dkdv(q, k, v, do, lse, delta, *, scale: float):
    """``(dk, dv)``: the kernel on a CUDA tensor, the twin on a CPU one."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_bwd_dkdv_reference(q, k, v, do, lse, delta, scale=scale)
    ops, args = _bwd_operands(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(ops[1]), torch.empty_like(ops[2])
    if dk.numel() == 0 or args[3] == 0:
        return dk.zero_(), dv.zero_()
    P, I, F = _build.P, _build.I, _build.F
    _build.launch("flash_bwd_dkdv", "apex_flash_bwd_dkdv",
                  (P,) * 8 + (I,) * 6 + (F, I, P),
                  *(t.data_ptr() for t in ops), dk.data_ptr(), dv.data_ptr(),
                  *args, float(scale), _build.dtype_code(dk),
                  _build.stream_of(dk))
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, scale: float, dlse=None):
    """``(dq, dk, dv)``: the two kernels on a CUDA tensor, the twins on a
    CPU one."""
    delta = flash_bwd_delta(o, do, dlse)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale=scale)
    return (dq, *flash_bwd_dkdv(q, k, v, do, lse, delta, scale=scale))


class _FlashAttentionFunction(torch.autograd.Function):
    """Autograd over the causal kernels: ``(o, lse)``; saves ``q, k, v, o,
    lse`` as the reference's ``_flash_fwd`` does. On the card the backward
    always launches the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, scale=scale)
        else:
            o, lse = _flash_fwd_kernel(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         scale=ctx.scale, dlse=dlse)
        return dq, dk, dv, None


def flash_attention_with_lse(q, k, v, *, scale: Optional[float] = None,
                             causal: bool = False,
                             window: Optional[int] = None,
                             dropout_rate: float = 0.0):
    """``(o, lse)``: the kernel on a CUDA tensor, the twin on a CPU one;
    differentiable in q, k and v through both outputs."""
    if not causal or window is not None or dropout_rate:
        raise NotImplementedError(_UNSUPPORTED)
    _check_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _FlashAttentionFunction.apply(q, k, v, float(scale))


def flash_attention(q, k, v, bias=None, segment_ids=None,
                    kv_segment_ids=None, *, causal: bool = False,
                    scale: Optional[float] = None, dropout_rate: float = 0.0,
                    window: Optional[int] = None):
    """Flash attention ``softmax(scale * q @ k^T [causal]) @ v`` — the
    reference's signature; every argument beyond the causal subset
    raises ``NotImplementedError``."""
    if bias is not None or segment_ids is not None \
            or kv_segment_ids is not None:
        raise NotImplementedError(_UNSUPPORTED)
    return flash_attention_with_lse(
        q, k, v, scale=scale, causal=causal, window=window,
        dropout_rate=dropout_rate)[0]


def mha_reference(q, k, v, *, causal: bool = True,
                  scale: Optional[float] = None):
    """The unfused ground truth (the twin's O), as ``mha_reference`` is in
    the reference."""
    if not causal:
        raise NotImplementedError(_UNSUPPORTED)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return flash_attention_reference(q, k, v, scale=scale)[0]
