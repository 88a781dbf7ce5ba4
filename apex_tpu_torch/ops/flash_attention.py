"""Causal flash-attention forward: the Hopper kernel ``csrc/flash_fwd.cu``
and its plain PyTorch twin.

Counterpart of ``apex_tpu/ops/flash_attention.py`` (``_fwd_kernel``,
``_fa_fwd``, ``flash_attention``, ``flash_attention_with_lse``,
``mha_reference``) in the subset the serving prefill uses: causal, no bias,
no segment ids, no dropout, no window, forward only. Layout as in the
reference: q ``[B, H, Sq, D]``, k/v ``[B, Hkv, Sk, D]`` with ``Hkv``
dividing ``H`` (GQA reads kv head ``h // (H / Hkv)``, never repeated in the
kernel). Query row ``r`` sees keys ``j <= r + (Sk - Sq)``. Returns O in q's
dtype and the fp32 log-sum-exp.

A tensor on the CPU takes the twin; a CUDA tensor always takes the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_UNSUPPORTED = ("flash attention in this port supports causal=True only, "
                "without bias, segment ids, dropout or window (ROADMAP "
                "queue B item 8: the full flash surface)")


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


def flash_attention_reference(q, k, v, *, scale: float):
    """Plain twin: dense causal attention with fp32 scores, masked
    probabilities exactly 0 and a fully-masked row output 0."""
    rep = _check_shapes(q, k, v)
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    q_len, kv_len = q.shape[2], k.shape[2]
    rows = torch.arange(q_len, device=q.device)[:, None] + (kv_len - q_len)
    mask = rows >= torch.arange(kv_len, device=q.device)[None, :]
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


def flash_attention_with_lse(q, k, v, *, scale: Optional[float] = None,
                             causal: bool = False,
                             window: Optional[int] = None,
                             dropout_rate: float = 0.0):
    """``(o, lse)``: the kernel on a CUDA tensor, the twin on a CPU one."""
    if not causal or window is not None or dropout_rate:
        raise NotImplementedError(_UNSUPPORTED)
    _check_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale=scale)
    return _flash_fwd_kernel(q, k, v, scale)


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
