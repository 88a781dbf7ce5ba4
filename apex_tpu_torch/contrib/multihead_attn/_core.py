"""Shared attention core of the multihead_attn modules.

Counterpart of ``apex_tpu/contrib/multihead_attn/_core.py``: the two masks
folded into one additive flash bias, and the fast-against-default dispatch
that ``SelfMultiheadAttn`` and ``EncdecMultiheadAttn`` share.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.flash_attention import flash_attention

_NEG = -1e9
_INT32_MAX = 2 ** 31 - 1


def masks_to_bias(key_padding_mask, attn_mask, mask_additive: bool):
    """The reference's two masks as one fp32 additive bias that broadcasts
    to ``[b, 1, sq, sk]``: ``key_padding_mask`` ``[b, sk]`` becomes ``[b, 1,
    1, sk]``, ``attn_mask`` ``[sq, sk]`` becomes ``[1, 1, sq, sk]``, their
    sum when both are given. A bool mask (True = masked) is -1e9 where True
    and 0 elsewhere; under ``mask_additive`` a mask is cast to fp32 as it
    is. The flash kernels read the result through its broadcast strides, so
    it is never expanded."""
    bias = None
    if key_padding_mask is not None:
        if mask_additive:
            pad = key_padding_mask.to(torch.float32)
        else:
            pad = torch.where(key_padding_mask.bool(), _NEG, 0.0).to(
                torch.float32)
        bias = pad[:, None, None, :]
    if attn_mask is not None:
        if mask_additive:
            am = attn_mask.to(torch.float32)
        else:
            am = torch.where(attn_mask.bool(), _NEG, 0.0).to(torch.float32)
        am = am[None, None, :, :]
        bias = am if bias is None else bias + am
    return bias


def draw_dropout_seed(generator: torch.Generator) -> int:
    """A host int in ``[0, 2^31 - 1)`` from a CPU ``generator``: the flash
    kernels' dropout seed (the reference draws it with
    ``jax.random.randint(make_rng("dropout"), (), 0, int32 max)``). Drawn
    on the CPU, it waits on nothing on the card."""
    return int(torch.randint(0, _INT32_MAX, (), generator=generator))


def attention_core(q, q_dim: int, k, v, bias, rate: float, impl: str, *,
                   generator: Optional[torch.Generator] = None,
                   seed: Optional[int] = None):
    """``softmax(q k^T / sqrt(q_dim) + bias) v`` with attention dropout at
    ``rate``; q, k, v ``[b, h, s, d]``.

    ``impl="fast"`` is the flash kernels (not causal, the bias read in
    place, the counter-based keep mask from ``seed``, drawn from the CPU
    ``generator`` when None). ``impl="default"`` is the unfused ground
    truth: fp32 scores, softmax, a keep mask drawn by ``torch.bernoulli``
    on the CPU ``generator``, then ``p.to(v.dtype) @ v``."""
    scale = q_dim ** -0.5
    if impl == "fast":
        if rate > 0.0 and seed is None:
            seed = draw_dropout_seed(generator)
        return flash_attention(q, k, v, bias=bias, scale=scale,
                               dropout_rate=rate,
                               dropout_seed=seed if rate > 0.0 else 0)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        keep = torch.bernoulli(torch.full(p.shape, 1.0 - rate),
                               generator=generator).to(p.device)
        p = p * keep / (1.0 - rate)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
