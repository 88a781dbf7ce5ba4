"""Rotary positional embedding (RoPE), plain torch.

Counterpart of ``apex_tpu/transformer/functional/fused_rope.py``
(``fused_apply_rotary_pos_emb``, ``fused_apply_rotary_pos_emb_cached``).
The reference writes no Pallas kernel here by design (an elementwise
rewrite its compiler fuses into the neighbouring products), so the port
writes no CUDA kernel either.

Layout as in the reference: ``t`` ``[sq, b, np, hn]``; ``freqs`` (or the
cached ``cos_``/``sin_``) ``[sq, 1 or b, 1, hn2]`` with ``hn2 <= hn`` even.
Rotate-half convention (``[x1 | x2] -> [-x2 | x1]`` over the first ``hn2``
features); the features past ``hn2`` pass through (partial rotary).
"""

from __future__ import annotations

import torch


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def _apply(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    hn2 = cos.shape[-1]
    rot, pass_through = t[..., :hn2], t[..., hn2:]
    rot = rot * cos + _rotate_half(rot) * sin
    if pass_through.shape[-1] == 0:
        return rot
    return torch.cat((rot, pass_through), dim=-1)


def fused_apply_rotary_pos_emb(t: torch.Tensor,
                               freqs: torch.Tensor) -> torch.Tensor:
    """RoPE with ``freqs`` in radians; cos and sin are taken in ``freqs``'s
    dtype and cast to ``t``'s, as in the reference."""
    return _apply(t, torch.cos(freqs).to(t.dtype),
                  torch.sin(freqs).to(t.dtype))


def fused_apply_rotary_pos_emb_cached(t: torch.Tensor, cos_: torch.Tensor,
                                      sin_: torch.Tensor) -> torch.Tensor:
    """RoPE from cached ``cos_``/``sin_`` tables, cast to ``t``'s dtype."""
    return _apply(t, cos_.to(t.dtype), sin_.to(t.dtype))
