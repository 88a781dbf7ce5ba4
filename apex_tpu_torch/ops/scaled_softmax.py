"""Fused scale + mask + softmax, forward and backward: the Hopper kernels
``csrc/scaled_softmax.cu`` and their plain PyTorch twins.

Counterpart of ``apex_tpu/ops/scaled_softmax.py`` (``_fwd_kernel``,
``_bwd_kernel``, ``_scaled_softmax``, ``scaled_masked_softmax``,
``scaled_upper_triang_masked_softmax``, ``scaled_softmax``), the three
Megatron softmax extensions. On ``x`` of shape ``[b, np, sq, sk]``, in fp32
whatever x's dtype::

    v  = x * scale, MASK_FILL where the mask is True (True = masked out)
         and, causal, where row < col (counted from the top left)
    y  = softmax(v) along sk                                (x's dtype)
    dx = (dy - sum(y * dy)) * y * scale                     (dy's dtype)

The fill is -10000, not -inf, so a row masked everywhere comes out
uniform, ``1 / sk``. The mask is bool (a nonzero entry of another dtype
masks, after the reference's cast to int8), broadcastable to ``[mb, 1, sq,
sk]`` with ``mb = mask.shape[0]``; sample ``i`` takes the mask's batch
block ``i % mb``, as the reference's index map does, for any ``mb``. The
kernel reads the mask in place through its broadcast strides, so a ``[b,
1, 1, sk]`` padding mask is never expanded. There is no cap on ``sk``.
fp32, bf16 and fp16.

Autograd goes through ``_ScaledSoftmaxFunction``, which saves ``y`` in x's
dtype (the reference's residual) and gives the mask no gradient. The
forward kernel launches under its branch's name:
``scaled_softmax_fwd_causal``, ``scaled_softmax_fwd_masked`` or
``scaled_softmax_fwd``.

A tensor on the CPU takes the twins; a CUDA tensor always takes the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import _build

# the reference fills masked scores with -10000 (scaled_masked_softmax.h)
MASK_FILL = -10000.0


def _check(x: torch.Tensor) -> None:
    if x.ndim != 4:
        raise ValueError(f"expected scores [b, np, sq, sk], got "
                         f"{tuple(x.shape)}")


def _broadcast_mask(mask: torch.Tensor, sq: int, sk: int) -> torch.Tensor:
    """The mask as bool, broadcast (a view) to ``[mb, 1, sq, sk]`` with
    ``mb = mask.shape[0]``, as the reference's ``broadcast_to``."""
    if mask.dtype != torch.bool:
        mask = mask.to(torch.int8) != 0
    return mask.expand(mask.shape[0], 1, sq, sk)


def _branch(mask, causal: bool) -> str:
    return ("scaled_softmax_fwd_causal" if causal
            else "scaled_softmax_fwd_masked" if mask is not None
            else "scaled_softmax_fwd")


def scaled_softmax_fwd_reference(x: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None,
                                 scale: float = 1.0, causal: bool = False):
    """Plain twin of the forward kernel: ``y`` in x's dtype, step by step
    as the reference's ``_fwd_kernel``."""
    _check(x)
    b, _, sq, sk = x.shape
    v = x.float() * scale
    if mask is not None:
        m = _broadcast_mask(mask, sq, sk).to(x.device)
        v = v.masked_fill(m[torch.arange(b, device=x.device) % m.shape[0]],
                          MASK_FILL)
    if causal:
        rows = torch.arange(sq, device=x.device)[:, None]
        cols = torch.arange(sk, device=x.device)[None, :]
        v = v.masked_fill(rows < cols, MASK_FILL)
    e = torch.exp(v - v.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def scaled_softmax_bwd_reference(y: torch.Tensor, dy: torch.Tensor,
                                 scale: float = 1.0):
    """Plain twin of the backward kernel: ``dx`` in dy's dtype."""
    yf, gf = y.float(), dy.float()
    dot = (yf * gf).sum(dim=-1, keepdim=True)
    return ((gf - dot) * yf * scale).to(dy.dtype)


def scaled_softmax_fwd(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                       scale: float = 1.0, causal: bool = False):
    """``y``: the kernel on a CUDA tensor, the twin on a CPU one."""
    _check(x)
    if x.device.type == "cpu":
        return scaled_softmax_fwd_reference(x, mask, scale, causal)
    x = x.contiguous()
    b, np_, sq, sk = x.shape
    y = torch.empty_like(x)
    mptr, strides, mb = None, (0, 0, 0), 1
    if mask is not None:
        m = _broadcast_mask(mask, sq, sk)
        if m.device != x.device:
            raise ValueError(f"mask on {m.device}, scores on {x.device}")
        mptr, mb = m.data_ptr(), m.shape[0]
        strides = (m.stride(0), m.stride(2), m.stride(3))
    _build.check_cuda(x)
    P, I, L, F = _build.P, _build.I, _build.L, _build.F
    _build.launch(_branch(mask, causal), "apex_scaled_softmax_fwd",
                  (P, P, P, L, L, L, I, I, I, I, I, F, I, I, P),
                  x.data_ptr(), y.data_ptr(), mptr, *strides, mb, b, np_, sq,
                  sk, float(scale), int(causal),
                  _build.dtype_code(x, _build.HALF_DTYPES),
                  _build.stream_of(x))
    return y


def scaled_softmax_bwd(y: torch.Tensor, dy: torch.Tensor, scale: float = 1.0):
    """``dx``: the kernel on a CUDA tensor, the twin on a CPU one."""
    if y.shape != dy.shape:
        raise ValueError(f"y {tuple(y.shape)} and dy {tuple(dy.shape)} "
                         f"differ")
    if y.device.type == "cpu":
        return scaled_softmax_bwd_reference(y, dy, scale)
    if dy.dtype != y.dtype:
        raise TypeError(f"the backward kernel takes y and dy of one dtype, "
                        f"got {y.dtype} and {dy.dtype}")
    y, dy = y.contiguous(), dy.contiguous()
    dx = torch.empty_like(dy)
    sk = y.shape[-1]
    _build.check_cuda(y, dy)
    P, I, L, F = _build.P, _build.I, _build.L, _build.F
    _build.launch("scaled_softmax_bwd", "apex_scaled_softmax_bwd",
                  (P, P, P, L, I, F, I, P),
                  y.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                  y.numel() // sk if sk else 0, sk, float(scale),
                  _build.dtype_code(y, _build.HALF_DTYPES),
                  _build.stream_of(y))
    return dx


class _ScaledSoftmaxFunction(torch.autograd.Function):
    """Autograd over the two kernels; saves ``y`` (x's dtype) only."""

    @staticmethod
    def forward(ctx, x, mask, scale, causal):
        y = scaled_softmax_fwd(x, mask, scale, causal)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return scaled_softmax_bwd(y, dy, ctx.scale), None, None, None


def scaled_masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor],
                          scale: float = 1.0):
    """softmax(scale * x masked-filled where ``mask`` is True), last dim, on
    ``[b, np, sq, sk]`` scores (reference ``ScaledMaskedSoftmax``)."""
    return _ScaledSoftmaxFunction.apply(x, mask, float(scale), False)


def scaled_upper_triang_masked_softmax(x: torch.Tensor, scale: float = 1.0):
    """Causal softmax of ``[b, sq, sk]`` scores, the attention batches
    flattened (reference ``ScaledUpperTriangMaskedSoftmax``)."""
    if x.ndim != 3:
        raise ValueError(f"expected scores [b, sq, sk], got "
                         f"{tuple(x.shape)}")
    return _ScaledSoftmaxFunction.apply(x[:, None], None, float(scale),
                                        True)[:, 0]


def scaled_softmax(x: torch.Tensor, scale: float = 1.0):
    """The no-mask variant (reference ``ScaledSoftmax``)."""
    return _ScaledSoftmaxFunction.apply(x, None, float(scale), False)
