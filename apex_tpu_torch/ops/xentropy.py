"""Fused softmax cross entropy with label smoothing: the Hopper kernel
``csrc/xentropy.cu`` (a forward giving the per-row loss and LSE, a backward
giving dx) and its plain PyTorch twins.

Counterpart of ``apex_tpu/ops/xentropy.py`` (``_fwd_kernel``,
``_bwd_kernel``, ``softmax_cross_entropy``)::

    loss_i = lse_i - (1 - s) * x_i[y_i] - s * mean_v(x_i[v])
    dx_i   = dloss_i * (softmax(x_i) - (1 - s) * onehot(y_i) - s / V)

in fp32 whatever the logits' dtype; dx comes back in the logits' dtype.
Rows whose label equals ``padding_idx`` get loss 0 and dx 0; a label
outside ``[0, V)`` picks no logit. ``softmax_cross_entropy`` is
differentiable in the logits through ``_SoftmaxXentropyFunction``, which
saves the logits, the labels and the LSE only (``_xent_vfwd``): the backward
recomputes the softmax.

A tensor on the CPU takes the twins; a CUDA tensor always takes the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import _build


def _check(x2d, labels):
    if x2d.ndim != 2 or labels.shape != (x2d.shape[0],):
        raise ValueError(f"expected logits [R, V] and labels [R], got "
                         f"{tuple(x2d.shape)} and {tuple(labels.shape)}")


def _pad_args(padding_idx):
    return (0, 0) if padding_idx is None else (1, int(padding_idx))


def xentropy_fwd_reference(x2d, labels, smoothing: float = 0.0,
                           padding_idx: Optional[int] = None):
    """Plain twin of the forward kernel: fp32 ``(loss, lse)`` of shape
    ``[R]``."""
    _check(x2d, labels)
    xf = x2d.float()
    vocab = xf.shape[1]
    m = xf.amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.exp(xf - m).sum(dim=-1, keepdim=True)))[:, 0]
    lbl = labels.long()
    in_range = (lbl >= 0) & (lbl < vocab)
    x_t = xf.gather(1, lbl.clamp(0, vocab - 1)[:, None])[:, 0]
    loss = lse - (1.0 - smoothing) * torch.where(in_range, x_t, 0.0)
    if smoothing > 0.0:
        loss = loss - smoothing * (xf.sum(dim=-1) / vocab)
    if padding_idx is not None:
        loss = torch.where(lbl == padding_idx, 0.0, loss)
    return loss, lse


def xentropy_bwd_reference(x2d, labels, lse, dy, smoothing: float = 0.0,
                           padding_idx: Optional[int] = None):
    """Plain twin of the backward kernel: dx in the logits' dtype."""
    _check(x2d, labels)
    xf = x2d.float()
    vocab = xf.shape[1]
    lbl = labels.long()
    onehot = (torch.arange(vocab, device=xf.device)[None, :]
              == lbl[:, None]).float()
    grad = torch.exp(xf - lse.float()[:, None]) - (1.0 - smoothing) * onehot
    if smoothing > 0.0:
        grad = grad - smoothing / vocab
    grad = grad * dy.float()[:, None]
    if padding_idx is not None:
        grad = torch.where((lbl == padding_idx)[:, None], 0.0, grad)
    return grad.to(x2d.dtype)


def xentropy_fwd(x2d, labels, smoothing: float = 0.0,
                 padding_idx: Optional[int] = None):
    """``(loss, lse)``: the kernel on a CUDA tensor, the twin on a CPU
    one."""
    if x2d.device.type == "cpu":
        return xentropy_fwd_reference(x2d, labels, smoothing, padding_idx)
    _check(x2d, labels)
    x2d = x2d.contiguous()
    lbl = labels.to(device=x2d.device, dtype=torch.int32).contiguous()
    rows, vocab = x2d.shape
    loss = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    lse = torch.empty_like(loss)
    _build.check_cuda(x2d, lbl)
    P, I, F = _build.P, _build.I, _build.F
    _build.launch("xentropy_fwd", "apex_xentropy_fwd",
                  (P, P, P, P, I, I, F, F, I, I, I, P),
                  x2d.data_ptr(), lbl.data_ptr(), loss.data_ptr(),
                  lse.data_ptr(), rows, vocab, 1.0 - smoothing,
                  float(smoothing), *_pad_args(padding_idx),
                  _build.dtype_code(x2d), _build.stream_of(x2d))
    return loss, lse


def xentropy_bwd(x2d, labels, lse, dy, smoothing: float = 0.0,
                 padding_idx: Optional[int] = None):
    """dx: the kernel on a CUDA tensor, the twin on a CPU one."""
    if x2d.device.type == "cpu":
        return xentropy_bwd_reference(x2d, labels, lse, dy, smoothing,
                                      padding_idx)
    _check(x2d, labels)
    x2d = x2d.contiguous()
    lbl = labels.to(device=x2d.device, dtype=torch.int32).contiguous()
    lse, dy = lse.float().contiguous(), dy.float().contiguous()
    rows, vocab = x2d.shape
    dx = torch.empty_like(x2d)
    _build.check_cuda(x2d, lbl, lse, dy)
    P, I, F = _build.P, _build.I, _build.F
    _build.launch("xentropy_bwd", "apex_xentropy_bwd",
                  (P, P, P, P, P, I, I, F, F, I, I, I, P),
                  x2d.data_ptr(), lbl.data_ptr(), lse.data_ptr(),
                  dy.data_ptr(), dx.data_ptr(), rows, vocab,
                  1.0 - smoothing, smoothing / vocab if smoothing else 0.0,
                  *_pad_args(padding_idx), _build.dtype_code(x2d),
                  _build.stream_of(x2d))
    return dx


class _SoftmaxXentropyFunction(torch.autograd.Function):
    """Autograd over the two kernels; saves the logits, labels and LSE."""

    @staticmethod
    def forward(ctx, x2d, labels, smoothing, padding_idx):
        loss, lse = xentropy_fwd(x2d, labels, smoothing, padding_idx)
        ctx.save_for_backward(x2d, labels, lse)
        ctx.smoothing, ctx.padding_idx = smoothing, padding_idx
        return loss

    @staticmethod
    def backward(ctx, dy):
        x2d, labels, lse = ctx.saved_tensors
        dx = xentropy_bwd(x2d, labels, lse, dy, ctx.smoothing,
                          ctx.padding_idx)
        return dx, None, None, None


def softmax_cross_entropy(logits, labels, smoothing: float = 0.0,
                          padding_idx: Optional[int] = None):
    """Fused label-smoothed softmax cross entropy: fp32 per-row losses of
    shape ``logits.shape[:-1]``, differentiable in ``logits``.

    ``logits`` is ``[..., V]`` in fp32 or bf16 (fp32 math inside),
    ``labels`` ``[...]`` integer class ids; ``smoothing`` in ``[0, 1)``;
    rows labelled ``padding_idx`` get zero loss and gradient."""
    if not 0.0 <= smoothing < 1.0:
        raise ValueError(f"smoothing must be in [0, 1), got {smoothing}")
    vocab = logits.shape[-1]
    lead = logits.shape[:-1]
    loss = _SoftmaxXentropyFunction.apply(
        logits.reshape(-1, vocab), labels.reshape(-1), float(smoothing),
        None if padding_idx is None else int(padding_idx))
    return loss.reshape(lead)
