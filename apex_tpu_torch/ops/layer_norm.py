"""LayerNorm and RMSNorm forward, LayerNorm backward: the Hopper kernels
``csrc/layer_norm_fwd.cu`` and ``csrc/layer_norm_bwd.cu`` and their plain
PyTorch twins.

Counterpart of ``apex_tpu/ops/layer_norm.py`` (``_ln_fwd_kernel``,
``_ln_bwd_kernel``, ``_fused_norm``, ``layer_norm``, ``rms_norm``) for
affine LayerNorm that saves x for the backward (the reference's default,
``memory_efficient=False``), and for RMSNorm's forward (``rms=True``: mean
0, ``var = mean(x^2)``, ``y = x * rstd * w``). Semantics: fp32 statistics
whatever x's dtype, fp32 weight and bias over an fp32 or bf16 x (the
reference's "mixed" variants), output in x's dtype; the backward returns dx
in dy's dtype and fp32 dgamma/dbeta summed over all rows. ``layer_norm`` is
differentiable through ``_FusedLayerNormFunction``, whose backward is the
backward kernel. ``rms_norm`` has no backward kernel yet: on the card it
raises where autograd would need one.

A tensor on the CPU takes the twins; a CUDA tensor always takes the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import _build

_B10 = ("is not ported yet (ROADMAP queue B item 10: the RMSNorm backward "
        "and memory_efficient LayerNorm)")


def layer_norm_fwd_reference(x2d: torch.Tensor, weight=None, bias=None,
                             eps: float = 1e-5):
    """Plain twin of the kernel: ``(y, mean, rstd)`` for a 2-D ``x``, with
    ``mean``/``rstd`` fp32 of shape ``(rows, 1)``."""
    xf = x2d.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd
    if weight is not None:
        y = y * weight.float()
        if bias is not None:
            y = y + bias.float()
    return y.to(x2d.dtype), mean, rstd


def rms_norm_fwd_reference(x2d: torch.Tensor, weight=None,
                           eps: float = 1e-5):
    """Plain twin of the kernel's RMS branch: ``(y, mean, rstd)`` for a 2-D
    ``x``, ``mean`` zeros and ``rstd = rsqrt(mean(x^2) + eps)``, both fp32
    ``(rows, 1)``; ``y = x * rstd * w`` in fp32, cast to x's dtype."""
    xf = x2d.float()
    mean = torch.zeros((x2d.shape[0], 1), dtype=torch.float32,
                       device=x2d.device)
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    y = xf * rstd
    if weight is not None:
        y = y * weight.float()
    return y.to(x2d.dtype), mean, rstd


def _norm_fwd_kernel(name: str, x2d, weight, bias, eps: float, rms: bool):
    rows, cols = x2d.shape
    x2d = x2d.contiguous()
    w = weight.float().contiguous() if weight is not None else None
    b = bias.float().contiguous() if bias is not None else None
    y = torch.empty_like(x2d)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    _build.check_cuda(*[t for t in (x2d, w, b) if t is not None])
    P, I, F = _build.P, _build.I, _build.F
    _build.launch(
        name, "apex_layer_norm_fwd",
        (P, P, P, P, P, P, I, I, F, I, I, P),
        x2d.data_ptr(), w.data_ptr() if w is not None else None,
        b.data_ptr() if b is not None else None, y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), rows, cols, float(eps), int(rms),
        _build.dtype_code(x2d), _build.stream_of(x2d))
    return y, mean, rstd


def layer_norm_fwd(x2d: torch.Tensor, weight=None, bias=None,
                   eps: float = 1e-5):
    """``(y, mean, rstd)`` for a 2-D ``x``: the kernel on a CUDA tensor, the
    twin on a CPU one."""
    if x2d.device.type == "cpu":
        return layer_norm_fwd_reference(x2d, weight, bias, eps)
    return _norm_fwd_kernel("layer_norm_fwd", x2d, weight, bias, eps, False)


def rms_norm_fwd(x2d: torch.Tensor, weight=None, eps: float = 1e-5):
    """RMSNorm's ``(y, mean, rstd)`` for a 2-D ``x``: the kernel's RMS branch
    on a CUDA tensor, the twin on a CPU one."""
    if x2d.device.type == "cpu":
        return rms_norm_fwd_reference(x2d, weight, eps)
    return _norm_fwd_kernel("rms_norm_fwd", x2d, weight, None, eps, True)


def layer_norm_bwd_reference(dy2d: torch.Tensor, x2d: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor,
                             weight=None):
    """Plain twin of the backward kernel: ``(dx, dw, db)`` for 2-D ``dy`` and
    ``x`` and the forward's fp32 ``(rows, 1)`` ``mean``/``rstd``. fp32 math;
    ``dx`` in dy's dtype; ``dw``/``db`` fp32, summed over all rows (None
    without a weight)."""
    dy = dy2d.float()
    xhat = (x2d.float() - mean) * rstd
    wdy = dy * weight.float() if weight is not None else dy
    c1 = (xhat * wdy).mean(dim=-1, keepdim=True)
    c2 = wdy.mean(dim=-1, keepdim=True)
    dx = ((wdy - xhat * c1 - c2) * rstd).to(dy2d.dtype)
    if weight is None:
        return dx, None, None
    return dx, (dy * xhat).sum(dim=0), dy.sum(dim=0)


def layer_norm_bwd(dy2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, weight=None):
    """``(dx, dw, db)``: the kernel on a CUDA tensor, the twin on a CPU
    one."""
    if dy2d.device.type == "cpu":
        return layer_norm_bwd_reference(dy2d, x2d, mean, rstd, weight)
    rows, cols = x2d.shape
    if tuple(dy2d.shape) != (rows, cols):
        raise ValueError(f"dy {tuple(dy2d.shape)} != x {(rows, cols)}")
    if dy2d.dtype != x2d.dtype:
        raise TypeError(f"dy and x dtypes differ: {dy2d.dtype}, {x2d.dtype}")
    dy2d, x2d = dy2d.contiguous(), x2d.contiguous()
    mean, rstd = mean.float().contiguous(), rstd.float().contiguous()
    w = weight.float().contiguous() if weight is not None else None
    P, I = _build.P, _build.I
    dx = torch.empty_like(dy2d)
    dw = db = part = None
    if w is not None:
        dw = torch.empty(cols, dtype=torch.float32, device=dy2d.device)
        db = torch.empty(cols, dtype=torch.float32, device=dy2d.device)
        # the kernel's tile layout decides the dgamma/dbeta scratch size
        n_part = _build.query("layer_norm_bwd",
                              "apex_layer_norm_bwd_scratch_floats", (I, I),
                              _build.L, rows, cols)
        part = torch.empty(n_part, dtype=torch.float32, device=dy2d.device)
    _build.check_cuda(*[t for t in (dy2d, x2d, mean, rstd, w)
                        if t is not None])

    def ptr(t):
        return t.data_ptr() if t is not None else None

    _build.launch(
        "layer_norm_bwd", "apex_layer_norm_bwd",
        (P, P, P, P, P, P, P, P, P, I, I, I, P),
        dy2d.data_ptr(), x2d.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        ptr(w), dx.data_ptr(), ptr(dw), ptr(db), ptr(part), rows, cols,
        _build.dtype_code(dy2d), _build.stream_of(dy2d))
    return dx, dw, db


class _FusedLayerNormFunction(torch.autograd.Function):
    """Autograd over the two kernels. Saves ``x2d, mean, rstd`` (and the
    weight) as the reference's ``_fused_norm_fwd`` does."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        cols = x.shape[-1]
        x2d = x.reshape(-1, cols)
        y, mean, rstd = layer_norm_fwd(x2d, weight, bias, eps)
        ctx.save_for_backward(x2d, mean, rstd, weight)
        ctx.has_bias = bias is not None
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2d, mean, rstd, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(dy.reshape(x2d.shape), x2d, mean, rstd,
                                    weight)
        if weight is not None:
            dw = dw.to(weight.dtype)
            db = db.to(weight.dtype) if ctx.has_bias else None
        return dx.reshape(dy.shape), dw, db, None


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
               memory_efficient: bool = False, rms: bool = False):
    """Fused LayerNorm over the last dimension, differentiable in x, weight
    and bias."""
    if memory_efficient:
        raise NotImplementedError(f"layer_norm(memory_efficient=True) {_B10}")
    if rms:
        if bias is not None:
            raise ValueError("RMSNorm takes no bias")
        return rms_norm(x, weight, eps)
    if weight is None and bias is not None:
        raise ValueError("layer_norm: bias requires weight (the reference "
                         "API has no bias-only variant)")
    return _FusedLayerNormFunction.apply(x, weight, bias, float(eps))


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-5, memory_efficient: bool = False):
    """Fused RMSNorm over the last dimension (the reference's ``rms_norm``),
    output in x's dtype. Forward only on the card: where autograd would
    need the backward kernel (a CUDA input or weight that requires grad,
    with grad enabled) it raises, naming ROADMAP B10; on the CPU the twin's
    plain ops are differentiable."""
    if memory_efficient:
        raise NotImplementedError(f"rms_norm(memory_efficient=True) {_B10}")
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, weight))
    if needs_grad and x.device.type != "cpu":
        raise NotImplementedError(
            f"the RMSNorm backward {_B10}: call rms_norm under "
            f"torch.no_grad() or on inputs that do not require grad")
    cols = x.shape[-1]
    return rms_norm_fwd(x.reshape(-1, cols), weight, eps)[0].reshape(x.shape)
