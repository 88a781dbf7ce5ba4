"""NHWC GroupNorm with an optional fused SiLU, forward and backward: the
Hopper kernels ``csrc/group_norm.cu`` and their plain PyTorch twins.

Counterpart of ``apex_tpu/ops/group_norm.py`` (``group_norm_reference``,
``_gn_fwd_kernel``, ``_gn_bwd_kernel``, ``_gn_bwd_jnp``,
``group_norm_nhwc``). On ``x`` of shape ``(n, h, w, c)`` in ``g`` groups of
``c / g`` channels, per (sample, group) slab, in fp32 whatever x's dtype:
``mean``, the two-pass variance ``mean((x - mean)^2)``, ``rstd =
rsqrt(var + eps)``; ``y = (x - mean) rstd w + b`` (no affine transform
when ``weight`` is None), then ``y sigmoid(y)`` under ``act="silu"``, in
x's dtype. The backward, from the forward's fp32 ``(n, g)`` mean and rstd,
is ``_gn_bwd_jnp``'s: the SiLU derivative recomputed from ``xhat w + b``,
``dw = sum(d xhat)`` and ``db = sum(d)`` over the samples and rows (in the
weight's dtype), ``dx = rstd (dw_ - sum(dw_)/m - xhat sum(dw_ xhat)/m)``
with ``dw_ = d w`` (x's dtype). fp32, bf16 and fp16.

The reference runs its Pallas kernels only where ``cg % 128 == 0`` and the
slab fits VMEM (``_kernel_eligible``, ``_bwd_kernel_eligible``) and the
two-pass jnp formula elsewhere, which at every Stable Diffusion shape (cg of
10, 20 or 40) is everywhere. Those gates are TPU layout and VMEM budgets:
on the card every shape takes the kernels, with the two-pass variance. At
``cg % 128 == 0`` the reference kernel's one-pass ``E[x^2] - mean^2``
agrees with it within fp32 rounding for data of moderate mean.

``group_norm_nhwc`` is differentiable in x, weight and bias through
``_GroupNormFunction``, which saves x, the weight and bias, and the mean
and rstd. A tensor on the CPU takes the twins; a CUDA tensor always takes
the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import _build


def _check(x: torch.Tensor, weight, bias, num_groups: int,
           act: Optional[str]) -> None:
    if act not in (None, "", "silu"):
        raise ValueError(f"unsupported act {act!r} (reference: silu only)")
    if x.ndim != 4:
        raise ValueError(f"expected NHWC input (n, h, w, c), got "
                         f"{tuple(x.shape)}")
    c = x.shape[-1]
    if num_groups <= 0 or c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups "
                         f"{num_groups}")
    if (weight is None) != (bias is None):
        raise ValueError("weight and bias go together (no affine: both "
                         "None)")
    for label, t in (("weight", weight), ("bias", bias)):
        if t is not None and tuple(t.shape) != (c,):
            raise ValueError(f"{label} of shape {tuple(t.shape)} does not "
                             f"fit {c} channels")


def _slabs(t: torch.Tensor, g: int) -> torch.Tensor:
    n, h, w, c = t.shape
    return t.float().reshape(n, h * w, g, c // g)


def group_norm_fwd_reference(x: torch.Tensor, weight, bias, num_groups: int,
                             eps: float = 1e-5, act: Optional[str] = None):
    """Plain twin of the forward kernel: ``(y, mean, rstd)``, y in x's
    dtype, mean and rstd fp32 ``(n, g)``; y is ``group_norm_reference``'s
    step by step."""
    _check(x, weight, bias, num_groups, act)
    n, h, w, c = x.shape
    x32 = _slabs(x, num_groups)
    mean = x32.mean(dim=(1, 3), keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = ((x32 - mean) * rstd).reshape(n, h, w, c)
    if weight is not None:
        y = y * weight.float() + bias.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    return (y.to(x.dtype), mean.reshape(n, num_groups),
            rstd.reshape(n, num_groups))


def group_norm_reference(x: torch.Tensor, weight, bias, num_groups: int,
                         eps: float = 1e-5, act: Optional[str] = None):
    """Plain GroupNorm (fp32 statistics), the reference's
    ``group_norm_reference``: y in x's dtype."""
    return group_norm_fwd_reference(x, weight, bias, num_groups, eps, act)[0]


def group_norm_bwd_reference(x: torch.Tensor, dy: torch.Tensor, weight,
                             bias, mean: torch.Tensor, rstd: torch.Tensor,
                             num_groups: int, act: Optional[str] = None):
    """Plain twin of the backward kernel, the reference's ``_gn_bwd_jnp``
    given the forward's statistics: ``(dx, dw, db)``, dx in x's dtype, dw
    and db in the weight's and bias's (None without affine)."""
    _check(x, weight, bias, num_groups, act)
    n, h, w, c = x.shape
    g = num_groups
    cg = c // g
    mean = mean.float().reshape(n, 1, g, 1)
    rstd = rstd.float().reshape(n, 1, g, 1)
    xhat = (_slabs(x, g) - mean) * rstd
    dy32 = _slabs(dy, g)
    affine = weight is not None
    if act == "silu":
        wv = weight.float().reshape(1, 1, g, cg) if affine else 1.0
        bv = bias.float().reshape(1, 1, g, cg) if affine else 0.0
        y_pre = xhat * wv + bv
        sig = torch.sigmoid(y_pre)
        dy32 = dy32 * (sig * (1.0 + y_pre * (1.0 - sig)))
    if affine:
        dw = (dy32 * xhat).sum(dim=(0, 1)).reshape(c).to(weight.dtype)
        db = dy32.sum(dim=(0, 1)).reshape(c).to(bias.dtype)
        dyw = dy32 * weight.float().reshape(1, 1, g, cg)
    else:
        dw = db = None
        dyw = dy32
    m = h * w * cg
    sum_dy = dyw.sum(dim=(1, 3), keepdim=True)
    sum_dy_xhat = (dyw * xhat).sum(dim=(1, 3), keepdim=True)
    dx = rstd * (dyw - sum_dy / m - xhat * sum_dy_xhat / m)
    return dx.reshape(n, h, w, c).to(x.dtype), dw, db


def _affine(weight, bias):
    if weight is None:
        return None, None
    return weight.float().contiguous(), bias.float().contiguous()


def group_norm_fwd(x: torch.Tensor, weight, bias, num_groups: int,
                   eps: float = 1e-5, act: Optional[str] = None):
    """``(y, mean, rstd)``: the kernel on a CUDA tensor, the twin on a CPU
    one."""
    if x.device.type == "cpu":
        return group_norm_fwd_reference(x, weight, bias, num_groups, eps, act)
    _check(x, weight, bias, num_groups, act)
    n, h, w_, c = x.shape
    x = x.contiguous()
    w, b = _affine(weight, bias)
    y = torch.empty_like(x)
    mean = torch.empty((n, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    _build.check_cuda(*[t for t in (x, w, b) if t is not None])
    P, I, F = _build.P, _build.I, _build.F
    _build.launch("group_norm_fwd", "apex_group_norm_fwd",
                  (P, P, P, P, P, P, I, I, I, I, F, I, I, P),
                  x.data_ptr(), w.data_ptr() if w is not None else None,
                  b.data_ptr() if b is not None else None, y.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), n, h * w_, c,
                  c // num_groups, float(eps), int(act == "silu"),
                  _build.dtype_code(x, _build.HALF_DTYPES),
                  _build.stream_of(x))
    return y, mean, rstd


def group_norm_bwd(x: torch.Tensor, dy: torch.Tensor, weight, bias,
                   mean: torch.Tensor, rstd: torch.Tensor, num_groups: int,
                   act: Optional[str] = None):
    """``(dx, dw, db)``: the kernel on a CUDA tensor (its per-sample dw and
    db partials summed over the samples here, as the reference sums its
    kernel's outside it), the twin on a CPU one."""
    if x.device.type == "cpu":
        return group_norm_bwd_reference(x, dy, weight, bias, mean, rstd,
                                        num_groups, act)
    _check(x, weight, bias, num_groups, act)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match "
                         f"x {tuple(x.shape)} {x.dtype}")
    n, h, w_, c = x.shape
    x, dy = x.contiguous(), dy.contiguous()
    mean, rstd = mean.float().contiguous(), rstd.float().contiguous()
    w, b = _affine(weight, bias)
    dx = torch.empty_like(x)
    dwp = dbp = None
    if w is not None:
        dwp = torch.empty((n, c), dtype=torch.float32, device=x.device)
        dbp = torch.empty_like(dwp)
    _build.check_cuda(*[t for t in (x, dy, w, b, mean, rstd) if t is not None])

    def ptr(t):
        return t.data_ptr() if t is not None else None

    P, I = _build.P, _build.I
    _build.launch("group_norm_bwd", "apex_group_norm_bwd",
                  (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P),
                  x.data_ptr(), dy.data_ptr(), ptr(w), ptr(b),
                  mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), ptr(dwp),
                  ptr(dbp), n, h * w_, c, c // num_groups,
                  int(act == "silu"),
                  _build.dtype_code(x, _build.HALF_DTYPES),
                  _build.stream_of(x))
    if w is None:
        return dx, None, None
    return dx, dwp.sum(dim=0).to(weight.dtype), dbp.sum(dim=0).to(bias.dtype)


class _GroupNormFunction(torch.autograd.Function):
    """Autograd over the two kernels; saves x, the weight and bias, and the
    forward's mean and rstd."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, act):
        y, mean, rstd = group_norm_fwd(x, weight, bias, num_groups, eps, act)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.num_groups, ctx.act = num_groups, act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dw, db = group_norm_bwd(x, dy.to(x.dtype), weight, bias, mean,
                                    rstd, ctx.num_groups, ctx.act)
        return dx, dw, db, None, None, None


def group_norm_nhwc(x: torch.Tensor, weight: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor], num_groups: int,
                    eps: float = 1e-5, act: Optional[str] = None):
    """GroupNorm over an NHWC ``(n, h, w, c)`` tensor; ``act="silu"`` fuses
    the activation; ``weight``/``bias`` None means no affine transform.
    Differentiable in x, weight and bias."""
    return _GroupNormFunction.apply(x, weight, bias, int(num_groups),
                                    float(eps), act or None)
