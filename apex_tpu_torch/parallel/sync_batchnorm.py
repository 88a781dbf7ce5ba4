"""SyncBatchNorm: batch normalization with the statistics of the whole
data-parallel batch.

Counterpart of ``apex_tpu/parallel/sync_batchnorm.py``. The statistics are
the reference's formula, not ``F.batch_norm``'s Welford: fp32 sums of x
and x^2 over every dimension but the channel, ``mean = s / n`` and ``var =
ss / n - mean^2``; ``y = (x - mean) rsqrt(var + eps) w + b`` in fp32, cast
to x's dtype (the compute dtype an amp policy set upstream). Running
statistics follow torch: momentum 0.1, the unbiased variance
``var n / (n - 1)``; eval mode normalizes with them.

The reference sums across the data axis when one is bound and takes local
statistics otherwise. Here the statistics are summed over the module's
``process_group`` (else the installed data-parallel group, else the
default world, ``parallel.distributed.data_parallel_group``): the forward
all-reduces the fp32 ``(sum x, sum x^2, n)`` in one call, and the backward
all-reduces ``(sum dy, sum dy * (x - mean))``, the cross-rank terms that
autodiff through the reference's ``psum`` implies, so that ``dx`` is the
derivative of every rank's loss; the weight and bias gradients stay local,
for DDP to average. With no ``torch.distributed``, or a group of one rank,
the statistics are local, as the reference's with no axis bound.

The layout is torch's NCHW (channel axis 1; any memory format). Training
mode runs through an autograd Function that keeps only x (in its own
dtype) and the per-channel mean and rstd for the backward, which is the
closed-form derivative of the same formula: autograd through the fp32
intermediates would keep several fp32 copies of every activation. On the
CPU the normalization and its derivative are plain fp32 tensor ops. On the
card the statistics are the same fp32 sums: Σx read straight from x, and
Σx² the reference's fp32 sum of the fp32 products ``x32 * x32`` (formed
by ``torch.addcmul`` from x in its own dtype, one fp32 tensor; the square
of ``vector_norm`` was further from the fp64 sum, ROADMAP C1). The
normalization and its backward are torch's fused CUDA batch-norm
elementwise and reduction ops (those ``torch.nn.SyncBatchNorm`` runs),
fp32 inside.
"""

from __future__ import annotations

import torch
from torch import nn

from apex_tpu_torch import collectives as coll
from apex_tpu_torch.parallel.distributed import data_parallel_group


def channel_sums(x):
    """``(s, ss)``: fp32 sums of x and of x^2 over every dimension of an
    NCHW (or NC...) tensor but 1, ``ss`` the reference's fp32 sum of
    ``x32 * x32``."""
    dims = [d for d in range(x.ndim) if d != 1]
    if x.is_cuda:
        s = x.sum(dims, dtype=torch.float32)
        # the fp32 products x32 * x32 formed from x in its own dtype; the
        # zero has x's rank, as a 0-d tensor would not promote x to fp32
        zero = torch.zeros([1] * x.ndim, dtype=torch.float32,
                           device=x.device)
        ss = torch.addcmul(zero, x, x).sum(dims)
    else:
        x32 = x.float()
        s = x32.sum(dims)
        ss = (x32 * x32).sum(dims)
    return s, ss


def sync_batch_norm_stats(x, process_group=None):
    """``(mean, var, n)`` per channel of an NCHW (or NC...) tensor: fp32
    sums of x and x^2 over every dimension but 1 and over the ranks of
    ``process_group`` (one all-reduce of ``[s | ss | n]``), ``var = E[x^2]
    - mean^2``; ``n`` the count, a number on one rank and a ``(1,)`` fp32
    device tensor (the sum over the ranks, no host read) across ranks."""
    n = x.numel() // x.shape[1]
    s, ss = channel_sums(x)
    if coll.world_size(process_group) > 1:
        c = s.shape[0]
        packed = torch.cat([s, ss, torch.full((1,), float(n),
                                              device=s.device)])
        packed = coll.all_reduce(packed, process_group)
        s, ss, n = packed[:c], packed[c:2 * c], packed[2 * c:]
    mean = s / n
    return mean, ss / n - mean * mean, n


def _channel(t, ndim):
    return t.reshape([1, -1] + [1] * (ndim - 2))


def _memory_format(x):
    return (torch.channels_last if x.ndim == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


class _SyncBatchNormFunction(torch.autograd.Function):
    """Normalize and affine with the given statistics, fp32 inside; the
    output in x's dtype. Saves x, w, mean and rstd."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps, n, group):
        ctx.n, ctx.group = n, group
        rstd = torch.rsqrt(var + eps)
        if x.is_cuda:
            y = torch.batch_norm_elemt(x, weight, bias, mean, rstd, eps)
        else:
            nd = x.ndim
            y = (x.float() - _channel(mean, nd)) * _channel(rstd, nd)
            if weight is not None:
                y = y * _channel(weight, nd) + _channel(bias, nd)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        nd = x.ndim
        n, group = ctx.n, ctx.group
        affine = weight is not None
        across = coll.world_size(group) > 1
        if x.is_cuda:
            dy = dy.contiguous(memory_format=_memory_format(x))
            sum_dy, sum_dy_xmu, dw, db = torch.batch_norm_backward_reduce(
                dy, x, mean, rstd, weight, True, affine, affine)
            if across:
                c = sum_dy.shape[0]
                both = coll.all_reduce(torch.cat([sum_dy, sum_dy_xmu]),
                                       group)
                sum_dy, sum_dy_xmu = both[:c], both[c:]
            count = (n.to(torch.int32) if torch.is_tensor(n)
                     else torch.full((1,), n, dtype=torch.int32,
                                     device=x.device))
            dx = torch.batch_norm_backward_elemt(dy, x, mean, rstd, weight,
                                                 sum_dy, sum_dy_xmu, count)
            return dx, dw, db, None, None, None, None, None
        dims = [d for d in range(nd) if d != 1]
        xhat = (x.float() - _channel(mean, nd)) * _channel(rstd, nd)
        dy32 = dy.float()
        db = dy32.sum(dims)
        dw = (dy32 * xhat).sum(dims)
        sum_dy, sum_dy_xhat = db, dw
        if across:
            c = db.shape[0]
            both = coll.all_reduce(torch.cat([db, dw]), group)
            sum_dy, sum_dy_xhat = both[:c], both[c:]
        w = weight if affine else torch.ones_like(mean)
        # d/dx of (x - mean) rsqrt(E[x^2] - mean^2 + eps) w + b, the sums
        # and the count over every rank
        dx = (dy32 - _channel(sum_dy / n, nd)
              - xhat * _channel(sum_dy_xhat / n, nd)) \
            * _channel(w * rstd, nd)
        grads_wb = (dw, db) if affine else (None, None)
        return (dx.to(x.dtype), *grads_wb, None, None, None, None, None)


class SyncBatchNorm(nn.Module):
    """Drop-in for ``apex.parallel.SyncBatchNorm`` over NCHW tensors:
    torch's BatchNorm arguments plus ``process_group`` (None: the installed
    data-parallel group, else the default world, read at each forward);
    the output in x's dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True, process_group=None,
                 device=None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.process_group = process_group
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features,
                                                  device=device))
            self.bias = nn.Parameter(torch.zeros(num_features,
                                                 device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        if track_running_stats:
            self.register_buffer("running_mean",
                                 torch.zeros(num_features, device=device))
            self.register_buffer("running_var",
                                 torch.ones(num_features, device=device))
        else:
            self.running_mean = self.running_var = None

    def forward(self, x):
        if x.shape[1] != self.num_features:
            raise ValueError(f"channel axis 1 of input shape "
                             f"{tuple(x.shape)} != num_features "
                             f"{self.num_features}")
        if self.training or self.running_mean is None:
            group = data_parallel_group(self.process_group)
            mean, var, n = sync_batch_norm_stats(x.detach(), group)
            if self.training and self.track_running_stats:
                with torch.no_grad():
                    m = self.momentum
                    unbiased = var * (n / (n - 1.0).clamp(min=1.0)
                                      if torch.is_tensor(n)
                                      else n / max(n - 1.0, 1.0))
                    self.running_mean.mul_(1 - m).add_(m * mean)
                    self.running_var.mul_(1 - m).add_(m * unbiased)
            return _SyncBatchNormFunction.apply(x, self.weight, self.bias,
                                                mean, var, self.eps, n,
                                                group)
        # eval: the running statistics are constants, plain autograd
        rstd = torch.rsqrt(self.running_var + self.eps)
        y = (x.float() - _channel(self.running_mean, x.ndim)) \
            * _channel(rstd, x.ndim)
        if self.weight is not None:
            y = y * _channel(self.weight, x.ndim) + _channel(self.bias,
                                                             x.ndim)
        return y.to(x.dtype)


def convert_syncbn_model(module: nn.Module, process_group=None) -> nn.Module:
    """Replace every ``nn.BatchNorm{1,2,3}d`` under ``module`` (walking
    ``named_children()``, as the reference) with a ``SyncBatchNorm`` that
    carries its arguments, parameters and running statistics, over
    ``process_group`` (None: the installed data-parallel group, else the
    default world). Returns the module (a BatchNorm itself comes back
    replaced)."""
    process_group = data_parallel_group(process_group)
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        sbn = SyncBatchNorm(module.num_features, eps=module.eps,
                            momentum=(0.1 if module.momentum is None
                                      else module.momentum),
                            affine=module.affine,
                            track_running_stats=module.track_running_stats,
                            process_group=process_group,
                            device=(module.weight.device if module.affine
                                    else None))
        with torch.no_grad():
            if module.affine:
                sbn.weight.copy_(module.weight)
                sbn.bias.copy_(module.bias)
            if module.track_running_stats:
                sbn.running_mean = module.running_mean.clone()
                sbn.running_var = module.running_var.clone()
        sbn.train(module.training)
        return sbn
    for name, child in module.named_children():
        new = convert_syncbn_model(child, process_group)
        if new is not child:
            setattr(module, name, new)
    return module
