"""Tensor- and sequence-parallel regions as autograd Functions.

Counterpart of ``apex_tpu/transformer/tensor_parallel/mappings.py``, whose
``custom_vjp`` pairs restate the reference's autograd Functions: each
region's forward and backward issue one collective over the
tensor-parallel group (``parallel_state.get_tensor_model_parallel_group``,
or the ``group`` given). Model-parallel regions act on the LAST dim
(hidden), sequence-parallel regions on the FIRST (sequence).

============================================  ==============  ==============
region                                        forward         backward
============================================  ==============  ==============
``copy_to_tensor_model_parallel_region``      identity        all-reduce
``reduce_from_tensor_model_parallel_region``  all-reduce      identity
``scatter_to_tensor_model_parallel_region``   split (last)    all-gather
``gather_from_tensor_model_parallel_region``  all-gather      split (last)
``scatter_to_sequence_parallel_region``       split (first)   all-gather
``gather_from_sequence_parallel_region``      all-gather      reduce-scatter
                                                              (or split)
``reduce_scatter_to_sequence_parallel_region`` reduce-scatter  all-gather
============================================  ==============  ==============

``reduce_from``'s backward is the identity: every rank seeds its own copy
of the (replicated) loss, so summing the cotangents again would inflate
every gradient upstream by the group size per region crossed (the
reference's docstring measured 4x/16x/64x at tp = 4). On a group of one
rank every region is the identity.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import collectives as coll
from apex_tpu_torch.transformer import parallel_state


def _group(group):
    return (group if group is not None
            else parallel_state.get_tensor_model_parallel_group())


def _split(x, group, dim):
    """This rank's block of ``x`` along ``dim`` (contiguous)."""
    n = coll.world_size(group)
    if n == 1:
        return x
    chunk = x.shape[dim] // n
    return x.narrow(dim, coll.rank(group) * chunk, chunk).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return coll.all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return coll.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    """Split along ``dim`` / all-gather (``dim`` -1: the model regions, 0:
    the sequence regions)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _split(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return coll.all_gather(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` / split, or reduce-scatter under
    ``reduce_grad`` (a sequence-parallel gather feeding a tensor-parallel
    linear)."""

    @staticmethod
    def forward(ctx, x, group, dim, reduce_grad):
        ctx.group, ctx.dim, ctx.reduce_grad = group, dim, reduce_grad
        return coll.all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            return coll.reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        return _split(g, ctx.group, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return coll.reduce_scatter(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        return coll.all_gather(g, ctx.group, 0), None


def copy_to_tensor_model_parallel_region(x, group=None):
    return _Copy.apply(x, _group(group))


def reduce_from_tensor_model_parallel_region(x, group=None):
    return _Reduce.apply(x, _group(group))


def scatter_to_tensor_model_parallel_region(x, group=None):
    return _Scatter.apply(x, _group(group), -1)


def gather_from_tensor_model_parallel_region(x, group=None):
    return _Gather.apply(x, _group(group), -1, False)


def scatter_to_sequence_parallel_region(x, group=None):
    return _Scatter.apply(x, _group(group), 0)


def gather_from_sequence_parallel_region(x, group=None,
                                         tensor_parallel_output_grad=True):
    """All-gather the sequence shards at a tensor-parallel region's entry;
    the backward reduce-scatters when the consumer is a tensor-parallel
    linear (``tensor_parallel_output_grad``), else splits."""
    return _Gather.apply(x, _group(group), 0, tensor_parallel_output_grad)


def reduce_scatter_to_sequence_parallel_region(x, group=None):
    return _ReduceScatter.apply(x, _group(group))
