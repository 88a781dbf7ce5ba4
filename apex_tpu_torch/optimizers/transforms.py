"""Optax-style pure transforms over the fused optimizer kernels.

Counterpart of ``apex_tpu/optimizers/transforms.py``: ``tx =
fused_adam(1e-3); state = tx.init(params); deltas, state =
tx.update(grads, state, params)`` over ``{name: tensor}`` dicts. Each
update lays the gradients and the parameters out in the flat ``(rows,
LANE)`` buffer (``ops.flat_buffer``, in the dict's order), runs the
one-launch kernel (``ops.optim_kernels``: the kernel on a CUDA tensor, its
twin on a CPU one) and returns the deltas ``new - old`` as ``{name:
tensor}`` in the gradients' dtypes. The moments stay flat between steps.
The transforms are pure: the state handed in is not written (the kernels
update copies of it in place).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from apex_tpu_torch.ops import flat_buffer, optim_kernels
from apex_tpu_torch.ops.flat_buffer import LANE

__all__ = ["FlatOptState", "GradientTransformation", "fused_adam",
           "fused_lamb", "fused_sgd", "fused_novograd"]


class FlatOptState(NamedTuple):
    count: torch.Tensor   # int32 0-d: steps taken
    m: torch.Tensor       # (rows, LANE)
    v: torch.Tensor       # (rows, LANE) Adam/LAMB; (num_tensors,) NovoGrad;
    #                       () SGD


class GradientTransformation(NamedTuple):
    """optax's pair: ``init(params) -> state`` and ``update(grads, state,
    params) -> (deltas, state)``."""

    init: Callable
    update: Callable


Tree = Dict[str, torch.Tensor]


def _init(params: Tree, v_shape) -> FlatOptState:
    spec = flat_buffer.build_spec(params.items())
    device = next(iter(params.values())).device
    z = torch.zeros(spec.total_rows, LANE, dtype=torch.float32, device=device)
    v = torch.zeros(v_shape(spec), dtype=torch.float32, device=device)
    return FlatOptState(count=torch.zeros((), dtype=torch.int32,
                                          device=device), m=z, v=v)


def _flat(updates: Tree, params, name: str):
    """``(spec, g, p, p_old)``: the layout of ``updates``, the flat fp32
    gradients, the flat parameters (updated in place by the kernel) and a
    copy of them."""
    if params is None:
        raise ValueError(f"{name} requires params")
    spec = flat_buffer.build_spec(updates.items())
    g = flat_buffer.flatten(updates.items(), spec)
    p = flat_buffer.flatten(((k, params[k]) for k in updates), spec)
    return spec, g, p, p.clone()


def _deltas(p, p_old, spec, updates: Tree) -> Tree:
    flat = flat_buffer.unflatten(p - p_old, spec)
    return {k: d.to(updates[k].dtype) for k, d in flat.items()}


def _lr(learning_rate, count):
    return learning_rate(count) if callable(learning_rate) else learning_rate


def _flat_v(spec):
    return (spec.total_rows, LANE)


def fused_adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
               adam_w_mode=True, bias_correction=True
               ) -> GradientTransformation:
    def init_fn(params):
        return _init(params, _flat_v)

    def update_fn(updates, state, params=None):
        spec, g, p, p_old = _flat(updates, params, "fused_adam")
        count = state.count + 1
        m, v = state.m.clone(), state.v.clone()
        optim_kernels.adam_update(
            g, p, m, v, beta1=b1, beta2=b2, eps=eps,
            weight_decay=weight_decay, lr=_lr(learning_rate, count),
            step=count, adam_w_mode=adam_w_mode,
            bias_correction=bias_correction)
        return (_deltas(p, p_old, spec, updates),
                FlatOptState(count=count, m=m, v=v))

    return GradientTransformation(init_fn, update_fn)


def fused_lamb(learning_rate, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01,
               max_grad_norm=1.0, grad_averaging=True, bias_correction=True
               ) -> GradientTransformation:
    """LAMB with the global-norm clip (``max_grad_norm / norm`` where the
    norm exceeds it) and a skip on a non-finite gradient, both decided on
    the device from one stats pass; the count advances on a skip, as the
    reference's."""
    def init_fn(params):
        return _init(params, _flat_v)

    def update_fn(updates, state, params=None):
        spec, g, p, p_old = _flat(updates, params, "fused_lamb")
        seg, n = spec.segment_rows().to(p.device), spec.num_tensors
        count = state.count + 1
        gnorm, finite, _ = optim_kernels.global_grad_norm_and_finite(
            g, seg, n)
        clip = (torch.where(gnorm > max_grad_norm, max_grad_norm / gnorm,
                            1.0) if max_grad_norm > 0.0
                else torch.ones_like(gnorm))
        m, v = state.m.clone(), state.v.clone()
        optim_kernels.lamb_update(
            g, p, m, v, seg, n, beta1=b1, beta2=b2, eps=eps,
            weight_decay=weight_decay, lr=_lr(learning_rate, count),
            step=count, grad_scale=clip, noop=1.0 - finite.float(),
            bias_correction=bias_correction, grad_averaging=grad_averaging)
        return (_deltas(p, p_old, spec, updates),
                FlatOptState(count=count, m=m, v=v))

    return GradientTransformation(init_fn, update_fn)


def fused_sgd(learning_rate, momentum=0.0, dampening=0.0, weight_decay=0.0,
              nesterov=False) -> GradientTransformation:
    """SGD; as the reference's transform, no first-step rule (the
    momentum buffer starts at zero and takes the dampening at step 1)."""
    def init_fn(params):
        return _init(params, lambda spec: ())

    def update_fn(updates, state, params=None):
        spec, g, p, p_old = _flat(updates, params, "fused_sgd")
        count = state.count + 1
        m = state.m.clone()
        optim_kernels.sgd_update(
            g, p, m, lr=_lr(learning_rate, count), momentum=momentum,
            dampening=dampening, weight_decay=weight_decay,
            nesterov=nesterov)
        return (_deltas(p, p_old, spec, updates),
                FlatOptState(count=count, m=m, v=state.v))

    return GradientTransformation(init_fn, update_fn)


def fused_novograd(learning_rate, b1=0.95, b2=0.98, eps=1e-8,
                   weight_decay=0.0, grad_averaging=True
                   ) -> GradientTransformation:
    def init_fn(params):
        return _init(params, lambda spec: (spec.num_tensors,))

    def update_fn(updates, state, params=None):
        spec, g, p, p_old = _flat(updates, params, "fused_novograd")
        seg, n = spec.segment_rows().to(p.device), spec.num_tensors
        count = state.count + 1
        m, v = state.m.clone(), state.v.clone()
        optim_kernels.novograd_update(
            g, p, m, v, seg, n, beta1=b1, beta2=b2, eps=eps,
            weight_decay=weight_decay, lr=_lr(learning_rate, count),
            step=count, grad_averaging=grad_averaging)
        return (_deltas(p, p_old, spec, updates),
                FlatOptState(count=count, m=m, v=v))

    return GradientTransformation(init_fn, update_fn)
