"""apex.amp for the port: opt levels O0-O3 as a dtype policy, half model
copies beside the fp32 master, and the dynamic loss scaler fused into the
optimizer's step.

Counterpart of ``apex_tpu/amp/__init__.py``. ``initialize`` sets the
policy that modules read through ``resolve_compute_dtype`` (the reference's
O1 seam). Under O2 and O3 (or any ``cast_model_type``) it also casts each
module's floating parameters to the policy's parameter dtype in place,
keeping fp32 the norm parameters (O2's ``keep_batchnorm_fp32``; the names
``keep_fp32_predicate`` selects, by default ``is_norm_param_name``), and
tells each fused optimizer its model's dtypes: the optimizer keeps its fp32
master and makes the half parameters views of its half copy of it
(``FusedOptimizerBase.set_output_dtypes``). O3 casts the norms too and
still keeps the optimizer's fp32 master, as the reference. Buffers (the
norms' running statistics) are not cast. It attaches a ``LossScaler`` to
each fused optimizer when the scaler does anything (dynamic, or a static
scale other than 1): the optimizer's step then unscales, skips on a
non-finite gradient and updates the scale on the device.

Typical use:

    model, optimizer = amp.initialize(model, optimizer, opt_level="O2")
    with amp.scale_loss(loss, optimizer) as scaled_loss:
        scaled_loss.backward()
    optimizer.step()      # unscale + overflow skip fused
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from apex_tpu_torch.amp.policy import (NORM_NAME_TOKENS, Policy,
                                       active_state, is_norm_param_name,
                                       make_policy, resolve_compute_dtype,
                                       set_active_state)
from apex_tpu_torch.amp.scaler import LossScaler, ScalerState

__all__ = ["initialize", "scale_loss", "unscale_and_combine", "master_params",
           "current_policy", "loss_scalers", "active_state", "scope",
           "reset", "state_dict", "load_state_dict", "Policy", "make_policy",
           "cast_params",
           "LossScaler", "ScalerState", "NORM_NAME_TOKENS",
           "is_norm_param_name", "resolve_compute_dtype"]


def current_policy() -> Optional[Policy]:
    """The active Policy (modules consult it for compute dtypes)."""
    return active_state()[0]


def loss_scalers() -> tuple:
    """The loss scalers ``initialize`` made, one per loss."""
    return active_state()[1]


def reset() -> None:
    """Turn amp off: no policy and no loss scalers."""
    set_active_state(None)


@contextlib.contextmanager
def scope(state=(None, ())):
    """Context: amp's state set to ``state`` (an ``active_state()``; by
    default amp off) inside, and put back as it was after."""
    saved = active_state()
    set_active_state(*state)
    try:
        yield
    finally:
        set_active_state(*saved)


def _device_of(models):
    for m in models:
        for p in m.parameters():
            return p.device
    return None


@torch.no_grad()
def cast_params(model, policy: Policy, keep_fp32_predicate=None) -> None:
    """Cast ``model``'s floating parameters in place to the policy's
    parameter dtype (their ``.grad`` with them), keeping fp32 those whose
    name ``keep_fp32_predicate`` (by default ``is_norm_param_name``) takes
    while ``keep_norm_fp32`` holds, as the reference's ``cast_params``.
    Buffers are left as they are."""
    keep = keep_fp32_predicate or is_norm_param_name
    for name, p in model.named_parameters():
        if not p.is_floating_point():
            continue
        dt = (torch.float32 if policy.keep_norm_fp32 and keep(name)
              else policy.param_dtype)
        if p.dtype == dt:
            continue
        grad, p.grad = p.grad, None
        p.data = p.data.to(dt)
        if grad is not None:
            p.grad = grad.to(dt)


def initialize(models, optimizers=None, enabled=True, opt_level="O1",
               cast_model_type=None, patch_torch_functions=None,
               keep_batchnorm_fp32=None, master_weights=None, loss_scale=None,
               cast_model_outputs=None, num_losses=1, verbosity=1,
               min_loss_scale=1.0, max_loss_scale=2.0 ** 24,
               half_dtype=torch.bfloat16, keep_fp32_predicate=None,
               hysteresis=1):
    """The reference's ``initialize`` over ``nn.Module``s (one or a list)
    and fused optimizers. Sets the policy; under a half parameter dtype
    casts the models' parameters (``cast_params``) and gives optimizer
    ``i`` the dtypes of model ``min(i, len - 1)``; makes ``num_losses``
    scalers on the models' device, and attaches scaler ``i`` to optimizer
    ``i`` when it is dynamic or its scale is not 1. With several
    dynamically scaled losses on one optimizer no scaler is attached:
    combine the gradients with ``unscale_and_combine`` and pass its
    ``noop`` to ``step`` (the optimizer refuses to step without it).
    Returns the models and optimizers it was given, the models cast in
    place. Torch-only knobs of the reference are accepted and ignored."""
    del patch_torch_functions, cast_model_outputs, verbosity
    if not enabled:
        return models if optimizers is None else (models, optimizers)

    policy = make_policy(opt_level, half_dtype=half_dtype,
                         cast_model_type=cast_model_type,
                         keep_batchnorm_fp32=keep_batchnorm_fp32,
                         master_weights=master_weights, loss_scale=loss_scale)
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if policy.param_dtype != torch.float32:
        for m in model_list:
            cast_params(m, policy, keep_fp32_predicate)
    device = _device_of(model_list)
    scalers = [
        LossScaler(policy.loss_scale, min_loss_scale=min_loss_scale,
                   max_loss_scale=max_loss_scale, hysteresis=hysteresis,
                   device=device)
        for _ in range(num_losses)]
    set_active_state(policy, scalers)
    out_models = model_list[0] if single_model else model_list
    if optimizers is None:
        return out_models

    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    if num_losses > 1 and len(opt_list) not in (1, num_losses):
        raise ValueError("num_losses must be 1 or match the optimizer count")
    multi_loss_dynamic_single_opt = (num_losses > 1 and len(opt_list) == 1
                                     and scalers[0].dynamic)
    for i, opt in enumerate(opt_list):
        scaler = scalers[min(i, num_losses - 1)]
        # a static scale of 1 needs neither an unscale nor a found-inf pass
        if (hasattr(opt, "attach_amp_scaler")
                and not multi_loss_dynamic_single_opt
                and (scaler.dynamic or float(scaler.state.scale) != 1.0)):
            opt.attach_amp_scaler(scaler)
        # assigned every time, so that a re-initialize clears a stale flag
        opt._amp_require_noop = multi_loss_dynamic_single_opt
        if (hasattr(opt, "set_output_dtypes")
                and policy.param_dtype != torch.float32):
            dtypes = {id(p): p.dtype for p in
                      model_list[min(i, len(model_list) - 1)].parameters()}
            opt.set_output_dtypes([dtypes.get(id(p), p.dtype)
                                   for p in opt.params])
    return out_models, (opt_list[0] if single_opt else opt_list)


@contextlib.contextmanager
def scale_loss(loss, optimizers=None, loss_id=0, model=None,
               delay_unscale=False, delay_overflow_check=False):
    """The reference's ``scale_loss``: yields ``loss * scale``; the unscale
    and the overflow skip are fused into ``optimizer.step``."""
    scalers = loss_scalers()
    if not scalers:
        yield loss
        return
    yield scalers[loss_id].scale_loss(loss)


def unscale_and_combine(grads_list, loss_ids=None):
    """Combine per-loss scaled gradients for ONE optimizer: each loss's
    ``{name: gradient}`` is unscaled by its own scaler, the unscaled
    gradients summed, and the skip flag is the union of the losses'
    overflows; each scaler updates on its own overflow. Returns ``(grads,
    noop)``: write the grads into ``.grad`` and call
    ``optimizer.step(noop=noop)``."""
    ids = tuple(loss_ids) if loss_ids is not None else tuple(
        range(len(grads_list)))
    if len(ids) != len(grads_list):
        raise ValueError("loss_ids must match grads_list length")
    if not loss_scalers():
        return ({k: sum(g[k] for g in grads_list) for k in grads_list[0]},
                torch.zeros((), dtype=torch.float32))
    scalers = [loss_scalers()[i] for i in ids]
    if not any(s.dynamic for s in scalers):
        raise RuntimeError(
            "unscale_and_combine is for dynamically-scaled multi-loss "
            "training; with a static loss_scale the unscale is fused into "
            "optimizer.step, so sum the raw scaled grads and call step "
            "directly")
    total, noop = None, None
    for g, sc in zip(grads_list, scalers):
        state = sc.state
        nonfinite = sum((~torch.isfinite(t.float())).sum() for t in g.values())
        found = (nonfinite > 0).float().to(state.scale.device)
        inv = 1.0 / state.scale
        g_un = {k: t * inv.to(device=t.device, dtype=t.dtype)
                for k, t in g.items()}
        total = g_un if total is None else {k: total[k] + g_un[k]
                                            for k in total}
        noop = found if noop is None else torch.maximum(noop, found)
        sc.state = sc.update(state, found)
    return total, noop


def master_params(optimizer):
    """The fp32 master parameters of a fused optimizer, ``{name: view}``."""
    from apex_tpu_torch.ops import flat_buffer

    return flat_buffer.unflatten(optimizer.master, optimizer.spec)


def state_dict(destination=None):
    """The loss scalers' state, as the reference's."""
    return {f"loss_scaler{i}": s.state_dict()
            for i, s in enumerate(loss_scalers())}


def load_state_dict(sd):
    for i, s in enumerate(loss_scalers()):
        key = f"loss_scaler{i}"
        if key in sd:
            s.load_state_dict(sd[key])
