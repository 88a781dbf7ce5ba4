"""Shared machinery of the fused optimizers: flat fp32 buffers over the
parameters.

Counterpart of ``apex_tpu/optimizers/common.py::FusedOptimizerBase`` in
PyTorch's idiom. The optimizer takes ``model.named_parameters()`` (any
iterable of ``(name, parameter)`` pairs) and lays them out once in a
flat fp32 ``(rows, LANE)`` master buffer (``ops.flat_buffer``), with flat
gradient and state buffers of the same layout. Every parameter then IS a
view into the master buffer (``p.data``), and its ``.grad`` a view into the
gradient buffer, so autograd accumulates straight into the flat layout and
one kernel launch updates all parameters in place: no copy in or out per
step. A gradient that is not the view (one that existed when the optimizer
was built, or a ``.grad`` replaced since) is copied in, at construction and
at ``step()``; a missing gradient counts as zero, as ``jax.grad`` returns
zeros. Parameters must be fp32: the master copy is the
parameter itself.

Weight-decay exclusion (apex param groups with decay 0 on biases and norms)
is a predicate over parameter names, turned into a per-tensor 0/1 mask that
each step multiplies by the group's current weight decay.

``amp.initialize`` attaches a loss scaler with :meth:`attach_amp_scaler`;
each step then fuses the reference's unscale and overflow skip
(``apex_tpu/optimizers/common.py:172-205``) on the device: the stats
kernel's non-finite count over the flat gradients raises the skip flag, the
grad scale is divided by the loss scale, and the scaler's state updates,
with no host read. The model-parallel agreement on the skip waits for
tensor parallelism (ROADMAP queue A item 10).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch.ops import flat_buffer, optim_kernels


class FusedOptimizerBase:
    """Flat-buffer state for FusedAdam, FusedLAMB, FusedSGD and
    FusedNovoGrad."""

    #: names of flat (rows, LANE) fp32 state buffers, e.g. ("m", "v")
    STATE_BUFFERS: tuple = ()

    def __init__(self, params, defaults: dict,
                 exclude_from_weight_decay: Optional[Callable[[str], bool]]
                 = None):
        named = list(params)
        if not named:
            raise ValueError("optimizer got an empty parameter list")
        for name, p in named:
            if p.dtype != torch.float32:
                raise TypeError(f"parameter {name} is {p.dtype}: the fused "
                                f"optimizers keep fp32 parameters as their "
                                f"own master copy")
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.defaults = dict(defaults)
        self.param_groups = [dict(defaults, params=self.params)]
        self.spec = flat_buffer.build_spec(named)
        device = self.params[0].device
        with torch.no_grad():
            self.master = flat_buffer.flatten(named, self.spec)
        self.grads = torch.zeros_like(self.master)
        self.state = {name: torch.zeros_like(self.master)
                      for name in self.STATE_BUFFERS}
        self.seg_rows = self.spec.segment_rows().to(device)
        self.step_count = torch.zeros((), dtype=torch.int32, device=device)
        # 1 where a tensor takes weight decay, 0 where it is excluded
        self.decay_mask = None
        if exclude_from_weight_decay is not None:
            self.decay_mask = torch.tensor(
                [0.0 if exclude_from_weight_decay(n) else 1.0
                 for n in self.names], dtype=torch.float32, device=device)
        self._grad_views = list(
            flat_buffer.unflatten(self.grads, self.spec).values())
        for p, view in zip(self.params,
                           flat_buffer.unflatten(self.master,
                                                 self.spec).values()):
            p.data = view
        self._gather_grads()
        self._amp_scaler = None
        #: set by ``amp.initialize`` when several dynamically scaled losses
        #: share this optimizer: ``step`` then needs the ``noop`` of
        #: ``amp.unscale_and_combine``
        self._amp_require_noop = False

    @property
    def wd_per_segment(self) -> Optional[torch.Tensor]:
        """The per-tensor decay vector, from ``param_groups[0]``'s current
        ``"weight_decay"`` (a scheduler or ``load_state_dict`` may change
        it), or None when no tensor is excluded from decay."""
        if self.decay_mask is None:
            return None
        return self.decay_mask * float(self.param_groups[0]["weight_decay"])

    def attach_amp_scaler(self, scaler) -> None:
        """Called by ``amp.initialize``: every step then unscales by
        ``scaler``'s loss scale, skips on a non-finite gradient and updates
        the scaler, all on the device."""
        self._amp_scaler = scaler

    def zero_grad(self, set_to_none: bool = False) -> None:
        """Zero the flat gradient buffer and point every ``.grad`` at its
        view again. ``set_to_none`` is accepted for the torch signature; the
        gradients stay views into the flat buffer either way."""
        del set_to_none
        self.grads.zero_()
        for p, view in zip(self.params, self._grad_views):
            p.grad = view

    def _gather_grads(self) -> None:
        for p, view in zip(self.params, self._grad_views):
            if p.grad is None:
                view.zero_()
            elif p.grad.data_ptr() != view.data_ptr():
                view.copy_(p.grad)
            else:
                continue
            p.grad = view

    # -- state dict ------------------------------------------------------
    def state_dict(self) -> dict:
        return {"master": self.master.clone(),
                "state": {k: v.clone() for k, v in self.state.items()},
                "step": self.step_count.clone(),
                "defaults": dict(self.defaults)}

    def load_state_dict(self, sd: dict) -> None:
        self.master.copy_(sd["master"])
        for k, v in sd["state"].items():
            self.state[k].copy_(v)
        self.step_count.copy_(sd["step"])
        self.defaults.update(sd.get("defaults", {}))
        self.param_groups[0].update(sd.get("defaults", {}))

    # -- stepping --------------------------------------------------------
    def _update(self, grad_scale, noop) -> None:
        """Update ``self.master`` and ``self.state`` in place from
        ``self.grads`` with the hyper-parameters of ``param_groups[0]`` (a
        scheduler may set its ``"lr"``); implemented by each optimizer with
        its kernel."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None, grad_scale=None, noop=None):
        """One step from the parameters' ``.grad``. ``grad_scale``
        multiplies the gradients inside the kernel; ``noop`` (0/1, a number
        or a device tensor) skips the step, leaving parameters and state
        bit-identical and the step count where it was (the reference skips
        the step entirely, so bias correction sees only applied steps). A
        skip that an optimizer decides inside ``_update`` (LAMB's on a
        non-finite gradient) comes after the count, as in the
        reference."""
        if self._amp_require_noop and noop is None:
            raise RuntimeError(
                "this optimizer was initialized by amp with multiple "
                "dynamically-scaled losses: combine grads with "
                "amp.unscale_and_combine and call step(noop=noop)")
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._gather_grads()
        scaler = self._amp_scaler
        if scaler is not None:
            grad_scale, noop = self._amp_unscale(scaler, grad_scale, noop)
        if noop is None:
            self.step_count += 1
        else:
            noop = optim_kernels.fp32_scalar(noop, self.master.device)
            self.step_count += (noop <= 0.0).to(self.step_count.dtype)
        self._update(grad_scale, noop)
        return loss

    def _amp_unscale(self, scaler, grad_scale, noop):
        """The fused amp step's prologue: ``(grad_scale / scale, max(noop,
        found_inf))`` from one stats pass over the flat gradients, and the
        scaler's state updated on ``found_inf``; decided before the step
        count, so a skipped step is not counted."""
        device = self.master.device
        _, finite, _ = optim_kernels.global_grad_norm_and_finite(
            self.grads, self.seg_rows, self.spec.num_tensors)
        found_inf = 1.0 - finite.float()
        state = scaler.state
        f = optim_kernels.fp32_scalar
        gs = f(1.0 if grad_scale is None else grad_scale, device) / state.scale
        noop = torch.maximum(f(0.0 if noop is None else noop, device),
                             found_inf)
        scaler.state = scaler.update(state, found_inf)
        return gs, noop
