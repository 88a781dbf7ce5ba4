"""Shared machinery of the fused optimizers: flat fp32 buffers over the
parameters, and half model copies beside them.

Counterpart of ``apex_tpu/optimizers/common.py::FusedOptimizerBase`` in
PyTorch's idiom. The optimizer takes ``model.named_parameters()`` (any
iterable of ``(name, parameter)`` pairs) and lays them out once in a
flat fp32 ``(rows, LANE)`` master buffer (``ops.flat_buffer``), with flat
gradient and state buffers of the same layout. An fp32 parameter then IS a
view into the master buffer (``p.data``), and its ``.grad`` a view into the
gradient buffer, so autograd accumulates straight into the flat layout and
one kernel launch updates all parameters in place: no copy in or out per
step. A gradient that is not the view (one that existed when the optimizer
was built, or a ``.grad`` replaced since) is copied in, at construction and
at ``step()``; a missing gradient counts as zero, as ``jax.grad`` returns
zeros.

A bf16 or fp16 parameter (amp O2/O3, or given half) is a view into a flat
half buffer of the same layout, its dtype's copy of the master, and its
``.grad`` a view into a flat half gradient buffer: the reference's
``set_output_dtypes`` and ``unflatten(..., dtypes=out_dtypes)``. Each step
casts the half gradients' rows into the fp32 gradient buffer (one
``torch.where`` a half dtype, so the fp32 tensors' rows keep their own
gradients), runs the unchanged kernel over the master, then casts the whole
master into the half buffer (one copy a half dtype; the rows of fp32
tensors there are never read). The half copies therefore equal
``master.to(dtype)`` bit for bit after every step, a skipped one included.

Weight-decay exclusion (apex param groups with decay 0 on biases and norms)
is a predicate over parameter names, turned into a per-tensor 0/1 mask that
each step multiplies by the group's current weight decay.

``amp.initialize`` attaches a loss scaler with :meth:`attach_amp_scaler`;
each step then fuses the reference's unscale and overflow skip
(``apex_tpu/optimizers/common.py:172-205``) on the device: the stats
kernel's non-finite count over the flat gradients raises the skip flag, the
grad scale is divided by the loss scale, and the scaler's state updates,
with no host read. Under model parallelism the ranks first agree on the
skip, as the reference's ``_agree_found_inf_across_model_parallel``: the
found-inf flag is all-reduced with MAX over the tensor-parallel group and
over a distributed context-parallel ring (:func:`agree_found_inf`), so one
rank's overflow skips the step on every rank. The flag stays a device
tensor (under ``gloo`` the library copies it through the host itself).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from apex_tpu_torch import collectives as coll
from apex_tpu_torch.ops import flat_buffer, optim_kernels
from apex_tpu_torch.transformer import parallel_state


#: the dtypes a parameter may have: fp32 (its own master view) or a half
#: type (a view into that type's copy of the master)
MODEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def agree_found_inf(found_inf: torch.Tensor) -> torch.Tensor:
    """``found_inf`` MAX-reduced over every model-parallel group this rank
    is in (the tensor-parallel group, a distributed context-parallel
    ring); the flag itself without model parallelism."""
    if parallel_state.get_tensor_model_parallel_world_size() > 1:
        found_inf = coll.all_reduce(
            found_inf, parallel_state.get_tensor_model_parallel_group(),
            "max")
    ring = parallel_state.get_context_parallel_ring()
    if ring is not None and not ring.local and ring.size > 1:
        found_inf = coll.all_reduce(found_inf, ring.group, "max")
    return found_inf


class HalfCopy(NamedTuple):
    """One half dtype's flat buffers, in the master's layout."""

    params: torch.Tensor   # the model's copies: ``master.to(dtype)``
    grads: torch.Tensor    # their gradients
    rows: torch.Tensor     # bool (rows, 1): the rows of this dtype's tensors


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
            if p.dtype not in MODEL_DTYPES:
                raise TypeError(f"parameter {name} is {p.dtype}: the fused "
                                f"optimizers take fp32, bf16 or fp16 "
                                f"parameters")
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.model_dtypes = [p.dtype for p in self.params]
        self.defaults = dict(defaults)
        self.param_groups = [dict(defaults, params=self.params)]
        self.spec = flat_buffer.build_spec(named)
        device = self.params[0].device
        grads_in = [p.grad for p in self.params]
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
        self._bind()
        with torch.no_grad():
            for view, g in zip(self._grad_views, grads_in):
                if g is not None:
                    view.copy_(g)
        self._amp_scaler = None
        #: set by ``amp.initialize`` when several dynamically scaled losses
        #: share this optimizer: ``step`` then needs the ``noop`` of
        #: ``amp.unscale_and_combine``
        self._amp_require_noop = False

    @torch.no_grad()
    def _bind(self) -> None:
        """Point every parameter at its flat view for its entry of
        ``model_dtypes`` (fp32: the master; a half type: that type's copy,
        made from the master) and its ``.grad`` at the matching gradient
        buffer, which starts as ``self.grads`` in that dtype."""
        seg = self.seg_rows.long()
        self.half = {}
        for dt in dict.fromkeys(self.model_dtypes):
            if dt == torch.float32:
                continue
            of_dt = torch.tensor([d == dt for d in self.model_dtypes],
                                 device=self.master.device)
            self.half[dt] = HalfCopy(self.master.to(dt), self.grads.to(dt),
                                     of_dt[seg][:, None])
        flats = {torch.float32: (self.master, self.grads),
                 **{dt: (h.params, h.grads) for dt, h in self.half.items()}}
        views = {dt: [list(flat_buffer.unflatten(b, self.spec).values())
                      for b in bufs] for dt, bufs in flats.items()}
        self._grad_views = []
        for i, (p, dt) in enumerate(zip(self.params, self.model_dtypes)):
            param_view, grad_view = views[dt][0][i], views[dt][1][i]
            p.grad = None
            p.data = param_view
            p.grad = grad_view
            self._grad_views.append(grad_view)

    def set_output_dtypes(self, dtypes) -> None:
        """Called by ``amp.initialize`` under O2/O3 (the reference's
        ``set_output_dtypes``): parameter ``i`` becomes a view of the master
        in ``dtypes[i]``; the master, the state and the gradients so far
        are kept."""
        dtypes = list(dtypes)
        if len(dtypes) != len(self.params):
            raise ValueError(f"{len(dtypes)} dtypes for "
                             f"{len(self.params)} parameters")
        bad = [d for d in dtypes if d not in MODEL_DTYPES]
        if bad:
            raise TypeError(f"output dtypes {bad}: the fused optimizers "
                            f"take fp32, bf16 or fp16")
        self._gather_grads(repoint=False)   # amp may have cast the params
        self.model_dtypes = dtypes
        self._bind()

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
        for h in self.half.values():
            h.grads.zero_()
        for p, view in zip(self.params, self._grad_views):
            p.grad = view

    @torch.no_grad()
    def _gather_grads(self, repoint: bool = True) -> None:
        """Every ``.grad`` into its flat view (and, with ``repoint``, the
        ``.grad`` pointed at it), then the half gradients' rows cast into
        the fp32 gradient buffer: afterwards ``self.grads`` holds every
        gradient in fp32."""
        for p, view in zip(self.params, self._grad_views):
            if p.grad is None:
                view.zero_()
            elif p.grad.data_ptr() != view.data_ptr():
                view.copy_(p.grad)
            else:
                continue
            if repoint:
                p.grad = view
        for h in self.half.values():
            torch.where(h.rows, h.grads, self.grads, out=self.grads)

    @torch.no_grad()
    def sync_half_params(self) -> None:
        """Each half copy from the master (after a step, a load, or a
        change made to the master in place)."""
        for h in self.half.values():
            h.params.copy_(self.master)

    # -- state dict ------------------------------------------------------
    def state_dict(self) -> dict:
        return {"master": self.master.clone(),
                "state": {k: v.clone() for k, v in self.state.items()},
                "step": self.step_count.clone(),
                "defaults": dict(self.defaults)}

    def load_state_dict(self, sd: dict) -> None:
        self.master.copy_(sd["master"])
        self.sync_half_params()
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
        self.sync_half_params()
        return loss

    def _amp_unscale(self, scaler, grad_scale, noop):
        """The fused amp step's prologue: ``(grad_scale / scale, max(noop,
        found_inf))`` from one stats pass over the flat gradients, and the
        scaler's state updated on ``found_inf``; decided before the step
        count, so a skipped step is not counted."""
        device = self.master.device
        _, finite, _ = optim_kernels.global_grad_norm_and_finite(
            self.grads, self.seg_rows, self.spec.num_tensors)
        found_inf = agree_found_inf(1.0 - finite.float())
        state = scaler.state
        f = optim_kernels.fp32_scalar
        gs = f(1.0 if grad_scale is None else grad_scale, device) / state.scale
        noop = torch.maximum(f(0.0 if noop is None else noop, device),
                             found_inf)
        scaler.state = scaler.update(state, found_inf)
        return gs, noop
