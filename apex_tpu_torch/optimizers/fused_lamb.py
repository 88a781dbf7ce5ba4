"""FusedLAMB: LAMB over the flat buffers, three kernel launches per step
(the gradient-norm pass, then the two LAMB phases).

Counterpart of ``apex_tpu/optimizers/fused_lamb.py::FusedLAMB``, with the
reference's constructor knobs (lr, bias_correction, betas, eps,
weight_decay, grad_averaging, max_grad_norm, use_nvlamb; amsgrad and
``adam_w_mode=False`` raise there too) and its ``exclude_from_weight_decay``
name predicate. Each step, on the device and with no host read: the global
gradient norm times the grad scale from one stats pass, the clip factor
``max_grad_norm / norm`` when the norm exceeds it, and the skip flag raised
when a gradient is inf or NaN. As in the reference, that automatic skip
happens inside the update, after ``step()`` has counted the step, so a step
that skips itself still counts (only an explicit ``noop`` does not).
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import optim_kernels
from apex_tpu_torch.optimizers.common import FusedOptimizerBase


class FusedLAMB(FusedOptimizerBase):
    STATE_BUFFERS = ("m", "v")

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 set_grad_none=True, max_grad_norm=1.0, use_nvlamb=False,
                 exclude_from_weight_decay=None):
        del set_grad_none            # gradients are flat-buffer views
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")
        if not adam_w_mode:
            raise NotImplementedError("FusedLAMB: only adam_w_mode=True is "
                                      "implemented (reference default).")
        defaults = dict(lr=lr, beta1=betas[0], beta2=betas[1], eps=eps,
                        weight_decay=weight_decay,
                        max_grad_norm=max_grad_norm)
        self.bias_correction = bias_correction
        self.grad_averaging = grad_averaging
        self.use_nvlamb = use_nvlamb
        super().__init__(params, defaults,
                         exclude_from_weight_decay=exclude_from_weight_decay)

    def _update(self, grad_scale, noop) -> None:
        hp = self.param_groups[0]
        device = self.master.device
        n = self.spec.num_tensors
        gnorm, finite, _ = optim_kernels.global_grad_norm_and_finite(
            self.grads, self.seg_rows, n)
        gs = torch.as_tensor(1.0 if grad_scale is None else grad_scale,
                             dtype=torch.float32, device=device)
        gnorm = gnorm * gs
        max_norm = float(hp["max_grad_norm"])
        clip = (torch.where(gnorm > max_norm, max_norm / gnorm, 1.0)
                if max_norm > 0.0 else torch.ones_like(gnorm))
        noop = torch.as_tensor(0.0 if noop is None else noop,
                               dtype=torch.float32, device=device)
        noop = torch.maximum(noop, 1.0 - finite.float())
        wd = self.wd_per_segment
        if wd is None:
            wd = hp["weight_decay"]
        optim_kernels.lamb_update(
            self.grads, self.master, self.state["m"], self.state["v"],
            self.seg_rows, n, beta1=hp["beta1"], beta2=hp["beta2"],
            eps=hp["eps"], weight_decay=wd, lr=hp["lr"],
            step=self.step_count, grad_scale=gs * clip, noop=noop,
            bias_correction=self.bias_correction,
            grad_averaging=self.grad_averaging, use_nvlamb=self.use_nvlamb)
