"""FusedNovoGrad: NovoGrad over the flat buffers, two kernel launches per
step (the per-tensor gradient norms, then the update).

Counterpart of ``apex_tpu/optimizers/fused_novograd.py::FusedNovoGrad``,
with the reference's constructor (amsgrad and ``norm_type != 2`` raise
there too; ``bias_correction`` and ``reg_inside_moment`` are accepted and
not read, as in the reference). The second moment is one float per tensor,
``state["v_per_tensor"]``, kept in ``state_dict``.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import optim_kernels
from apex_tpu_torch.optimizers.common import FusedOptimizerBase


class FusedNovoGrad(FusedOptimizerBase):
    STATE_BUFFERS = ("m",)

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.95, 0.98), eps=1e-8, weight_decay=0.0,
                 amsgrad=False, reg_inside_moment=False, grad_averaging=True,
                 norm_type=2, init_zero=False, set_grad_none=True):
        del bias_correction, reg_inside_moment, set_grad_none
        if amsgrad:
            raise RuntimeError("FusedNovoGrad does not support the AMSGrad "
                               "variant.")
        if norm_type != 2:
            raise ValueError("FusedNovoGrad only supports norm_type=2")
        defaults = dict(lr=lr, beta1=betas[0], beta2=betas[1], eps=eps,
                        weight_decay=weight_decay)
        self.init_zero = init_zero
        self.grad_averaging = grad_averaging
        super().__init__(params, defaults)
        self.state["v_per_tensor"] = torch.zeros(
            self.spec.num_tensors, dtype=torch.float32,
            device=self.master.device)

    def _update(self, grad_scale, noop) -> None:
        hp = self.param_groups[0]
        optim_kernels.novograd_update(
            self.grads, self.master, self.state["m"],
            self.state["v_per_tensor"], self.seg_rows, self.spec.num_tensors,
            beta1=hp["beta1"], beta2=hp["beta2"], eps=hp["eps"],
            weight_decay=hp["weight_decay"], lr=hp["lr"],
            step=self.step_count, grad_scale=grad_scale, noop=noop,
            grad_averaging=self.grad_averaging, init_zero=self.init_zero)
