"""FusedAdam: Adam and AdamW over the flat buffers, one kernel launch per
step.

Counterpart of ``apex_tpu/optimizers/fused_adam.py::FusedAdam``, with the
reference's constructor knobs (lr, bias_correction, betas, eps,
adam_w_mode, weight_decay; amsgrad raises there too) and its
``exclude_from_weight_decay`` name predicate.
"""

from __future__ import annotations

from apex_tpu_torch.ops import optim_kernels
from apex_tpu_torch.optimizers.common import FusedOptimizerBase


class FusedAdam(FusedOptimizerBase):
    STATE_BUFFERS = ("m", "v")

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, set_grad_none=True,
                 exclude_from_weight_decay=None):
        del set_grad_none            # gradients are flat-buffer views
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        defaults = dict(lr=lr, beta1=betas[0], beta2=betas[1], eps=eps,
                        weight_decay=weight_decay)
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction
        super().__init__(params, defaults,
                         exclude_from_weight_decay=exclude_from_weight_decay)

    def _update(self, grad_scale, noop) -> None:
        hp = self.param_groups[0]
        wd = self.wd_per_segment
        if wd is None:
            wd = hp["weight_decay"]
        optim_kernels.adam_update(
            self.grads, self.master, self.state["m"], self.state["v"],
            beta1=hp["beta1"], beta2=hp["beta2"], eps=hp["eps"],
            weight_decay=wd, lr=hp["lr"], step=self.step_count,
            grad_scale=grad_scale, noop=noop, adam_w_mode=self.adam_w_mode,
            bias_correction=self.bias_correction, seg_rows=self.seg_rows)
