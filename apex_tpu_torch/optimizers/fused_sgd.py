"""FusedSGD: SGD with momentum over the flat buffers, one kernel launch per
step.

Counterpart of ``apex_tpu/optimizers/fused_sgd.py::FusedSGD``, with the
reference's constructor (lr, momentum, dampening, weight_decay, nesterov;
Nesterov without momentum or with dampening, and ``wd_after_momentum``,
raise there too). The momentum buffer starts as the raw gradient (the
first-step rule). As in the reference, the step passes no grad scale to the
kernel, whose row has no slot for one: under an amp loss scaler the
unscale is dropped and only the overflow skip acts (ROADMAP queue C).
"""

from __future__ import annotations

from apex_tpu_torch.ops import optim_kernels
from apex_tpu_torch.optimizers.common import FusedOptimizerBase


class FusedSGD(FusedOptimizerBase):
    STATE_BUFFERS = ("momentum_buffer",)

    def __init__(self, params, lr, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, wd_after_momentum=False,
                 materialize_master_grads=True, set_grad_none=False):
        del materialize_master_grads, set_grad_none  # flat-buffer views
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and "
                             "zero dampening")
        if wd_after_momentum:
            raise NotImplementedError("wd_after_momentum=True not "
                                      "implemented")
        defaults = dict(lr=lr, momentum=momentum, dampening=dampening,
                        weight_decay=weight_decay)
        self.nesterov = nesterov
        self.momentum = momentum
        super().__init__(params, defaults)

    def _update(self, grad_scale, noop) -> None:
        del grad_scale               # the reference's kernel takes none
        hp = self.param_groups[0]
        optim_kernels.sgd_update(
            self.grads, self.master, self.state["momentum_buffer"],
            lr=hp["lr"], momentum=self.momentum, dampening=hp["dampening"],
            weight_decay=hp["weight_decay"], nesterov=self.nesterov,
            noop=noop, step=self.step_count)
