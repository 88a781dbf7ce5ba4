"""Fused optimizers of the port (counterpart of ``apex_tpu.optimizers``):
flat fp32 buffers over the parameters, one launch per step (Adam, SGD),
two (NovoGrad) or three (LAMB)."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.optimizers.fused_novograd import FusedNovoGrad
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD

__all__ = ["FusedAdam", "FusedLAMB", "FusedNovoGrad", "FusedSGD"]
