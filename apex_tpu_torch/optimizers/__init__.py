"""Fused optimizers of the port (counterpart of ``apex_tpu.optimizers``):
flat fp32 buffers over the parameters, one launch (Adam) or three (LAMB)
per step. FusedSGD and FusedNovoGrad are not ported yet (ROADMAP queue A
item 12)."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB

__all__ = ["FusedAdam", "FusedLAMB"]
