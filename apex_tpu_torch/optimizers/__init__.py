"""Fused optimizers of the port (counterpart of ``apex_tpu.optimizers``):
flat fp32 buffers over the parameters, one kernel launch per step.
FusedLAMB, FusedSGD and FusedNovoGrad are not ported yet (ROADMAP queue A
items 11-12)."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam

__all__ = ["FusedAdam"]
