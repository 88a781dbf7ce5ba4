"""Fused optimizers of the port (counterpart of ``apex_tpu.optimizers``):
flat fp32 buffers over the parameters (half parameters as views of a half
copy of them), one launch per step (Adam, SGD), two (NovoGrad) or three
(LAMB); and the optax-style pure transforms over the same kernels."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.optimizers.fused_novograd import FusedNovoGrad
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD
from apex_tpu_torch.optimizers.transforms import (fused_adam, fused_lamb,
                                                  fused_novograd, fused_sgd)

__all__ = ["FusedAdam", "FusedLAMB", "FusedNovoGrad", "FusedSGD",
           "fused_adam", "fused_lamb", "fused_novograd", "fused_sgd"]
