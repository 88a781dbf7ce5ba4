"""``FusedLayerNorm`` and ``FusedRMSNorm`` modules (counterparts of
``apex_tpu/normalization/fused_layer_norm.py::FusedLayerNorm`` and
``::FusedRMSNorm``): ``weight`` (ones) and, for LayerNorm, ``bias`` (zeros)
in ``param_dtype``, output in the input's dtype; ``memory_efficient`` (the
reference's field) saves the output instead of the input for the backward.
Both run forward and backward through the norm kernels (RMSNorm through
their RMS branches)."""

from __future__ import annotations

import torch
from torch import nn

from apex_tpu_torch.ops.layer_norm import layer_norm, rms_norm


class FusedLayerNorm(nn.Module):
    def __init__(self, normalized_shape: int, eps: float = 1e-5, *,
                 param_dtype=torch.float32, device=None,
                 memory_efficient: bool = False):
        super().__init__()
        self.eps = eps
        self.memory_efficient = memory_efficient
        self.weight = nn.Parameter(torch.ones(normalized_shape,
                                              dtype=param_dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(normalized_shape,
                                             dtype=param_dtype,
                                             device=device))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps,
                          self.memory_efficient)


class FusedRMSNorm(nn.Module):
    def __init__(self, normalized_shape: int, eps: float = 1e-5, *,
                 param_dtype=torch.float32, device=None,
                 memory_efficient: bool = False):
        super().__init__()
        self.eps = eps
        self.memory_efficient = memory_efficient
        self.weight = nn.Parameter(torch.ones(normalized_shape,
                                              dtype=param_dtype,
                                              device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps, self.memory_efficient)
