"""``FusedLayerNorm`` module (counterpart of
``apex_tpu/normalization/fused_layer_norm.py::FusedLayerNorm``): fp32
``weight``/``bias`` (ones/zeros), output in the input's dtype, forward and
backward through the LayerNorm kernels."""

from __future__ import annotations

import torch
from torch import nn

from apex_tpu_torch.ops.layer_norm import layer_norm


class FusedLayerNorm(nn.Module):
    def __init__(self, normalized_shape: int, eps: float = 1e-5, *,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(normalized_shape,
                                              dtype=param_dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(normalized_shape,
                                             dtype=param_dtype,
                                             device=device))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)
