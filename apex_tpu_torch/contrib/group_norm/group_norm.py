"""GroupNorm module: drop-in for ``apex.contrib.group_norm.GroupNorm``.

Counterpart of ``apex_tpu/contrib/group_norm/group_norm.py``, over the NHWC
GroupNorm kernels (``apex_tpu_torch/ops/group_norm.py``), with ``act="silu"``
fusing the activation (diffusion UNets). In PyTorch's idiom it takes an
NCHW-shaped tensor in ``channels_last`` memory, which holds the same bytes
as the reference's NHWC array (upstream apex's contrib GroupNorm has the
same contract); the output comes back NCHW-shaped in ``channels_last``. An
input in another memory format is converted to ``channels_last`` once, a
copy, before the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.ops.group_norm import group_norm_nhwc


class GroupNorm(nn.Module):
    """``GroupNorm(num_groups, num_channels, eps, affine, act)``: fp32
    ``weight`` (ones) and ``bias`` (zeros) when ``affine``."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 affine: bool = True, act: Optional[str] = None,
                 device="cuda"):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.affine = affine
        self.act = act
        if affine:
            self.weight = nn.Parameter(torch.ones(num_channels,
                                                  device=device))
            self.bias = nn.Parameter(torch.zeros(num_channels,
                                                 device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x):
        if x.ndim != 4 or x.shape[1] != self.num_channels:
            raise ValueError(
                f"input of shape {tuple(x.shape)}: expected (n, "
                f"{self.num_channels}, h, w) (NCHW, channels_last)")
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(
            0, 2, 3, 1)
        y = group_norm_nhwc(nhwc, self.weight, self.bias, self.num_groups,
                            self.eps, self.act)
        return y.permute(0, 3, 1, 2)
