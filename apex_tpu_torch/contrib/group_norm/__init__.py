"""Counterpart of ``apex_tpu.contrib.group_norm``."""

from apex_tpu_torch.contrib.group_norm.group_norm import GroupNorm

__all__ = ["GroupNorm"]
