"""Counterpart of ``apex_tpu.contrib.sparsity`` (ASP 2:4 structured
sparsity)."""

from apex_tpu_torch.contrib.sparsity.asp import ASP
from apex_tpu_torch.contrib.sparsity.permutation_lib import (
    apply_permutation_and_mask, search_permutation)
from apex_tpu_torch.contrib.sparsity.sparse_masklib import (
    create_mask, magnitude_retained, mn_1d_mask)

__all__ = ["ASP", "create_mask", "mn_1d_mask", "magnitude_retained",
           "search_permutation", "apply_permutation_and_mask"]
