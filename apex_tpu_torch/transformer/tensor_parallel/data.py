"""Batch broadcast across the tensor-parallel group.

Counterpart of ``apex_tpu/transformer/tensor_parallel/data.py``: the
tensor-parallel source rank holds the batch and every rank of its group
takes that rank's tensors (the ranks must not each read their own).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from apex_tpu_torch import collectives as coll
from apex_tpu_torch.transformer import parallel_state


def broadcast_data(keys: Sequence[str], data: Dict[str, torch.Tensor],
                   datatype=None, group=None) -> Dict[str, torch.Tensor]:
    """``{k: the source rank's data[k]}`` for ``k`` in ``keys``, cast to
    ``datatype`` when given. Every rank passes tensors of the source's
    shapes and dtypes (their values are replaced)."""
    if group is None:
        group = parallel_state.get_tensor_model_parallel_group()
    out = {}
    for k in keys:
        v = data[k]
        if datatype is not None:
            v = v.to(datatype)
        out[k] = coll.broadcast(v, group, src=0)
    return out
