"""DistributedDataParallel facade.

Counterpart of ``apex_tpu/parallel/distributed.py``. It wraps a module and
records the reference's knobs (``message_size``, ``delay_allreduce``,
``gradient_average``, ...), so reference training scripts port unchanged.
On one rank there is nothing to reduce: ``allreduce_gradients`` is the
identity. Across ranks it raises (ROADMAP queue A item 10: DDP over
``torch.distributed``).
"""

from __future__ import annotations

import torch
from torch import nn

_ACROSS_RANKS = ("DistributedDataParallel across more than one rank is not "
                 "ported yet (ROADMAP queue A item 10: DDP and SyncBatchNorm "
                 "over torch.distributed)")


class DistributedDataParallel(nn.Module):
    """API-parity wrapper: ``ddp(x)`` calls the module."""

    def __init__(self, module: nn.Module, message_size: int = 10_000_000,
                 delay_allreduce: bool = False, shared_param=None,
                 allreduce_trigger_params=None,
                 retain_allreduce_buffers: bool = False,
                 allreduce_always_fp32: bool = False,
                 num_allreduce_streams: int = 1,
                 allreduce_communicators=None, gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0, process_group=None):
        super().__init__()
        self.module = module
        self.process_group = process_group
        self.gradient_average = gradient_average
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.gradient_predivide_factor = gradient_predivide_factor
        # recorded-only knobs
        self.message_size = message_size
        self.delay_allreduce = delay_allreduce
        self._check_world()

    def _world_size(self) -> int:
        dist = torch.distributed
        if self.process_group is not None:
            return dist.get_world_size(self.process_group)
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return 1

    def _check_world(self) -> None:
        if self._world_size() > 1:
            raise NotImplementedError(_ACROSS_RANKS)

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    def allreduce_gradients(self, grads=None):
        """Average the gradients over the data-parallel ranks: the identity
        on one rank (returns ``grads``); raises across ranks."""
        self._check_world()
        return grads
