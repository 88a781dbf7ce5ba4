"""DistributedDataParallel over a ``torch.distributed`` group.

Counterpart of ``apex_tpu/parallel/distributed.py``. It wraps a module,
records the reference's knobs (``message_size``, ``delay_allreduce``, ...)
so reference training scripts port unchanged, and averages gradients over
the data-parallel ranks in ``allreduce_gradients``, which the training
loop calls after ``backward()`` (the reference's ``shard_map`` loops call
it the same way):

- the group is ``process_group``, else the data-parallel group of
  ``transformer.parallel_state`` once initialized, else the default world;
- at construction the module's parameters and buffers are broadcast from
  the group's rank 0, as the reference's ``flat_dist_call`` broadcast;
- ``allreduce_gradients`` flattens the gradients into one buffer per dtype
  (fp32 under ``allreduce_always_fp32``), divides by
  ``gradient_predivide_factor``, sums over the group (one all-reduce a
  buffer) and, under ``gradient_average``, divides by ``world /
  gradient_predivide_factor``: the reference's ``red``.

The bucketing and overlap knobs (``message_size``, ``delay_allreduce``,
``num_allreduce_streams``, ...) are recorded only: the reduction runs once,
after the backward. On one rank there is nothing to reduce:
``allreduce_gradients`` returns the gradients as they are.
"""

from __future__ import annotations

import torch
from torch import nn

from apex_tpu_torch import collectives as coll
from apex_tpu_torch.transformer import parallel_state


def data_parallel_group(process_group=None):
    """``process_group``, else the installed data-parallel group, else
    None (the default world)."""
    if process_group is not None:
        return process_group
    if parallel_state.model_parallel_is_initialized():
        return parallel_state.get_data_parallel_group()
    return None


class DistributedDataParallel(nn.Module):
    """``ddp(x)`` calls the module; ``ddp.allreduce_gradients()`` averages
    the module's gradients over the data-parallel group."""

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
        self.process_group = data_parallel_group(process_group)
        self.gradient_average = gradient_average
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.gradient_predivide_factor = gradient_predivide_factor
        # recorded-only knobs
        self.message_size = message_size
        self.delay_allreduce = delay_allreduce
        self.num_allreduce_streams = num_allreduce_streams
        if self.world_size > 1:
            with torch.no_grad():
                for t in list(module.parameters()) + list(module.buffers()):
                    t.copy_(coll.broadcast(t, self.process_group, src=0))

    @property
    def world_size(self) -> int:
        return coll.world_size(self.process_group)

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    def _reduce(self, grads):
        """The reference's ``red`` over a list of tensors, flattened into
        one buffer per dtype; returns the reduced tensors in order."""
        out = [None] * len(grads)
        by_dtype = {}
        for i, g in enumerate(grads):
            dt = torch.float32 if self.allreduce_always_fp32 else g.dtype
            by_dtype.setdefault((dt, g.device), []).append(i)
        pre = self.gradient_predivide_factor
        n = self.world_size
        for (dt, _), idx in by_dtype.items():
            flat = torch.cat([grads[i].reshape(-1).to(dt) for i in idx])
            if pre != 1.0:
                flat = flat / pre
            flat = coll.all_reduce(flat, self.process_group)
            if self.gradient_average:
                flat = flat / (n / pre)
            for i, part in zip(idx, flat.split([grads[i].numel()
                                                for i in idx])):
                out[i] = part.view_as(grads[i]).to(grads[i].dtype)
        return out

    @torch.no_grad()
    def allreduce_gradients(self, grads=None):
        """Average gradients over the data-parallel ranks. With no argument,
        every ``.grad`` of the module's parameters in place (and returns
        None); given a dict or a list of tensors, returns their averages in
        the same structure. On one rank, returns ``grads`` as it is."""
        if self.world_size == 1:
            return grads
        if grads is None:
            params = [p for p in self.module.parameters()
                      if p.grad is not None]
            for p, g in zip(params, self._reduce([p.grad for p in params])):
                p.grad.copy_(g)
            return None
        if isinstance(grads, dict):
            keys = list(grads)
            return dict(zip(keys, self._reduce([grads[k] for k in keys])))
        return self._reduce(list(grads))
