"""Model-parallel state of the port: the context-parallel ring.

Counterpart of the part of ``apex_tpu/transformer/parallel_state.py`` that
context parallelism needs: ``initialize_model_parallel(1, 1, *,
context_parallel_size_=cp)``, ``destroy_model_parallel``,
``get_context_parallel_group``,
``get_context_parallel_world_size`` and ``get_context_parallel_rank``. The
reference's mesh axis becomes a ring (``ops/ring_attention.py``):

- when ``torch.distributed`` is initialized with ``cp`` ranks (a ``gloo``
  or ``torchrun`` launch), a :class:`DistributedRing` over the default
  group: each process is one rank and holds its chunk of the sequence;
- without ``torch.distributed``, a :class:`LocalRing` of ``cp`` ranks in
  this process: the models hold the whole sequence and every rank's ring
  schedule runs in turn (how one card runs ``cp > 1``).

A ``torch.distributed`` world of another size than ``cp`` would be the
reference's data-parallel x context-parallel mesh, which is not ported:
it raises ``NotImplementedError`` (ROADMAP A10).

Like the reference's mesh, the ring is module state, read by the models
at forward time. Tensor and pipeline parallelism above 1 raise
``NotImplementedError`` (ROADMAP A10, A12.5).
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.ring_attention import DistributedRing, LocalRing

_CONTEXT_RING = None


def initialize_model_parallel(
        tensor_model_parallel_size_: int = 1,
        pipeline_model_parallel_size_: int = 1,
        virtual_pipeline_model_parallel_size_: Optional[int] = None,
        pipeline_model_parallel_split_rank_: Optional[int] = None, *,
        context_parallel_size_: int = 1):
    """Install the context-parallel ring of ``context_parallel_size_``
    ranks and return it (the reference returns its mesh)."""
    global _CONTEXT_RING
    if tensor_model_parallel_size_ != 1:
        raise NotImplementedError(
            "tensor_model_parallel_size_ > 1 is not ported yet (ROADMAP "
            "queue A item 10: tensor parallelism over torch.distributed)")
    if (pipeline_model_parallel_size_ != 1
            or virtual_pipeline_model_parallel_size_ is not None
            or pipeline_model_parallel_split_rank_ is not None):
        raise NotImplementedError(
            "pipeline parallelism is not ported yet (ROADMAP queue A item "
            "12.5: transformer/pipeline_parallel)")
    cp = int(context_parallel_size_)
    if cp < 1:
        raise ValueError(f"context_parallel_size_ must be >= 1, got {cp}")
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        _CONTEXT_RING = LocalRing(cp)
    elif dist.get_world_size() == cp:
        _CONTEXT_RING = DistributedRing()
    else:
        raise NotImplementedError(
            f"a torch.distributed world of {dist.get_world_size()} ranks "
            f"with context_parallel_size_={cp} is a data-parallel x "
            f"context-parallel split, not ported yet (ROADMAP queue A item "
            f"10: parallelism across ranks, the dp x cp mesh); give cp the "
            f"world size, or run without torch.distributed for the "
            f"in-process ring")
    return _CONTEXT_RING


def destroy_model_parallel() -> None:
    global _CONTEXT_RING
    _CONTEXT_RING = None


def get_context_parallel_ring():
    """The installed ring, or None when model parallelism is not
    initialized (the models then attend without a ring)."""
    return _CONTEXT_RING


def _ring():
    if _CONTEXT_RING is None:
        raise RuntimeError(
            "model parallelism is not initialized; call apex_tpu_torch."
            "transformer.parallel_state.initialize_model_parallel() first")
    return _CONTEXT_RING


def get_context_parallel_group():
    """The ring's ``torch.distributed`` group (None: the default group, or
    the in-process ring, which has none)."""
    return _ring().group


def get_context_parallel_world_size() -> int:
    return _ring().size


def get_context_parallel_rank() -> Optional[int]:
    """This process's rank in the distributed ring; None for the in-process
    ring, whose process holds every rank."""
    return _ring().rank
