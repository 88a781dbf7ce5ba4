"""Model-parallel state of the port: tensor-parallel and data-parallel
process groups, and the context-parallel ring.

Counterpart of ``apex_tpu/transformer/parallel_state.py``. The reference
builds one mesh ``(data, stage, context, model)`` with ``model`` fastest
(``apex_tpu/mesh.py``); a "group" there is a mesh axis. Here a group is a
``torch.distributed`` process group, and each process is one rank (SPMD as
in the reference: the same program on every rank, each with its shard).

``initialize_model_parallel(tp)`` over an initialized world of ``tp x dp``
ranks builds

- the tensor-parallel groups, ``tp`` consecutive ranks each (``[0, tp)``,
  ``[tp, 2 tp)``, ...: ``model`` is the mesh's fastest axis);
- the data-parallel groups, the ranks of equal tensor-parallel rank
  (``r, r + tp, r + 2 tp, ...``).

Every process creates every group, in the same order, as
``torch.distributed.new_group`` requires. Without ``torch.distributed``,
``tp > 1`` raises: a tensor-parallel model holds one rank's shard, so it
needs ``tp`` processes (``torchrun --nproc-per-node tp`` or
``apex_tpu_torch.parallel.spawn.run_ranks``).

The context-parallel ring keeps its two forms (``ops/ring_attention.py``):

- when ``torch.distributed`` is initialized with ``cp`` ranks (a ``gloo``
  or ``torchrun`` launch), a :class:`DistributedRing` over the default
  group: each process is one rank and holds its chunk of the sequence;
- without ``torch.distributed``, a :class:`LocalRing` of ``cp`` ranks in
  this process: the models hold the whole sequence and every rank's ring
  schedule runs in turn (how one card runs ``cp > 1``).

A world of another size than ``cp`` under ``cp > 1`` would be the
reference's data-parallel x context-parallel mesh, which is not ported, and
``tp > 1`` together with ``cp > 1`` neither: both raise
``NotImplementedError`` (ROADMAP A10). Pipeline parallelism raises too
(ROADMAP A12.5).

Like the reference's mesh, the groups are module state, read by the
layers and the models at forward time.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.ring_attention import DistributedRing, LocalRing

_CONTEXT_RING = None
#: this process's groups and sizes once initialized, else None
_STATE: Optional[dict] = None


def _dist_ready() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def initialize_model_parallel(
        tensor_model_parallel_size_: int = 1,
        pipeline_model_parallel_size_: int = 1,
        virtual_pipeline_model_parallel_size_: Optional[int] = None,
        pipeline_model_parallel_split_rank_: Optional[int] = None, *,
        context_parallel_size_: int = 1):
    """Build this process's tensor- and data-parallel groups (and the
    context-parallel ring) and return the ring (the reference returns its
    mesh)."""
    global _CONTEXT_RING, _STATE
    if (pipeline_model_parallel_size_ != 1
            or virtual_pipeline_model_parallel_size_ is not None
            or pipeline_model_parallel_split_rank_ is not None):
        raise NotImplementedError(
            "pipeline parallelism is not ported yet (ROADMAP queue A item "
            "12.5: transformer/pipeline_parallel)")
    tp = int(tensor_model_parallel_size_)
    cp = int(context_parallel_size_)
    if tp < 1:
        raise ValueError(f"tensor_model_parallel_size_ must be >= 1, got "
                         f"{tp}")
    if cp < 1:
        raise ValueError(f"context_parallel_size_ must be >= 1, got {cp}")
    if tp > 1 and cp > 1:
        raise NotImplementedError(
            "tensor parallelism together with context parallelism is not "
            "ported yet (ROADMAP queue A item 10: the tp x cp mesh)")
    dist = torch.distributed
    if not _dist_ready():
        if tp > 1:
            raise RuntimeError(
                f"tensor_model_parallel_size_={tp} needs {tp} processes, one "
                f"per rank, over an initialized torch.distributed world: "
                f"start {tp} ranks (torchrun --nproc-per-node {tp}, or "
                f"apex_tpu_torch.parallel.spawn.run_ranks) and call "
                f"torch.distributed.init_process_group in each first")
        _CONTEXT_RING = LocalRing(cp)
        _STATE = dict(tp=1, dp=1, tp_rank=0, dp_rank=0, tp_group=None,
                      dp_group=None, tp_src=0)
        return _CONTEXT_RING
    world, me = dist.get_world_size(), dist.get_rank()
    if cp > 1 and world != cp:
        raise NotImplementedError(
            f"a torch.distributed world of {world} ranks with "
            f"context_parallel_size_={cp} is a data-parallel x "
            f"context-parallel split, not ported yet (ROADMAP queue A item "
            f"10: parallelism across ranks, the dp x cp mesh); give cp the "
            f"world size, or run without torch.distributed for the "
            f"in-process ring")
    if world % tp:
        raise RuntimeError(f"world size {world} is not divisible by "
                           f"tensor_model_parallel_size_ {tp}")
    # the ring's ranks are neither tensor- nor data-parallel peers
    dp = 1 if cp > 1 else world // tp
    tp_group = dp_group = None
    # every rank creates every group, in one order
    for start in range(0, world, tp):
        g = dist.new_group(list(range(start, start + tp)))
        if start <= me < start + tp:
            tp_group = g
    dp_sets = ([[r] for r in range(world)] if cp > 1
               else [list(range(r, world, tp)) for r in range(tp)])
    for ranks in dp_sets:
        g = dist.new_group(ranks)
        if me in ranks:
            dp_group = g
    _CONTEXT_RING = (DistributedRing() if cp > 1 or world == 1
                     else LocalRing(1))
    _STATE = dict(tp=tp, dp=dp, tp_rank=me % tp,
                  dp_rank=0 if cp > 1 else me // tp, tp_group=tp_group,
                  dp_group=dp_group, tp_src=me - me % tp)
    return _CONTEXT_RING


def model_parallel_is_initialized() -> bool:
    return _STATE is not None


def destroy_model_parallel() -> None:
    global _CONTEXT_RING, _STATE
    _CONTEXT_RING = None
    _STATE = None


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


def _state() -> dict:
    if _STATE is None:
        raise RuntimeError(
            "model parallelism is not initialized; call apex_tpu_torch."
            "transformer.parallel_state.initialize_model_parallel() first")
    return _STATE


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


# --- tensor and data parallelism ---------------------------------------------

def get_tensor_model_parallel_group():
    """This rank's tensor-parallel process group (None without
    ``torch.distributed``: one rank)."""
    return _state()["tp_group"]


def get_tensor_model_parallel_world_size() -> int:
    """1 when model parallelism is not initialized, as the layers' tp = 1
    default."""
    return _STATE["tp"] if _STATE is not None else 1


def get_tensor_model_parallel_rank() -> int:
    return _STATE["tp_rank"] if _STATE is not None else 0


def get_tensor_model_parallel_src_rank() -> int:
    """The global rank of this tensor-parallel group's rank 0."""
    return _state()["tp_src"]


def get_data_parallel_group():
    """This rank's data-parallel process group (None without
    ``torch.distributed``)."""
    return _state()["dp_group"]


def get_data_parallel_world_size() -> int:
    return _STATE["dp"] if _STATE is not None else 1


def get_data_parallel_rank() -> int:
    return _STATE["dp_rank"] if _STATE is not None else 0

