"""Tensor-parallel paged serving: one logical engine over ``tp`` ranks.

Counterpart of ``apex_tpu/serving/tp.py``. The reference shards one
engine's programs over a ``model`` mesh axis with ``shard_map``; here, as
in upstream Megatron, each rank is a process running its own
:class:`TensorParallelPagedEngine` over the installed tensor-parallel group
(``transformer.parallel_state``), SPMD:

- **model**: the rank's shard (``GPTModel`` at ``tensor_parallel_size =
  tp``): column-parallel QKV and MLP-in give it ``num_heads / tp`` heads,
  the row-parallel projections and the vocab-parallel embedding issue the
  Megatron collectives;
- **K/V pool**: ``num_kv_heads / tp`` heads of EVERY page
  (``kv_pool.local_kv_heads``; the reference's ``P(None, model)``), so a
  rank's pool is ``1/tp`` of the tp = 1 pool's bytes;
- **block tables, free stack, lengths, refcounts, the prefix tree and the
  host scheduling**: replicated. Every rank runs the same host logic on the
  same requests, and the token choice gathers the vocab-parallel logits
  first (``generation.gather_vocab``), so every rank picks the same token
  and the replicated state advances identically: ``run()``, the
  ``ServingFrontend``, preemption and the prefix cache drive this engine
  unchanged.

Construction, in each of ``tp`` ranks (``torch.distributed`` initialized,
``parallel_state.initialize_model_parallel(tp)`` called)::

    model = GPTModel(gpt2_small_config(tensor_parallel_size=tp))
    model.load_state_dict(shard_model_variables(model, full_state_dict))
    engine = TensorParallelPagedEngine(model, num_slots=8, page_size=16)
    outs, stats = engine.run(requests)        # the same on every rank
"""

from __future__ import annotations

from apex_tpu_torch.serving.scheduler import PagedDecodeEngine
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    partition_specs, shard_state_dict)

__all__ = ["TensorParallelPagedEngine", "infer_variable_specs",
           "shard_model_variables"]


#: ``{state-dict name: (dim, chunks) or None}`` of a model: the dim along
#: which each tensor is split over the tensor-parallel ranks and its
#: fused-chunk count (QKV: 3), None for a replicated tensor
infer_variable_specs = partition_specs


def shard_model_variables(model, full_state_dict: dict, rank=None) -> dict:
    """This rank's (or rank ``rank``'s) shard of a tp = 1 checkpoint's
    FULL state dict for ``model`` (a tensor-parallel model), ready for
    ``model.load_state_dict``: a fused projection is interleaved per chunk
    first (each rank its heads' q, k and v), the other split tensors cut
    contiguously, replicated tensors kept whole."""
    tp = model.config.tensor_parallel_size
    rank = (parallel_state.get_tensor_model_parallel_rank() if rank is None
            else rank)
    specs = infer_variable_specs(model)
    local = model.state_dict()
    for name, t in full_state_dict.items():
        want = list(local[name].shape)
        spec = specs.get(name)
        if spec is not None:
            want[spec[0]] *= tp
        if list(t.shape) != want:
            raise ValueError(
                f"variable {name!r} has shape {tuple(t.shape)}; expected "
                f"the tp=1 FULL shape {tuple(want)} (pass the unsharded "
                f"checkpoint: this helper does the slicing)")
    return shard_state_dict(full_state_dict, specs, tp, rank)


class TensorParallelPagedEngine(PagedDecodeEngine):
    """This rank's side of one logical continuous-batching paged engine.
    A drop-in for :class:`PagedDecodeEngine`: ``model`` (and a
    speculative ``draft_model``) must be tensor-parallel models of the
    installed group's size; ``stats()["tp_world"]`` reports it."""

    def __init__(self, model, **kwargs):
        tp = model.config.tensor_parallel_size
        have = parallel_state.get_tensor_model_parallel_world_size()
        if have != tp:
            raise ValueError(
                f"config.tensor_parallel_size={tp} but the installed "
                f"tensor-parallel group has {have} ranks: the model's shard "
                f"shapes and the engine's head sharding would disagree")
        draft = kwargs.get("draft_model")
        if (draft is not None and kwargs.get("draft_len", 0) > 0
                and draft.config.tensor_parallel_size != tp):
            raise ValueError(
                f"draft model has tensor_parallel_size="
                f"{draft.config.tensor_parallel_size}, target has {tp}: "
                f"both must shard over the same group")
        self.tp_world = tp
        super().__init__(model, **kwargs)
