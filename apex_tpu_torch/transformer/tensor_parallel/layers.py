"""Megatron-style tensor-parallel linears and embedding.

Counterparts of ``apex_tpu/transformer/tensor_parallel/layers.py``
(``ColumnParallelLinear``, ``RowParallelLinear``,
``VocabParallelEmbedding``). Each rank holds its shard of the weight in the
torch/reference layout ``(out, in)`` in ``params_dtype``; the forward casts
weight and bias to the input's dtype and computes ``y = x @ w.T + b``, as
the reference does. These GEMMs sit outside any Pallas kernel in the
reference, so they stay ``torch.matmul`` here.

At ``world_size`` > 1 the layers run on the installed tensor-parallel group
(``transformer.parallel_state``; ``world_size`` must equal its size) and
issue the reference's collectives through ``mappings``:

- ``ColumnParallelLinear``: the weight split along its OUTPUT dim; the
  input enters through ``copy_to`` (``gather_from_sequence_parallel`` under
  ``sequence_parallel_enabled``), and ``gather_output`` all-gathers the
  output shards;
- ``RowParallelLinear``: the weight split along its INPUT dim; an input
  that is not ``input_is_parallel`` is scattered first, and the partial
  products leave through ``reduce_from`` (``reduce_scatter_to_sequence_
  parallel`` under ``sequence_parallel_enabled``); the bias, replicated,
  is added after the reduction;
- ``VocabParallelEmbedding``: the table split along the vocab; each rank
  looks up the ids in its range ``[rank * per, (rank + 1) * per)``, zeroes
  the others and the ranks' rows are summed (``reduce_from``); ``attend``
  (the tied LM head) returns this rank's vocab shard of the logits.

Initialization draws the FULL tp = 1 weight from the generator and keeps
this rank's block (the reference's ``use_cpu_initialization`` master
weight, split), so a model built at any tensor-parallel size from one seed
computes the tp = 1 model's function. A fused projection (``fused_chunks``
> 1, GPT's ``[q | k | v]``) keeps its rank's block of EVERY chunk, the
Megatron layout.

With ``quantize=`` (``"int8"``/``True``, ``"fp8"`` or ``"int4"``, as the
reference's) a linear stores its weight narrow, as buffers ``weight`` and
``scale`` (int8/fp8: ``(out, in)`` with ``(out,)`` scales; int4: ``(out,
in // 2)`` uint8 with ``(in // quantize_group_size, out)`` scales), and its
forward is ``fused_dequant_matmul`` (the dequant-matmul kernels). The
buffers start as placeholders, zeros and ones, as in the reference; real
values come from ``models/quantize.py``. Inference only, and at
``world_size`` 1 only: the quantized tensor-parallel variant waits (ROADMAP
A7).
"""

from __future__ import annotations

import torch
from torch import nn

from apex_tpu_torch.ops.quant import (fused_dequant_matmul,
                                      resolve_weight_dtype,
                                      validate_int4_group,
                                      weight_storage_dtype)
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.transformer.utils import divide

_QUANT_TP_TODO = ("a quantized linear at world_size > 1 is not ported yet "
                  "(ROADMAP queue A item 7: the quantized variant of tensor "
                  "parallelism, scales sharded with the channels)")


def check_world(world_size: int) -> None:
    """A layer of ``world_size`` > 1 needs an installed tensor-parallel
    group of that size."""
    if world_size == 1:
        return
    have = parallel_state.get_tensor_model_parallel_world_size()
    if have != world_size:
        raise RuntimeError(
            f"a tensor-parallel layer of world_size={world_size} needs "
            f"{world_size} ranks with an installed tensor-parallel group "
            f"of that size (this process has {have}): start "
            f"{world_size} ranks and call parallel_state."
            f"initialize_model_parallel({world_size}) in each first")


def shard_block(full: torch.Tensor, dim: int, world: int, rank: int,
                chunks: int = 1) -> torch.Tensor:
    """Rank ``rank``'s block of ``full`` along ``dim`` at ``world`` ranks;
    under ``chunks`` > 1 (a fused projection) its block of every one of
    the ``chunks`` equal parts, concatenated."""
    parts = full.chunk(chunks, dim=dim)
    return torch.cat([p.chunk(world, dim=dim)[rank] for p in parts],
                     dim=dim)


class _Linear(nn.Module):
    #: the weight dim split over the ranks (0: output, 1: input)
    partition_dim = 0

    def __init__(self, input_size: int, output_size: int, *,
                 bias: bool = True, world_size: int = 1,
                 params_dtype=torch.float32, quantize=False,
                 quantize_group_size: int = 128,
                 sequence_parallel_enabled: bool = False,
                 fused_chunks: int = 1, device=None):
        super().__init__()
        self.quantize = resolve_weight_dtype(quantize)
        if self.quantize and world_size > 1:
            raise NotImplementedError(_QUANT_TP_TODO)
        check_world(world_size)
        self.world_size = world_size
        self.input_size, self.output_size = input_size, output_size
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.fused_chunks = fused_chunks
        out_local, in_local = ((divide(output_size, world_size), input_size)
                               if self.partition_dim == 0
                               else (output_size,
                                     divide(input_size, world_size)))
        if self.quantize == "int4":
            validate_int4_group(input_size, quantize_group_size)
            self.register_buffer("weight", torch.zeros(
                output_size, input_size // 2, dtype=torch.uint8,
                device=device))
            self.register_buffer("scale", torch.ones(
                input_size // quantize_group_size, output_size,
                dtype=torch.float32, device=device))
        elif self.quantize:
            self.register_buffer("weight", torch.zeros(
                output_size, input_size,
                dtype=weight_storage_dtype(self.quantize), device=device))
            self.register_buffer("scale", torch.ones(
                output_size, dtype=torch.float32, device=device))
        else:
            self.weight = nn.Parameter(torch.empty(
                out_local, in_local, dtype=params_dtype, device=device))
        # the column split shards the bias; the row split's is replicated
        b_size = out_local if self.partition_dim == 0 else output_size
        self.bias = (nn.Parameter(torch.zeros(b_size, dtype=params_dtype,
                                              device=device))
                     if bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """LeCun-normal weight (std ``1/sqrt(fan_in)``, the reference's
        default init family) drawn at the full tp = 1 shape on
        ``generator``'s device, this rank's block kept; zero bias. A
        quantized weight keeps its placeholders."""
        with torch.no_grad():
            if not self.quantize:
                w = torch.randn((self.output_size, self.input_size),
                                generator=generator, dtype=torch.float32,
                                device=generator.device)
                w = w * self.input_size ** -0.5
                if self.world_size > 1:
                    w = shard_block(
                        w, self.partition_dim, self.world_size,
                        parallel_state.get_tensor_model_parallel_rank(),
                        self.fused_chunks)
                self.weight.copy_(w)
            if self.bias is not None:
                self.bias.zero_()

    def _matmul(self, x):
        if self.quantize:
            return fused_dequant_matmul(x, self.weight, self.scale)
        return x @ self.weight.to(x.dtype).T


class ColumnParallelLinear(_Linear):
    """``Y = X A^T + b`` with A split along its output dim; the output is
    this rank's columns unless ``gather_output``."""

    partition_dim = 0

    def __init__(self, input_size: int, output_size: int, *,
                 gather_output: bool = True, **kw):
        super().__init__(input_size, output_size, **kw)
        if gather_output and self.sequence_parallel_enabled:
            raise RuntimeError("gather_output is incompatible with "
                               "sequence_parallel_enabled (same as the "
                               "reference)")
        self.gather_output = gather_output

    def forward(self, x):
        tp = self.world_size > 1
        if tp:
            x = (mappings.gather_from_sequence_parallel_region(x, None, True)
                 if self.sequence_parallel_enabled
                 else mappings.copy_to_tensor_model_parallel_region(x))
        y = self._matmul(x)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if tp and self.gather_output:
            y = mappings.gather_from_tensor_model_parallel_region(y)
        return y


class RowParallelLinear(_Linear):
    """``Y = X A^T + b`` with A split along its input dim; the bias is
    added after the reduction."""

    partition_dim = 1

    def __init__(self, input_size: int, output_size: int, *,
                 input_is_parallel: bool = False, **kw):
        super().__init__(input_size, output_size, **kw)
        if self.sequence_parallel_enabled and not input_is_parallel:
            raise RuntimeError("sequence_parallel_enabled requires "
                               "input_is_parallel (same as the reference)")
        self.input_is_parallel = input_is_parallel

    def forward(self, x):
        tp = self.world_size > 1
        if tp and not self.input_is_parallel:
            x = mappings.scatter_to_tensor_model_parallel_region(x)
        y = self._matmul(x)
        if tp:
            y = (mappings.reduce_scatter_to_sequence_parallel_region(y)
                 if self.sequence_parallel_enabled
                 else mappings.reduce_from_tensor_model_parallel_region(y))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class VocabParallelEmbedding(nn.Module):
    """Embedding table ``(vocab / world_size, dim)``, this rank's rows of the
    vocab. At world size 1 ids are clipped into the table as in the
    reference's unsharded branch. ``attend`` is the tied LM head ``x @
    W.T`` in x's dtype, this rank's vocab shard of the logits."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 world_size: int = 1, params_dtype=torch.float32,
                 device=None):
        super().__init__()
        check_world(world_size)
        self.world_size = world_size
        self.num_embeddings = num_embeddings
        self.weight = nn.Parameter(torch.empty(
            divide(num_embeddings, world_size), embedding_dim,
            dtype=params_dtype, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal(0.02) at the full table's shape, drawn on ``generator``'s
        device; this rank's rows kept."""
        with torch.no_grad():
            w = torch.randn((self.num_embeddings, self.weight.shape[1]),
                            generator=generator,
                            device=generator.device) * 0.02
            if self.world_size > 1:
                w = shard_block(
                    w, 0, self.world_size,
                    parallel_state.get_tensor_model_parallel_rank())
            self.weight.copy_(w)

    def forward(self, input_ids):
        per = self.weight.shape[0]
        if self.world_size == 1:
            return self.weight[input_ids.long().clamp(0, per - 1)]
        start = parallel_state.get_tensor_model_parallel_rank() * per
        local = input_ids.long() - start
        in_range = (local >= 0) & (local < per)
        emb = self.weight[local.clamp(0, per - 1)]
        emb = torch.where(in_range[..., None], emb, 0.0)
        return mappings.reduce_from_tensor_model_parallel_region(emb)

    def attend(self, x):
        if self.world_size > 1:
            x = mappings.copy_to_tensor_model_parallel_region(x)
        return x @ self.weight.to(x.dtype).T


def partition_specs(module: nn.Module) -> dict:
    """``{state-dict name: (dim, chunks) or None}`` of ``module``: the dim
    along which each tensor-parallel layer's tensor is split over the ranks
    and its fused-chunk count (column-parallel weights and biases: dim 0;
    row-parallel weights: dim 1; the vocab-parallel table: dim 0), None for
    a replicated tensor (norms, row-parallel biases, position tables).
    The counterpart of the reference's ``infer_variable_specs``
    PartitionSpecs."""
    specs = {}
    for mod_name, mod in module.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        for name, _ in mod.named_parameters(recurse=False):
            specs[prefix + name] = None
        for name, _ in mod.named_buffers(recurse=False):
            specs[prefix + name] = None
        if isinstance(mod, ColumnParallelLinear):
            specs[prefix + "weight"] = (0, mod.fused_chunks)
            if mod.bias is not None:
                specs[prefix + "bias"] = (0, mod.fused_chunks)
        elif isinstance(mod, RowParallelLinear):
            specs[prefix + "weight"] = (1, 1)
        elif isinstance(mod, VocabParallelEmbedding):
            specs[prefix + "weight"] = (0, 1)
    return specs


def shard_state_dict(full: dict, specs: dict, world: int, rank: int) -> dict:
    """Rank ``rank``'s shard of a tp = 1 state dict ``full`` at ``world``
    ranks, by ``specs`` (:func:`partition_specs`): split tensors cut with
    :func:`shard_block` (a fused projection's block of every chunk),
    replicated ones kept whole."""
    out = {}
    for name, t in full.items():
        spec = specs.get(name)
        out[name] = (t if spec is None or world == 1
                     else shard_block(t, spec[0], world, rank, spec[1]))
    return out


def unshard_state_dict(shards, specs: dict) -> dict:
    """The tp = 1 state dict from every rank's shard, in rank order: the
    inverse of :func:`shard_state_dict` (a replicated tensor is rank 0's)."""
    world = len(shards)
    out = {}
    for name, t0 in shards[0].items():
        spec = specs.get(name)
        if spec is None or world == 1:
            out[name] = t0
            continue
        dim, chunks = spec
        per_rank = [s[name].chunk(chunks, dim=dim) for s in shards]
        out[name] = torch.cat([torch.cat([p[c] for p in per_rank], dim=dim)
                               for c in range(chunks)], dim=dim)
    return out
