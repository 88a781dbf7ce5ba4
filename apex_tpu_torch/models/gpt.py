"""GPT (pre-LN decoder) at tensor-parallel size 1.

Counterpart of ``apex_tpu/models/gpt.py`` (``GPTConfig``,
``gpt2_small_config``, ``gpt_tiny_config``, ``ParallelDecoderBlock``,
``GPTModel``, ``lm_token_loss``, ``gpt_loss``) in its four paths:

- no cache: causal flash attention over the whole sequence; the training
  path, differentiable end to end (the LayerNorm and flash kernels have
  their backward kernels);
- no cache under ``context_parallel`` with a ring installed
  (``transformer.parallel_state``): ``ring_attention(causal=True)`` or,
  under ``context_parallel_zigzag``, ``ring_attention_zigzag``, with the
  position rows of the tokens' global positions (``context_positions``);
  the loss is the mean over the ring's tokens;
- a contiguous cache: the static prefill (length 0, more than one token)
  rides the flash kernel, later chunks the dense ``cached_attention``;
- a paged cache: each slot's K/V chunk is written into its pages and the
  paged-attention kernel attends over the block table, at per-slot
  positions ``clip(len + arange(s))``.

dtype flow as in the reference: ``x = (emb + pos).to(dtype)``; each
LayerNorm reads and writes x's dtype; linears cast their fp32 weights to
x's dtype; the tied LM head returns logits in ``dtype``.

Quantized serving: ``weight_policy=WeightPrecisionPolicy(...)`` (or the
``quantize_int8=True`` alias) stores the four block linears narrow and runs
them through the dequant-matmul kernels; embeddings, norms, biases and the
tied head stay in ``param_dtype``. Load real values with
``models/quantize.py``. A paged cache built with ``kv_dtype=`` carries
per-page scales, which the block passes to ``paged_attention``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.amp.policy import resolve_compute_dtype
from apex_tpu_torch.models.generation import (advance_cache, cached_attention,
                                              check_chunk_bounds, is_paged,
                                              is_static_prefill, layer_cache,
                                              update_layer_cache,
                                              update_paged_layer_cache)
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.paged_attention import paged_attention
from apex_tpu_torch.ops.quant import WeightPrecisionPolicy
from apex_tpu_torch.ops.ring_attention import (context_positions,
                                               global_length, ring_attention,
                                               ring_attention_zigzag)
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304          # GPT-2 50257 rounded up
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    layernorm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    tensor_parallel_size: int = 1
    # ring attention over the context-parallel ring (sequence order, or the
    # load-balanced zigzag layout: ``to_zigzag`` the batch first)
    context_parallel: bool = False
    context_parallel_zigzag: bool = False
    # quantized block linears (inference only): ``quantize_int8`` is the
    # alias of the int8-everywhere policy, ``weight_policy`` a
    # WeightPrecisionPolicy (int8 / fp8 / int4-grouped)
    quantize_int8: bool = False
    weight_policy: Any = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def weight_quant(self) -> Optional[WeightPrecisionPolicy]:
        """The resolved policy, or None for full-precision weights (a named
        error when ``quantize_int8`` and ``weight_policy`` conflict)."""
        return WeightPrecisionPolicy.resolve(self.weight_policy,
                                             self.quantize_int8)


def gpt2_small_config(**overrides) -> GPTConfig:
    return dataclasses.replace(GPTConfig(), **overrides)


def gpt_tiny_config(**overrides) -> GPTConfig:
    base = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                     num_heads=4, max_position_embeddings=128,
                     dtype=torch.float32)
    return dataclasses.replace(base, **overrides)


class ParallelDecoderBlock(nn.Module):
    """Pre-LN block: LN -> attention -> residual -> LN -> MLP -> residual."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        cfg = config
        e, pd, tp = cfg.hidden_size, cfg.param_dtype, cfg.tensor_parallel_size
        pol = cfg.weight_quant()
        kw = dict(world_size=tp, params_dtype=pd, device=device,
                  quantize=pol.linears if pol else False,
                  quantize_group_size=pol.group_size if pol else 128)
        self.config = cfg
        self.input_norm = FusedLayerNorm(e, cfg.layernorm_eps, param_dtype=pd,
                                         device=device)
        self.qkv = ColumnParallelLinear(e, 3 * e, gather_output=False, **kw)
        self.out_proj = RowParallelLinear(e, e, input_is_parallel=True, **kw)
        self.post_norm = FusedLayerNorm(e, cfg.layernorm_eps, param_dtype=pd,
                                        device=device)
        self.mlp_in = ColumnParallelLinear(e, 4 * e, gather_output=False,
                                           **kw)
        self.mlp_out = RowParallelLinear(4 * e, e, input_is_parallel=True,
                                         **kw)

    def forward(self, x, cache=None):
        cfg = self.config
        dt = resolve_compute_dtype(cfg.dtype)  # amp O1 seam
        h_heads, d = cfg.num_heads, cfg.head_dim
        b, s, _ = x.shape

        h = self.input_norm(x).to(dt)
        q, k, v = self.qkv(h).chunk(3, dim=-1)       # [q | k | v], each e

        def to_bhsd(t):
            return t.reshape(b, s, h_heads, d).transpose(1, 2)

        if cache is not None and is_paged(cache):
            cache = update_paged_layer_cache(cache, to_bhsd(k), to_bhsd(v))
            ctx = paged_attention(to_bhsd(q), cache["k_pages"],
                                  cache["v_pages"], cache["block_tables"],
                                  cache["len"] + s,
                                  k_scales=cache.get("k_scales"),
                                  v_scales=cache.get("v_scales"))
        elif cache is not None:
            prefill = is_static_prefill(cache, s)
            cache = update_layer_cache(cache, to_bhsd(k), to_bhsd(v))
            if prefill:
                ctx = flash_attention(to_bhsd(q), to_bhsd(k), to_bhsd(v),
                                      causal=True)
            else:
                ctx = cached_attention(to_bhsd(q), cache)
        elif (ring := cp_ring(cfg)) is not None:
            if cfg.context_parallel_zigzag:
                ctx = ring_attention_zigzag(to_bhsd(q), to_bhsd(k),
                                            to_bhsd(v), ring=ring)
            else:
                ctx = ring_attention(to_bhsd(q), to_bhsd(k), to_bhsd(v),
                                     ring=ring, causal=True)
        else:
            ctx = flash_attention(to_bhsd(q), to_bhsd(k), to_bhsd(v),
                                  causal=True)
        ctx = ctx.transpose(1, 2).reshape(b, s, h_heads * d)
        x = x + self.out_proj(ctx).to(x.dtype)

        h = self.post_norm(x).to(dt)
        h = F.gelu(self.mlp_in(h), approximate="tanh")
        out = x + self.mlp_out(h).to(x.dtype)
        return out if cache is None else (out, cache)


class GPTModel(nn.Module):
    """Decoder-only LM with the LM head tied to the word embedding.
    ``forward(input_ids)`` -> logits ``[B, S, vocab]``;
    ``forward(input_ids, cache=...)`` -> ``(logits, cache)``."""

    def __init__(self, config: GPTConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.word_embeddings = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size,
            world_size=cfg.tensor_parallel_size,
            params_dtype=cfg.param_dtype, device=device)
        self.position_embeddings = nn.Parameter(torch.empty(
            cfg.max_position_embeddings, cfg.hidden_size,
            dtype=cfg.param_dtype, device=device))
        self.layers = nn.ModuleList(ParallelDecoderBlock(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = FusedLayerNorm(cfg.hidden_size, cfg.layernorm_eps,
                                         param_dtype=cfg.param_dtype,
                                         device=device)
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    @property
    def device(self) -> torch.device:
        return self.position_embeddings.device

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights (CPU ``generator``): normal(0.02)
        embeddings, LeCun-normal linears, zero biases, unit norms.
        Quantized linears keep their placeholders."""
        self.word_embeddings.reset_parameters(generator)
        with torch.no_grad():
            self.position_embeddings.copy_(torch.randn(
                self.position_embeddings.shape, generator=generator) * 0.02)
        for blk in self.layers:
            for lin in (blk.qkv, blk.out_proj, blk.mlp_in, blk.mlp_out):
                lin.reset_parameters(generator)

    def forward(self, input_ids, cache=None):
        cfg = self.config
        dt = resolve_compute_dtype(cfg.dtype)
        b, s = input_ids.shape
        x = self.word_embeddings(input_ids)
        pos = self.position_embeddings
        ring = cp_ring(cfg) if cache is None else None
        if cache is not None and cfg.context_parallel:
            raise ValueError("incremental decoding does not compose with "
                             "context parallelism; decode on a dp/tp mesh "
                             "instead")
        if ring is not None:
            # the position rows of the global positions held here
            if global_length(ring, s) > cfg.max_position_embeddings:
                raise ValueError(
                    f"global sequence {global_length(ring, s)} (cp = "
                    f"{ring.size}) exceeds max_position_embeddings="
                    f"{cfg.max_position_embeddings}")
            pos_s = pos[context_positions(
                ring, s, zigzag=cfg.context_parallel_zigzag,
                device=pos.device)][None]
        elif cache is None:
            if s > cfg.max_position_embeddings:
                raise ValueError(f"sequence {s} exceeds "
                                 f"max_position_embeddings="
                                 f"{cfg.max_position_embeddings}")
            pos_s = pos[:s][None]
        elif is_paged(cache):
            idx = (cache["len"].long()[:, None]
                   + torch.arange(s, device=x.device)[None, :]).clamp(
                0, cfg.max_position_embeddings - 1)              # (b, s)
            pos_s = pos[idx]
        else:
            t0 = check_chunk_bounds(cache, s, cfg.max_position_embeddings)
            pos_s = pos[t0:t0 + s][None]
        x = (x + pos_s).to(dt)
        new_layers = []
        for i, blk in enumerate(self.layers):
            if cache is None:
                x = blk(x)
            else:
                x, lc = blk(x, cache=layer_cache(cache, i))
                new_layers.append(lc)
        x = self.final_norm(x)
        logits = self.word_embeddings.attend(x.to(dt))
        if cache is None:
            return logits
        return logits, advance_cache(cache, new_layers, s)


def cp_ring(cfg):
    """The context-parallel ring a no-cache forward attends over: the
    installed one under ``context_parallel``, else None (the reference's
    ``context_parallel and _axis_bound(CONTEXT_AXIS)``)."""
    return (parallel_state.get_context_parallel_ring()
            if cfg.context_parallel else None)


def lm_token_loss(logits: torch.Tensor, labels: torch.Tensor,
                  ring=None) -> torch.Tensor:
    """Mean next-token loss at tensor-parallel size 1 (the reference's
    unbound branch): logits cast to fp32, ``log_softmax``, mean NLL of
    ``labels``. Over a distributed context-parallel ``ring`` its value is
    the mean over the ring's equal chunks (the reference's CP ``pmean``)
    and its gradient this rank's own loss's: after every rank's backward,
    average the gradients over the ring's group, as the reference's
    example does (``examples/long_context``). The in-process ring holds the
    whole sequence, so its mean is already the ring's."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, labels.long()[..., None])[..., 0].mean()
    if ring is not None and not ring.local and ring.size > 1:
        mean = loss.detach().clone()
        torch.distributed.all_reduce(mean, group=ring.group)
        loss = loss + (mean / ring.size - loss.detach())
    return loss


def gpt_loss(model: GPTModel, input_ids: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token loss of ``model`` on ``input_ids`` (the no-cache
    forward), as ``apex_tpu.models.gpt.gpt_loss`` at tp=1; under context
    parallelism the mean over the ring's tokens."""
    return lm_token_loss(model(input_ids), labels,
                         ring=cp_ring(model.config))
