"""GPT (pre-LN decoder) at tensor-parallel size 1.

Counterpart of ``apex_tpu/models/gpt.py`` (``GPTConfig``,
``gpt2_small_config``, ``gpt_tiny_config``, ``ParallelDecoderBlock``,
``GPTModel``, ``lm_token_loss``, ``gpt_loss``) in its three paths:

- no cache: causal flash attention over the whole sequence; the training
  path, differentiable end to end (the LayerNorm and flash kernels have
  their backward kernels);
- a contiguous cache: the static prefill (length 0, more than one token)
  rides the flash kernel, later chunks the dense ``cached_attention``;
- a paged cache: each slot's K/V chunk is written into its pages and the
  paged-attention kernel attends over the block table, at per-slot
  positions ``clip(len + arange(s))``.

dtype flow as in the reference: ``x = (emb + pos).to(dtype)``; each
LayerNorm reads and writes x's dtype; linears cast their fp32 weights to
x's dtype; the tied LM head returns logits in ``dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.models.generation import (advance_cache, cached_attention,
                                              check_chunk_bounds, is_paged,
                                              is_static_prefill, layer_cache,
                                              update_layer_cache,
                                              update_paged_layer_cache)
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.paged_attention import paged_attention
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

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


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
        kw = dict(world_size=tp, params_dtype=pd, device=device)
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
        dt = cfg.dtype
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
                                  cache["len"] + s)
        elif cache is not None:
            prefill = is_static_prefill(cache, s)
            cache = update_layer_cache(cache, to_bhsd(k), to_bhsd(v))
            if prefill:
                ctx = flash_attention(to_bhsd(q), to_bhsd(k), to_bhsd(v),
                                      causal=True)
            else:
                ctx = cached_attention(to_bhsd(q), cache)
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
        embeddings, LeCun-normal linears, zero biases, unit norms."""
        self.word_embeddings.reset_parameters(generator)
        with torch.no_grad():
            self.position_embeddings.copy_(torch.randn(
                self.position_embeddings.shape, generator=generator) * 0.02)
        for blk in self.layers:
            for lin in (blk.qkv, blk.out_proj, blk.mlp_in, blk.mlp_out):
                lin.reset_parameters(generator)

    def forward(self, input_ids, cache=None):
        cfg = self.config
        b, s = input_ids.shape
        x = self.word_embeddings(input_ids)
        pos = self.position_embeddings
        if cache is None:
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
        x = (x + pos_s).to(cfg.dtype)
        new_layers = []
        for i, blk in enumerate(self.layers):
            if cache is None:
                x = blk(x)
            else:
                x, lc = blk(x, cache=layer_cache(cache, i))
                new_layers.append(lc)
        x = self.final_norm(x)
        logits = self.word_embeddings.attend(x.to(cfg.dtype))
        if cache is None:
            return logits
        return logits, advance_cache(cache, new_layers, s)


def lm_token_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token loss at tensor-parallel size 1 (the reference's
    unbound branch): logits cast to fp32, ``log_softmax``, mean NLL of
    ``labels``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0].mean()


def gpt_loss(model: GPTModel, input_ids: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token loss of ``model`` on ``input_ids`` (the no-cache
    forward), as ``apex_tpu.models.gpt.gpt_loss`` at tp=1."""
    return lm_token_loss(model(input_ids), labels)
