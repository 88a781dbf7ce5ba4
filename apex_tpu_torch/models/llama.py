"""Llama-family decoder (RMSNorm + RoPE + SwiGLU + GQA, optional sliding
window) at tensor-parallel size 1, for serving and training.

Counterpart of ``apex_tpu/models/llama.py`` (``LlamaConfig``,
``llama_tiny_config``, ``_rope_freqs``, ``_rope_cos_sin``,
``LlamaDecoderBlock``, ``LlamaModel``, ``llama_loss``) in its four
attention paths:

- no cache: causal flash attention over the whole sequence, banded under
  ``sliding_window``;
- no cache under ``context_parallel`` with a ring installed
  (``transformer.parallel_state``): ``ring_attention(causal=True,
  window=sliding_window)``, or ``ring_attention_zigzag`` under
  ``context_parallel_zigzag``, with RoPE at the tokens' global positions
  (``context_positions``: the rank's chunk, or zigzag's two half-chunks;
  over the in-process ring the model holds the whole sequence in the
  layout's order);
- a contiguous cache: the static prefill (length 0, more than one token)
  rides the windowed flash kernel, later chunks the dense banded
  ``cached_attention``;
- a paged cache: each slot's RoPE'd K/V chunk is written into its pages and
  the paged-attention kernel attends over the block table under the window,
  with per-slot RoPE tables gathered at positions ``clip(len + arange(s))``.

Mistral-7B is the Llama family with GQA and ``sliding_window``
(:func:`mistral_7b_config`). dtype flow as in the reference: ``x =
emb(ids).to(dtype)``; each RMSNorm (fp32 weight) reads and writes x's
dtype; linears cast their ``param_dtype`` weights to x's dtype; the untied
LM head returns logits in ``dtype``. The blocks' five linears take the
weight policy (``weight_policy``/``quantize_int8``) through the quantized
tp=1 linears; embeddings, norms and the head stay in ``param_dtype``.

Training goes through ``llama_loss`` on the no-cache forward: the RMSNorm
and (windowed) flash kernels are ``autograd.Function``s whose backward is a
kernel on the card; RoPE, SwiGLU and the linears are plain differentiable
torch. ``remat`` recomputes each decoder block in the backward
(``torch.utils.checkpoint``, as the reference's ``nn.remat``), so the
forward kernels of a block launch twice per step. Fields this slice does
not carry raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.amp.policy import resolve_compute_dtype
from apex_tpu_torch.models.generation import (advance_cache, cached_attention,
                                              check_chunk_bounds, is_paged,
                                              is_static_prefill, layer_cache,
                                              update_layer_cache,
                                              update_paged_layer_cache)
from apex_tpu_torch.models.gpt import cp_ring, lm_token_loss
from apex_tpu_torch.normalization import FusedRMSNorm
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.paged_attention import paged_attention
from apex_tpu_torch.ops.quant import WeightPrecisionPolicy
from apex_tpu_torch.ops.ring_attention import (context_positions,
                                               global_length, ring_attention,
                                               ring_attention_zigzag)
from apex_tpu_torch.transformer.functional.fused_rope import (
    fused_apply_rotary_pos_emb_cached)
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008       # SwiGLU inner width
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32               # < num_heads => GQA
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    tensor_parallel_size: int = 1
    context_parallel: bool = False
    context_parallel_zigzag: bool = False
    tie_word_embeddings: bool = False
    # Mistral-style sliding window: key j is visible to the query at
    # position p iff p - window < j <= p
    sliding_window: Optional[int] = None
    rolling_cache: bool = False
    num_experts: int = 0
    moe_layer_freq: int = 2
    moe_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coeff: float = 1e-2
    moe_z_loss_coeff: float = 0.0
    expert_parallel: bool = False
    quantize_int8: bool = False
    weight_policy: Any = None
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def weight_quant(self) -> Optional[WeightPrecisionPolicy]:
        """The resolved policy, or None for full-precision weights."""
        return WeightPrecisionPolicy.resolve(self.weight_policy,
                                             self.quantize_int8)


def llama_tiny_config(**overrides) -> LlamaConfig:
    base = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=176,
                       num_layers=2, num_heads=4, num_kv_heads=2,
                       max_position_embeddings=128, dtype=torch.float32)
    return dataclasses.replace(base, **overrides)


def mistral_7b_config(**overrides) -> LlamaConfig:
    """Mistral-7B-v0.1, from its published ``config.json``
    (huggingface.co/mistralai/Mistral-7B-v0.1): 7,241,732,096 parameters."""
    base = LlamaConfig(vocab_size=32000, hidden_size=4096,
                       intermediate_size=14336, num_layers=32, num_heads=32,
                       num_kv_heads=8, max_position_embeddings=32768,
                       rope_theta=10000.0, rms_eps=1e-5, sliding_window=4096,
                       tie_word_embeddings=False)
    return dataclasses.replace(base, **overrides)


def _refuse_unported(cfg: LlamaConfig) -> None:
    """Name each configured feature this slice does not carry."""
    unported = [
        (cfg.num_experts > 0, "num_experts > 0 (mixture of experts)",
         "queue A item 12: transformer/moe"),
        (cfg.tensor_parallel_size != 1, "tensor_parallel_size > 1",
         "queue A item 10: tensor-parallel serving"),
        (cfg.rolling_cache, "rolling_cache (the ring-buffer KV cache; the "
         "paged pool drops pages below the window instead)",
         "queue A item 8: the rest of Llama serving"),
    ]
    for configured, what, item in unported:
        if configured:
            raise NotImplementedError(
                f"LlamaConfig {what} is not ported yet (ROADMAP {item})")
    if cfg.num_heads % cfg.num_kv_heads != 0:
        raise ValueError(f"num_heads ({cfg.num_heads}) must be a multiple of "
                         f"num_kv_heads ({cfg.num_kv_heads})")


def _rope_freqs(cfg: LlamaConfig, pos: torch.Tensor):
    """cos/sin rows ``(n, head_dim)`` for a vector of absolute positions,
    rotate-half layout ``[first half | second half]``."""
    d = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=pos.device) / d))
    ang = pos.to(torch.float32)[:, None] * inv[None, :]          # (n, d/2)
    freqs = torch.cat([ang, ang], dim=-1)                         # (n, d)
    return torch.cos(freqs), torch.sin(freqs)


def _rope_cos_sin(cfg: LlamaConfig, s: int, offset: int, device):
    """cos/sin tables ``(s, 1, 1, head_dim)`` for positions ``[offset,
    offset + s)``, the cached-RoPE layout ``[sq, b, np, hn]``."""
    return _rope_at(cfg, torch.arange(s, device=device) + offset)


def _rope_at(cfg: LlamaConfig, pos: torch.Tensor):
    """cos/sin tables ``(n, 1, 1, head_dim)`` at the positions ``pos``."""
    cos, sin = _rope_freqs(cfg, pos)
    return cos[:, None, None, :], sin[:, None, None, :]


class LlamaDecoderBlock(nn.Module):
    """Pre-RMSNorm block: attention (RoPE + GQA flash or paged, banded under
    the window) -> residual -> SwiGLU MLP -> residual."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        cfg = config
        e, d = cfg.hidden_size, cfg.head_dim
        pol = cfg.weight_quant()
        kw = dict(bias=False, world_size=cfg.tensor_parallel_size,
                  params_dtype=cfg.param_dtype, device=device,
                  quantize=pol.linears if pol else False,
                  quantize_group_size=pol.group_size if pol else 128)
        self.config = cfg
        self.input_norm = FusedRMSNorm(e, cfg.rms_eps, device=device)
        self.q_proj = ColumnParallelLinear(e, cfg.num_heads * d,
                                           gather_output=False, **kw)
        # [k | v], each num_kv_heads * d wide
        self.kv_proj = ColumnParallelLinear(e, 2 * cfg.num_kv_heads * d,
                                            gather_output=False, **kw)
        self.o_proj = RowParallelLinear(e, e, input_is_parallel=True, **kw)
        self.post_norm = FusedRMSNorm(e, cfg.rms_eps, device=device)
        # [gate | up], each intermediate_size wide
        self.gate_up_proj = ColumnParallelLinear(
            e, 2 * cfg.intermediate_size, gather_output=False, **kw)
        self.down_proj = RowParallelLinear(cfg.intermediate_size, e,
                                           input_is_parallel=True, **kw)

    def linears(self):
        return (self.q_proj, self.kv_proj, self.o_proj, self.gate_up_proj,
                self.down_proj)

    def forward(self, x, cos_, sin_, cache=None):
        cfg = self.config
        n_h, n_kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        window = cfg.sliding_window
        b, s, _ = x.shape

        dt = resolve_compute_dtype(cfg.dtype)
        h = self.input_norm(x).to(dt)
        q = self.q_proj(h)
        k, v = self.kv_proj(h).chunk(2, dim=-1)

        def rope(t, heads):        # (b, s, heads*d) -> (b, heads, s, d)
            t = t.reshape(b, s, heads, d).transpose(0, 1)   # (s, b, heads, d)
            t = fused_apply_rotary_pos_emb_cached(t, cos_, sin_)
            return t.permute(1, 2, 0, 3)

        q, k = rope(q, n_h), rope(k, n_kv)
        v = v.reshape(b, s, n_kv, d).transpose(1, 2)

        if cache is not None and is_paged(cache):
            cache = update_paged_layer_cache(cache, k, v)
            ctx = paged_attention(q, cache["k_pages"], cache["v_pages"],
                                  cache["block_tables"], cache["len"] + s,
                                  window=window,
                                  k_scales=cache.get("k_scales"),
                                  v_scales=cache.get("v_scales"))
        elif cache is not None:
            prefill = is_static_prefill(cache, s)
            cache = update_layer_cache(cache, k, v)
            if prefill:
                ctx = flash_attention(q, k, v, causal=True, window=window)
            else:
                ctx = cached_attention(q, cache, window=window)
        elif (ring := cp_ring(cfg)) is not None:
            if cfg.context_parallel_zigzag:
                ctx = ring_attention_zigzag(q, k, v, ring=ring,
                                            window=window)
            else:
                ctx = ring_attention(q, k, v, ring=ring, causal=True,
                                     window=window)
        else:
            ctx = flash_attention(q, k, v, causal=True, window=window)
        ctx = ctx.transpose(1, 2).reshape(b, s, n_h * d)
        x = x + self.o_proj(ctx).to(x.dtype)

        h = self.post_norm(x).to(dt)
        gate, up = self.gate_up_proj(h).chunk(2, dim=-1)
        out = x + self.down_proj(F.silu(gate) * up).to(x.dtype)
        return out if cache is None else (out, cache)


class LlamaModel(nn.Module):
    """Decoder-only LM; untied LM head unless ``tie_word_embeddings``.
    ``forward(input_ids)`` -> logits ``[B, S, vocab]``;
    ``forward(input_ids, cache=...)`` -> ``(logits, cache)``."""

    def __init__(self, config: LlamaConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        _refuse_unported(cfg)
        self.config = cfg
        self.embed_tokens = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, params_dtype=cfg.param_dtype,
            device=device)
        self.layers = nn.ModuleList(LlamaDecoderBlock(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = FusedRMSNorm(cfg.hidden_size, cfg.rms_eps,
                                       device=device)
        self.lm_head = None if cfg.tie_word_embeddings else \
            ColumnParallelLinear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 gather_output=False,
                                 params_dtype=cfg.param_dtype, device=device)
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights: normal(0.02) embeddings, LeCun-normal
        linears and head, unit norms; drawn on ``generator``'s device (a
        CUDA generator keeps a 7B init on the card). Quantized linears keep
        their placeholders."""
        self.embed_tokens.reset_parameters(generator)
        for blk in self.layers:
            for lin in blk.linears():
                lin.reset_parameters(generator)
        if self.lm_head is not None:
            self.lm_head.reset_parameters(generator)

    def forward(self, input_ids, cache=None):
        cfg = self.config
        b, s = input_ids.shape
        dt = resolve_compute_dtype(cfg.dtype)
        x = self.embed_tokens(input_ids).to(dt)
        dev = x.device
        ring = cp_ring(cfg) if cache is None else None
        if cache is not None and cfg.context_parallel:
            raise ValueError("incremental decoding does not compose with "
                             "context parallelism; decode on a dp/tp mesh "
                             "instead")
        if ring is not None:
            # RoPE at the global positions of the tokens held here
            if global_length(ring, s) > cfg.max_position_embeddings:
                raise ValueError(
                    f"global sequence {global_length(ring, s)} (cp = "
                    f"{ring.size}) exceeds max_position_embeddings="
                    f"{cfg.max_position_embeddings}")
            cos_, sin_ = _rope_at(cfg, context_positions(
                ring, s, zigzag=cfg.context_parallel_zigzag, device=dev))
        elif cache is None:
            if s > cfg.max_position_embeddings:
                raise ValueError(f"sequence {s} exceeds "
                                 f"max_position_embeddings="
                                 f"{cfg.max_position_embeddings}")
            cos_, sin_ = _rope_cos_sin(cfg, s, 0, dev)
        elif is_paged(cache):
            # per-slot positions [len, len + s), clipped into the table;
            # the tables ride the batch axis: (s, b, 1, d)
            pos = (cache["len"].long()[:, None]
                   + torch.arange(s, device=dev)[None, :]).clamp(
                0, cfg.max_position_embeddings - 1)                # (b, s)
            cos, sin = _rope_freqs(cfg, pos.reshape(-1))
            cos_ = cos.reshape(b, s, -1).transpose(0, 1)[:, :, None, :]
            sin_ = sin.reshape(b, s, -1).transpose(0, 1)[:, :, None, :]
        else:
            t0 = check_chunk_bounds(cache, s, cfg.max_position_embeddings)
            cos_, sin_ = _rope_cos_sin(cfg, s, t0, dev)
        new_layers = []
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, blk in enumerate(self.layers):
            if remat:
                x = checkpoint(blk, x, cos_, sin_, use_reentrant=False)
            elif cache is None:
                x = blk(x, cos_, sin_)
            else:
                x, lc = blk(x, cos_, sin_, cache=layer_cache(cache, i))
                new_layers.append(lc)
        x = self.final_norm(x).to(dt)
        logits = (self.embed_tokens.attend(x) if self.lm_head is None
                  else self.lm_head(x))
        if cache is None:
            return logits
        return logits, advance_cache(cache, new_layers, s)


def llama_loss(model: LlamaModel, input_ids: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token loss of ``model`` on ``input_ids`` (the no-cache
    forward), as ``apex_tpu.models.llama.llama_loss`` at tp=1 and no
    experts; under context parallelism the mean over the ring's tokens."""
    return lm_token_loss(model(input_ids), labels,
                         ring=cp_ring(model.config))
