"""T5-family encoder-decoder (RMSNorm, relative-position bias, bias-free
linears, unscaled attention) at tensor-parallel size 1, served and trained.

Counterpart of ``apex_tpu/models/t5.py`` (``T5Config``, ``t5_tiny_config``,
``relative_position_bucket``, ``T5RelativeBias``, ``_T5SelfAttention``,
``_T5CrossAttention``, ``_T5FFN``, ``T5EncoderBlock``, ``T5DecoderBlock``,
``T5Model``, ``t5_loss``, ``_validate_t5_decode``, ``t5_generate``), with the
reference's names and dtype flow:

- every self-attention call passes the shared relative-position bias
  ``(1, H, Sq, Sk)`` through the flash kernel's additive bias (the encoder
  non-causal, the decoder causal); cross-attention is non-causal flash
  with no bias, Sq against the encoder's Sk; every call has ``scale=1.0``
  (T5 folds 1/sqrt(d) into its init);
- a contiguous decode cache: the static prefill (length 0, more than one
  token) rides flash with the bias sliced to the chunk square, later
  chunks (the start token included) the dense ``cached_attention`` with
  the ``(1, H, s, T)`` bias; the encoder K/V are projected once, on the
  first call, into each layer's ``ck``/``cv``; a paged cache raises the
  reference's ``NotImplementedError``;
- training through ``t5_loss`` on the teacher-forced forward: the RMSNorm
  and flash kernels are ``autograd.Function``s whose backward is a kernel
  on the card. As in the reference the flash bias gets a zero gradient,
  so both relative-bias tables train to nothing (their gradients are
  exactly 0).

dtype flow as in the reference: ``x = shared(ids).to(dtype)``, the bias
tables cast to ``dtype``; each RMSNorm (fp32 weight) reads and writes x's
dtype; linears cast their ``param_dtype`` weights to x's dtype; the tied
head multiplies by ``d_model ** -0.5`` before ``attend``. ``t5_generate`` is
the port's own greedy loop, as ``generate`` is, not a ``lax.scan``.
Sampled decode, ``quantize_int8`` and ``tensor_parallel_size > 1`` raise,
naming ROADMAP items A6, A7 and A10.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.amp.policy import resolve_compute_dtype
from apex_tpu_torch.models.generation import (_greedy_token, advance_cache,
                                              cached_attention,
                                              check_chunk_bounds, init_cache,
                                              is_paged, is_static_prefill,
                                              layer_cache, update_layer_cache)
from apex_tpu_torch.models.gpt import lm_token_loss
from apex_tpu_torch.normalization import FusedRMSNorm
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_ff: int = 2048
    num_layers: int = 6                  # encoder AND decoder depth
    num_heads: int = 8
    head_dim: int = 64                   # T5 decouples d_kv from d_model
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    rms_eps: float = 1e-6
    ff_act: str = "relu"                 # "relu" (v1.0) | "gated-gelu" (v1.1)
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    tensor_parallel_size: int = 1
    decoder_start_token_id: int = 0      # T5 convention: pad id starts decode
    # v1.0 ties the LM head to the shared embedding with the d_model^-0.5
    # rescale; v1.1 (gated-gelu) unties it and drops the rescale
    tie_word_embeddings: bool = True
    quantize_int8: bool = False
    # cap of the decode cache and bias tables
    max_position_embeddings: int = 512


def t5_tiny_config(**overrides) -> T5Config:
    base = T5Config(vocab_size=128, d_model=64, d_ff=128, num_layers=2,
                    num_heads=4, head_dim=16, max_position_embeddings=128,
                    dtype=torch.float32)
    return dataclasses.replace(base, **overrides)


def _refuse_unported(cfg: T5Config) -> None:
    """Name each configured feature this slice does not carry."""
    if cfg.tensor_parallel_size != 1:
        raise NotImplementedError(
            "T5Config tensor_parallel_size > 1 is not ported yet (ROADMAP "
            "queue A item 10: tensor-parallel serving)")
    if cfg.quantize_int8:
        raise NotImplementedError(
            "T5Config quantize_int8 is not ported yet (ROADMAP queue A item "
            "7: the rest of quantized decode)")
    if cfg.ff_act not in ("relu", "gated-gelu"):
        raise ValueError(f"unknown ff_act {cfg.ff_act!r}")


def relative_position_bucket(rel: torch.Tensor, *, bidirectional: bool,
                             num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5's log-binned bucket of ``rel = k_pos - q_pos`` (the HF/mesh-tf
    formula): half the buckets exact, half log-spaced up to
    ``max_distance``. The log branch keeps the reference's fp32 order of
    operations (``n / max_exact``, ``log``, divide by the fp32 constant
    ``log(max_distance / max_exact)``, multiply, truncate), since at n =
    16, 32 and 64 the exact value is an integer and one ulp moves a bucket."""
    ret = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel > 0).to(rel.dtype) * num_buckets
        n = rel.abs()
    else:
        n = torch.clamp(-rel, min=0)     # causal: only the past is bucketed
    max_exact = num_buckets // 2
    is_small = n < max_exact
    f32 = dict(dtype=torch.float32, device=rel.device)
    # guard log(0); masked to the exact branch anyway
    ratio = torch.clamp(n, min=1).to(torch.float32) / torch.tensor(
        float(max_exact), **f32)
    val_large = max_exact + (
        torch.log(ratio) / torch.tensor(math.log(max_distance / max_exact),
                                        **f32)
        * torch.tensor(float(num_buckets - max_exact), **f32)).to(rel.dtype)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


class T5RelativeBias(nn.Module):
    """The shared bias table ``rel_attn_bias`` (num_buckets, num_heads) ->
    additive bias ``(1, H, s_q, s_k)`` for self-attention, contiguous, in
    ``param_dtype``."""

    def __init__(self, config: T5Config, bidirectional: bool = True,
                 device=None):
        super().__init__()
        self.config = config
        self.bidirectional = bidirectional
        self.rel_attn_bias = nn.Parameter(torch.empty(
            config.relative_attention_num_buckets, config.num_heads,
            dtype=config.param_dtype, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal(0.02), drawn on ``generator``'s device."""
        with torch.no_grad():
            self.rel_attn_bias.copy_(torch.randn(
                self.rel_attn_bias.shape, generator=generator,
                device=generator.device) * 0.02)

    def buckets(self, q_pos: torch.Tensor, k_pos: torch.Tensor):
        """int32 ``(s_q, s_k)`` bucket of each (query, key) position pair."""
        cfg = self.config
        rel = (k_pos[None, :] - q_pos[:, None]).to(torch.int32)
        return relative_position_bucket(
            rel, bidirectional=self.bidirectional,
            num_buckets=cfg.relative_attention_num_buckets,
            max_distance=cfg.relative_attention_max_distance)

    def forward(self, q_pos: torch.Tensor, k_pos: torch.Tensor):
        bias = self.rel_attn_bias[self.buckets(q_pos, k_pos).long()]
        return bias.permute(2, 0, 1)[None].contiguous()   # (1, H, s_q, s_k)


def _linear(cfg: T5Config, n_in: int, n_out: int, device, column: bool):
    kw = dict(bias=False, params_dtype=cfg.param_dtype, device=device)
    if column:
        return ColumnParallelLinear(n_in, n_out, gather_output=False, **kw)
    return RowParallelLinear(n_in, n_out, input_is_parallel=True, **kw)


class _T5SelfAttention(nn.Module):
    """Bias-free QKV and out projections, unscaled flash attention with the
    shared relative bias; cache-aware for incremental decoding."""

    def __init__(self, config: T5Config, causal: bool = False, device=None):
        super().__init__()
        cfg = config
        inner = cfg.num_heads * cfg.head_dim
        self.config, self.causal = cfg, causal
        self.qkv = _linear(cfg, cfg.d_model, 3 * inner, device, True)
        self.out = _linear(cfg, inner, cfg.d_model, device, False)

    def forward(self, h, bias, cache=None):
        cfg = self.config
        n_h, d = cfg.num_heads, cfg.head_dim
        b, s, _ = h.shape
        q, k, v = self.qkv(h).chunk(3, dim=-1)

        def to_bhsd(t):
            return t.reshape(b, s, n_h, d).transpose(1, 2)

        if cache is not None:
            prefill = is_static_prefill(cache, s)
            cache = update_layer_cache(cache, to_bhsd(k), to_bhsd(v))
            if prefill:
                ctx = flash_attention(to_bhsd(q), to_bhsd(k), to_bhsd(v),
                                      bias=bias, causal=self.causal,
                                      scale=1.0)
            else:
                ctx = cached_attention(to_bhsd(q), cache, bias=bias,
                                       scale=1.0)
        else:
            ctx = flash_attention(to_bhsd(q), to_bhsd(k), to_bhsd(v),
                                  bias=bias, causal=self.causal, scale=1.0)
        out = self.out(ctx.transpose(1, 2).reshape(b, s, n_h * d))
        return (out, cache) if cache is not None else out


class _T5CrossAttention(nn.Module):
    """Decoder-to-encoder attention. At decode time the encoder K/V are
    projected ONCE (on the first call, when the cache view lacks them) and
    reused every step."""

    def __init__(self, config: T5Config, device=None):
        super().__init__()
        cfg = config
        inner = cfg.num_heads * cfg.head_dim
        self.config = cfg
        self.q = _linear(cfg, cfg.d_model, inner, device, True)
        self.kv = _linear(cfg, cfg.d_model, 2 * inner, device, True)
        self.out = _linear(cfg, inner, cfg.d_model, device, False)

    def forward(self, h, enc, cache=None):
        cfg = self.config
        n_h, d = cfg.num_heads, cfg.head_dim
        b, s, _ = h.shape

        def to_bhsd(t, length):
            return t.reshape(b, length, n_h, d).transpose(1, 2)

        if cache is not None and "ck" in cache:
            ck, cv = cache["ck"], cache["cv"]
        else:
            k, v = self.kv(enc).chunk(2, dim=-1)
            ck, cv = to_bhsd(k, enc.shape[1]), to_bhsd(v, enc.shape[1])
            if cache is not None:
                cache = dict(cache, ck=ck, cv=cv)
        ctx = flash_attention(to_bhsd(self.q(h), s), ck, cv, scale=1.0)
        out = self.out(ctx.transpose(1, 2).reshape(b, s, n_h * d))
        return (out, cache) if cache is not None else out


class _T5FFN(nn.Module):
    """relu (v1.0) or gated-gelu (v1.1: gate and up in one GEMM,
    ``gelu(gate, approximate="tanh") * up``)."""

    def __init__(self, config: T5Config, device=None):
        super().__init__()
        cfg = config
        self.gated = cfg.ff_act == "gated-gelu"
        width = 2 * cfg.d_ff if self.gated else cfg.d_ff
        self.wi = _linear(cfg, cfg.d_model, width, device, True)
        self.wo = _linear(cfg, cfg.d_ff, cfg.d_model, device, False)

    def forward(self, h):
        if self.gated:
            gate, up = self.wi(h).chunk(2, dim=-1)
            act = F.gelu(gate, approximate="tanh") * up
        else:
            act = F.relu(self.wi(h))
        return self.wo(act)


class T5EncoderBlock(nn.Module):
    def __init__(self, config: T5Config, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.attn_norm = FusedRMSNorm(cfg.d_model, cfg.rms_eps,
                                      device=device)
        self.self_attn = _T5SelfAttention(cfg, causal=False, device=device)
        self.ffn_norm = FusedRMSNorm(cfg.d_model, cfg.rms_eps, device=device)
        self.ffn = _T5FFN(cfg, device=device)

    def forward(self, x, bias):
        dt = resolve_compute_dtype(self.config.dtype)
        h = self.attn_norm(x)
        x = x + self.self_attn(h.to(dt), bias).to(x.dtype)
        h = self.ffn_norm(x)
        return x + self.ffn(h.to(dt)).to(x.dtype)


class T5DecoderBlock(nn.Module):
    def __init__(self, config: T5Config, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.attn_norm = FusedRMSNorm(cfg.d_model, cfg.rms_eps,
                                      device=device)
        self.self_attn = _T5SelfAttention(cfg, causal=True, device=device)
        self.cross_norm = FusedRMSNorm(cfg.d_model, cfg.rms_eps,
                                       device=device)
        self.cross_attn = _T5CrossAttention(cfg, device=device)
        self.ffn_norm = FusedRMSNorm(cfg.d_model, cfg.rms_eps, device=device)
        self.ffn = _T5FFN(cfg, device=device)

    def forward(self, x, enc, bias, cache=None):
        dt = resolve_compute_dtype(self.config.dtype)
        h = self.attn_norm(x)
        if cache is None:
            attn = self.self_attn(h.to(dt), bias)
        else:
            attn, cache = self.self_attn(h.to(dt), bias, cache=cache)
        x = x + attn.to(x.dtype)
        h = self.cross_norm(x)
        if cache is None:
            cross = self.cross_attn(h.to(dt), enc)
        else:
            cross, cache = self.cross_attn(h.to(dt), enc, cache=cache)
        x = x + cross.to(x.dtype)
        h = self.ffn_norm(x)
        out = x + self.ffn(h.to(dt)).to(x.dtype)
        return out if cache is None else (out, cache)


class T5Model(nn.Module):
    """Encoder-decoder LM. ``forward(encoder_ids, decoder_ids)`` returns the
    logits ``[B, S_dec, vocab]`` over the decoder positions (teacher
    forcing); ``encode``/``decode`` split the two halves for generation.
    The LM head is the tied embedding scaled by ``d_model ** -0.5``, or an
    untied unscaled ``lm_head``."""

    def __init__(self, config: T5Config, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        _refuse_unported(cfg)
        self.config = cfg
        self.shared = VocabParallelEmbedding(
            cfg.vocab_size, cfg.d_model, params_dtype=cfg.param_dtype,
            device=device)
        self.enc_rel_bias = T5RelativeBias(cfg, bidirectional=True,
                                           device=device)
        self.dec_rel_bias = T5RelativeBias(cfg, bidirectional=False,
                                           device=device)
        self.enc_blocks = nn.ModuleList(T5EncoderBlock(cfg, device=device)
                                        for _ in range(cfg.num_layers))
        self.dec_blocks = nn.ModuleList(T5DecoderBlock(cfg, device=device)
                                        for _ in range(cfg.num_layers))
        self.enc_final_norm = FusedRMSNorm(cfg.d_model, cfg.rms_eps,
                                           device=device)
        self.dec_final_norm = FusedRMSNorm(cfg.d_model, cfg.rms_eps,
                                           device=device)
        self.lm_head = None if cfg.tie_word_embeddings else _linear(
            cfg, cfg.d_model, cfg.vocab_size, device, True)
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    @property
    def device(self) -> torch.device:
        return self.shared.weight.device

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights: normal(0.02) embedding and bias tables,
        LeCun-normal linears and head, unit norms; drawn on
        ``generator``'s device."""
        self.shared.reset_parameters(generator)
        self.enc_rel_bias.reset_parameters(generator)
        self.dec_rel_bias.reset_parameters(generator)
        for m in self.modules():
            if isinstance(m, (ColumnParallelLinear, RowParallelLinear)):
                m.reset_parameters(generator)

    def _lm_logits(self, x):
        if self.lm_head is None:
            return self.shared.attend(x * (self.config.d_model ** -0.5))
        return self.lm_head(x)

    def encode(self, encoder_ids):
        cfg = self.config
        dt = resolve_compute_dtype(cfg.dtype)
        pos = torch.arange(encoder_ids.shape[1], device=self.device)
        bias = self.enc_rel_bias(pos, pos).to(dt)
        x = self.shared(encoder_ids).to(dt)
        for blk in self.enc_blocks:
            x = blk(x, bias)
        return self.enc_final_norm(x).to(dt)

    def decode(self, decoder_ids, enc, cache=None):
        """Teacher-forced (``cache=None``) logits, or ``(logits, cache)`` of
        an incremental decode chunk against a computed encoder
        representation. The cache layout is ``generation.init_cache``'s,
        with each layer's encoder K/V ``ck``/``cv`` added by the first
        call."""
        cfg = self.config
        dt = resolve_compute_dtype(cfg.dtype)
        s = decoder_ids.shape[1]
        x = self.shared(decoder_ids).to(dt)
        if cache is None:
            pos = torch.arange(s, device=self.device)
            bias = self.dec_rel_bias(pos, pos).to(dt)
            for blk in self.dec_blocks:
                x = blk(x, enc, bias)
            return self._lm_logits(self.dec_final_norm(x).to(dt))
        if is_paged(cache):
            raise NotImplementedError(
                "paged serving decode (apex_tpu/serving) covers the "
                "decoder-only families (GPT, Llama); T5 needs per-slot "
                "relative-position bias and paged cross-attention")
        t0 = check_chunk_bounds(cache, s, cfg.max_position_embeddings)
        t_max = cache["layers"][0]["k"].shape[2]
        q_pos = t0 + torch.arange(s, device=self.device)
        k_pos = torch.arange(t_max, device=self.device)
        bias = self.dec_rel_bias(q_pos, k_pos).to(dt)
        # the flash prefill sees only the chunk's keys, not the whole
        # buffer: the bias sliced to the chunk square
        bias_prefill = bias[:, :, :, :s]
        new_layers = []
        for i, blk in enumerate(self.dec_blocks):
            lc = layer_cache(cache, i)
            blk_bias = bias_prefill if is_static_prefill(lc, s) else bias
            x, lc = blk(x, enc, blk_bias, cache=lc)
            new_layers.append(lc)
        logits = self._lm_logits(self.dec_final_norm(x).to(dt))
        # ck/cv ride each layer dict (advance_cache keeps extras)
        return logits, advance_cache(cache, new_layers, s)

    def forward(self, encoder_ids, decoder_ids):
        return self.decode(decoder_ids, self.encode(encoder_ids))


def t5_loss(model: T5Model, encoder_ids: torch.Tensor,
            decoder_ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token loss over the decoder positions (teacher forcing), as
    ``apex_tpu.models.t5.t5_loss`` at tp=1."""
    return lm_token_loss(model(encoder_ids, decoder_ids), labels)


def _validate_t5_decode(cfg: T5Config, max_new_tokens: int) -> None:
    """The start token and the generated tokens must fit the cache and the
    bias tables."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if max_new_tokens + 1 > cfg.max_position_embeddings:
        raise ValueError(
            f"max_new_tokens={max_new_tokens} exceeds the decode cap "
            f"max_position_embeddings={cfg.max_position_embeddings}")


@torch.no_grad()
def t5_generate(model: T5Model, encoder_ids, max_new_tokens: int, *,
                temperature: float = 0.0, top_k: Optional[int] = None,
                top_p: Optional[float] = None, rng: Optional[int] = None,
                eos_token_id: Optional[int] = None):
    """Encode once, prefill the ``decoder_start_token_id`` (a one-token
    chunk, so the dense cached path), then ``max_new_tokens - 1``
    single-token steps through ``generation.decode_loop``: greedy at
    temperature 0, else sampled as ``generate`` samples (an int seed
    ``rng``); after ``eos_token_id`` a row keeps emitting EOS. Returns the
    ``(batch, max_new_tokens)`` int32 decoder tokens (the start token not
    included)."""
    from apex_tpu_torch.models.generation import (decode_loop,
                                                  validate_sampling)

    cfg = model.config
    _validate_t5_decode(cfg, max_new_tokens)
    rng = validate_sampling(temperature, top_k, top_p, rng)
    enc, logits, cache = _t5_prefill(model, encoder_ids, max_new_tokens)
    return decode_loop(lambda tok, c: model.decode(tok[:, None], enc, c),
                       logits, cache, max_new_tokens,
                       temperature=temperature, top_k=top_k, top_p=top_p,
                       rng=rng, eos_token_id=eos_token_id)


def _t5_prefill(model: T5Model, encoder_ids, max_new_tokens: int):
    """The encoder output, the start token's logits and the decoder cache
    after it, at the encoder batch."""
    cfg = model.config
    encoder_ids = torch.as_tensor(encoder_ids, device=model.device).to(
        torch.int32)
    b = encoder_ids.shape[0]
    enc = model.encode(encoder_ids)
    cache = init_cache(cfg, b, max_new_tokens + 1, device=model.device)
    start = torch.full((b, 1), cfg.decoder_start_token_id, dtype=torch.int32,
                       device=model.device)
    logits, cache = model.decode(start, enc, cache)
    return enc, logits, cache


@torch.no_grad()
def t5_beam_search(model: T5Model, encoder_ids, max_new_tokens: int, *,
                   num_beams: int, eos_token_id: Optional[int] = None,
                   length_penalty: float = 1.0):
    """Beam-search decode of the encoder-decoder family: encode and prefill
    the start token once at batch b, replicate the cache (its cross
    ``ck``/``cv`` included) and the encoder output per beam, run
    ``generation.beam_search_loop`` (``length_offset`` 0: the start token
    is not counted). Returns ``(sequences (b, num_beams, max_new_tokens),
    scores (b, num_beams))``, best beam first."""
    from apex_tpu_torch.models.generation import (beam_search_loop,
                                                  repeat_cache)

    cfg = model.config
    if num_beams < 1:
        raise ValueError("num_beams must be >= 1")
    _validate_t5_decode(cfg, max_new_tokens)
    enc, logits, cache = _t5_prefill(model, encoder_ids, max_new_tokens)
    b = enc.shape[0]
    cache = repeat_cache(cache, num_beams)
    logits = logits.repeat_interleave(num_beams, dim=0)
    enc_rep = enc.repeat_interleave(num_beams, dim=0)
    return beam_search_loop(
        lambda tok, c: model.decode(tok[:, None], enc_rep, c), logits, cache,
        max_new_tokens, batch=b, num_beams=num_beams,
        eos_token_id=eos_token_id, length_penalty=length_penalty)
