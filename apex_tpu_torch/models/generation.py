"""Autoregressive decoding with a static-shape KV cache.

Counterpart of ``apex_tpu/models/generation.py``, in the pieces the serving
slices run: the contiguous cache (``init_cache``, ``layer_cache``,
``is_static_prefill``, ``update_layer_cache``, ``advance_cache``,
``cached_attention``, banded under a sliding window and with an additive
bias; the reference's rolling cache is not ported), the paged-cache write
(``is_paged``, ``update_paged_layer_cache``, with the quantized pool's
requantize-on-grow append), the greedy token, sampling (``filter_logits``,
``sample_noise``, ``_sample_token``, ``validate_sampling``,
``decode_loop``; the vocab-parallel logits of a model at
``tensor_parallel_size`` > 1 are gathered first, ``gather_vocab``),
lock-step ``generate`` greedy or sampled — the token-identity oracle of
the serving engine — beam search (``repeat_cache``,
``_gather_beam_cache``, ``beam_search_loop``, ``generate_beam``) and
greedy lock-step ``speculative_generate`` with its ``rollback_cache``.

Sampling filters as the reference does (temperature, then top-k, then
top-p against the exclusive cumulative mass) and draws ``argmax(filtered
+ gumbel)``, what ``jax.random.categorical`` computes. The Gumbel noise of
token ``i`` of stream ``r`` (a batch row, or a serving request) is a
counter-based hash of ``(seed, r, i)``: draws are scheduling-invariant by
construction. They follow threefry's distribution, not its bits; ``rng``
is an int seed (the reference's is a PRNG key).

Cache structure, as in the reference::

    cache = {"layers": [{"k": (b, kv, T, d), "v": ...}] * num_layers,
             "len": tokens already written (a Python int)}

A paged cache (``apex_tpu_torch/serving/kv_pool.py``) is recognized by its
``block_tables`` key, and its ``len`` is a ``(num_slots,)`` tensor.

Unlike the reference, whose arrays are immutable, the cache writes here
update the K/V buffers IN PLACE (the per-layer views share them); the
dictionaries themselves are rebuilt, so ``len`` never changes behind a
caller's back.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.amp.policy import resolve_compute_dtype
from apex_tpu_torch.ops.quant import kv_cast, kv_inverse, kv_qmax
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    gather_from_tensor_model_parallel_region)


def init_cache(config, batch: int, max_len: int, *, dtype=None,
               device="cuda"):
    """All-zeros contiguous KV cache for ``batch`` sequences of up to
    ``max_len`` tokens, of this rank's ``kv_heads / tensor_parallel_size``
    heads."""
    kv_heads = (getattr(config, "num_kv_heads", config.num_heads)
                // getattr(config, "tensor_parallel_size", 1))
    dt = (dtype if dtype is not None
          else resolve_compute_dtype(config.dtype))
    shape = (batch, kv_heads, max_len, config.head_dim)
    layers = [{"k": torch.zeros(shape, dtype=dt, device=device),
               "v": torch.zeros(shape, dtype=dt, device=device)}
              for _ in range(config.num_layers)]
    return {"layers": layers, "len": 0}


def is_paged(cache) -> bool:
    return "block_tables" in cache


def layer_cache(cache, i: int):
    """Per-layer view for decoder block ``i``: adds the shared length and,
    for a paged cache, the shared block tables."""
    lc = dict(cache["layers"][i])
    lc["len"] = cache["len"]
    if is_paged(cache):
        lc["block_tables"] = cache["block_tables"]
    return lc


def is_static_prefill(lc, s: int) -> bool:
    """True when this chunk is the first tokens of a contiguous cache: the
    block then attends with the flash kernel instead of the dense cached
    path."""
    return isinstance(lc["len"], int) and lc["len"] == 0 and s > 1


def is_flash_tail(lc, s: int) -> bool:
    """True when this chunk continues a contiguous cache whose layers are
    marked ``flash_tail`` (a shared-prefix admission's uncached tail): the
    block then attends with the flash kernel over the buffer's first ``len
    + s`` keys, as the cold prefill would, instead of the dense cached
    path."""
    return bool(lc.get("flash_tail")) and s > 1


def flash_tail_attention(q, lc, s: int, *, window: Optional[int] = None):
    """The flash kernel over the buffer's keys ``[0, len + s)`` for the
    ``(b, h, s, d)`` chunk at positions ``[len, len + s)`` (the chunk's K/V
    already written): causal at the default diagonal, so each row sees
    the keys the cold prefill shows it, and its output is that prefill's
    row bit for bit given the same K/V."""
    from apex_tpu_torch.ops.flash_attention import flash_attention

    t = lc["len"] + s
    return flash_attention(q, lc["k"][:, :, :t], lc["v"][:, :, :t],
                           causal=True, window=window)


def check_chunk_bounds(cache, s: int, max_position_embeddings: int) -> int:
    t0 = cache["len"]
    t_max = cache["layers"][0]["k"].shape[2]
    if t0 + s > max_position_embeddings:
        raise ValueError(f"decode chunk [{t0}, {t0 + s}) exceeds "
                         f"max_position_embeddings={max_position_embeddings}")
    if t0 + s > t_max:
        raise ValueError(f"decode chunk [{t0}, {t0 + s}) exceeds the cache "
                         f"buffer (max_len={t_max})")
    return t0


def update_layer_cache(lc, k_chunk, v_chunk):
    """Write a ``(b, kv, s, d)`` chunk at offset ``len`` (in place)."""
    t0, s = lc["len"], k_chunk.shape[2]
    lc["k"][:, :, t0:t0 + s] = k_chunk.to(lc["k"].dtype)
    lc["v"][:, :, t0:t0 + s] = v_chunk.to(lc["v"].dtype)
    return dict(lc)


def _append_quantized_pages(pages, scales, chunk, bt, t, ps: int,
                            max_pages: int, qmax: float) -> None:
    """Quantized-pool append with requantize-on-grow (in place), as the
    reference's: the ``s <= page_size`` chunk spans at most the boundary
    page and its successor, so two sequential rounds each (1) take the
    per-(slot, kv head) amax of the new tokens landing in that page, (2)
    grow the page's scale, ``new = max(old, amax / qmax)``, (3) rescale the
    page's existing codes by ``old / new`` (a ratio of 1, the common case,
    rewrites them bit for bit) and requantize, and (4) write the new tokens
    quantized at ``new``. Only pages at or past ``len // page_size`` are
    touched, so full pages stay bit-stable."""
    slots, _, s, _ = chunk.shape
    cf = chunk.float()
    pos = t[:, None] + torch.arange(s, device=t.device)[None, :]  # (slots, s)
    base = t // ps
    sl = torch.arange(slots, device=t.device)
    for j in (0, 1):
        ent = base + j
        pg = torch.gather(bt.long(), 1,
                          ent.clamp(0, max_pages - 1)[:, None])[:, 0]
        in_pg = (pos // ps) == ent[:, None]                  # (slots, s)
        has = in_pg.any(dim=1)
        amax = torch.where(in_pg[:, None, :, None], cf.abs(), 0.0).amax(
            dim=(2, 3))                                      # (slots, kv)
        old = scales[pg]
        new = torch.where(has[:, None], torch.maximum(old, amax / qmax), old)
        ratio = torch.where(new > 0, old / torch.clamp(new, min=1e-30), 0.0)
        # the page's codes on the grown grid: (slots, kv, ps, d)
        tile = pages[pg].float() * ratio[:, :, None, None]
        qtok = kv_cast(cf * kv_inverse(new)[:, :, None, None], pages.dtype,
                       qmax)
        # members land at their in-page offset, the rest at the extra row
        # ps, dropped below
        off = torch.where(in_pg, pos % ps, ps)
        tile_q = kv_cast(tile, pages.dtype, qmax)
        tile_q = torch.cat([tile_q, torch.zeros_like(tile_q[:, :, :1])],
                           dim=2)
        tile_q[sl[:, None], :, off, :] = qtok.transpose(1, 2)
        # distinct live slots own distinct pages; idle and done slots meet
        # only on the null page 0, which no live slot reads
        pages[pg] = tile_q[:, :, :ps]
        scales[pg] = new


def _append_quantized_token(lc, k_tok, v_tok, qmax: float) -> None:
    """The decode step's append (``s = 1``) into a quantized pool, K and V
    together: the reference's first round on the page that takes the
    token, with the same arithmetic (in place). Its second round, on the
    next page, changes no value a slot reads when ``s = 1``: no token lands
    there, so the page's scale stays, and its codes are rescaled by 1 (a
    bit-exact rewrite) or, while its scale is still 0, zeroed, which the
    first token to land there does too. So it is left out."""
    kp, vp, ks, vs = (lc[n] for n in ("k_pages", "v_pages", "k_scales",
                                      "v_scales"))
    bt, t = lc["block_tables"], lc["len"].long()
    ps = kp.shape[2]
    ent = (t // ps).clamp(0, bt.shape[1] - 1)
    pg = torch.gather(bt, 1, ent[:, None])[:, 0].long()      # (slots,)
    off = t % ps
    # K and V stacked: (2, slots, kv, d)
    cf = torch.stack((k_tok[:, :, 0], v_tok[:, :, 0])).float()
    old = torch.stack((ks[pg], vs[pg]))                      # (2, slots, kv)
    new = torch.maximum(old, cf.abs().amax(dim=-1) / qmax)
    ratio = torch.where(new > 0, old / torch.clamp(new, min=1e-30), 0.0)
    tile = kv_cast(torch.stack((kp[pg], vp[pg])).float()
                   * ratio[..., None, None], kp.dtype, qmax)
    qtok = kv_cast(cf * kv_inverse(new)[..., None], kp.dtype, qmax)
    tile[:, torch.arange(pg.shape[0], device=pg.device), :, off, :] = \
        qtok.transpose(0, 1)
    # distinct live slots own distinct pages; idle and done slots meet only
    # on the null page 0, which no live slot reads
    kp[pg], vp[pg] = tile[0], tile[1]
    ks[pg], vs[pg] = new[0], new[1]


def update_paged_layer_cache(lc, k_chunk, v_chunk):
    """Write an ``(slots, kv, s, d)`` chunk into the page pool at each slot's
    current length (in place): slot ``b``'s position ``len_b + i`` lands in
    page ``block_tables[b, (len_b + i) // page_size]`` at offset
    ``(len_b + i) % page_size``. Idle slots (all-null table rows) write into
    the null page 0, which no live slot reads. A quantized pool (``k_scales``
    in the layer view) quantizes on write through
    :func:`_append_quantized_token` at a decode step (``s = 1``), else
    :func:`_append_quantized_pages`."""
    if "k_scales" in lc and k_chunk.shape[2] == 1:
        _append_quantized_token(lc, k_chunk, v_chunk,
                                kv_qmax(lc["k_pages"].dtype))
        return dict(lc)
    if "k_scales" in lc:
        kp = lc["k_pages"]
        args = (lc["block_tables"], lc["len"].long(), kp.shape[2],
                lc["block_tables"].shape[1], kv_qmax(kp.dtype))
        _append_quantized_pages(kp, lc["k_scales"], k_chunk, *args)
        _append_quantized_pages(lc["v_pages"], lc["v_scales"], v_chunk,
                                *args)
        return dict(lc)
    kp, vp = lc["k_pages"], lc["v_pages"]
    ps = kp.shape[2]
    bt = lc["block_tables"]
    max_pages = bt.shape[1]
    s = k_chunk.shape[2]
    t = lc["len"].long()
    pos = t[:, None] + torch.arange(s, device=t.device)[None, :]
    page = torch.gather(bt.long(), 1, (pos // ps).clamp(0, max_pages - 1))
    off = pos % ps
    kp[page, :, off, :] = k_chunk.transpose(1, 2).to(kp.dtype)
    vp[page, :, off, :] = v_chunk.transpose(1, 2).to(vp.dtype)
    return dict(lc)


def advance_cache(cache, new_layers, s: int):
    """Reassemble the cache after all blocks ran a chunk of length ``s``;
    the length advances (elementwise for a paged cache)."""
    out = dict(cache)
    out["layers"] = [{k: v for k, v in lc.items()
                      if k not in ("len", "block_tables")}
                     for lc in new_layers]
    out["len"] = cache["len"] + s
    return out


def cached_attention(q, lc, *, window: Optional[int] = None, bias=None,
                     scale: Optional[float] = None):
    """Masked dot-product attention of a ``(b, h, s, d)`` chunk at absolute
    positions ``[len, len + s)`` against the whole contiguous buffer: key
    ``j`` is visible to the query at position ``p`` iff ``j <= p`` and,
    under a ``window``, ``j > p - window``. GQA against the unexpanded kv
    heads; fp32 scores and accumulation. ``bias`` (broadcastable to ``(b,
    h, s, T)``, T5's relative-position bias) adds to the scaled scores
    before masking, the cached analog of the flash kernel's additive bias.
    Plain torch, as the reference's is plain jnp."""
    k, v, t0 = lc["k"], lc["v"], lc["len"]
    b, h, s, d = q.shape
    kv, t_max = k.shape[1], k.shape[2]
    rep = h // kv
    pos_q = t0 + torch.arange(s, device=q.device)[:, None]
    pos_k = torch.arange(t_max, device=q.device)[None, :]
    mask = pos_k <= pos_q                                   # (s, T)
    if window is not None:
        mask = mask & (pos_k > pos_q - window)
    qf = q.reshape(b, kv, rep, s, d).float()
    scores = torch.einsum("bkrsd,bktd->bkrst", qf, k.float())
    scores = scores * (scale if scale is not None else d ** -0.5)
    if bias is not None:
        bb = bias.float().expand(b, h, s, t_max)
        scores = scores + bb.reshape(b, kv, rep, s, t_max)
    scores = torch.where(mask, scores, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkrst,bktd->bkrsd", p, v.float())
    return ctx.reshape(b, h, s, d).to(q.dtype)


def is_vocab_parallel(model) -> bool:
    """True when ``model`` returns vocab-parallel logits, each rank its
    shard of the vocab: its config's ``tensor_parallel_size`` is above 1.
    The model decides, not the process's installed groups."""
    return getattr(model.config, "tensor_parallel_size", 1) > 1


def gather_vocab(logits, vocab_parallel: bool):
    """The full-vocab logits: ``vocab_parallel`` logits (see
    :func:`is_vocab_parallel`) have the ranks' vocab shards all-gathered
    along the last axis (the reference's
    ``gather_from_tensor_model_parallel_region`` before every token
    choice), so that every rank picks the same token; else ``logits``."""
    if vocab_parallel:
        return gather_from_tensor_model_parallel_region(logits)
    return logits


def _greedy_token(logits, vocab_parallel: bool = False):
    """fp32 argmax over the (gathered) last axis (first index on ties, as
    in JAX)."""
    return torch.argmax(gather_vocab(logits, vocab_parallel).float(),
                        dim=-1).to(torch.int32)


# --- sampling ------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer on int64 values in ``[0, 2^32)``."""
    from apex_tpu_torch.ops.flash_attention import _mul32

    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def sample_noise(seed: int, streams: torch.Tensor, index,
                 vocab: int) -> torch.Tensor:
    """fp32 ``(b, vocab)`` standard Gumbel noise, row ``r`` a function of
    ``(seed, streams[r], index[r])`` and the column alone: a counter-based
    hash (murmur3 finalizer rounds over the four, in int64 torch ops, the
    same bits on the CPU and the card) to a uniform in ``(0, 1)``, then
    ``-log(-log(u))`` in fp64. ``streams`` are int64 request (or batch-row)
    ids, ``index`` the token's index in that stream (an int or an int64
    ``(b,)`` tensor). The reference draws ``jax.random.gumbel`` from
    ``fold_in(key, i)``; threefry's bits are not reproduced, so the draws
    follow its distribution, not its values."""
    from apex_tpu_torch.ops.flash_attention import _mul32

    dev = streams.device
    streams = streams.to(torch.int64) & _M32
    index = torch.as_tensor(index, dtype=torch.int64,
                            device=dev).expand_as(streams) & _M32
    seed = int(seed)
    key = _fmix32(_fmix32(streams) ^ (seed & _M32))
    key = _fmix32((key + _mul32(index, 0x9E3779B1)) & _M32)
    key = _fmix32(key ^ ((seed >> 32) & _M32))
    cols = torch.arange(vocab, dtype=torch.int64, device=dev)
    bits = _fmix32((key[:, None] + _mul32(cols, 0x85EBCA77)[None, :])
                   & _M32)
    bits = _fmix32(bits ^ 0x5BD1E995)
    u = (bits.double() + 0.5) * (1.0 / 4294967296.0)
    return (-torch.log(-torch.log(u))).float()


def filter_logits(logits, *, temperature: float, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """The reference's filtering (``_sample_token``), on fp32 logits:
    divided by ``temperature``, then under ``top_k`` every logit below the
    k-th largest set to ``-inf``, then under ``top_p`` every logit below
    the cutoff of the nucleus: the sorted distribution's smallest prefix
    whose EXCLUSIVE cumulative mass stays below ``top_p`` (the first token
    always survives)."""
    logits = logits.float() / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        mass_before = torch.cumsum(probs, dim=-1) - probs
        cutoff_idx = (mass_before < top_p).to(torch.int64).sum(
            dim=-1, keepdim=True) - 1
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def _sample_token(last_logits, seed, streams, index, *, temperature,
                  top_k=None, top_p=None, vocab_parallel: bool = False):
    """One token per row of ``(b, V)`` final-position logits: greedy at
    temperature 0, else ``argmax(filter_logits(...) + noise)`` with the
    Gumbel noise of :func:`sample_noise` (what ``jax.random.categorical``
    computes, ``argmax(logits + gumbel)``); ``vocab_parallel`` logits are
    gathered first (:func:`gather_vocab`)."""
    if not temperature:
        return _greedy_token(last_logits, vocab_parallel)
    logits = filter_logits(gather_vocab(last_logits, vocab_parallel),
                           temperature=temperature, top_k=top_k, top_p=top_p)
    noise = sample_noise(seed, streams, index, logits.shape[-1])
    return torch.argmax(noise.to(logits.device) + logits,
                        dim=-1).to(torch.int32)


def validate_sampling(temperature, top_k, top_p, rng) -> int:
    """The reference's knob checks; returns the effective seed. ``rng`` is
    an int seed here (the reference's a PRNG key): sampling needs one, and
    sampling knobs at temperature 0 raise rather than go unused."""
    if temperature and rng is None:
        raise ValueError("sampling (temperature > 0) needs an explicit rng")
    if not temperature and (top_k is not None or top_p is not None
                            or rng is not None):
        raise ValueError("top_k/top_p/rng require temperature > 0 (greedy "
                         "decoding at temperature=0 ignores them)")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if rng is not None and not isinstance(rng, int):
        raise TypeError(f"rng must be an int seed in this port, got "
                        f"{type(rng).__name__}")
    return 0 if rng is None else rng


def decode_loop(step_apply, prefill_logits, cache, max_new_tokens: int, *,
                temperature, top_k, top_p, rng, eos_token_id,
                vocab_parallel: bool = False):
    """The shared decode loop of the decoder-only and encoder-decoder
    models: ``step_apply(tok (b,), cache) -> (logits (b, 1, V), cache)``,
    its logits vocab-parallel when ``vocab_parallel``.
    Token ``i`` of batch row ``r`` samples with the noise of stream ``r``,
    index ``i``; EOS rows keep emitting EOS. Returns the ``(b,
    max_new_tokens)`` int32 generated tokens."""
    b = prefill_logits.shape[0]
    streams = torch.arange(b, dtype=torch.int64,
                           device=prefill_logits.device)

    def sample(last, i):
        return _sample_token(last, rng, streams, i, temperature=temperature,
                             top_k=top_k, top_p=top_p,
                             vocab_parallel=vocab_parallel)

    tok = sample(prefill_logits[:, -1], 0)
    done = (tok == eos_token_id) if eos_token_id is not None else None
    out = [tok]
    for i in range(1, max_new_tokens):
        logits, cache = step_apply(tok, cache)
        nxt = sample(logits[:, 0], i)
        if eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


def validate_decode_bounds(s0: int, max_new_tokens: int,
                           max_position_embeddings: int, max_len=None) -> int:
    total = s0 + int(max_new_tokens)
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if total > max_position_embeddings:
        raise ValueError(
            f"prompt ({s0}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_position_embeddings={max_position_embeddings}")
    t_max = total if max_len is None else int(max_len)
    if t_max < total:
        raise ValueError(f"max_len={t_max} < prompt + max_new_tokens={total}")
    return t_max


@torch.no_grad()
def generate(model, prompt_ids, max_new_tokens: int, *,
             max_len: Optional[int] = None, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             rng: Optional[int] = None,
             eos_token_id: Optional[int] = None):
    """Lock-step decoding: prefill the prompt (flash kernel), then
    ``max_new_tokens - 1`` single-token steps over the contiguous cache,
    greedy at temperature 0, else sampled (``temperature``, ``top_k``,
    ``top_p`` and an int seed ``rng``; row ``r``'s token ``i`` draws the
    noise of stream ``r``, index ``i``). Returns ``(batch, prompt_len +
    max_new_tokens)`` int32 ids, prompt included; after ``eos_token_id`` a
    row keeps emitting EOS."""
    rng = validate_sampling(temperature, top_k, top_p, rng)
    cfg = model.config
    device = model.device
    prompt_ids = torch.as_tensor(prompt_ids, device=device).to(torch.int32)
    b, s0 = prompt_ids.shape
    t_max = validate_decode_bounds(s0, max_new_tokens,
                                   cfg.max_position_embeddings, max_len)
    cache = init_cache(cfg, b, t_max, device=device)
    logits, cache = model(prompt_ids, cache=cache)
    gen = decode_loop(lambda tok, c: model(tok[:, None], cache=c), logits,
                      cache, max_new_tokens, temperature=temperature,
                      top_k=top_k, top_p=top_p, rng=rng,
                      eos_token_id=eos_token_id,
                      vocab_parallel=is_vocab_parallel(model))
    return torch.cat([prompt_ids, gen], dim=1)


# --- beam search -------------------------------------------------------------


def repeat_cache(cache, times: int):
    """Every per-sequence cache tensor repeated ``times`` along the leading
    dim (rows ``[b0 x times, b1 x times, ...]``): beam search prefills once
    at batch b and fans the cache out to b * W."""
    def rep(t):
        return (t.repeat_interleave(times, dim=0)
                if torch.is_tensor(t) and t.ndim >= 1 else t)

    return dict(cache, layers=[{k: rep(v) for k, v in lc.items()}
                               for lc in cache["layers"]])


def _gather_beam_cache(cache, parent, batch: int, num_beams: int):
    """Every ``(batch * num_beams)``-leading cache tensor reordered by the
    chosen parents: surviving beams inherit their parent's K/V (and
    extras such as T5's cross ``ck``/``cv``)."""
    flat = (torch.arange(batch, device=parent.device)[:, None] * num_beams
            + parent).reshape(-1)
    bw = batch * num_beams

    def reorder(t):
        return (t[flat] if torch.is_tensor(t) and t.ndim >= 1
                and t.shape[0] == bw else t)

    return dict(cache, layers=[{k: reorder(v) for k, v in lc.items()}
                               for lc in cache["layers"]])


def _gathered_log_softmax(logits, vocab_parallel: bool):
    return torch.log_softmax(gather_vocab(logits, vocab_parallel).float(),
                             dim=-1)


def _top_k(x, k: int):
    """``lax.top_k`` over the last axis: the k largest, the lower index
    first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search_loop(step_apply, prefill_logits, cache, max_new_tokens: int,
                     *, batch: int, num_beams: int, eos_token_id=None,
                     length_penalty: float = 1.0, length_offset: int = 0,
                     vocab_parallel: bool = False):
    """Beam search over a ``(batch * num_beams)``-row cache, the
    reference's: beams fold into the batch, so a step is one batched
    forward and a reorder a gather over the cache's leading dim; the
    (token, parent) backpointers unwind after the loop. Finished beams
    extend only with EOS at no added score. The final ranking divides by
    ``(length_offset + gen_length) ** length_penalty``, ``gen_length`` the
    generated tokens up to and including the first EOS. Returns
    ``(sequences (batch, num_beams, max_new_tokens), scores (batch,
    num_beams))``, best beam first. ``prefill_logits`` hold the prompt's
    last logits replicated per beam (rows ``[b0 x W, b1 x W, ...]``);
    ``step_apply``'s logits are vocab-parallel when ``vocab_parallel``."""
    b, w = batch, num_beams
    neg = -1e30            # -inf breaks top_k ties; large-negative is safe
    logp0 = _gathered_log_softmax(prefill_logits[:, -1], vocab_parallel)
    vocab = logp0.shape[-1]
    dev = logp0.device
    logp0 = logp0.reshape(b, w, vocab)
    # every beam starts identical: only beam 0 may seed
    seed_mask = torch.where(torch.arange(w, device=dev)[None, :, None] == 0,
                            0.0, neg)
    scores, idx = _top_k((logp0 + seed_mask).reshape(b, w * vocab), w)
    tok = tok0 = (idx % vocab).to(torch.int32)
    done = ((tok == eos_token_id) if eos_token_id is not None
            else torch.zeros((b, w), dtype=torch.bool, device=dev))
    toks, parents = [], []
    if eos_token_id is not None:
        eos_only = torch.full((vocab,), neg, device=dev)
        eos_only[eos_token_id] = 0.0
    for _ in range(max_new_tokens - 1):
        logits, cache = step_apply(tok.reshape(b * w), cache)
        logp = _gathered_log_softmax(logits[:, 0],
                                     vocab_parallel).reshape(b, w, vocab)
        if eos_token_id is not None:
            # finished beams: EOS-extension only, at no cost
            logp = torch.where(done[..., None], eos_only[None, None], logp)
        cand = (scores[..., None] + logp).reshape(b, w * vocab)
        scores, idx = _top_k(cand, w)
        tok = (idx % vocab).to(torch.int32)
        parent = idx // vocab
        done = torch.gather(done, 1, parent)
        if eos_token_id is not None:
            done = done | (tok == eos_token_id)
        cache = _gather_beam_cache(cache, parent, b, w)
        toks.append(tok)
        parents.append(parent)
    # unwind the backpointers
    seq = [None] * max_new_tokens
    beam_idx = torch.arange(w, device=dev)[None].expand(b, w)
    for t in range(max_new_tokens - 1, 0, -1):
        seq[t] = torch.gather(toks[t - 1], 1, beam_idx)
        beam_idx = torch.gather(parents[t - 1], 1, beam_idx)
    seq[0] = torch.gather(tok0, 1, beam_idx)
    seqs = torch.stack(seq, dim=-1)                          # (b, w, T)
    if eos_token_id is not None and length_penalty:
        is_eos = seqs == eos_token_id
        # the length up to and including the first EOS; all when none
        first_eos = is_eos.to(torch.int32).argmax(dim=-1) + 1
        lengths = torch.where(is_eos.any(dim=-1), first_eos, max_new_tokens)
    else:
        lengths = torch.full((b, w), max_new_tokens, device=dev)
    lengths = lengths + length_offset
    final = scores / (lengths.float() ** length_penalty)
    order = torch.argsort(-final, dim=1, stable=True)
    seqs = torch.gather(seqs, 1, order[..., None].expand_as(seqs))
    return seqs, torch.gather(final, 1, order)


@torch.no_grad()
def generate_beam(model, prompt_ids, max_new_tokens: int, *, num_beams: int,
                  eos_token_id: Optional[int] = None,
                  length_penalty: float = 1.0,
                  max_len: Optional[int] = None):
    """Beam-search decoding for the decoder-only families: prefill the
    prompt once at batch b, replicate the cache and the last logits per
    beam, run :func:`beam_search_loop`. Returns ``(sequences (b,
    num_beams, prompt + max_new_tokens), scores (b, num_beams))``, best
    beam first, prompt included."""
    cfg = model.config
    device = model.device
    prompt_ids = torch.as_tensor(prompt_ids, device=device).to(torch.int32)
    b, s0 = prompt_ids.shape
    if num_beams < 1:
        raise ValueError("num_beams must be >= 1")
    t_max = validate_decode_bounds(s0, max_new_tokens,
                                   cfg.max_position_embeddings, max_len)
    cache = init_cache(cfg, b, t_max, device=device)
    logits, cache = model(prompt_ids, cache=cache)
    cache = repeat_cache(cache, num_beams)
    logits = logits[:, -1:].repeat_interleave(num_beams, dim=0)
    seqs, scores = beam_search_loop(
        lambda tok, c: model(tok[:, None], cache=c), logits, cache,
        max_new_tokens, batch=b, num_beams=num_beams,
        eos_token_id=eos_token_id, length_penalty=length_penalty,
        vocab_parallel=is_vocab_parallel(model))
    prompt_rep = prompt_ids[:, None].expand(b, num_beams, s0)
    return torch.cat([prompt_rep, seqs], dim=-1), scores


# --- speculative decoding ----------------------------------------------------


def rollback_cache(cache, new_len):
    """Rewind a cache to ``new_len`` tokens. O(1): entries past the length
    are invisible to ``cached_attention``'s absolute-position mask and are
    overwritten by the next chunk write, so rejection rollback is the
    length assignment alone."""
    return dict(cache, len=new_len)


@torch.no_grad()
def speculative_generate(model, draft_model, prompt_ids, max_new_tokens: int,
                         *, k: int = 4):
    """Greedy speculative decoding over contiguous caches: the DRAFT model
    proposes ``k - 1`` tokens per round, the target verifies them in ONE
    ``k``-token chunk and accepts the longest prefix matching its own
    argmax; rejected positions roll both caches back. The output is the
    target's greedy decode for any draft (exactly so where the ``s = k``
    verify and the ``s = 1`` step agree numerically, as in fp32). Batched
    rows accept the minimum match count over the batch; the round's bonus
    token (the target's argmax after the accepted prefix) keeps every
    round's progress >= 1 token per row. Greedy only; EOS rows are not
    stopped early. Returns ``(batch, prompt_len + max_new_tokens)`` int32
    ids, prompt included."""
    cfg = model.config
    device = model.device
    prompt_ids = torch.as_tensor(prompt_ids, device=device).to(torch.int32)
    b, s0 = prompt_ids.shape
    total = s0 + int(max_new_tokens)
    if k < 2:
        raise ValueError("k must be >= 2 (k-1 draft proposals per round)")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    for c in (cfg, draft_model.config):
        # + k: the last round's verify chunk may span positions past the
        # final token before the rollback discards them
        if total + k > c.max_position_embeddings:
            raise ValueError(
                f"prompt ({s0}) + max_new_tokens ({max_new_tokens}) + "
                f"k ({k}) speculative slack exceeds "
                f"max_position_embeddings={c.max_position_embeddings}")
    t_cache = init_cache(cfg, b, total + k, device=device)
    d_cache = init_cache(draft_model.config, b, total + k, device=device)
    logits, t_cache = model(prompt_ids, cache=t_cache)
    _, d_cache = draft_model(prompt_ids, cache=d_cache)

    tp_t, tp_d = is_vocab_parallel(model), is_vocab_parallel(draft_model)
    produced = []
    n_out = 0
    next_tok = _greedy_token(logits[:, -1], tp_t)
    while n_out < max_new_tokens:
        x_t, tok, ins = next_tok, next_tok, []
        # k draft steps from x_t: the k-th only advances the draft cache,
        # so a fully accepted round leaves it consistent
        for _ in range(k):
            ins.append(tok)
            lg, d_cache = draft_model(tok[:, None], cache=d_cache)
            tok = _greedy_token(lg[:, 0], tp_d)
        props = torch.stack(ins[1:], dim=1)                 # (b, k - 1)
        chunk = torch.cat([x_t[:, None], props], dim=1)
        lg, t_cache = model(chunk, cache=t_cache)
        preds = _greedy_token(lg, tp_t)                     # (b, k)
        # leading matches of the proposals against the target's argmax,
        # the minimum over rows
        match = (props == preds[:, :-1]).to(torch.int32)
        m = int(torch.cumprod(match, dim=1).sum(dim=1).min())
        produced.append(torch.cat([x_t[:, None], props[:, :m]], dim=1))
        n_out += m + 1
        new_len = t_cache["len"] - (k - (m + 1))    # back to t + 1 + m
        t_cache = rollback_cache(t_cache, new_len)
        d_cache = rollback_cache(d_cache, new_len)
        next_tok = preds[:, m]
    gen = torch.cat(produced, dim=1)[:, :max_new_tokens]
    return torch.cat([prompt_ids, gen], dim=1)
