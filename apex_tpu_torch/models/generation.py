"""Autoregressive decoding with a static-shape KV cache.

Counterpart of ``apex_tpu/models/generation.py``, in the pieces the serving
slice runs: the contiguous cache (``init_cache``, ``layer_cache``,
``is_static_prefill``, ``update_layer_cache``, ``advance_cache``,
``cached_attention``), the paged-cache write (``is_paged``,
``update_paged_layer_cache``, unquantized), the greedy token and greedy
lock-step ``generate`` — the token-identity oracle of the serving engine.

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


def init_cache(config, batch: int, max_len: int, *, dtype=None,
               device="cuda"):
    """All-zeros contiguous KV cache for ``batch`` sequences of up to
    ``max_len`` tokens."""
    kv_heads = getattr(config, "num_kv_heads", config.num_heads)
    dt = dtype if dtype is not None else config.dtype
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


def update_paged_layer_cache(lc, k_chunk, v_chunk):
    """Write an ``(slots, kv, s, d)`` chunk into the page pool at each slot's
    current length (in place): slot ``b``'s position ``len_b + i`` lands in
    page ``block_tables[b, (len_b + i) // page_size]`` at offset
    ``(len_b + i) % page_size``. Idle slots (all-null table rows) write into
    the null page 0, which no live slot reads."""
    if "k_scales" in lc:
        raise NotImplementedError(
            "quantized KV pages are not ported yet (ROADMAP queue B item 6)")
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


def cached_attention(q, lc, *, scale: Optional[float] = None):
    """Masked dot-product attention of a ``(b, h, s, d)`` chunk at absolute
    positions ``[len, len + s)`` against the whole contiguous buffer; GQA
    against the unexpanded kv heads; fp32 scores and accumulation. Plain
    torch, as the reference's is plain jnp."""
    k, v, t0 = lc["k"], lc["v"], lc["len"]
    b, h, s, d = q.shape
    kv, t_max = k.shape[1], k.shape[2]
    rep = h // kv
    pos_q = t0 + torch.arange(s, device=q.device)[:, None]
    pos_k = torch.arange(t_max, device=q.device)[None, :]
    mask = pos_k <= pos_q                                   # (s, T)
    qf = q.reshape(b, kv, rep, s, d).float()
    scores = torch.einsum("bkrsd,bktd->bkrst", qf, k.float())
    scores = scores * (scale if scale is not None else d ** -0.5)
    scores = torch.where(mask, scores, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkrst,bktd->bkrsd", p, v.float())
    return ctx.reshape(b, h, s, d).to(q.dtype)


def _greedy_token(logits):
    """fp32 argmax over the last axis (first index on ties, as in JAX)."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


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
             eos_token_id: Optional[int] = None):
    """Greedy lock-step decoding: prefill the prompt (flash kernel), then
    ``max_new_tokens - 1`` single-token steps over the contiguous cache.
    Returns ``(batch, prompt_len + max_new_tokens)`` int32 ids, prompt
    included; after ``eos_token_id`` a row keeps emitting EOS."""
    if temperature:
        raise NotImplementedError(
            "sampled decode (temperature > 0) is not ported yet (ROADMAP "
            "queue A item 6: sampled decode); JAX threefry draws cannot be "
            "matched, so it will be held to scheduling invariance")
    cfg = model.config
    device = model.device
    prompt_ids = torch.as_tensor(prompt_ids, device=device).to(torch.int32)
    b, s0 = prompt_ids.shape
    t_max = validate_decode_bounds(s0, max_new_tokens,
                                   cfg.max_position_embeddings, max_len)
    cache = init_cache(cfg, b, t_max, device=device)
    logits, cache = model(prompt_ids, cache=cache)
    tok = _greedy_token(logits[:, -1])
    done = (tok == eos_token_id) if eos_token_id is not None else None
    out = [tok]
    for _ in range(1, max_new_tokens):
        logits, cache = model(tok[:, None], cache=cache)
        nxt = _greedy_token(logits[:, 0])
        if eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done = done | (nxt == eos_token_id)
        out.append(nxt)
        tok = nxt
    return torch.cat([prompt_ids, torch.stack(out, dim=1)], dim=1)
