"""Autoregressive decoding with a static-shape KV cache.

Counterpart of ``apex_tpu/models/generation.py``, in the pieces the serving
slices run: the contiguous cache (``init_cache``, ``layer_cache``,
``is_static_prefill``, ``update_layer_cache``, ``advance_cache``,
``cached_attention``, banded under a sliding window and with an additive
bias; the reference's rolling cache is not ported), the paged-cache write
(``is_paged``, ``update_paged_layer_cache``, with the quantized pool's
requantize-on-grow append), the greedy token, greedy lock-step
``generate`` — the token-identity oracle of the serving engine — and
greedy lock-step ``speculative_generate`` with its ``rollback_cache``.

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


def init_cache(config, batch: int, max_len: int, *, dtype=None,
               device="cuda"):
    """All-zeros contiguous KV cache for ``batch`` sequences of up to
    ``max_len`` tokens."""
    kv_heads = getattr(config, "num_kv_heads", config.num_heads)
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

    produced = []
    n_out = 0
    next_tok = _greedy_token(logits[:, -1])
    while n_out < max_new_tokens:
        x_t, tok, ins = next_tok, next_tok, []
        # k draft steps from x_t: the k-th only advances the draft cache,
        # so a fully accepted round leaves it consistent
        for _ in range(k):
            ins.append(tok)
            lg, d_cache = draft_model(tok[:, None], cache=d_cache)
            tok = _greedy_token(lg[:, 0])
        props = torch.stack(ins[1:], dim=1)                 # (b, k - 1)
        chunk = torch.cat([x_t[:, None], props], dim=1)
        lg, t_cache = model(chunk, cache=t_cache)
        preds = _greedy_token(lg)                           # (b, k)
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
