"""Paged KV pool: page-granular cache storage, block tables, the free
stack and page sharing, full-precision or quantized.

Counterpart of ``apex_tpu/serving/kv_pool.py`` (``init_paged_cache``,
``alloc_slot``, ``alloc_slot_shared``, ``release_slot``, ``free_slot``,
``drop_slot_pages``, ``push_free_pages``, ``defrag_map``, ``defrag``,
``observe_pool``,
``prefill_into_pages``, ``pages_for``, ``free_page_count``,
``page_bytes``, ``max_slots_for_pool_bytes``; the host tier's
``gather_pages``/``promote_pages``/``evict_pages`` are not ported).
Layout::

    pcache = {
      "layers": [{"k_pages": (num_pages, kv, page_size, d),
                  "v_pages": ...,
                  # a quantized pool (kv_dtype="int8" or "fp8") only:
                  "k_scales": (num_pages, kv) fp32, "v_scales": ...,
                  }] * num_layers,                     # on the device
      "block_tables": (num_slots, max_pages_per_seq) int32,   # device
      "len":          (num_slots,) int32,  # tokens written per slot, device
      "alloc_pages":  (num_slots,) int32,  # pages OWNED per slot, host
      "shared_pages": (num_slots,) int32,  # leading SHARED entries, host
      "page_ref":     (num_pages,) int32,  # slots reading a shared page, host
      "free_stack":   (num_pages,) int32,  # stack[0:free_top] free, host
      "free_top":     int,                 # host
    }

A slot's row is ``[shared cached pages | private pages | null...]``: the
first ``shared_pages[slot]`` entries are prefix-cache pages the slot only
reads (every write lands at or past the slot's length, which is past
them), and ``page_ref`` counts their readers; the prefix cache frees a
cached page only at refcount 0.

Under tensor parallelism (``serving/tp.py``) each rank's pool holds its
``kv / tp`` heads of every page (``local_kv_heads``); the block tables,
lengths and free-list bookkeeping are replicated and advance alike on every
rank.

The page pool, block tables and lengths live on the device, where the
kernels read them; the free-list bookkeeping that only the host scheduler
reads lives on the host, so admission never waits on the device to learn
the free count. Page 0 is the reserved NULL page: never allocated, every
dead table entry points at it, and idle slots write their K/V there — no
live slot ever reads it.

A quantized pool stores int8 or fp8 e4m3 pages with one symmetric fp32
scale per (page, kv head): a page's true K is ``k_pages[p].float() *
k_scales[p][:, None, None]``. A freshly allocated page's scales are zeroed
(scale 0 means "holds nothing yet"); ``prefill_into_pages`` quantizes on
write with each page's scale SET from its tokens' amax, and decode appends
requantize on grow (``models/generation.update_paged_layer_cache``).

Unlike the reference's pure functions, these update the cache dict and its
tensors IN PLACE, and return it for the reference's call style.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.amp.policy import resolve_compute_dtype
from apex_tpu_torch.ops.quant import (kv_cast, kv_inverse, kv_qmax,
                                      resolve_kv_dtype)


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def page_size_of(cache) -> int:
    return cache["layers"][0]["k_pages"].shape[2]


def num_pages_of(cache) -> int:
    return cache["layers"][0]["k_pages"].shape[0]


def pages_for(length: int, page_size: int) -> int:
    """Pages needed for ``length`` tokens."""
    return cdiv(length, page_size)


def local_kv_heads(config) -> int:
    """The kv heads one rank's pool holds: ``num_kv_heads`` (or
    ``num_heads``) over ``tensor_parallel_size``, the reference's
    ``P(None, model)`` shard of every page."""
    kv = getattr(config, "num_kv_heads", config.num_heads)
    tp = getattr(config, "tensor_parallel_size", 1)
    if kv % tp:
        raise ValueError(f"{kv} kv heads do not divide over "
                         f"tensor_parallel_size={tp}")
    return kv // tp


def _page_dtype(config, dtype, quant):
    """The pool's page dtype: the quantized one, else ``dtype`` or the
    model's compute dtype."""
    if quant is not None:
        return quant[0]
    return dtype if dtype is not None else resolve_compute_dtype(
        config.dtype)


def init_paged_cache(config, num_slots: int, *, num_pages: int,
                     page_size: int = 16,
                     max_pages_per_seq: Optional[int] = None, dtype=None,
                     kv_dtype=None, device="cuda"):
    """Allocate the shared page pool + empty slot state. ``num_pages``
    includes the null page 0. ``kv_dtype`` (``"int8"``/``"fp8"``) makes a
    quantized pool with fp32 per-(page, kv head) ``k_scales``/``v_scales``
    in each layer; it excludes ``dtype``, since the page dtype is then the
    quantized one."""
    if kv_dtype is not None and dtype is not None:
        raise ValueError("kv-dtype-conflict: pass dtype= OR kv_dtype=, "
                         "not both — a quantized pool's page dtype is "
                         "the quantized dtype")
    quant = resolve_kv_dtype(kv_dtype)
    dt = _page_dtype(config, dtype, quant)
    if page_size % 8 != 0:
        raise ValueError(f"page_size must be a multiple of 8, got "
                         f"{page_size}")
    if num_pages < 2:
        raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
    kv = local_kv_heads(config)
    if max_pages_per_seq is None:
        max_pages_per_seq = cdiv(config.max_position_embeddings, page_size)
    shape = (num_pages, kv, page_size, config.head_dim)

    def layer():
        lc = {"k_pages": torch.zeros(shape, dtype=dt, device=device),
              "v_pages": torch.zeros(shape, dtype=dt, device=device)}
        if quant is not None:
            for name in ("k_scales", "v_scales"):
                lc[name] = torch.zeros((num_pages, kv), dtype=torch.float32,
                                       device=device)
        return lc

    return {
        "layers": [layer() for _ in range(config.num_layers)],
        "block_tables": torch.zeros((num_slots, max_pages_per_seq),
                                    dtype=torch.int32, device=device),
        "len": torch.zeros((num_slots,), dtype=torch.int32, device=device),
        "alloc_pages": torch.zeros((num_slots,), dtype=torch.int32),
        "shared_pages": torch.zeros((num_slots,), dtype=torch.int32),
        "page_ref": torch.zeros((num_pages,), dtype=torch.int32),
        # pages 1..num_pages-1 free; popped from the top of the stack
        "free_stack": torch.arange(1, num_pages + 1,
                                   dtype=torch.int32) % num_pages,
        "free_top": num_pages - 1,
    }


def free_page_count(cache) -> int:
    return cache["free_top"]


def observe_pool(cache, labels: Optional[dict] = None) -> dict:
    """Publish the pool's health gauges, as the reference's:
    ``kv_pool.free_pages``, ``kv_pool.pages_total`` (usable: the null page
    left out), ``kv_pool.shared_pages_active`` (pages a live slot shares)
    and ``kv_pool.page_refs_total``; host reads only. ``labels`` keeps two
    engines' pools apart. Returns the values."""
    from apex_tpu_torch.utils import metrics

    refs = cache["page_ref"]
    vals = {"kv_pool.free_pages": int(cache["free_top"]),
            "kv_pool.pages_total": num_pages_of(cache) - 1,
            "kv_pool.shared_pages_active": int((refs > 0).sum()),
            "kv_pool.page_refs_total": int(refs.sum())}
    for name, v in vals.items():
        metrics.gauge(name, labels=labels).set(v)
    return vals


def is_quantized(cache) -> bool:
    return "k_scales" in cache["layers"][0]


def _reset_page_scales(cache, page_ids) -> None:
    """Zero the scales of freshly allocated pages (a no-op on a
    full-precision pool): the prefill write and the requantize-on-grow
    append trust scale 0 to mean an empty page, and a previous occupant's
    scale would inflate the new occupant's grid. ``page_ids`` may hold the
    null page 0, whose scale no live slot reads."""
    if not is_quantized(cache):
        return
    for lc in cache["layers"]:
        lc["k_scales"][page_ids] = 0.0
        lc["v_scales"][page_ids] = 0.0


def alloc_slot(cache, slot: int, n_pages: int):
    """Pop ``n_pages`` pages off the free stack and install them as slot
    ``slot``'s block-table row (entries past ``n_pages`` point at the null
    page), zeroing their scales in a quantized pool. The caller ensures
    ``free_page_count(cache) >= n_pages``."""
    top = cache["free_top"]
    if n_pages > top:
        raise ValueError(f"alloc of {n_pages} pages with {top} free")
    max_pages = cache["block_tables"].shape[1]
    if n_pages > max_pages:
        raise ValueError(f"{n_pages} pages exceed max_pages_per_seq="
                         f"{max_pages}")
    row = torch.zeros((max_pages,), dtype=torch.int32)
    row[:n_pages] = cache["free_stack"][top - n_pages:top].flip(0)
    cache["free_top"] = top - n_pages
    row = row.to(cache["block_tables"].device)
    cache["block_tables"][slot] = row
    cache["alloc_pages"][slot] = n_pages
    cache["shared_pages"][slot] = 0
    _reset_page_scales(cache, row.long())
    return cache


def alloc_slot_shared(cache, slot: int, shared_row, n_shared: int,
                      n_private: int):
    """Install slot ``slot``'s row as ``[shared cached pages | freshly
    popped private pages | null...]``: the first ``n_shared`` entries come
    from ``shared_row`` (pages the prefix cache holds: refcount +1 each,
    not popped), the next ``n_private`` pop off the free stack as in
    :func:`alloc_slot`. Only the private pages' scales are zeroed: shared
    pages keep their scales. The caller ensures ``free_page_count(cache)
    >= n_private``."""
    top = cache["free_top"]
    max_pages = cache["block_tables"].shape[1]
    if n_private > top:
        raise ValueError(f"alloc of {n_private} pages with {top} free")
    if n_shared + n_private > max_pages:
        raise ValueError(f"{n_shared} + {n_private} pages exceed "
                         f"max_pages_per_seq={max_pages}")
    shared = torch.as_tensor(shared_row, dtype=torch.int32).cpu()[:n_shared]
    row = torch.zeros((max_pages,), dtype=torch.int32)
    row[:n_shared] = shared
    priv = cache["free_stack"][top - n_private:top].flip(0)
    row[n_shared:n_shared + n_private] = priv
    cache["free_top"] = top - n_private
    cache["block_tables"][slot] = row.to(cache["block_tables"].device)
    cache["alloc_pages"][slot] = n_private
    cache["shared_pages"][slot] = n_shared
    cache["page_ref"][shared.long()] += 1
    _reset_page_scales(cache, priv.long().to(cache["block_tables"].device))
    return cache


def push_free_pages(cache, pages):
    """Push the listed physical pages onto the free stack, in order (the
    prefix cache's LRU eviction returns refcount-0 pages this way)."""
    pages = torch.as_tensor(pages, dtype=torch.int32).reshape(-1).cpu()
    top = cache["free_top"]
    cache["free_stack"][top:top + pages.shape[0]] = pages
    cache["free_top"] = top + pages.shape[0]
    return cache


def release_slot(cache, slot: int, keep):
    """Retire slot ``slot``: every table entry in its shared + owned range
    with ``keep[j]`` False returns to the free stack (in table order);
    entries with ``keep[j]`` True leave the slot without touching the
    stack (they are, or just became, prefix-cache property). The leading
    ``shared_pages[slot]`` entries also drop their ``page_ref`` by one.
    Entries a sliding window already dropped (null) are skipped. Resets
    the slot's row, length, ownership and sharing."""
    row = cache["block_tables"][slot].cpu()
    idx = torch.arange(row.shape[0])
    keep = torch.as_tensor(keep, dtype=torch.bool)
    sh = int(cache["shared_pages"][slot])
    total = sh + int(cache["alloc_pages"][slot])
    freeable = (idx < total) & ~keep & (row != 0)
    push_free_pages(cache, row[freeable])
    shared = row[(idx < sh) & (row != 0)]
    cache["page_ref"][shared.long()] -= 1
    cache["block_tables"][slot] = 0
    cache["len"][slot] = 0
    cache["alloc_pages"][slot] = 0
    cache["shared_pages"][slot] = 0
    return cache


def free_slot(cache, slot: int):
    """Retire slot ``slot`` and push ALL its owned pages (not only those
    its length reached) back onto the free stack; its shared leading
    entries stay cache property and only drop their refcount."""
    keep = torch.arange(cache["block_tables"].shape[1]) < int(
        cache["shared_pages"][slot])
    return release_slot(cache, slot, keep)


def drop_slot_pages(cache, slot: int, upto: int):
    """Free the pages behind slot ``slot``'s leading ``upto`` table entries
    that are not already null, pushing them onto the free stack in table
    order, and null those entries: the sliding-window page eviction. Once
    all of a page's positions lie below the attention band's floor, no later
    decode step of the slot reads it (the band only moves forward).
    Repeated calls with a growing ``upto`` free each page once.
    ``alloc_pages`` is left as it is: it bounds the slot's row, and
    ``release_slot`` skips the nulled entries at retirement. The caller
    drops only private pages wholly below the band."""
    row = cache["block_tables"][slot].cpu()
    droppable = (torch.arange(row.shape[0]) < int(upto)) & (row != 0)
    pages = row[droppable]
    top = cache["free_top"]
    cache["free_stack"][top:top + pages.shape[0]] = pages
    cache["free_top"] = top + pages.shape[0]
    row[droppable] = 0
    cache["block_tables"][slot] = row.to(cache["block_tables"].device)
    return cache


def defrag_map(cache, extra_live=None):
    """Compact the live pages to the low end of the pool (stable order),
    rebuild the free stack from actual liveness and return ``(cache,
    new_idx)``, ``new_idx[old_page] = new_page``: the remap a host-side
    prefix cache follows. A page no slot's table reaches returns to the
    free stack even if an earlier free miscounted (a leak collector).
    ``extra_live``: a ``(num_pages,)`` bool mask of pages live for
    reasons no table shows (the prefix cache's refcount-0 pages). A page's
    scales move with it, so its contents stay bit-identical."""
    bt = cache["block_tables"].cpu().long()
    num_pages = num_pages_of(cache)
    max_pages = bt.shape[1]
    n_used = (cache["shared_pages"] + cache["alloc_pages"]).long()
    used = torch.arange(max_pages)[None, :] < n_used[:, None]
    live = torch.zeros((num_pages,), dtype=torch.bool)
    live[torch.where(used, bt, 0)] = True
    if extra_live is not None:
        live |= torch.as_tensor(extra_live, dtype=torch.bool).cpu()
    live[0] = True                               # the null page stays 0
    n_live = int(live.sum())
    li = live.to(torch.int64)
    new_idx = torch.where(live, torch.cumsum(li, 0) - 1,
                          n_live + torch.cumsum(1 - li, 0) - 1)
    old_of_new = torch.empty_like(new_idx)
    old_of_new[new_idx] = torch.arange(num_pages)
    dev = cache["block_tables"].device
    perm = old_of_new.to(dev)
    for lc in cache["layers"]:
        for key in lc:
            lc[key].copy_(lc[key][perm])
    cache["block_tables"].copy_(torch.where(used, new_idx[bt], 0).to(
        torch.int32).to(dev))
    cache["page_ref"] = cache["page_ref"][old_of_new]
    idx = torch.arange(num_pages)
    cache["free_stack"] = torch.where(idx < num_pages - n_live, n_live + idx,
                                      0).to(torch.int32)
    cache["free_top"] = num_pages - n_live
    return cache, new_idx.to(torch.int32)


def defrag(cache, extra_live=None):
    """:func:`defrag_map` without the remap."""
    return defrag_map(cache, extra_live)[0]


def prefill_into_pages(cache, slot: int, contig_layers, s0: int, *,
                       start: int = 0):
    """Scatter a contiguous prefill cache (per-layer ``k``/``v`` of shape
    ``(1, kv, len_bucket, d)``) into slot ``slot``'s allocated pages and
    set its length to ``s0``. Position ``p`` lands in table entry
    ``p // page_size`` at offset ``p % page_size``; bucket padding
    (``p >= s0``) goes to the null page, and so do the positions below
    ``start``: a shared-prefix admission writes only its uncached tail,
    never the shared pages it reads.

    A quantized pool quantizes on write: each written table entry's scale
    per kv head is SET (alloc zeroed it) to the amax of its valid tokens
    over ``qmax``, and the tokens are quantized at that scale."""
    bt = cache["block_tables"]
    ps = page_size_of(cache)
    max_pages = bt.shape[1]
    len_bucket = contig_layers[0]["k"].shape[2]
    pos = torch.arange(len_bucket, device=bt.device)
    valid = (pos >= start) & (pos < s0)
    row = bt[slot].long()
    phys = torch.where(valid, row[(pos // ps).clamp(0, max_pages - 1)], 0)
    off = pos % ps
    if is_quantized(cache):
        qdt = cache["layers"][0]["k_pages"].dtype
        qmax = kv_qmax(qdt)
        nb = cdiv(len_bucket, ps)
        pad = nb * ps - len_bucket
        ent_any = torch.nn.functional.pad(valid, (0, pad)).reshape(
            nb, ps).any(dim=1)                                  # (nb,)
        page_e = torch.where(ent_any, row[:nb], 0)
        ent_of = (pos // ps).clamp(0, nb - 1)

        def write(pages, scales, x):
            xf = x.float()                             # (len_bucket, kv, d)
            ax = torch.where(valid[:, None, None], xf.abs(), 0.0)
            ax = torch.nn.functional.pad(ax, (0, 0, 0, 0, 0, pad))
            amax = ax.reshape(nb, ps, *x.shape[1:]).amax(dim=(1, 3))
            sc = amax / qmax                                   # (nb, kv)
            q = kv_cast(xf * kv_inverse(sc)[ent_of][:, :, None], qdt, qmax)
            pages[phys, :, off, :] = q
            scales[page_e] = torch.where(ent_any[:, None], sc, 0.0)
    else:
        def write(pages, scales, x):
            pages[phys, :, off, :] = x.to(pages.dtype)

    for lc, src in zip(cache["layers"], contig_layers):
        write(lc["k_pages"], lc.get("k_scales"),
              src["k"][0].transpose(0, 1))            # (len_bucket, kv, d)
        write(lc["v_pages"], lc.get("v_scales"), src["v"][0].transpose(0, 1))
    cache["len"][slot] = s0
    return cache


# --- pool sizing ------------------------------------------------------------

def page_bytes(config, page_size: int = 16, *, kv_dtype=None,
               dtype=None) -> int:
    """Pool bytes one page costs one rank across all layers: the K and V
    page tiles of its kv heads at the pool dtype plus, in a quantized pool,
    their two fp32 per-(page, kv head) scales. At page 16, head_dim 64 an int8 page costs ``(16 * 64
    + 4) / (2 * 16 * 64) ~= 0.502`` of a bf16 page."""
    quant = resolve_kv_dtype(kv_dtype)
    dt = _page_dtype(config, dtype, quant)
    kv = local_kv_heads(config)
    per_tensor = kv * page_size * config.head_dim * dt.itemsize
    if quant is not None:
        per_tensor += kv * 4
    return 2 * per_tensor * config.num_layers


def max_slots_for_pool_bytes(config, pool_bytes: int, *,
                             pages_per_slot: int, page_size: int = 16,
                             kv_dtype=None, dtype=None) -> int:
    """How many ``pages_per_slot``-page slots a ``pool_bytes`` budget
    admits (the null page 0 carved out first)."""
    pb = page_bytes(config, page_size, kv_dtype=kv_dtype, dtype=dtype)
    num_pages = pool_bytes // pb
    return max(int(num_pages - 1) // pages_per_slot, 0)
