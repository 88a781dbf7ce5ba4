"""Paged KV pool: page-granular cache storage, block tables and the free
stack (unquantized, unshared).

Counterpart of ``apex_tpu/serving/kv_pool.py`` (``init_paged_cache``,
``alloc_slot``, ``release_slot``, ``free_slot``, ``prefill_into_pages``,
``pages_for``, ``free_page_count``). Layout::

    pcache = {
      "layers": [{"k_pages": (num_pages, kv, page_size, d),
                  "v_pages": ...}] * num_layers,      # on the device
      "block_tables": (num_slots, max_pages_per_seq) int32,   # device
      "len":          (num_slots,) int32,  # tokens written per slot, device
      "alloc_pages":  (num_slots,) int32,  # pages OWNED per slot, host
      "free_stack":   (num_pages,) int32,  # stack[0:free_top] free, host
      "free_top":     int,                 # host
    }

The page pool, block tables and lengths live on the device, where the
kernels read them; the free-list bookkeeping that only the host scheduler
reads lives on the host, so admission never waits on the device to learn
the free count. Page 0 is the reserved NULL page: never allocated, every
dead table entry points at it, and idle slots write their K/V there — no
live slot ever reads it.

Unlike the reference's pure functions, these update the cache dict and its
tensors IN PLACE, and return it for the reference's call style.
"""

from __future__ import annotations

from typing import Optional

import torch


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


def init_paged_cache(config, num_slots: int, *, num_pages: int,
                     page_size: int = 16,
                     max_pages_per_seq: Optional[int] = None, dtype=None,
                     kv_dtype=None, device="cuda"):
    """Allocate the shared page pool + empty slot state. ``num_pages``
    includes the null page 0."""
    if kv_dtype is not None:
        raise NotImplementedError(
            "quantized KV pools are not ported yet (ROADMAP queue B item 6)")
    if page_size % 8 != 0:
        raise ValueError(f"page_size must be a multiple of 8, got "
                         f"{page_size}")
    if num_pages < 2:
        raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
    kv = getattr(config, "num_kv_heads", config.num_heads)
    dt = dtype if dtype is not None else config.dtype
    if max_pages_per_seq is None:
        max_pages_per_seq = cdiv(config.max_position_embeddings, page_size)
    shape = (num_pages, kv, page_size, config.head_dim)
    return {
        "layers": [{"k_pages": torch.zeros(shape, dtype=dt, device=device),
                    "v_pages": torch.zeros(shape, dtype=dt, device=device)}
                   for _ in range(config.num_layers)],
        "block_tables": torch.zeros((num_slots, max_pages_per_seq),
                                    dtype=torch.int32, device=device),
        "len": torch.zeros((num_slots,), dtype=torch.int32, device=device),
        "alloc_pages": torch.zeros((num_slots,), dtype=torch.int32),
        # pages 1..num_pages-1 free; popped from the top of the stack
        "free_stack": torch.arange(1, num_pages + 1,
                                   dtype=torch.int32) % num_pages,
        "free_top": num_pages - 1,
    }


def free_page_count(cache) -> int:
    return cache["free_top"]


def alloc_slot(cache, slot: int, n_pages: int):
    """Pop ``n_pages`` pages off the free stack and install them as slot
    ``slot``'s block-table row (entries past ``n_pages`` point at the null
    page). The caller ensures ``free_page_count(cache) >= n_pages``."""
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
    cache["block_tables"][slot] = row.to(cache["block_tables"].device)
    cache["alloc_pages"][slot] = n_pages
    return cache


def release_slot(cache, slot: int, keep):
    """Retire slot ``slot``: every owned table entry with ``keep[j]`` False
    returns to the free stack (in table order); entries with ``keep[j]``
    True leave the slot without touching the stack. Resets the slot's row,
    length and ownership."""
    row = cache["block_tables"][slot].cpu()
    idx = torch.arange(row.shape[0])
    keep = torch.as_tensor(keep, dtype=torch.bool)
    freeable = (idx < int(cache["alloc_pages"][slot])) & ~keep & (row != 0)
    pages = row[freeable]
    top = cache["free_top"]
    cache["free_stack"][top:top + pages.shape[0]] = pages
    cache["free_top"] = top + pages.shape[0]
    cache["block_tables"][slot] = 0
    cache["len"][slot] = 0
    cache["alloc_pages"][slot] = 0
    return cache


def free_slot(cache, slot: int):
    """Retire slot ``slot`` and push ALL its owned pages (not only those
    its length reached) back onto the free stack."""
    keep = torch.zeros((cache["block_tables"].shape[1],), dtype=torch.bool)
    return release_slot(cache, slot, keep)


def prefill_into_pages(cache, slot: int, contig_layers, s0: int):
    """Scatter a contiguous prefill cache (per-layer ``k``/``v`` of shape
    ``(1, kv, len_bucket, d)``) into slot ``slot``'s allocated pages and
    set its length to ``s0``. Position ``p`` lands in table entry
    ``p // page_size`` at offset ``p % page_size``; bucket padding
    (``p >= s0``) goes to the null page."""
    bt = cache["block_tables"]
    ps = page_size_of(cache)
    max_pages = bt.shape[1]
    len_bucket = contig_layers[0]["k"].shape[2]
    pos = torch.arange(len_bucket, device=bt.device)
    row = bt[slot].long()
    phys = torch.where(pos < s0, row[(pos // ps).clamp(0, max_pages - 1)], 0)
    off = pos % ps
    for lc, src in zip(cache["layers"], contig_layers):
        k = src["k"][0].transpose(0, 1)          # (len_bucket, kv, d)
        v = src["v"][0].transpose(0, 1)
        lc["k_pages"][phys, :, off, :] = k.to(lc["k_pages"].dtype)
        lc["v_pages"][phys, :, off, :] = v.to(lc["v_pages"].dtype)
    cache["len"][slot] = s0
    return cache
