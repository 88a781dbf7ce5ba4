"""Shared-prefix KV cache: a ref-counted radix tree over the page pool.

The port's copy of ``apex_tpu/serving/prefix_cache.py`` (host-side
bookkeeping only: numpy and the port's metrics registry); the host tier's
promotion (``insert_promoted``) waits for the host tier itself.

The dominant serving pattern is thousands of requests sharing a system
prompt or few-shot header; without cross-request reuse every one of them
re-prefills the shared tokens. This module is the host-side half of
RadixAttention-style prefix caching (SGLang, Zheng et al. 2023) over the
existing paged pool (``kv_pool.py``): a radix tree keyed by PAGE-sized
runs of token ids whose nodes name physical pages already holding that
run's K/V at those absolute positions.

Granularity is one page (``page_size`` tokens), matching the pool's unit
of allocation and the copy-on-write boundary: a cached page is complete
and immutable, so matching, sharing, and eviction are all whole-page
moves. The partially-filled boundary page of a sequence is therefore
never shared — a new request recomputes (copies) it into a private page.

Lifecycle, as driven by ``scheduler.PagedDecodeEngine``:

- **Match** (admission): walk the tree down the prompt's full pages —
  capped at ``(s0 - 1) // page_size`` so at least one prompt token is
  always prefilled (the last-token logits seed sampling). Matched nodes
  are ``acquire``d (refcount +1, mirrored into the device-side
  ``page_ref``) and the slot's block table points straight at their
  pages; only the uncached tail is prefilled.
- **Insert** (retirement): the request's full-page prefix — prompt AND
  written generated tokens — moves into the tree instead of the free
  stack (``release_and_insert`` returns the per-entry keep mask for
  ``kv_pool.release_slot``). A page whose key a concurrent twin already
  inserted is a duplicate and frees normally.
- **Evict** (on demand): when admission finds the free stack short, LRU
  refcount-0 LEAVES leave the tree and return to the stack
  (``kv_pool.push_free_pages``). Interior nodes are never evicted before
  their children (a child's positions extend the parent's — evicting the
  parent would orphan reachable state), and a refcount > 0 node is
  pinned by its active readers.

Correctness of sharing rests on two pool invariants: pages are
position-indexed (a cached page is only ever matched at the positions it
was written for — matches start at position 0 and extend page by page),
and the decode step never writes below a slot's length (a sharer's
writes land in its private tail pages, so cached pages are read-only).

The pool's refcounts (``cache["page_ref"]``, int32 per page, kept on the
host beside the free stack) and the nodes' mirror of them are updated
together, so admission and eviction never read the card.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from apex_tpu_torch.utils import metrics

__all__ = ["PrefixCache"]

#: rolling retirement window for the ``prefix_cache.churn`` gauge
#: (evictions per retirement, averaged over the last N retirements)
CHURN_WINDOW = 64

#: bound on the remembered-evicted-path set backing the
#: ``evicted_reinserted`` counter (best-effort: overflowing resets it)
_EVICTED_KEYS_CAP = 4096


class _Node:
    """One cached page: ``key`` is its page_size-token run, ``page`` the
    physical page id holding that run's K/V. ``refs`` mirrors the device
    ``page_ref`` entry (active slots reading this page); ``last_used`` is
    the LRU clock tick of the last match that walked through it."""

    __slots__ = ("key", "page", "parent", "children", "refs", "last_used")

    def __init__(self, key, page: int, parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children = {}
        self.refs = 0
        self.last_used = 0


class PrefixCache:
    """Host-side radix tree naming pool pages by their token-run prefix.

    Pure bookkeeping — every device mutation (refcounts, stack pushes,
    block-table rows) goes through the ``kv_pool`` ops the scheduler
    calls; this class decides WHICH pages to share, keep, and evict."""

    def __init__(self, page_size: int,
                 metrics_labels: Optional[dict] = None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.root = _Node(key=None, page=-1, parent=None)
        self._nodes: set = set()
        self._tick = 0
        # eviction-churn observability: the
        # paths recently evicted (so a RE-insertion of an evicted path —
        # the thrash signature — is distinguishable from first-time
        # growth), evictions accumulated since the last retirement, and
        # the rolling evictions-per-retirement window behind the
        # ``prefix_cache.churn`` gauge
        self._evicted_keys: set = set()
        self._churn_window: deque = deque(maxlen=CHURN_WINDOW)
        self._evictions_since_retire = 0
        # label set for the cache's gauges/counters (the engine passes
        # its ``engine`` label so two caches never clobber one family)
        self._metrics_labels = (dict(metrics_labels)
                                if metrics_labels else None)

    # --- introspection ------------------------------------------------------

    def __len__(self) -> int:
        """Number of cached pages (= tree nodes, root excluded)."""
        return len(self._nodes)

    def _observe(self) -> None:
        """Refresh the residency gauge (``prefix_cache.pages``); called on
        every tree mutation — host-side dict math, no device traffic."""
        metrics.gauge("prefix_cache.pages",
                      labels=self._metrics_labels).set(len(self._nodes))

    def pages(self) -> List[int]:
        """Physical page ids the cache currently holds (order arbitrary)."""
        return [n.page for n in self._nodes]

    def _page_key(self, tokens, j: int):
        ps = self.page_size
        return tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])

    def _path_hash(self, node: _Node) -> int:
        """Process-stable identity of a node's full token path (root →
        node) — how a re-insertion of a previously EVICTED path is
        recognized (the churn signature; a fresh path is just growth)."""
        return hash(self._path_keys(node))

    def _path_keys(self, node: _Node):
        """A node's full token path (root → node) as the tuple of its
        ancestors' page keys — the radix-node identity the host tier
        (``serving/host_tier.py``) files demoted pages under: token
        content, not physical page id, so defrag/realloc never
        invalidates a tier entry."""
        parts = []
        while node is not None and node.key is not None:
            parts.append(node.key)
            node = node.parent
        return tuple(reversed(parts))

    # --- admission ----------------------------------------------------------

    def match(self, prompt) -> List[_Node]:
        """Longest cached full-page prefix of ``prompt``: the node path,
        shallowest first (``[n.page for n in path]`` is the block-table
        prefix). Capped at ``(len(prompt) - 1) // page_size`` pages so the
        admission always prefills >= 1 token — the tail forward's
        last-position logits are what seed the first sampled token. Bumps
        the LRU clock along the path. Does NOT take references — call
        ``acquire`` once the admission commits (and nothing if it defers)."""
        prompt = np.asarray(prompt).reshape(-1)
        cap = max(int(prompt.shape[0]) - 1, 0) // self.page_size
        self._tick += 1
        path: List[_Node] = []
        node = self.root
        for j in range(cap):
            child = node.children.get(self._page_key(prompt, j))
            if child is None:
                break
            child.last_used = self._tick
            path.append(child)
            node = child
        return path

    def acquire(self, nodes: Sequence[_Node]) -> None:
        """Pin matched nodes for an admitted request (host mirror of the
        ``page_ref`` +1 that ``kv_pool.alloc_slot_shared`` applies)."""
        for n in nodes:
            n.refs += 1

    def release(self, nodes: Sequence[_Node]) -> None:
        """Undo ``acquire`` for a request that never got a device-side
        footprint (admission deferred after matching)."""
        for n in nodes:
            n.refs -= 1

    # --- retirement ---------------------------------------------------------

    def release_and_insert(self, tokens, written: int,
                           matched: Sequence[_Node], row,
                           ) -> np.ndarray:
        """Retire a request: drop its references on the matched prefix and
        move its newly-written full pages into the tree.

        ``tokens``: the request's WRITTEN token sequence (prompt followed
        by the generated tokens whose K/V actually landed in the pool);
        ``written``: its length — only full pages (``written //
        page_size``) are cacheable, the partial boundary page frees.
        ``matched``: the node path ``match`` returned at admission (their
        pages are the row's leading shared entries). ``row``: the slot's
        block-table row (host copy) — entry ``j`` holds the physical page
        for positions ``[j*ps, (j+1)*ps)``.

        Returns the bool keep mask for ``kv_pool.release_slot``: True
        entries stay cache property (the shared prefix + newly inserted
        pages), False entries return to the free stack (the partial tail,
        the preallocated-but-unused pages, and duplicates — pages whose
        key a concurrently-retired twin already inserted)."""
        row = np.asarray(row).reshape(-1)
        m = len(matched)
        n_cache = int(written) // self.page_size
        keep = np.zeros(row.shape[0], dtype=bool)
        keep[:m] = True                  # shared pages stay with the cache
        node = matched[-1] if matched else self.root
        self._tick += 1
        reinserted = 0
        for j in range(m, n_cache):
            key = self._page_key(tokens, j)
            child = node.children.get(key)
            if child is None:
                child = _Node(key=key, page=int(row[j]), parent=node)
                child.last_used = self._tick
                node.children[key] = child
                self._nodes.add(child)
                keep[j] = True           # ownership transfers to the cache
                pk = self._path_hash(child)
                if pk in self._evicted_keys:
                    # the churn signature: this exact path was evicted
                    # earlier and is now being recomputed + re-cached
                    self._evicted_keys.discard(pk)
                    reinserted += 1
            # else: a twin inserted this run first — our copy is a
            # duplicate and frees (keep[j] stays False); continue the walk
            # under the canonical node so deeper pages chain correctly
            node = child
        self.release(matched)
        inserted = int(keep[m:n_cache].sum())
        metrics.counter("prefix_cache.inserted_pages",
                        labels=self._metrics_labels).inc(inserted)
        metrics.counter("prefix_cache.duplicate_pages",
                        labels=self._metrics_labels).inc(
            (n_cache - m) - inserted)
        if reinserted:
            metrics.counter("prefix_cache.evicted_reinserted",
                            labels=self._metrics_labels).inc(reinserted)
        # churn = evictions per retirement over the rolling window: ~0
        # in steady state, >= 1 when every admission cycle evicts some
        # other tenant's pages (the eviction-churn scenario's gauge)
        self._churn_window.append(self._evictions_since_retire)
        self._evictions_since_retire = 0
        metrics.gauge("prefix_cache.churn",
                      labels=self._metrics_labels).set(
            sum(self._churn_window) / len(self._churn_window))
        self._observe()
        return keep

    # --- eviction -----------------------------------------------------------

    def evict(self, n: int, *, sink=None) -> List[int]:
        """Evict up to ``n`` pages — LRU first, leaves only, refcount-0
        only — removing their nodes and returning the physical page ids
        for ``kv_pool.push_free_pages``. Evicting a leaf can expose its parent
        as the next candidate, so candidates heap by ``last_used`` and a
        parent enters the heap the moment its last child leaves —
        O((candidates + n) log candidates), no per-victim rescans. Pinned
        (refcount > 0) or interior pages never leave.

        ``sink``: optional ``sink(path_keys, page)`` callback invoked per
        victim BEFORE its page id is returned for the free-stack push —
        the host tier's demote hook (the frontend dispatches the page
        gather against these ids first, so the device-stream copy reads
        the page before any re-allocation can overwrite it). ``path_keys``
        is the victim's full root→node token path (its tier identity)."""
        out: List[int] = []
        heap = [(nd.last_used, id(nd), nd) for nd in self._nodes
                if not nd.children and nd.refs == 0]
        heapq.heapify(heap)
        while heap and len(out) < n:
            _, _, victim = heapq.heappop(heap)
            if (victim not in self._nodes or victim.children
                    or victim.refs != 0):
                continue                 # stale entry (state moved on)
            parent = victim.parent
            # remember the evicted PATH (victim.parent stays linked, so
            # the walk still works after the detach below) — bounded:
            # overflow resets the set, trading a few missed reinsert
            # counts for O(1) memory
            if len(self._evicted_keys) >= _EVICTED_KEYS_CAP:
                self._evicted_keys.clear()
            self._evicted_keys.add(self._path_hash(victim))
            if sink is not None:
                sink(self._path_keys(victim), victim.page)
            del parent.children[victim.key]
            self._nodes.remove(victim)
            out.append(victim.page)
            if (parent is not self.root and not parent.children
                    and parent.refs == 0):
                heapq.heappush(heap, (parent.last_used, id(parent), parent))
        self._evictions_since_retire += len(out)
        metrics.counter("prefix_cache.evicted_pages",
                        labels=self._metrics_labels).inc(len(out))
        self._observe()
        return out

    # --- maintenance --------------------------------------------------------

    def remap(self, new_idx) -> None:
        """Follow a ``kv_pool.defrag_map`` compaction: rewrite every
        node's physical page through ``new_idx[old_page] = new_page``. The
        scheduler passes the cache's pages as ``extra_live``, so every
        node's page survived the compaction by construction."""
        new_idx = np.asarray(new_idx)
        for node in self._nodes:
            node.page = int(new_idx[node.page])
