"""The shared-prefix KV cache of the port (``serving/prefix_cache.py``,
``kv_pool``'s sharing ops, the engine's ``prefix_cache=True``) against the
JAX reference, on the CPU.

Invariant tier (no model), the reference's own cases on the port: the
radix tree's match, insert, dedup and LRU leaf-only eviction; the pool's
``alloc_slot_shared`` / ``release_slot`` / ``free_slot`` refcounts and
free-stack bookkeeping; ``defrag_map``'s permutation against the
reference's.

Engine tier (tiny GPT, flax weights bridged into the port, fp32): a
shared-system-prompt workload decodes token-identically with the prefix
cache on and off and to JAX's engine with it on, and ``prefix_hits``,
``prefill_tokens_skipped`` and ``evicted_pages`` equal the JAX engine's on
the same requests; then the reference's engine cases mirrored on the port
against lock-step ``generate``: a partial match, a hit after eviction,
pool exhaustion deferring, a leak provoking ``defrag`` and a defrag
remapping the tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPTModel as JaxGPT
from apex_tpu.models.gpt import gpt_tiny_config as jax_tiny
from apex_tpu.serving import PagedDecodeEngine as JaxEngine
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import kv_pool as jax_pool
from apex_tpu_torch.bridge import gpt_params_from_flax
from apex_tpu_torch.models import GPTModel, generate, gpt_tiny_config
from apex_tpu_torch.serving import (PagedDecodeEngine, PrefixCache, Request,
                                    alloc_slot_shared, defrag_map,
                                    free_page_count, free_slot,
                                    init_paged_cache, release_slot)

PS = 8


@pytest.fixture(scope="module")
def pair():
    jm = JaxGPT(jax_tiny())
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tm = GPTModel(gpt_tiny_config(), device="cpu")
    tm.load_state_dict(gpt_params_from_flax(
        jax.tree.map(np.asarray, variables)))
    return jm, variables, tm.eval()


def _lockstep(tm, req):
    p = np.asarray(req.prompt)
    return generate(tm, torch.from_numpy(p)[None],
                    req.max_new_tokens)[0, p.shape[0]:].numpy()


def _req(rng, prefix, tail_len, max_new):
    tail = rng.integers(0, 100, (tail_len,)).astype(np.int32)
    return Request(np.concatenate([prefix, tail]).astype(np.int32), max_new)


# --- invariant tier ----------------------------------------------------------


def test_radix_match_insert_dedup_evict():
    pc = PrefixCache(page_size=4)
    toks = np.arange(14, dtype=np.int32)          # 3 full pages + 2 tail
    row = np.asarray([11, 12, 13, 14, 0, 0], np.int32)
    assert pc.match(toks) == []
    keep = pc.release_and_insert(toks, 14, [], row)
    assert keep.tolist() == [True, True, True, False, False, False]
    assert len(pc) == 3 and sorted(pc.pages()) == [11, 12, 13]
    # match is capped at (len - 1) // ps, so >= 1 token always prefills
    assert [n.page for n in pc.match(toks)] == [11, 12, 13]
    assert [n.page for n in pc.match(toks[:12])] == [11, 12]
    assert [n.page for n in pc.match(toks[:5])] == [11]
    div = toks.copy()
    div[5] = 99
    assert [n.page for n in pc.match(div)] == [11]
    # a concurrent twin's duplicate insert: the existing nodes win
    keep2 = pc.release_and_insert(toks, 14, [], np.asarray(
        [21, 22, 23, 24, 0, 0], np.int32))
    assert not keep2.any() and len(pc) == 3
    # references pin; eviction is LRU and leaf-only
    nodes = pc.match(toks)
    pc.acquire(nodes)
    assert pc.evict(3) == []
    pc.release(nodes)
    pc.match(toks[:9])
    assert pc.evict(1) == [13]
    assert pc.evict(5) == [12, 11]
    assert len(pc) == 0


def test_kv_pool_shared_ops_refcounts():
    cfg = gpt_tiny_config()
    cache = init_paged_cache(cfg, 2, num_pages=12, page_size=PS,
                             device="cpu")
    free_slot(cache, 0)                            # a no-op on an empty slot
    assert free_page_count(cache) == 11
    shared_row = torch.zeros((cache["block_tables"].shape[1],),
                             dtype=torch.int32)
    shared_row[:2] = torch.tensor([1, 2])
    cache["free_stack"] = torch.tensor([3, 4, 5, 6, 7, 8, 9, 10, 11, 0, 0,
                                        0], dtype=torch.int32)
    cache["free_top"] = 9
    alloc_slot_shared(cache, 0, shared_row, 2, 2)
    assert free_page_count(cache) == 7
    assert int(cache["shared_pages"][0]) == 2
    assert int(cache["alloc_pages"][0]) == 2
    assert cache["page_ref"][[1, 2]].tolist() == [1, 1]
    row = cache["block_tables"][0].numpy().copy()
    assert row[:2].tolist() == [1, 2] and (row[2:4] > 2).all()
    alloc_slot_shared(cache, 1, shared_row, 2, 1)
    assert cache["page_ref"][[1, 2]].tolist() == [2, 2]
    free_slot(cache, 1)
    assert cache["page_ref"][[1, 2]].tolist() == [1, 1]
    assert free_page_count(cache) == 7
    keep = np.zeros((row.shape[0],), bool)
    keep[:3] = True
    release_slot(cache, 0, torch.from_numpy(keep))
    assert cache["page_ref"][[1, 2]].tolist() == [0, 0]
    assert free_page_count(cache) == 8
    assert int(cache["shared_pages"][0]) == 0
    free = set(cache["free_stack"][:cache["free_top"]].tolist())
    assert row[2] not in free and row[3] in free


def test_defrag_map_equals_the_reference():
    """The compaction's permutation, block tables, refcounts and free
    stack equal JAX's on a fragmented pool with shared pages and extra
    liveness; every page's contents move with it."""
    cfg = gpt_tiny_config()
    tc = init_paged_cache(cfg, 3, num_pages=16, page_size=PS, device="cpu")
    jc = jax_pool.init_paged_cache(jax_tiny(), 3, num_pages=16,
                                   page_size=PS)
    for lc in tc["layers"]:
        lc["k_pages"].copy_(torch.arange(16.0)[:, None, None, None])
    rows = {0: [5, 9, 2], 1: [14, 3], 2: [11]}
    for slot, pages in rows.items():
        row = np.zeros((tc["block_tables"].shape[1],), np.int32)
        row[:len(pages)] = pages
        tc["block_tables"][slot] = torch.from_numpy(row)
        jc["block_tables"] = jc["block_tables"].at[slot].set(row)
        n_sh = 1 if slot == 1 else 0
        tc["alloc_pages"][slot] = len(pages) - n_sh
        tc["shared_pages"][slot] = n_sh
        jc["alloc_pages"] = jc["alloc_pages"].at[slot].set(len(pages) - n_sh)
        jc["shared_pages"] = jc["shared_pages"].at[slot].set(n_sh)
    tc["page_ref"][14] = 1
    jc["page_ref"] = jc["page_ref"].at[14].set(1)
    extra = np.zeros((16,), bool)
    extra[[7, 13]] = True
    tc, t_idx = defrag_map(tc, torch.from_numpy(extra))
    jc, j_idx = jax_pool.defrag_map(jc, jnp.asarray(extra))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(tc["block_tables"].numpy(),
                                  np.asarray(jc["block_tables"]))
    np.testing.assert_array_equal(tc["page_ref"].numpy(),
                                  np.asarray(jc["page_ref"]))
    assert tc["free_top"] == int(jc["free_top"])
    np.testing.assert_array_equal(tc["free_stack"].numpy(),
                                  np.asarray(jc["free_stack"]))
    moved = tc["layers"][0]["k_pages"][:, 0, 0, 0]
    for old in (5, 9, 2, 14, 3, 11, 7, 13):
        assert moved[int(t_idx[old])] == old


# --- engine tier -------------------------------------------------------------


def test_prefix_cache_matches_jax_engine_and_off(pair):
    """4 system prompts of 1-4 pages, 10 requests adding private tails:
    tokens equal with the cache off, with it on, and to JAX's engine with
    it on; the hit, skip and eviction counters equal JAX's (a pool small
    enough to evict); after the drain no page is referenced and the free
    stack plus the cached pages partition the usable pool."""
    jm, variables, tm = pair
    rng = np.random.default_rng(0)
    systems = [rng.integers(0, 128, (n * PS,)).astype(np.int32)
               for n in (1, 2, 3, 4)]
    work = [(np.concatenate([systems[i % 4],
                             rng.integers(0, 128, (t,)).astype(np.int32)]),
             int(m))
            for i, (t, m) in enumerate(zip(rng.integers(2, 14, 10),
                                           rng.integers(2, 7, 10)))]
    kw = dict(num_slots=2, page_size=PS, num_pages=15)
    outs_off, _ = PagedDecodeEngine(tm, **kw).run(
        [Request(p, n) for p, n in work])
    eng = PagedDecodeEngine(tm, prefix_cache=True, **kw)
    outs_on, stats = eng.run([Request(p, n) for p, n in work])
    j_outs, j_stats = JaxEngine(jm, variables, prefix_cache=True, **kw).run(
        [JaxRequest(prompt=p, max_new_tokens=n) for p, n in work])
    for a, b, c in zip(outs_off, outs_on, j_outs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, np.asarray(c))
    for key in ("prefix_hits", "prefill_tokens_skipped", "evicted_pages",
                "prefill_tokens_total", "decode_steps",
                "prefix_cached_pages", "deferred_admissions"):
        assert stats[key] == j_stats[key], key
    assert stats["prefix_hits"] > 0 and stats["evicted_pages"] > 0
    assert int(eng.cache["page_ref"].sum()) == 0
    usable = eng.cache["free_stack"].shape[0] - 1
    assert free_page_count(eng.cache) == usable - len(eng.prefix)


def test_prefix_cache_token_identical_and_skips(pair):
    _, _, tm = pair
    rng = np.random.default_rng(1)
    sys_p = rng.integers(0, 128, (4 * PS,)).astype(np.int32)
    reqs = [_req(rng, sys_p, int(t), int(m))
            for t, m in zip(rng.integers(3, 12, 6), rng.integers(3, 8, 6))]
    o_off, s_off = PagedDecodeEngine(tm, num_slots=2, page_size=PS).run(reqs)
    e_on = PagedDecodeEngine(tm, num_slots=2, page_size=PS,
                             prefix_cache=True)
    o_on, s_on = e_on.run(reqs)
    for a, b in zip(o_off, o_on):
        np.testing.assert_array_equal(a, b)
    assert not s_off["prefix_cache_enabled"]
    assert s_off["prefill_tokens_skipped"] == 0
    assert s_on["prefix_hits"] >= len(reqs) - 2
    assert s_on["prefill_tokens_skipped"] >= (len(reqs) - 2) * 4 * PS
    assert (s_on["prefill_tokens_computed"]
            + s_on["prefill_tokens_skipped"]) == s_on["prefill_tokens_total"]
    o2, s2 = e_on.run(reqs)                 # a warm second run: all hit
    for a, b in zip(o_off, o2):
        np.testing.assert_array_equal(a, b)
    assert s2["prefix_hits"] == len(reqs)


def test_prefix_cache_partial_match(pair):
    _, _, tm = pair
    rng = np.random.default_rng(2)
    base = rng.integers(0, 128, (2 * PS,)).astype(np.int32)
    engine = PagedDecodeEngine(tm, num_slots=1, page_size=PS,
                               prefix_cache=True)
    warm = Request(np.concatenate(
        [base, rng.integers(0, 128, (5,)).astype(np.int32)]), 4)
    engine.run([warm])
    part = warm.prompt.copy()
    part[PS + 4] = (part[PS + 4] + 1) % 128      # inside page 1
    miss = warm.prompt.copy()
    miss[2] = (miss[2] + 1) % 128                # inside page 0
    reqs = [Request(part, 4), Request(miss, 4)]
    outs, stats = engine.run(reqs)
    for o, r in zip(outs, reqs):
        np.testing.assert_array_equal(o, _lockstep(tm, r))
    assert stats["prefix_hits"] == 1
    assert stats["prefill_tokens_skipped"] == PS


def test_prefix_cache_hit_after_evict(pair):
    _, _, tm = pair
    rng = np.random.default_rng(3)
    sys_p = rng.integers(0, 128, (2 * PS,)).astype(np.int32)
    engine = PagedDecodeEngine(tm, num_slots=1, page_size=PS, num_pages=8,
                               prefix_cache=True)
    req_a = _req(rng, sys_p, 3, 4)
    (out_a,), _ = engine.run([req_a])
    np.testing.assert_array_equal(out_a, _lockstep(tm, req_a))
    assert len(engine.prefix) >= 2
    fat = Request(rng.integers(0, 128, (5 * PS,)).astype(np.int32), PS)
    (out_f,), s_fat = engine.run([fat])
    np.testing.assert_array_equal(out_f, _lockstep(tm, fat))
    assert s_fat["evicted_pages"] >= 1
    for tail in (4, 6):
        req = _req(rng, sys_p, tail, 4)
        (out,), st = engine.run([req])
        np.testing.assert_array_equal(out, _lockstep(tm, req))
    assert st["prefix_hits"] == 1
    assert st["prefill_tokens_skipped"] >= 2 * PS


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_pool_exhaustion_defers_until_retirement(pair, prefix_cache):
    _, _, tm = pair
    rng = np.random.default_rng(4)
    reqs = [Request(rng.integers(0, 128, (2 * PS,)).astype(np.int32), PS)
            for _ in range(2)]                  # 3 pages each, 5 usable
    engine = PagedDecodeEngine(tm, num_slots=2, page_size=PS, num_pages=6,
                               prefix_cache=prefix_cache)
    outs, stats = engine.run(reqs)
    for r, o in zip(reqs, outs):
        np.testing.assert_array_equal(o, _lockstep(tm, r))
    assert stats["deferred_admissions"] >= 1
    assert stats["peak_slots_in_use"] == 1 and stats["retired"] == 2
    assert int(engine.cache["page_ref"].sum()) == 0
    cached = len(engine.prefix) if prefix_cache else 0
    assert free_page_count(engine.cache) == 5 - cached


def test_defrag_provoked_by_leak(pair):
    _, _, tm = pair
    rng = np.random.default_rng(5)
    engine = PagedDecodeEngine(tm, num_slots=1, page_size=PS, num_pages=9)
    engine.run([Request(rng.integers(0, 128, (PS,)).astype(np.int32), 4)])
    engine.cache["free_top"] -= 4             # a miscounted free
    assert free_page_count(engine.cache) == 4
    req2 = Request(rng.integers(0, 128, (4 * PS,)).astype(np.int32), PS)
    (out2,), stats = engine.run([req2])
    np.testing.assert_array_equal(out2, _lockstep(tm, req2))
    assert stats["defrag_runs"] == 1
    assert free_page_count(engine.cache) == 8  # the leak collected


def test_defrag_remaps_prefix_cache(pair):
    _, _, tm = pair
    rng = np.random.default_rng(6)
    sys_p = rng.integers(0, 128, (2 * PS,)).astype(np.int32)
    engine = PagedDecodeEngine(tm, num_slots=2, page_size=PS, num_pages=20,
                               prefix_cache=True)
    engine.run([Request(np.concatenate(
        [sys_p, rng.integers(0, 128, (1,)).astype(np.int32)]), 4)])
    assert len(engine.prefix) == 2
    engine.cache["free_top"] -= 12
    req_x = _req(rng, sys_p, 5, 12)
    req_y = Request(rng.integers(0, 128, (21,)).astype(np.int32), 4)
    outs, stats = engine.run([req_x, req_y])
    np.testing.assert_array_equal(outs[0], _lockstep(tm, req_x))
    np.testing.assert_array_equal(outs[1], _lockstep(tm, req_y))
    assert stats["defrag_runs"] >= 1 and stats["evicted_pages"] == 0
    req_z = _req(rng, sys_p, 4, 3)
    (out_z,), s_z = engine.run([req_z])
    np.testing.assert_array_equal(out_z, _lockstep(tm, req_z))
    assert s_z["prefix_hits"] == 1


def test_quantized_pool_shares_pages_and_scales(pair):
    """Over an int8 pool a hit shares the cached pages with their scales
    (only private pages' scales reset): the prefix-on run's tokens equal
    the prefix-off run's on the same quantized pool."""
    _, _, tm = pair
    rng = np.random.default_rng(7)
    sys_p = rng.integers(0, 128, (2 * PS,)).astype(np.int32)
    reqs = [_req(rng, sys_p, int(t), 5) for t in (3, 7, 2, 9)]
    kw = dict(num_slots=1, page_size=PS, kv_dtype="int8")
    off, _ = PagedDecodeEngine(tm, **kw).run(reqs)
    on, stats = PagedDecodeEngine(tm, prefix_cache=True, **kw).run(reqs)
    assert stats["prefix_hits"] == 3
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
