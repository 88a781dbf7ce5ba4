"""Port parity: windowed Llama serving, apex_tpu_torch against apex_tpu.

Tiny Llama (GQA, 4 heads over 2 kv heads) with a sliding window of 16
tokens, two pages of 8, weights from JAX (``init`` at key 0) bridged to the
port. Five requests whose prompts plus budgets run past the window (23 to
41 tokens) go through JAX's engine once (module-scoped) and through the
port's engine at ``sync_every`` 1 and 2, 3 slots: outputs must be
token-identical, request by request, to JAX's engine and to the port's
lock-step ``generate``; the engine must have dropped pages below the band (``window_dropped_pages >
0``) and the pool must drain back to ``num_pages - 1`` free pages with
every table row null. ``drop_slot_pages`` against the reference's: the
same allocs and drops leave the same block tables and free stacks, and a
page frees once. Over int8 and fp8 pools the engine is token-identical to
JAX's engine over the same pool, with the same 8 pages dropped. The engine
still refuses the prefix cache, and refuses
chunked prefill and speculative decode for a windowed model with the
reference's ``ValueError``. fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.llama import LlamaModel as JaxLlama
from apex_tpu.models.llama import llama_tiny_config as jax_tiny
from apex_tpu.serving import PagedDecodeEngine as JaxEngine
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import kv_pool as jax_pool
from apex_tpu_torch.bridge import llama_params_from_flax
from apex_tpu_torch.models import LlamaModel, generate, llama_tiny_config
from apex_tpu_torch.serving import (PagedDecodeEngine, Request, alloc_slot,
                                    drop_slot_pages, free_page_count,
                                    free_slot, generate_paged,
                                    init_paged_cache)

SLOTS, PS, WINDOW = 3, 8, 16


def _workload(seed=2):
    rng = np.random.default_rng(seed)
    lens, budgets = (20, 5, 33, 12, 3), (12, 30, 8, 25, 20)
    return [(rng.integers(0, 128, n).astype(np.int32), b)
            for n, b in zip(lens, budgets)]


@pytest.fixture(scope="module")
def setup():
    jm = JaxLlama(jax_tiny(sliding_window=WINDOW))
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tm = LlamaModel(llama_tiny_config(sliding_window=WINDOW), device="cpu")
    tm.load_state_dict(llama_params_from_flax(
        jax.tree.map(np.asarray, variables)))
    work = _workload()
    assert all(len(p) + n > WINDOW for p, n in work)
    jax_outs, jax_stats = JaxEngine(jm, variables, num_slots=SLOTS,
                                    page_size=PS).run(
        [JaxRequest(p, n) for p, n in work])
    assert jax_stats["window_dropped_pages"] > 0
    lockstep = [generate(tm, torch.from_numpy(p)[None], n)[0, len(p):]
                .numpy() for p, n in work]
    return tm.eval(), work, jax_outs, lockstep, (jm, variables)


@pytest.mark.parametrize("sync_every", [1, 2])
def test_windowed_engine_token_identical_to_jax_engine_and_lockstep(
        setup, sync_every):
    tm, work, jax_outs, lockstep, _ = setup
    eng = PagedDecodeEngine(tm, num_slots=SLOTS, page_size=PS,
                            sync_every=sync_every)
    outs, stats = eng.run([Request(p, n) for p, n in work])
    for i, (o, j, ref) in enumerate(zip(outs, jax_outs, lockstep)):
        np.testing.assert_array_equal(o, np.asarray(j), err_msg=f"req {i}")
        np.testing.assert_array_equal(o, ref, err_msg=f"req {i}")
    assert stats["window_dropped_pages"] > 0
    num_pages = eng.cache["free_stack"].shape[0]
    assert free_page_count(eng.cache) == num_pages - 1
    assert sorted(eng.cache["free_stack"].tolist()) == list(range(num_pages))
    assert (eng.cache["block_tables"] == 0).all()
    assert stats["admitted"] == stats["retired"] == len(work)


@pytest.mark.parametrize("sync_every", [1, 2])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_windowed_engine_over_a_quantized_pool_matches_jax(setup, kv_dtype,
                                                           sync_every):
    """The windowed engine over an int8 and an fp8 pool: token-identical
    to JAX's engine over the same pool at the same ``sync_every``, with the
    same 8 pages dropped below the band on both sides."""
    tm, work = setup[0], setup[1]
    jm, variables = setup[4]
    kw = dict(num_slots=SLOTS, page_size=PS, sync_every=sync_every,
              kv_dtype=kv_dtype)
    jax_outs, jax_stats = JaxEngine(jm, variables, **kw).run(
        [JaxRequest(p, n) for p, n in work])
    eng = PagedDecodeEngine(tm, **kw)
    outs, stats = eng.run([Request(p, n) for p, n in work])
    for i, (o, j) in enumerate(zip(outs, jax_outs)):
        np.testing.assert_array_equal(o, np.asarray(j), err_msg=f"req {i}")
    assert stats["window_dropped_pages"] == \
        jax_stats["window_dropped_pages"] == 8
    assert stats["decode_steps"] == jax_stats["decode_steps"]
    assert free_page_count(eng.cache) == eng.cache["free_stack"].shape[0] - 1


def test_windowed_engine_drops_pages_as_the_band_passes(setup):
    """One request of 40 prompt tokens and 24 new ones, page 8, window 16:
    the last decode step queries position 62 (the 24th token comes from
    it), so by then the entries of pages 0-4 lie below the band ((62 + 1 -
    16) // 8 = 5), and the pool holds every page again after the drain."""
    tm = setup[0]
    prompt = np.random.default_rng(7).integers(0, 128, 40).astype(np.int32)
    eng = PagedDecodeEngine(tm, num_slots=1, page_size=PS, num_pages=9)
    outs, stats = eng.run([Request(prompt, 24)])
    assert stats["window_dropped_pages"] == 5
    np.testing.assert_array_equal(
        outs[0], generate(tm, torch.from_numpy(prompt)[None], 24)[0, 40:])
    assert free_page_count(eng.cache) == 8


def test_generate_paged_serves_llama(setup):
    tm = setup[0]
    ids = np.random.default_rng(4).integers(0, 128, (2, 19)).astype(np.int32)
    out, stats = generate_paged(tm, torch.from_numpy(ids), 14, num_slots=2,
                                page_size=PS, return_stats=True)
    np.testing.assert_array_equal(
        out.numpy(), generate(tm, torch.from_numpy(ids), 14).numpy())
    assert stats["window_dropped_pages"] > 0


def test_drop_slot_pages_matches_jax_pool():
    """The same allocs, drops with a growing ``upto`` and retirements on a
    JAX and a port pool leave the same tables and free stacks; a dropped
    page frees once, at the drop, and not again at retirement."""
    jc = jax_pool.init_paged_cache(jax_tiny(), num_slots=3, num_pages=14,
                                   page_size=PS)
    tc = init_paged_cache(llama_tiny_config(), 3, num_pages=14, page_size=PS,
                          device="cpu")
    ops = [("alloc", 0, 5), ("alloc", 1, 4), ("drop", 0, 2), ("drop", 0, 2),
           ("drop", 0, 3), ("alloc", 2, 4), ("drop", 1, 1), ("free", 0),
           ("drop", 2, 4), ("free", 1), ("free", 2)]
    for op in ops:
        if op[0] == "alloc":
            jc = jax_pool.alloc_slot(jc, op[1], op[2])
            alloc_slot(tc, op[1], op[2])
        elif op[0] == "drop":
            jc = jax_pool.drop_slot_pages(jc, jnp.int32(op[1]),
                                          jnp.int32(op[2]))
            drop_slot_pages(tc, op[1], op[2])
        else:
            jc = jax_pool.free_slot(jc, op[1])
            free_slot(tc, op[1])
        top = free_page_count(tc)
        assert top == int(jax_pool.free_page_count(jc)), op
        np.testing.assert_array_equal(tc["block_tables"].numpy(),
                                      np.asarray(jc["block_tables"]))
        np.testing.assert_array_equal(tc["free_stack"][:top].numpy(),
                                      np.asarray(jc["free_stack"][:top]))
        np.testing.assert_array_equal(tc["alloc_pages"].numpy(),
                                      np.asarray(jc["alloc_pages"]))
    assert free_page_count(tc) == 13
    assert sorted(tc["free_stack"][:13].tolist()) == list(range(1, 14))


@pytest.mark.parametrize("kw,exc,match", [
    pytest.param(dict(prefix_cache=True), NotImplementedError,
                 "prefix cache", id="kw0-prefix cache"),
    # the reference's ValueErrors: neither mode composes with the window
    pytest.param(dict(prefill_chunk=4), ValueError, "sliding-window",
                 id="kw1-chunked prefill"),
    pytest.param(dict(draft_len=2, draft=True), ValueError,
                 "sliding-window", id="kw2-speculative"),
])
def test_windowed_engine_refuses_what_the_reference_refuses(setup, kw, exc,
                                                            match):
    kw = dict(kw)
    if kw.pop("draft", False):
        kw["draft_model"] = setup[0]
    with pytest.raises(exc, match=match):
        PagedDecodeEngine(setup[0], num_slots=2, page_size=PS, **kw)
