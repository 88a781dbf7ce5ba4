"""Port parity: apex_tpu_torch PagedDecodeEngine vs apex_tpu's engine.

A mixed-length request set (6 requests, prompts 3-20 tokens, budgets 4-12,
3 slots, page 8) through the JAX engine once and through the port's engine
at ``sync_every`` 1 and 3: outputs must be token-identical, request by
request, to the JAX engine and to the port's lock-step ``generate``; the
pool must drain back to ``num_pages - 1`` free pages; the engine must take
as many decode steps as JAX's engine at the same ``sync_every`` (both run
the reference pump's order, where a finished slot's successor joins one
chunk late), and at ``sync_every`` 1 fewer than lock-step padding. fp32
tiny GPT.
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
from apex_tpu_torch.serving import (PagedDecodeEngine, Request, alloc_slot,
                                    free_page_count, free_slot,
                                    generate_paged, init_paged_cache,
                                    prompt_bucket, release_slot)
from apex_tpu.serving.scheduler import prompt_bucket as jax_prompt_bucket

SLOTS, PS = 3, 8


def _workload(seed=1, n=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, int(rng.integers(3, 21))).astype(np.int32),
             int(rng.integers(4, 13))) for _ in range(n)]


@pytest.fixture(scope="module")
def setup():
    jm = JaxGPT(jax_tiny())
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tm = GPTModel(gpt_tiny_config(), device="cpu")
    tm.load_state_dict(gpt_params_from_flax(
        jax.tree.map(np.asarray, variables)))
    work = _workload()
    jax_outs, _ = JaxEngine(jm, variables, num_slots=SLOTS,
                            page_size=PS).run(
        [JaxRequest(p, n) for p, n in work])
    lockstep = [generate(tm, torch.from_numpy(p)[None], n)[0, len(p):]
                .numpy() for p, n in work]
    return tm.eval(), work, jax_outs, lockstep, (jm, variables)


@pytest.fixture(scope="module")
def jax_steps(setup):
    """JAX's engine's decode steps on the workload, by ``sync_every``."""
    work, (jm, variables) = setup[1], setup[4]
    return {se: JaxEngine(jm, variables, num_slots=SLOTS, page_size=PS,
                          sync_every=se).run(
        [JaxRequest(p, n) for p, n in work])[1]["decode_steps"]
        for se in (1, 3)}


@pytest.mark.parametrize("sync_every", [1, 3])
def test_engine_token_identical_to_jax_engine_and_lockstep(setup, jax_steps,
                                                           sync_every):
    tm, work, jax_outs, lockstep, _ = setup
    eng = PagedDecodeEngine(tm, num_slots=SLOTS, page_size=PS,
                            sync_every=sync_every)
    outs, stats = eng.run([Request(p, n) for p, n in work])
    for i, (o, j, ref) in enumerate(zip(outs, jax_outs, lockstep)):
        np.testing.assert_array_equal(o, np.asarray(j), err_msg=f"req {i}")
        np.testing.assert_array_equal(o, ref, err_msg=f"req {i}")
    num_pages = eng.cache["free_stack"].shape[0]
    assert free_page_count(eng.cache) == num_pages - 1
    assert (eng.cache["block_tables"] == 0).all()
    assert stats["admitted"] == stats["retired"] == len(work)
    assert stats["generated_tokens"] == sum(n for _, n in work)
    budgets = sorted((n for _, n in work), reverse=True)
    lock_steps = sum(max(budgets[g:g + SLOTS])
                     for g in range(0, len(budgets), SLOTS))
    assert stats["decode_steps"] == jax_steps[sync_every]
    if sync_every == 1:
        assert stats["decode_steps"] < lock_steps


def test_eos_retires_early_and_matches_lockstep(setup):
    tm, work, _, lockstep, _ = setup
    eos = int(lockstep[0][2])       # a token request 0 emits mid-stream
    eng = PagedDecodeEngine(tm, num_slots=2, page_size=PS,
                            eos_token_id=eos)
    outs, _ = eng.run([Request(p, n) for p, n in work])
    for (p, n), o in zip(work, outs):
        ref = generate(tm, torch.from_numpy(p)[None], n,
                       eos_token_id=eos)[0, len(p):].numpy()
        hit = np.flatnonzero(ref == eos)
        want = ref[:hit[0] + 1] if hit.size else ref
        np.testing.assert_array_equal(o, want)
    assert outs[0].shape[0] == 3 and outs[0][-1] == eos


def test_small_pool_defers_admission_head_of_line(setup):
    """A pool holding ~one request at a time still drains correctly."""
    tm, work, _, lockstep, _ = setup
    eng = PagedDecodeEngine(tm, num_slots=SLOTS, page_size=PS, num_pages=5)
    outs, stats = eng.run([Request(p, n) for p, n in work])
    for o, ref in zip(outs, lockstep):
        np.testing.assert_array_equal(o, ref)
    assert free_page_count(eng.cache) == 4


def test_generate_paged_rectangular_matches_generate(setup):
    tm = setup[0]
    ids = np.random.default_rng(4).integers(0, 128, (3, 6)).astype(np.int32)
    out = generate_paged(tm, torch.from_numpy(ids), 7, num_slots=2,
                         page_size=PS)
    np.testing.assert_array_equal(
        out.numpy(), generate(tm, torch.from_numpy(ids), 7).numpy())


def test_pool_alloc_release_matches_jax_pool():
    """Same alloc/free sequence -> same block tables and free stacks."""
    jcfg, tcfg = jax_tiny(), gpt_tiny_config()
    jc = jax_pool.init_paged_cache(jcfg, num_slots=3, num_pages=12,
                                   page_size=8)
    tc = init_paged_cache(tcfg, 3, num_pages=12, page_size=8, device="cpu")
    ops = [("alloc", 0, 3), ("alloc", 1, 4), ("alloc", 2, 2), ("free", 1),
           ("alloc", 1, 3), ("release", 0, [True, False, True])]
    for op in ops:
        if op[0] == "alloc":
            jc = jax_pool.alloc_slot(jc, op[1], op[2])
            alloc_slot(tc, op[1], op[2])
        elif op[0] == "free":
            jc = jax_pool.free_slot(jc, op[1])
            free_slot(tc, op[1])
        else:
            keep = np.zeros(jc["block_tables"].shape[1], bool)
            keep[:len(op[2])] = op[2]
            jc = jax_pool.release_slot(jc, op[1], jnp.asarray(keep))
            release_slot(tc, op[1], keep)
        assert free_page_count(tc) == int(jax_pool.free_page_count(jc))
        np.testing.assert_array_equal(tc["block_tables"].numpy(),
                                      np.asarray(jc["block_tables"]))
        top = free_page_count(tc)
        np.testing.assert_array_equal(tc["free_stack"][:top].numpy(),
                                      np.asarray(jc["free_stack"][:top]))
        np.testing.assert_array_equal(tc["alloc_pages"].numpy(),
                                      np.asarray(jc["alloc_pages"]))


@pytest.mark.parametrize("s0", [1, 7, 8, 9, 120, 127])
def test_prompt_bucket_matches(s0):
    assert prompt_bucket(s0, 8, 128) == jax_prompt_bucket(s0, 8, 128)


@pytest.mark.parametrize("kw,exc,match", [
    pytest.param(dict(prefix_cache=True), NotImplementedError,
                 "prefix cache", id="kw0-prefix cache"),
    # the reference's refusals of the speculative and chunked modes
    pytest.param(dict(draft_kv_dtype="int8", draft_len=2, draft=True),
                 ValueError, "kv-dtype-mismatch", id="kw1-quantized"),
    pytest.param(dict(draft_len=8, draft=True), ValueError,
                 "query-block limit", id="kw2-speculative"),
    pytest.param(dict(prefill_chunk=9), ValueError, "1..page_size",
                 id="kw3-chunked prefill"),
    pytest.param(dict(temperature=0.7), NotImplementedError, "sampled",
                 id="kw4-sampled"),
])
def test_unported_engine_modes_raise_at_construction(setup, kw, exc, match):
    """What the engine refuses when built: the unported prefix cache and
    sampled decode (``NotImplementedError``), and the reference's
    ``ValueError``s for a draft pool of another kv dtype, a draft block
    longer than a page and a prefill chunk outside ``1..page_size``."""
    tm = setup[0]
    kw = dict(kw)
    if kw.pop("draft", False):
        kw["draft_model"] = tm
    with pytest.raises(exc, match=match):
        PagedDecodeEngine(tm, num_slots=2, page_size=PS, **kw)


@pytest.mark.parametrize("kw,match", [
    (dict(draft_len=2), "needs a draft_model"),
    (dict(draft_len=2, draft=True, temperature=0.5), "greedy-only"),
    (dict(draft_len=2, draft=True, prefix_cache=True), "prefix_cache"),
    (dict(draft_len=2, draft=True, prefill_chunk=4), "mutually exclusive"),
    (dict(draft_len=-1), "draft_len must be >= 0"),
    (dict(prefill_chunk=0), "1..page_size"),
])
def test_spec_and_chunked_refusals_match_the_reference(setup, kw, match):
    """The rest of the reference's construction checks, by its messages."""
    tm = setup[0]
    kw = dict(kw)
    if kw.pop("draft", False):
        kw["draft_model"] = tm
    with pytest.raises(ValueError, match=match):
        PagedDecodeEngine(tm, num_slots=2, page_size=PS, **kw)


def test_engine_rejects_oversized_request(setup):
    tm = setup[0]
    eng = PagedDecodeEngine(tm, num_slots=2, page_size=PS)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        eng.run([Request(np.zeros(120, np.int32), 9)])
