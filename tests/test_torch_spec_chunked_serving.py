"""Port parity: in-engine speculative decode and chunked prefill,
apex_tpu_torch against apex_tpu.

Tiny GPT (fp32) with weights from JAX (``init`` at key 0) bridged to the
port, and three drafts: the target itself (every proposal accepted), an
unrelated GPT of the same width (key 99: most proposals rejected, so every
round rolls both pools back) and a smaller one (hidden 32, 2 heads, 1
layer, key 5: the draft pool's geometry differs from the target's). Five
requests (prompts 5-37 tokens, budgets 6-13), 2 slots, page 8, greedy.

- Spec engines (``draft_len`` 3, and 2 for the small draft) at
  ``sync_every`` 1 and 2: token-identical, request by request, to JAX's
  spec engine and to the port's non-spec engine, with ``spec_tokens`` and
  ``spec_rounds`` equal to JAX's, both pools drained; EOS predicted inside
  a draft block stops emission at the EOS as the non-spec engine does.
- Chunked engines (``prefill_chunk`` 8 and 5) at ``sync_every`` 1 and 3:
  token-identical to JAX's chunked engine and to monolithic admission,
  ``chunked_prefills`` and ``prefill_chunks`` equal to JAX's.
- Over int8 pools, the spec and the chunked engine against JAX's int8
  engines in the same mode at the same ``sync_every`` (the garbage writes
  of done and mid-prefill slots requantize pages alike on both sides).
- A non-windowed tiny Llama (4 heads over 2 kv heads) spec engine with an
  unrelated Llama draft: GQA rows at ``s > 1``.
- Lock-step ``speculative_generate`` against JAX's and ``generate``.
- The draft block's overshoot bound at admission, against JAX's message.
- The draft pool: the draft's geometry, the target's kv dtype, and the
  same block tables as the target pool after every admission.
JAX runs once per configuration (module-scoped).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.generation import \
    speculative_generate as jax_speculative_generate
from apex_tpu.models.gpt import GPTModel as JaxGPT
from apex_tpu.models.gpt import gpt_tiny_config as jax_gpt_tiny
from apex_tpu.models.llama import LlamaModel as JaxLlama
from apex_tpu.models.llama import llama_tiny_config as jax_llama_tiny
from apex_tpu.serving import PagedDecodeEngine as JaxEngine
from apex_tpu.serving import Request as JaxRequest
from apex_tpu_torch.bridge import gpt_params_from_flax, llama_params_from_flax
from apex_tpu_torch.models import (GPTModel, LlamaModel, generate,
                                   gpt_tiny_config, llama_tiny_config,
                                   speculative_generate)
from apex_tpu_torch.serving import PagedDecodeEngine, Request

SLOTS, PS = 2, 8
SIZES = ((5, 6), (19, 9), (37, 7), (12, 13), (29, 6))


def _work(seed=7, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, s).astype(np.int32), n) for s, n in sizes]


def _pair(jax_model, torch_model, key, bridge):
    v = jax_model.init(jax.random.PRNGKey(key), jnp.zeros((1, 8), jnp.int32))
    torch_model.load_state_dict(bridge(jax.tree.map(np.asarray, v)))
    return jax_model, v, torch_model.eval()


@pytest.fixture(scope="module")
def models():
    small = dict(hidden_size=32, num_heads=2, num_layers=1)
    return {
        "target": _pair(JaxGPT(jax_gpt_tiny()),
                        GPTModel(gpt_tiny_config(), device="cpu"), 0,
                        gpt_params_from_flax),
        "unrelated": _pair(JaxGPT(jax_gpt_tiny()),
                           GPTModel(gpt_tiny_config(), device="cpu"), 99,
                           gpt_params_from_flax),
        "small": _pair(JaxGPT(jax_gpt_tiny(**small)),
                       GPTModel(gpt_tiny_config(**small), device="cpu"), 5,
                       gpt_params_from_flax),
        "llama": _pair(JaxLlama(jax_llama_tiny()),
                       LlamaModel(llama_tiny_config(), device="cpu"), 0,
                       llama_params_from_flax),
        "llama_draft": _pair(JaxLlama(jax_llama_tiny()),
                             LlamaModel(llama_tiny_config(), device="cpu"),
                             7, llama_params_from_flax),
    }


def _jax_run(models, target, work, draft=None, **kw):
    jm, jv, _ = models[target]
    if draft is not None:
        kw.update(draft_model=models[draft][0],
                  draft_variables=models[draft][1])
    return JaxEngine(jm, jv, num_slots=SLOTS, page_size=PS, **kw).run(
        [JaxRequest(p, n) for p, n in work])


def _run(models, target, work, draft=None, **kw):
    if draft is not None:
        kw["draft_model"] = models[draft][2]
    eng = PagedDecodeEngine(models[target][2], num_slots=SLOTS,
                            page_size=PS, **kw)
    outs, stats = eng.run([Request(p, n) for p, n in work])
    for pool in (eng.cache, eng.draft_cache):
        if pool is not None:             # every page back on the stack
            num_pages = pool["free_stack"].shape[0]
            assert pool["free_top"] == num_pages - 1
            assert (pool["block_tables"] == 0).all()
    return outs, stats


def _same(outs, want):
    assert len(outs) == len(want)
    for i, (o, w) in enumerate(zip(outs, want)):
        np.testing.assert_array_equal(o, np.asarray(w), err_msg=f"req {i}")


@pytest.fixture(scope="module")
def base(models):
    """The port's non-spec monolithic engine on the workload."""
    return _run(models, "target", _work())[0]


SPEC_CASES = {"self": ("target", 3), "unrelated": ("unrelated", 3),
              "small": ("small", 2)}


@pytest.fixture(scope="module")
def jax_spec(models):
    return {name: _jax_run(models, "target", _work(), draft=d,
                           draft_len=n, sync_every=2)
            for name, (d, n) in SPEC_CASES.items()}


@pytest.mark.parametrize("sync_every", [1, 2])
@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_engine_matches_jax_spec_engine_and_non_spec(
        models, base, jax_spec, case, sync_every):
    draft, draft_len = SPEC_CASES[case]
    outs, stats = _run(models, "target", _work(), draft=draft,
                       draft_len=draft_len, sync_every=sync_every)
    jax_outs, jax_stats = jax_spec[case]
    _same(outs, jax_outs)
    _same(outs, base)
    assert stats["spec_tokens"] == jax_stats["spec_tokens"]
    assert stats["spec_rounds"] == jax_stats["spec_rounds"]
    assert stats["spec_tokens"] == sum(len(o) - 1 for o in outs)
    if case == "self":                   # every proposal accepted
        assert stats["mean_acceptance_len"] > 2.0
    else:
        assert stats["mean_acceptance_len"] >= 1.0
    if sync_every == 2:
        assert stats["decode_steps"] == jax_stats["decode_steps"]


@pytest.mark.parametrize("sync_every", [1, 2])
def test_spec_eos_inside_a_draft_block(models, sync_every):
    """EOS predicted mid-block: emission stops AT the EOS, as the non-spec
    engine's and JAX's spec engine's."""
    work = _work(seed=3, sizes=((5, 12), (9, 12)))
    base_outs, _ = _run(models, "target", work)
    # the first token of request 0 that is new at its index, inside the
    # first round's block of 4 (tokens 1-4; token 0 comes from admission)
    first = [j for j in range(1, 5)
             if base_outs[0][j] not in base_outs[0][:j]][0]
    eos = int(base_outs[0][first])
    want, _ = _run(models, "target", work, eos_token_id=eos)
    jax_outs, _ = _jax_run(models, "target", work, draft="target",
                           draft_len=3, eos_token_id=eos)
    outs, stats = _run(models, "target", work, draft="target", draft_len=3,
                       eos_token_id=eos, sync_every=sync_every)
    _same(outs, want)
    _same(outs, jax_outs)
    assert len(outs[0]) == first + 1 and outs[0][-1] == eos


CHUNK_CASES = [8, 5]


@pytest.fixture(scope="module")
def jax_chunked(models):
    return {c: _jax_run(models, "target", _work(), prefill_chunk=c,
                        sync_every=3) for c in CHUNK_CASES}


@pytest.mark.parametrize("sync_every", [1, 3])
@pytest.mark.parametrize("chunk", CHUNK_CASES)
def test_chunked_engine_matches_jax_and_monolithic(models, base, jax_chunked,
                                                   chunk, sync_every):
    outs, stats = _run(models, "target", _work(), prefill_chunk=chunk,
                       sync_every=sync_every)
    jax_outs, jax_stats = jax_chunked[chunk]
    _same(outs, jax_outs)
    _same(outs, base)
    for name in ("chunked_prefills", "prefill_chunks"):
        assert stats[name] == jax_stats[name], name
    assert stats["chunked_prefills"] == sum(len(p) > chunk
                                            for p, _ in _work())
    assert stats["prefill_chunks"] > stats["chunked_prefills"]
    if sync_every == 3:
        assert stats["decode_steps"] == jax_stats["decode_steps"]
    assert 0 < stats["ttft_ms_p50"] <= stats["ttft_ms_p95"]


@pytest.mark.parametrize("mode", [
    dict(draft="unrelated", draft_len=3), dict(draft="target", draft_len=3),
    dict(prefill_chunk=8), dict(prefill_chunk=5)])
def test_int8_pool_modes_match_jax(models, mode):
    """Spec and chunked engines over an int8 pool against JAX's int8
    engines in the same mode at the same ``sync_every``."""
    kw = dict(mode, kv_dtype="int8", sync_every=2)
    jax_outs, jax_stats = _jax_run(models, "target", _work(), **kw)
    outs, stats = _run(models, "target", _work(), **kw)
    _same(outs, jax_outs)
    for name in ("spec_tokens", "spec_rounds", "chunked_prefills",
                 "prefill_chunks", "decode_steps"):
        assert stats[name] == jax_stats[name], name


def test_llama_spec_engine_gqa_rows(models):
    """A non-windowed tiny Llama target with an unrelated Llama draft:
    the verify step's GQA rows at s = 4."""
    work = _work(seed=11, sizes=((6, 9), (21, 8), (14, 10)))
    jax_outs, jax_stats = _jax_run(models, "llama", work, draft="llama_draft",
                                   draft_len=3, sync_every=2)
    outs, stats = _run(models, "llama", work, draft="llama_draft",
                       draft_len=3, sync_every=2)
    _same(outs, jax_outs)
    _same(outs, _run(models, "llama", work)[0])
    assert stats["spec_tokens"] == jax_stats["spec_tokens"]


def test_speculative_generate_matches_jax_and_generate(models):
    jm, jv, tm = models["target"]
    djm, djv, dtm = models["unrelated"]
    prompts = np.random.default_rng(9).integers(0, 128, (3, 9)).astype(
        np.int32)
    want = np.asarray(jax_speculative_generate(
        jm, jv, djm, djv, jnp.asarray(prompts), max_new_tokens=10, k=3))
    got = speculative_generate(tm, dtm, torch.from_numpy(prompts), 10, k=3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), generate(tm, torch.from_numpy(prompts), 10).numpy())
    with pytest.raises(ValueError, match="k must be >= 2"):
        speculative_generate(tm, dtm, torch.from_numpy(prompts), 4, k=1)
    with pytest.raises(ValueError, match="speculative slack"):
        speculative_generate(tm, dtm, torch.from_numpy(prompts), 118, k=3)


def test_spec_validate_request_draft_overshoot(models):
    """The draft block's position and page overshoot is refused at
    admission, as JAX's engine refuses it."""
    prompt = np.zeros(8, np.int32)
    over = gpt_tiny_config().max_position_embeddings - prompt.shape[0] - 1
    jm, jv, tm = models["target"]
    jeng = JaxEngine(jm, jv, num_slots=1, page_size=PS,
                     draft_model=models["small"][0],
                     draft_variables=models["small"][1], draft_len=2)
    eng = PagedDecodeEngine(tm, num_slots=1, page_size=PS,
                            draft_model=models["small"][2], draft_len=2)
    for e in (jeng, eng):
        with pytest.raises(ValueError, match="draft block"):
            e._validate_request(Request(prompt, over))
    with pytest.raises(ValueError, match="draft block"):
        eng.run([Request(prompt, over)])
    # pages: 8 + 8 tokens fill 2 pages; the block of 3 needs a third
    eng = PagedDecodeEngine(tm, num_slots=1, page_size=PS,
                            max_pages_per_seq=2,
                            draft_model=models["small"][2], draft_len=2)
    eng._validate_request(Request(prompt, 5))
    with pytest.raises(ValueError, match="overshoot"):
        eng._validate_request(Request(prompt, 8))


def test_draft_pool_mirrors_the_target_pool(models):
    """The draft pool has the draft's geometry and the target's pages: a
    run through the small draft drains both, and mid-run the two pools
    hold the same block tables."""
    eng = PagedDecodeEngine(models["target"][2], num_slots=SLOTS,
                            page_size=PS, draft_model=models["small"][2],
                            draft_len=2, kv_dtype="int8")
    small = models["small"][2].config
    lc = eng.draft_cache["layers"]
    assert len(lc) == small.num_layers
    assert tuple(lc[0]["k_pages"].shape[1:]) == (small.num_heads, PS,
                                                 small.head_dim)
    assert lc[0]["k_pages"].dtype == torch.int8 and "k_scales" in lc[0]
    seen = []
    admit = eng._admit

    def spy(*args):
        tok0 = admit(*args)
        seen.append(torch.equal(eng.cache["block_tables"],
                                eng.draft_cache["block_tables"]))
        return tok0

    eng._admit = spy
    eng.run([Request(p, n) for p, n in _work()])
    assert seen and all(seen)
    assert eng.draft_cache["free_top"] == eng.cache["free_top"]
