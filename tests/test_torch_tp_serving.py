"""Tensor-parallel paged serving over two spawned ``gloo`` ranks, against
the JAX package's ``TensorParallelPagedEngine`` and the port's tp = 1
engine: the cases of ``tests/test_tp_serving.py:50-106, :152, :272``.

One tp = 1 tiny GPT from the JAX model, bridged and cut into each rank's
shard. Every rank's ``TensorParallelPagedEngine`` (fp32, 2 slots, page 8,
EOS 1) must give, request by request:

- greedy tokens equal to JAX's tensor-parallel engine on a 2-device mesh
  and to the port's tp = 1 engine, with the same decode steps;
- the s > 1 programs (self-draft speculative decode, chunked prefill)
  equal to the greedy tokens;
- sampled tokens independent of the slot count and ``sync_every``;
- a warm prefix-cached run that hits, skips prefill and equals the port's
  tp = 1 engine without the cache, with the pool whole after the drain;
- a priority preemption through ``ServingFrontend`` that fires, resumes
  and equals the tp = 1 engine's tokens.

The ranks agree with each other on every output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tp_worker import gpt_serving_worker
from apex_tpu.models.gpt import GPTModel as JaxGPT
from apex_tpu.models.gpt import gpt_tiny_config as jax_tiny
from apex_tpu_torch.bridge import gpt_params_from_flax
from apex_tpu_torch.models import GPTModel, gpt_tiny_config
from apex_tpu_torch.parallel import run_ranks
from apex_tpu_torch.serving import PagedDecodeEngine, Request

EOS = 1


def _requests():
    """The JAX test's shapes: four requests of mixed prompt lengths and
    budgets, no EOS in the prompts."""
    rng = np.random.default_rng(3)
    return [Request(prompt=rng.integers(2, 128, s).astype(np.int32),
                    max_new_tokens=m)
            for s, m in ((5, 6), (12, 4), (3, 8), (20, 5))]


@pytest.fixture(scope="module")
def setup():
    """The JAX variables, the bridged state dict, the port's tp = 1
    model, the requests and the JAX TP engine's greedy run."""
    from apex_tpu.serving.scheduler import Request as JaxRequest
    from apex_tpu.serving.tp import (TensorParallelPagedEngine,
                                     shard_model_variables, tp_mesh)

    m1 = JaxGPT(jax_tiny())
    v1 = m1.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    v1 = jax.tree.map(np.asarray, v1)
    m2 = JaxGPT(jax_tiny(tensor_parallel_size=2))
    mesh = tp_mesh(2)
    v2, _ = shard_model_variables(m2, v1, mesh)
    reqs = _requests()
    jeng = TensorParallelPagedEngine(m2, v2, mesh=mesh, num_slots=2,
                                     page_size=8, eos_token_id=EOS)
    jouts, jstats = jeng.run([JaxRequest(prompt=r.prompt,
                                         max_new_tokens=r.max_new_tokens)
                              for r in reqs])
    sd = {k: v.numpy() for k, v in gpt_params_from_flax(v1).items()}
    tm = GPTModel(gpt_tiny_config(), device="cpu")
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return dict(sd=sd, tm=tm, reqs=reqs,
                jax_outs=[np.asarray(o) for o in jouts], jax_stats=jstats)


def _tp1(setup, reqs, **kw):
    eng = PagedDecodeEngine(setup["tm"], num_slots=2, page_size=8,
                            eos_token_id=EOS, **kw)
    return eng.run(reqs)


@pytest.fixture(scope="module")
def ranks(setup):
    return run_ranks(gpt_serving_worker, 2, (setup["sd"], setup["reqs"],
                                             EOS), threads=1, timeout=150)


def _equal(outs_a, outs_b):
    assert len(outs_a) == len(outs_b)
    for a, b in zip(outs_a, outs_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_tp2_greedy_token_identical_to_jax_tp_engine_and_tp1(setup, ranks):
    want1, stats1 = _tp1(setup, setup["reqs"])
    _equal(want1, setup["jax_outs"])
    for r in ranks:
        _equal(r["greedy"], setup["jax_outs"])
        assert r["stats"]["tp_world"] == 2 and stats1["tp_world"] == 1
        assert r["stats"]["decode_steps"] == setup["jax_stats"][
            "decode_steps"] == stats1["decode_steps"]
        # each rank's pool holds half the heads of every page
        assert r["pool_kv_heads"] == gpt_tiny_config().num_heads // 2


def test_tp2_s_gt_1_programs_token_identical(setup, ranks):
    for r in ranks:
        _equal(r["spec"], setup["jax_outs"])
        assert r["spec_acceptance"] > 1.0
        _equal(r["chunked"], setup["jax_outs"])
        assert r["chunked_prefills"] >= 1


def test_tp2_sampled_scheduling_invariance(ranks):
    for r in ranks:
        _equal(r["sampled_a"], r["sampled_b"])
    _equal(ranks[0]["sampled_a"], ranks[1]["sampled_a"])


def test_tp2_prefix_cache_hits_and_identity(setup, ranks):
    want, _ = _tp1(setup, ranks[0]["prefix_requests"])
    for r in ranks:
        assert r["prefix_hits"] >= len(want)
        assert r["prefix_skipped"] > 0
        assert r["prefix_pool_ok"]
        _equal(r["prefix_warm"], want)


def test_tp2_frontend_preemption_composes(setup, ranks):
    reqs = ranks[0]["preempt_requests"]
    want, _ = _tp1(setup, [Request(prompt=r.prompt,
                                   max_new_tokens=r.max_new_tokens)
                           for r in reqs])
    for r in ranks:
        _equal(r["preempt_outputs"], want)
        stats = r["preempt_stats"]
        assert stats["preemptions"] >= 1 and stats["resumes"] >= 1
        assert stats["tp_world"] == 2
        assert all(o.shape[0] >= 1 for o in r["preempt_outputs"])
    _equal(ranks[0]["preempt_outputs"], ranks[1]["preempt_outputs"])


def test_shard_model_variables_and_the_engine_validate(ranks):
    """``shard_model_variables`` cuts as ``bridge.shard_gpt_params``; a
    tp = 1 model in a TP engine and a checkpoint of local shapes raise
    named errors (the reference's ``test_tp_engine_validates_mesh_and_
    checkpoint``)."""
    for r in ranks:
        v = r["validation"]
        assert v["same_as_bridge"]
        assert "tensor_parallel_size=1" in v["errors"]["tp1_model"]
        assert "FULL shape" in v["errors"]["local_shapes"]
