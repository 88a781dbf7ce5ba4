"""Port parity: quantized GPT serving, apex_tpu_torch against apex_tpu.

Tiny GPT in fp32 with weights from JAX (``init`` at key 0) bridged to the
port. For int8, fp8 and int4 (group 8) block linears:
- the JAX-quantized tree, bridged, is bit-equal to the port's own
  ``quantize_model_params`` state dict;
- no-cache logits agree with JAX's within 1e-5 (the dequant-matmul twin
  against JAX's Pallas kernel in interpret mode; fp32 sums in other
  orders).
Then engines on a mixed-length workload (6 requests, prompts 3-20 tokens,
budgets 4-12, 3 slots, page 8): int8 weights over an int8 pool, and int4
weights over an fp8 pool, must be token-identical to JAX's engine on the
same requests (one JAX run each, module-scoped); a weight-only quantized
engine must be token-identical to the port's lock-step ``generate``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPTModel as JaxGPT
from apex_tpu.models.gpt import gpt_tiny_config as jax_tiny
from apex_tpu.models.quantize import \
    quantize_model_params as jax_quantize_model_params
from apex_tpu.ops.quant import WeightPrecisionPolicy as JaxPolicy
from apex_tpu.serving import PagedDecodeEngine as JaxEngine
from apex_tpu.serving import Request as JaxRequest
from apex_tpu_torch.bridge import gpt_params_from_flax
from apex_tpu_torch.models import (GPTModel, WeightPrecisionPolicy,
                                   assert_quantized_loaded, generate,
                                   gpt_tiny_config, quantize_model_params)
from apex_tpu_torch.serving import PagedDecodeEngine, Request

SLOTS, PS, GS = 3, 8, 8
KINDS = ("int8", "fp8", "int4")
#: (weight kind, pool kv_dtype) of the engine cases
ENGINES = (("int8", "int8"), ("int4", "fp8"))


def _workload(seed=1, n=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, int(rng.integers(3, 21))).astype(np.int32),
             int(rng.integers(4, 13))) for _ in range(n)]


def _np(t):
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn
            else t).numpy()


@pytest.fixture(scope="module")
def models():
    """JAX and port models: fp and one quantized pair per kind."""
    ids = jnp.zeros((1, 8), jnp.int32)
    jm = JaxGPT(jax_tiny())
    jv = jm.init(jax.random.PRNGKey(0), ids)
    fp = GPTModel(gpt_tiny_config(), device="cpu")
    fp.load_state_dict(gpt_params_from_flax(jax.tree.map(np.asarray, jv)))
    out = {"fp": (jm, jv, fp.eval())}
    for kind in KINDS:
        jq = JaxGPT(dataclasses.replace(
            jax_tiny(), weight_policy=JaxPolicy(kind, group_size=GS)))
        jqv = {"params": jax_quantize_model_params(jq, jv, ids)}
        tq = GPTModel(gpt_tiny_config(weight_policy=WeightPrecisionPolicy(
            kind, group_size=GS)), device="cpu")
        tq.load_state_dict(quantize_model_params(tq, fp))
        out[kind] = (jq, jqv, tq.eval())
    return out


@pytest.fixture(scope="module")
def jax_engine_outputs(models):
    """JAX's engine on the workload, per engine case (one run each)."""
    work = _workload()
    outs = {}
    for kind, kv_dtype in ENGINES:
        jq, jqv, _ = models[kind]
        outs[kind, kv_dtype], _ = JaxEngine(
            jq, jqv, num_slots=SLOTS, page_size=PS, kv_dtype=kv_dtype).run(
            [JaxRequest(p, n) for p, n in work])
    return work, outs


@pytest.mark.parametrize("kind", KINDS)
def test_bridged_jax_tree_bit_equal_to_port_quantization(models, kind):
    _, jqv, tq = models[kind]
    bridged = gpt_params_from_flax(jax.tree.map(np.asarray, jqv))
    own = tq.state_dict()
    assert set(bridged) == set(own)
    for name, t in own.items():
        assert bridged[name].dtype == t.dtype, name
        np.testing.assert_array_equal(_np(bridged[name]), _np(t),
                                      err_msg=name)
    narrow = [n for n, t in own.items() if t.dtype in (
        torch.int8, torch.uint8, torch.float8_e4m3fn)]
    assert len(narrow) == 4 * 2                   # 4 linears x 2 layers
    assert_quantized_loaded(tq)


@pytest.mark.parametrize("kind", KINDS)
def test_no_cache_logits_match_jax(models, kind):
    jq, jqv, tq = models[kind]
    ids = np.random.default_rng(3).integers(0, 128, (2, 12)).astype(np.int32)
    want = np.asarray(jq.apply(jqv, jnp.asarray(ids)))
    with torch.no_grad():
        got = tq(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_bridge_raises_on_unmapped_leaf(models):
    _, jv, _ = models["fp"]
    tree = jax.tree.map(np.asarray, jv)["params"]
    tree = dict(tree, layer_0=dict(tree["layer_0"], extra={"w": np.ones(2)}))
    with pytest.raises(KeyError, match="layer_0/extra/w"):
        gpt_params_from_flax(tree)


def test_placeholders_are_refused(models):
    tq = GPTModel(gpt_tiny_config(quantize_int8=True), device="cpu")
    assert not tq.layers[0].qkv.weight.any()
    assert (tq.layers[0].qkv.scale == 1).all()
    with pytest.raises(ValueError, match="all zeros"):
        assert_quantized_loaded(tq)
    with pytest.raises(ValueError, match="no int8/fp8/int4"):
        assert_quantized_loaded(models["fp"][2])
    with pytest.raises(ValueError, match="weight-policy-conflict"):
        gpt_tiny_config(quantize_int8=True,
                        weight_policy=WeightPrecisionPolicy("int4"))\
            .weight_quant()


def _lockstep(model, work):
    return [generate(model, torch.from_numpy(p)[None], n)[0, len(p):].numpy()
            for p, n in work]


def _first_divergence(a, b):
    n = min(len(a), len(b))
    diff = np.flatnonzero(np.asarray(a[:n]) != np.asarray(b[:n]))
    return int(diff[0]) if diff.size else None


@pytest.mark.parametrize("kind,kv_dtype", ENGINES)
def test_quantized_engine_token_identical_to_jax_engine(
        models, jax_engine_outputs, kind, kv_dtype):
    work, jax_outs = jax_engine_outputs
    tq = models[kind][2]
    eng = PagedDecodeEngine(tq, num_slots=SLOTS, page_size=PS,
                            kv_dtype=kv_dtype)
    outs, stats = eng.run([Request(p, n) for p, n in work])
    for i, (o, j) in enumerate(zip(outs, jax_outs[kind, kv_dtype])):
        np.testing.assert_array_equal(o, np.asarray(j),
                                      err_msg=f"request {i}, first "
                                      f"divergence at "
                                      f"{_first_divergence(o, j)}")
    assert stats["retired"] == len(work)
    num_pages = eng.cache["free_stack"].shape[0]
    assert eng.cache["free_top"] == num_pages - 1


@pytest.mark.parametrize("kind", KINDS)
def test_weight_only_engine_token_identical_to_lockstep(models, kind):
    work = _workload(seed=2, n=4)
    tq = models[kind][2]
    outs, _ = PagedDecodeEngine(tq, num_slots=2, page_size=PS,
                                sync_every=2).run(
        [Request(p, n) for p, n in work])
    for i, (o, ref) in enumerate(zip(outs, _lockstep(tq, work))):
        np.testing.assert_array_equal(o, ref, err_msg=f"request {i}")


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_pool_first_tokens_match_fp_pool(models, kv_dtype):
    """Prefill never reads the pool: every request's first token over a
    quantized pool equals the fp pool's."""
    work = _workload(seed=3, n=4)
    fp = models["fp"][2]
    reqs = [Request(p, n) for p, n in work]
    ref, _ = PagedDecodeEngine(fp, num_slots=2, page_size=PS).run(reqs)
    got, _ = PagedDecodeEngine(fp, num_slots=2, page_size=PS,
                               kv_dtype=kv_dtype).run(reqs)
    assert [int(o[0]) for o in got] == [int(o[0]) for o in ref]


@pytest.mark.parametrize("kw,exc,match", [
    # the prefix cache is ported over a quantized pool too; its host
    # tier is not (A9)
    pytest.param(dict(kv_dtype="int8", prefix_cache=True,
                      host_tier_bytes=1 << 20),
                 NotImplementedError, "host tier",
                 id="kw0-prefix cache"),
    # over a quantized pool the speculative and chunked modes run; what
    # they refuse is the reference's ValueErrors
    pytest.param(dict(kv_dtype="int8", draft_kv_dtype="fp8", draft_len=2,
                      draft=True), ValueError, "kv-dtype-mismatch",
                 id="kw1-draft"),
    pytest.param(dict(kv_dtype="int8", draft_len=8, draft=True),
                 ValueError, "query-block limit", id="kw2-speculative"),
    pytest.param(dict(kv_dtype="int8", prefill_chunk=9), ValueError,
                 "1..page_size", id="kw3-chunked prefill"),
])
def test_unported_quantized_modes_raise(models, kw, exc, match):
    kw = dict(kw)
    if kw.pop("draft", False):
        kw["draft_model"] = models["int8"][2]
    with pytest.raises(exc, match=match):
        PagedDecodeEngine(models["int8"][2], num_slots=2, page_size=PS, **kw)


def test_unsupported_kv_dtype_is_a_named_error(models):
    with pytest.raises(ValueError, match="kv-dtype-unsupported"):
        PagedDecodeEngine(models["fp"][2], num_slots=2, page_size=PS,
                          kv_dtype="int4")
