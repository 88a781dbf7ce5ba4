"""Port parity: apex_tpu_torch LlamaModel vs apex_tpu LlamaModel.

A flax ``LlamaModel.init`` (seed 0) of the tiny config with GQA (4 heads
over 2 kv heads) and a sliding window of 5 goes through the weight bridge
into the port; the same numpy token ids then go through both models on the
no-cache forward (window and full attention), the static (flash) prefill
followed by incremental decode past the window, one paged decode step over
a hand-built pool whose leading pages were dropped below the band, and
greedy lock-step ``generate``. fp32; logits atol/rtol 1e-4, tokens
identical. An int8 weight policy maps through the quantized linears: the
bridged JAX-quantized tree equals the port's own quantization, and logits
agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.generation import generate as jax_generate
from apex_tpu.models.generation import init_cache as jax_init_cache
from apex_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from apex_tpu.models.llama import LlamaModel as JaxLlama
from apex_tpu.models.llama import llama_tiny_config as jax_tiny
from apex_tpu.models.quantize import \
    quantize_model_params as jax_quantize_model_params
from apex_tpu.ops.quant import WeightPrecisionPolicy as JaxPolicy
from apex_tpu.serving import kv_pool as jax_pool
from apex_tpu_torch.bridge import llama_params_from_flax
from apex_tpu_torch.models import (LlamaConfig, LlamaModel,
                                   WeightPrecisionPolicy, generate,
                                   llama_tiny_config, mistral_7b_config,
                                   quantize_model_params)
from apex_tpu_torch.models.generation import init_cache
from apex_tpu_torch.serving import kv_pool

WINDOW = 5
TOL = dict(atol=1e-4, rtol=1e-4)


def _bridge(variables):
    return llama_params_from_flax(jax.tree.map(np.asarray, variables))


@pytest.fixture(scope="module")
def pair():
    jm = JaxLlama(jax_tiny(sliding_window=WINDOW))
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tm = LlamaModel(llama_tiny_config(sliding_window=WINDOW), device="cpu")
    tm.load_state_dict(_bridge(variables))
    return jm, variables, tm.eval()


def _ids(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


def test_bridge_maps_every_flax_leaf(pair):
    _, variables, tm = pair
    sd = _bridge(variables)
    assert set(sd) == set(tm.state_dict())
    assert len(sd) == len(jax.tree.leaves(variables))
    np.testing.assert_array_equal(
        sd["layers.1.kv_proj.weight"].numpy(),
        np.asarray(variables["params"]["layer_1"]["kv_proj"]["weight"]))


def test_bridge_raises_on_a_stray_leaf(pair):
    _, variables, _ = pair
    tree = jax.tree.map(np.asarray, variables)
    tree["params"]["layer_0"]["q_proj"]["bias"] = np.zeros(64, np.float32)
    with pytest.raises(KeyError, match="layer_0/q_proj/bias"):
        llama_params_from_flax(tree)


def test_configs_match_the_reference():
    fields = [f.name for f in dataclasses.fields(JaxLlamaConfig)
              if f.name not in ("dtype", "param_dtype")]
    assert fields == [f.name for f in dataclasses.fields(LlamaConfig)
                      if f.name not in ("dtype", "param_dtype")]
    for jc, tc in ((JaxLlamaConfig(), LlamaConfig()),
                   (jax_tiny(), llama_tiny_config())):
        for f in fields + ["head_dim"]:
            assert getattr(jc, f) == getattr(tc, f), f
    m = mistral_7b_config()
    assert (m.hidden_size, m.intermediate_size, m.num_layers, m.num_heads,
            m.num_kv_heads, m.sliding_window, m.head_dim) == (
        4096, 14336, 32, 32, 8, 4096, 128)
    e, i, d = m.hidden_size, m.intermediate_size, m.head_dim
    per_layer = (e * m.num_heads * d + e * 2 * m.num_kv_heads * d + e * e
                 + e * 2 * i + i * e + 2 * e)
    assert m.num_layers * per_layer + 2 * m.vocab_size * e + e == \
        7_241_732_096


@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("s", [1, 13])
def test_no_cache_forward_logits_match(pair, s, window):
    jm, variables, tm = pair
    if window is None:
        jm = JaxLlama(jax_tiny())
        tm = LlamaModel(llama_tiny_config(), device="cpu")
        tm.load_state_dict(_bridge(variables))
    ids = _ids(2, s, seed=s)
    want = np.asarray(jm.apply(variables, jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, s, 128)
    np.testing.assert_allclose(got, want, **TOL)


def test_windowed_prefill_then_decode_past_the_window(pair):
    """Prefill 8 tokens (the windowed flash path), then 8 single-token
    steps (banded ``cached_attention``): every step's logits and the cache
    match JAX's, with the window (5) far behind the last position."""
    jm, variables, tm = pair
    ids = _ids(2, 16, seed=3)
    jl, jc = jm.apply(variables, jnp.asarray(ids[:, :8]),
                      cache=jax_init_cache(jm.config, 2, 16))
    with torch.no_grad():
        tl, tc = tm(torch.from_numpy(ids[:, :8]),
                    cache=init_cache(tm.config, 2, 16, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for p in range(8, 16):
        jl, jc = jm.apply(variables, jnp.asarray(ids[:, p:p + 1]), cache=jc)
        with torch.no_grad():
            tl, tc = tm(torch.from_numpy(ids[:, p:p + 1]), cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["len"] == int(jc["len"]) == 16
    np.testing.assert_allclose(tc["layers"][1]["k"].numpy(),
                               np.asarray(jc["layers"][1]["k"]), **TOL)


def test_paged_decode_step_with_dropped_pages_matches(pair):
    """Three slots prefilled (lengths 21, 3 and 9, page 8), slot 0's two
    leading pages dropped below the band in both pools, then one
    single-token paged step through both models."""
    jm, variables, tm = pair
    ps, bucket = 8, 24
    jcache = jax_pool.init_paged_cache(jm.config, 3, num_pages=16,
                                       page_size=ps)
    tcache = kv_pool.init_paged_cache(tm.config, 3, num_pages=16,
                                      page_size=ps, device="cpu")
    for slot, s0 in ((0, 21), (1, 3), (2, 9)):
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :s0] = _ids(1, s0, seed=slot)[0]
        _, jc = jm.apply(variables, jnp.asarray(ids),
                         cache=jax_init_cache(jm.config, 1, bucket))
        jcache = jax_pool.alloc_slot(jcache, slot, 4)
        jcache = jax_pool.prefill_into_pages(jcache, slot, jc["layers"], s0)
        with torch.no_grad():
            _, tc = tm(torch.from_numpy(ids),
                       cache=init_cache(tm.config, 1, bucket, device="cpu"))
        kv_pool.alloc_slot(tcache, slot, 4)
        kv_pool.prefill_into_pages(tcache, slot, tc["layers"], s0)
    # the next query of slot 0 sits at 21: entries 0-1 (positions 0-15)
    # lie at or below 21 - 5
    jcache = jax_pool.drop_slot_pages(jcache, jnp.int32(0), jnp.int32(2))
    kv_pool.drop_slot_pages(tcache, 0, 2)
    np.testing.assert_array_equal(tcache["block_tables"].numpy(),
                                  np.asarray(jcache["block_tables"]))
    assert (tcache["block_tables"][0, :2] == 0).all()
    tok = np.asarray([[5], [0], [77]], np.int32)
    jl, jc = jm.apply(variables, jnp.asarray(tok), cache=jcache)
    with torch.no_grad():
        tl, tc = tm(torch.from_numpy(tok), cache=tcache)
    np.testing.assert_array_equal(tc["len"].numpy(), [22, 4, 10])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("eos", [None, 93])
def test_greedy_generate_is_token_identical(pair, eos):
    jm, variables, tm = pair
    ids = _ids(2, 11, seed=0)
    want = np.asarray(jax_generate(jm, variables, jnp.asarray(ids), 9,
                                   eos_token_id=eos))
    got = generate(tm, torch.from_numpy(ids), 9, eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("field,value,match", [
    ("num_experts", 4, "moe"),
    ("tensor_parallel_size", 2, "tensor_parallel_size"),
    ("rolling_cache", True, "rolling_cache"),
])
def test_unported_config_fields_raise(field, value, match):
    cfg = llama_tiny_config(sliding_window=WINDOW, **{field: value})
    with pytest.raises(NotImplementedError, match=match):
        LlamaModel(cfg, device="cpu")


def test_int8_weight_policy_runs_the_quantized_linears(pair):
    """The JAX-quantized tree, bridged, equals the port's own quantization
    of the bridged fp weights, and no-cache logits agree."""
    jm, variables, tm = pair
    ids = jnp.zeros((1, 8), jnp.int32)
    jq = JaxLlama(dataclasses.replace(jm.config,
                                      weight_policy=JaxPolicy("int8")))
    jqv = {"params": jax_quantize_model_params(jq, variables, ids)}
    tq = LlamaModel(llama_tiny_config(
        sliding_window=WINDOW, weight_policy=WeightPrecisionPolicy("int8")),
        device="cpu")
    ours = quantize_model_params(tq, tm)
    bridged = _bridge(jqv)
    assert set(bridged) == set(ours)
    for name, t in ours.items():
        torch.testing.assert_close(bridged[name], t, atol=0, rtol=0,
                                   msg=name)
    assert ours["layers.0.gate_up_proj.weight"].dtype == torch.int8
    tq.load_state_dict(ours)
    x = _ids(2, 9, seed=5)
    want = np.asarray(jq.apply(jqv, jnp.asarray(x)))
    with torch.no_grad():
        got = tq.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
