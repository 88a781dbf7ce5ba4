"""Port parity: apex_tpu_torch GPT vs apex_tpu GPT on the tiny config.

A flax ``GPTModel.init`` (seed 0) goes through the weight bridge into the
port; the same numpy token ids then go through both models on the no-cache
forward, the static (flash) prefill, one paged decode step over a
hand-built pool, and greedy lock-step ``generate``. fp32; logits atol 1e-4,
tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.generation import generate as jax_generate
from apex_tpu.models.generation import init_cache as jax_init_cache
from apex_tpu.models.gpt import GPTModel as JaxGPT
from apex_tpu.models.gpt import gpt2_small_config as jax_small
from apex_tpu.models.gpt import gpt_tiny_config as jax_tiny
from apex_tpu.serving import kv_pool as jax_pool
from apex_tpu_torch.bridge import gpt_params_from_flax
from apex_tpu_torch.models import (GPTModel, generate, gpt2_small_config,
                                   gpt_tiny_config)
from apex_tpu_torch.models.generation import init_cache
from apex_tpu_torch.serving import kv_pool


@pytest.fixture(scope="module")
def pair():
    jm = JaxGPT(jax_tiny())
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tm = GPTModel(gpt_tiny_config(), device="cpu")
    tm.load_state_dict(gpt_params_from_flax(
        jax.tree.map(np.asarray, variables)))
    return jm, variables, tm.eval()


def _ids(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


def test_bridge_maps_every_flax_leaf(pair):
    _, variables, tm = pair
    sd = gpt_params_from_flax(jax.tree.map(np.asarray, variables))
    assert set(sd) == set(tm.state_dict())
    n_flax = len(jax.tree.leaves(variables))
    assert len(sd) == n_flax
    np.testing.assert_array_equal(
        sd["layers.1.qkv.weight"].numpy(),
        np.asarray(variables["params"]["layer_1"]["qkv"]["weight"]))


def test_configs_match_the_reference():
    for jc, tc in ((jax_small(), gpt2_small_config()),
                   (jax_tiny(), gpt_tiny_config())):
        for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "max_position_embeddings", "layernorm_eps", "head_dim"):
            assert getattr(jc, f) == getattr(tc, f), f
    assert gpt2_small_config().dtype == torch.bfloat16


@pytest.mark.parametrize("s", [1, 13])
def test_no_cache_forward_logits_match(pair, s):
    jm, variables, tm = pair
    ids = _ids(2, s, seed=s)
    want = np.asarray(jm.apply(variables, jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, s, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_static_prefill_logits_and_cache_match(pair):
    jm, variables, tm = pair
    ids = _ids(2, 11, seed=3)
    jl, jc = jm.apply(variables, jnp.asarray(ids),
                      cache=jax_init_cache(jm.config, 2, 16))
    with torch.no_grad():
        tl, tc = tm(torch.from_numpy(ids),
                    cache=init_cache(tm.config, 2, 16, device="cpu"))
    assert tc["len"] == jc["len"] == 11
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tc["layers"][1]["v"].numpy(),
                               np.asarray(jc["layers"][1]["v"]), atol=1e-4,
                               rtol=1e-4)


def test_paged_decode_step_matches(pair):
    """Two slots prefilled (lengths 9 and 3) plus one idle slot; one
    single-token paged step through both models."""
    jm, variables, tm = pair
    ps, bucket = 8, 16
    jcache = jax_pool.init_paged_cache(jm.config, 3, num_pages=10,
                                       page_size=ps)
    tcache = kv_pool.init_paged_cache(tm.config, 3, num_pages=10,
                                      page_size=ps, device="cpu")
    for slot, s0 in ((0, 9), (2, 3)):
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :s0] = _ids(1, s0, seed=slot)[0]
        _, jc = jm.apply(variables, jnp.asarray(ids),
                         cache=jax_init_cache(jm.config, 1, bucket))
        jcache = jax_pool.alloc_slot(jcache, slot, 2)
        jcache = jax_pool.prefill_into_pages(jcache, slot, jc["layers"], s0)
        with torch.no_grad():
            _, tc = tm(torch.from_numpy(ids),
                       cache=init_cache(tm.config, 1, bucket, device="cpu"))
        kv_pool.alloc_slot(tcache, slot, 2)
        kv_pool.prefill_into_pages(tcache, slot, tc["layers"], s0)
    np.testing.assert_array_equal(tcache["block_tables"].numpy(),
                                  np.asarray(jcache["block_tables"]))
    tok = np.asarray([[5], [0], [77]], np.int32)
    jl, jc = jm.apply(variables, jnp.asarray(tok), cache=jcache)
    with torch.no_grad():
        tl, tc = tm(torch.from_numpy(tok), cache=tcache)
    np.testing.assert_array_equal(tc["len"].numpy(), [10, 1, 4])
    np.testing.assert_array_equal(np.asarray(jc["len"]), [10, 1, 4])
    live = [0, 2]                   # the idle slot's output is discarded
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("eos", [None, 93])
def test_greedy_generate_is_token_identical(pair, eos):
    jm, variables, tm = pair
    ids = _ids(2, 13, seed=0)
    want = np.asarray(jax_generate(jm, variables, jnp.asarray(ids), 8,
                                   eos_token_id=eos))
    got = generate(tm, torch.from_numpy(ids), 8, eos_token_id=eos)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_single_token_prompt_generate_matches(pair):
    jm, variables, tm = pair
    ids = _ids(1, 1, seed=9)
    want = np.asarray(jax_generate(jm, variables, jnp.asarray(ids), 5))
    np.testing.assert_array_equal(
        generate(tm, torch.from_numpy(ids), 5).numpy(), want)


def test_sampling_and_tensor_parallel_raise(pair):
    _, _, tm = pair
    with pytest.raises(NotImplementedError, match="sampled decode"):
        generate(tm, torch.zeros((1, 3), dtype=torch.int32), 2,
                 temperature=1.0)
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        GPTModel(gpt_tiny_config(tensor_parallel_size=2), device="cpu")


def test_generate_validates_bounds(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="max_position_embeddings"):
        generate(tm, torch.zeros((1, 120), dtype=torch.int32), 9)
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate(tm, torch.zeros((1, 3), dtype=torch.int32), 0)
