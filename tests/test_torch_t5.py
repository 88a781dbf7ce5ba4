"""Port parity: apex_tpu_torch T5Model vs apex_tpu T5Model, serving.

A flax ``T5Model.init`` (seed 0) of ``t5_tiny_config`` goes through
``bridge.t5_params_from_flax`` into the port, in the two FFN variants:
relu with the tied, rescaled head (v1.0) and gated-gelu with an untied
``lm_head`` (v1.1). The same numpy token ids then go through both models:
``encode``, the teacher-forced logits, the cached decode (a static flash
prefill with the bias sliced to the chunk square, then dense cached steps)
and greedy ``t5_generate`` with an EOS id. The JAX side runs its flash
kernels in interpret mode. fp32; encoder output and logits within atol =
rtol = 1e-4, tokens identical. The relative-position buckets equal the
reference's exactly for every ``rel`` in [-1024, 1024], both directions;
and the refusals name their ROADMAP items.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import t5 as jax_t5
from apex_tpu.models.generation import init_cache as jax_init_cache
from apex_tpu_torch.bridge import t5_params_from_flax
from apex_tpu_torch.models import (T5Config, T5Model,
                                   relative_position_bucket, t5_generate,
                                   t5_tiny_config)
from apex_tpu_torch.models.generation import init_cache
from apex_tpu_torch.serving import kv_pool

TOL = dict(atol=1e-4, rtol=1e-4)
VARIANTS = {"relu_tied": {},
            "gated_untied": dict(ff_act="gated-gelu",
                                 tie_word_embeddings=False)}
B, S_ENC, S_DEC, NEW, EOS = 2, 11, 7, 6, 3


def _bridge(tree):
    return t5_params_from_flax(jax.tree.map(np.asarray, tree))


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(0, 128, shape).astype(
        np.int32)


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    kw = VARIANTS[request.param]
    jm = jax_t5.T5Model(jax_t5.t5_tiny_config(**kw))
    enc, dec = _ids((B, S_ENC), 0), _ids((B, S_DEC), 1)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(enc),
                        jnp.asarray(dec))
    tm = T5Model(t5_tiny_config(**kw), device="cpu")
    tm.load_state_dict(_bridge(variables))
    return dict(jm=jm, variables=variables, tm=tm.eval(), enc=enc, dec=dec,
                name=request.param)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 64),
                                                      (8, 20)])
def test_relative_position_bucket_equals_jax_exactly(bidirectional,
                                                     num_buckets,
                                                     max_distance):
    """Integer buckets equal JAX's for every rel in [-1024, 1024]: at n =
    16, 32 and 64 the fp32 log branch's exact value is an integer, where
    one ulp of ``log`` would move a whole bucket."""
    rel = np.arange(-1024, 1025, dtype=np.int32)
    kw = dict(bidirectional=bidirectional, num_buckets=num_buckets,
              max_distance=max_distance)
    want = np.asarray(jax_t5.relative_position_bucket(jnp.asarray(rel),
                                                      **kw))
    got = relative_position_bucket(torch.from_numpy(rel), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_configs_match_the_reference():
    """Same fields and defaults (t5-small's published widths), dtypes as
    torch's."""
    ref, port = jax_t5.T5Config(), T5Config()
    names = [f.name for f in dataclasses.fields(ref)]
    assert names == [f.name for f in dataclasses.fields(port)]
    for n in names:
        if n not in ("dtype", "param_dtype"):
            assert getattr(ref, n) == getattr(port, n), n
    assert (port.dtype, port.param_dtype) == (torch.bfloat16, torch.float32)
    tiny = jax_t5.t5_tiny_config()
    for n in names:
        if n not in ("dtype", "param_dtype"):
            assert getattr(tiny, n) == getattr(t5_tiny_config(), n), n


def test_bridge_maps_every_flax_leaf(pair):
    sd = _bridge(pair["variables"])
    assert set(sd) == set(pair["tm"].state_dict())
    assert len(sd) == len(jax.tree.leaves(pair["variables"]))
    np.testing.assert_array_equal(
        sd["dec_blocks.1.cross_attn.kv.weight"].numpy(),
        np.asarray(pair["variables"]["params"]["dec_1"]["cross_attn"]["kv"]
                   ["weight"]))
    assert ("lm_head.weight" in sd) == (pair["name"] == "gated_untied")


def test_bridge_raises_on_a_stray_leaf(pair):
    tree = jax.tree.map(np.asarray, pair["variables"])
    tree["params"]["enc_0"]["self_attn"]["qkv"]["bias"] = np.zeros(
        192, np.float32)
    with pytest.raises(KeyError, match="enc_0/self_attn/qkv/bias"):
        t5_params_from_flax(tree)
    tree = jax.tree.map(np.asarray, pair["variables"])
    tree["params"]["enc_0"]["cross_attn"] = {"q": {"weight": np.zeros(1)}}
    with pytest.raises(KeyError, match="enc_0/cross_attn"):
        t5_params_from_flax(tree)


def test_encode_and_teacher_forced_logits_match_jax(pair):
    jm, v, tm = pair["jm"], pair["variables"], pair["tm"]
    enc, dec = pair["enc"], pair["dec"]
    want_enc = jm.apply(v, jnp.asarray(enc), method=jax_t5.T5Model.encode)
    want = jm.apply(v, jnp.asarray(enc), jnp.asarray(dec))
    with torch.no_grad():
        got_enc = tm.encode(torch.from_numpy(enc))
        got = tm(torch.from_numpy(enc), torch.from_numpy(dec))
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc), **TOL)
    assert got.shape == (B, S_DEC, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cached_decode_matches_jax_and_teacher_forcing(pair):
    """A static flash prefill of 3 tokens (the bias sliced to the chunk
    square), then single-token cached steps (the (1, H, 1, T) bias), each
    against JAX's cached decode and the teacher-forced logits; the encoder
    K/V are projected once into every layer's ``ck``/``cv``."""
    jm, v, tm = pair["jm"], pair["variables"], pair["tm"]
    enc, dec = pair["enc"], pair["dec"]
    dec_m = jax_t5.T5Model.decode
    jenc = jm.apply(v, jnp.asarray(enc), method=jax_t5.T5Model.encode)
    jcache = jax_init_cache(jm.config, B, S_DEC)
    with torch.no_grad():
        tenc = tm.encode(torch.from_numpy(enc))
        full = tm(torch.from_numpy(enc), torch.from_numpy(dec))
        cache = init_cache(tm.config, B, S_DEC, device="cpu")
        for p0, p1 in ((0, 3), (3, 4), (4, 5), (5, 6), (6, 7)):
            want, jcache = jm.apply(v, jnp.asarray(dec[:, p0:p1]), jenc,
                                    jcache, method=dec_m)
            got, cache = tm.decode(torch.from_numpy(dec[:, p0:p1]), tenc,
                                   cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_allclose(got.numpy(), full[:, p0:p1].numpy(),
                                       **TOL)
            assert all("ck" in lc and "cv" in lc for lc in cache["layers"])
    assert cache["len"] == S_DEC
    # projected once: a zeroed encoder output changes no later step
    with torch.no_grad():
        cache = init_cache(tm.config, B, 3, device="cpu")
        _, cache = tm.decode(torch.from_numpy(dec[:, :1]), tenc, cache)
        real, _ = tm.decode(torch.from_numpy(dec[:, 1:2]), tenc, cache)
        zero, _ = tm.decode(torch.from_numpy(dec[:, 1:2]),
                            torch.zeros_like(tenc), cache)
    torch.testing.assert_close(real, zero, atol=0, rtol=0)


def test_t5_generate_tokens_equal_jax(pair):
    """Greedy ``t5_generate`` with an EOS id: the same tokens as the
    reference's, and as the port's own greedy teacher-forced
    re-derivation."""
    jm, v, tm, enc = pair["jm"], pair["variables"], pair["tm"], pair["enc"]
    want = np.asarray(jax_t5.t5_generate(jm, v, jnp.asarray(enc), NEW,
                                         eos_token_id=EOS))
    got = t5_generate(tm, torch.from_numpy(enc), NEW, eos_token_id=EOS)
    assert got.dtype == torch.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = t5_generate(tm, torch.from_numpy(enc), NEW).numpy()
    dec = np.full((B, NEW + 1), tm.config.decoder_start_token_id, np.int32)
    with torch.no_grad():
        for t in range(1, NEW + 1):
            logits = tm(torch.from_numpy(enc), torch.from_numpy(dec))
            dec[:, t] = logits[:, t - 1].argmax(-1).numpy()
    np.testing.assert_array_equal(plain, dec[:, 1:])


def test_relative_bias_tables_and_dtype_flow(pair):
    """The bias the encoder passes to flash is ``(1, H, S, S)``, contiguous
    and equal to the reference module's; a bf16 model hands the kernels a
    bf16 bias."""
    jm, v, tm = pair["jm"], pair["variables"], pair["tm"]
    pos = np.arange(S_ENC, dtype=np.int32)
    for name, bidir in (("enc_rel_bias", True), ("dec_rel_bias", False)):
        mod = jax_t5.T5RelativeBias(jm.config, bidirectional=bidir)
        want = mod.apply({"params": v["params"][name]}, jnp.asarray(pos),
                         jnp.asarray(pos))
        got = getattr(tm, name)(torch.from_numpy(pos), torch.from_numpy(pos))
        assert got.shape == (1, 4, S_ENC, S_ENC) and got.is_contiguous()
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.asarray(want))
    bf = T5Model(t5_tiny_config(dtype=torch.bfloat16), device="cpu")
    with torch.no_grad():
        enc = bf.encode(torch.from_numpy(pair["enc"]))
    assert enc.dtype == torch.bfloat16 and torch.isfinite(enc.float()).all()


def test_unported_t5_options_raise():
    with pytest.raises(NotImplementedError, match="item 10"):
        T5Model(t5_tiny_config(tensor_parallel_size=2), device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        T5Model(t5_tiny_config(quantize_int8=True), device="cpu")
    with pytest.raises(ValueError, match="unknown ff_act"):
        T5Model(t5_tiny_config(ff_act="swish"), device="cpu")
    tm = T5Model(t5_tiny_config(), device="cpu")
    enc = torch.from_numpy(_ids((1, 5), 4))
    with pytest.raises(NotImplementedError, match="item 6"):
        t5_generate(tm, enc, 3, temperature=0.7)
    with pytest.raises(ValueError, match="max_new_tokens"):
        t5_generate(tm, enc, 0)
    with pytest.raises(ValueError, match="decode cap"):
        t5_generate(tm, enc, tm.config.max_position_embeddings)
    pool = kv_pool.init_paged_cache(tm.config, 2, num_pages=8,
                                    page_size=8, max_pages_per_seq=2,
                                    device="cpu")
    with pytest.raises(NotImplementedError, match="paged serving decode"):
        tm.decode(torch.zeros(2, 1, dtype=torch.int32), tm.encode(enc), pool)
    with torch.no_grad():
        cache = init_cache(tm.config, 1, 4, device="cpu")
        with pytest.raises(ValueError, match="cache buffer"):
            tm.decode(torch.zeros(1, 6, dtype=torch.int32), tm.encode(enc),
                      cache)
