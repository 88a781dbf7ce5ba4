"""Port parity: sampled decode (temperature, top-k, top-p) against the JAX
reference on the CPU.

- Filtering: ``filter_logits`` against the logits the reference hands
  ``jax.random.categorical`` (captured by a stand-in for it), bit for bit
  in the ``-inf`` pattern and the finite values, over hypothesis-drawn
  logits (no subnormals: the reference's CPU arithmetic flushes them to
  zero). The two sides sum the nucleus's softmax in their own orders, so
  a draw whose exclusive cumulative mass lies within 1e-5 of ``top_p``
  (where one rounding decides a token's fate) is not drawn.
- The draw: with the port's noise replaced by the reference's
  ``jax.random.gumbel(fold_in(key, i), (b, V))``, sampled ``generate``
  gives JAX's tokens exactly (filter and argmax held together; the port's
  own counter-based noise cannot match threefry). ``t5_generate``'s case
  is in ``test_torch_beam.py``, beside the T5 beam search on the same
  model.
- The port's noise: a function of (seed, stream, index) alone, so a row's
  draws do not depend on the batch around it.
- ``validate_sampling``'s errors, as the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st

from apex_tpu.models import generation as jax_generation
from apex_tpu.models.gpt import GPTModel as JaxGPT
from apex_tpu.models.gpt import gpt_tiny_config as jax_tiny
from apex_tpu_torch.bridge import gpt_params_from_flax
from apex_tpu_torch.models import GPTModel, generate, gpt_tiny_config
from apex_tpu_torch.models import generation
from apex_tpu_torch.models.generation import (filter_logits, sample_noise,
                                              validate_sampling)


def _jax_filtered(logits, temperature, top_k, top_p):
    """The logits the reference's ``_sample_token`` hands to
    ``jax.random.categorical``."""
    seen = {}

    def capture(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)

    orig = jax.random.categorical
    jax.random.categorical = capture
    try:
        jax_generation._sample_token(
            jnp.asarray(logits), jax.random.PRNGKey(0),
            temperature=temperature, top_k=top_k, top_p=top_p,
            axis_name="model")
    finally:
        jax.random.categorical = orig
    return seen["logits"]


def _nucleus_margin(logits, temperature, top_k, top_p) -> float:
    """The smallest |exclusive mass - top_p| over the sorted nucleus, in
    fp64 (inf without top_p)."""
    if top_p is None:
        return float("inf")
    x = logits.astype(np.float64) / temperature
    if top_k is not None:
        kth = np.sort(x, axis=-1)[:, ::-1][:, top_k - 1:top_k]
        x = np.where(x < kth, -np.inf, x)
    x = np.sort(x, axis=-1)[:, ::-1]
    p = np.exp(x - x[:, :1])
    p /= p.sum(-1, keepdims=True)
    before = np.cumsum(p, -1) - p
    return float(np.abs(before - top_p).min())


@settings(max_examples=50, deadline=None)
@given(data=st.data(),
       b=st.sampled_from([1, 3]), vocab=st.sampled_from([2, 7, 48]),
       temperature=st.sampled_from([0.5, 0.8, 1.0, 1.7]),
       use_k=st.booleans(), use_p=st.booleans())
def test_filtering_equals_jax_bit_for_bit(data, b, vocab, temperature,
                                          use_k, use_p):
    logits = np.asarray(data.draw(st.lists(
        st.floats(-12.0, 12.0, width=32, allow_subnormal=False),
        min_size=b * vocab, max_size=b * vocab)), np.float32).reshape(
            b, vocab)
    # the reference's CPU arithmetic flushes subnormals to zero
    logits[np.abs(logits) < 1e-30] = 0.0
    top_k = (data.draw(st.sampled_from(sorted({1, 2, vocab // 2 or 1,
                                                vocab})))
             if use_k else None)
    top_p = (data.draw(st.floats(0.0625, 1.0, width=32)) if use_p
             else None)
    assume(_nucleus_margin(logits, temperature, top_k, top_p) > 1e-5)
    want = _jax_filtered(logits, temperature, top_k, top_p)
    got = filter_logits(torch.from_numpy(logits), temperature=temperature,
                        top_k=top_k, top_p=top_p).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def gpt_pair():
    jm = JaxGPT(jax_tiny())
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tm = GPTModel(gpt_tiny_config(), device="cpu")
    tm.load_state_dict(gpt_params_from_flax(
        jax.tree.map(np.asarray, variables)))
    return jm, variables, tm.eval()


def _jax_noise(key):
    """The reference's draw in place of the port's noise: token ``i`` of
    every row from ``gumbel(fold_in(key, i), (b, V))``."""
    def noise(seed, streams, index, vocab):
        g = jax.random.gumbel(jax.random.fold_in(key, int(index)),
                              (streams.shape[0], vocab))
        return torch.from_numpy(np.array(g))
    return noise


@pytest.mark.parametrize("kw", [
    dict(temperature=1.0),
    dict(temperature=0.7, top_k=40, top_p=0.95),
], ids=["plain", "both"])
def test_sampled_generate_matches_jax_under_shared_noise(gpt_pair, kw,
                                                         monkeypatch):
    jm, variables, tm = gpt_pair
    ids = np.random.default_rng(4).integers(0, 128, (3, 5)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_generation.generate(
        jm, variables, jnp.asarray(ids), 9, rng=key, eos_token_id=7, **kw))
    monkeypatch.setattr(generation, "sample_noise", _jax_noise(key))
    got = generate(tm, torch.from_numpy(ids), 9, rng=11, eos_token_id=7,
                   **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_noise_depends_on_seed_stream_and_index_alone():
    streams = torch.tensor([3, 1, 7], dtype=torch.int64)
    index = torch.tensor([5, 2, 0], dtype=torch.int64)
    full = sample_noise(9, streams, index, 300)
    assert full.dtype == torch.float32 and full.shape == (3, 300)
    assert torch.isfinite(full).all()
    for r in range(3):
        alone = sample_noise(9, streams[r:r + 1], index[r:r + 1], 300)
        assert torch.equal(alone[0], full[r])
    assert not torch.equal(sample_noise(10, streams, index, 300), full)
    assert not torch.equal(sample_noise(9, streams, index + 1, 300), full)
    # a standard Gumbel: mean Euler's constant, variance pi^2 / 6
    big = sample_noise(1, torch.arange(64), 0, 4096).double()
    assert abs(big.mean().item() - 0.5772) < 0.01
    assert abs(big.var().item() - np.pi ** 2 / 6) < 0.03


def test_sampled_rows_do_not_depend_on_the_batch(gpt_pair):
    """Row ``r``'s draws are stream ``r``'s: a batch of one prompt gives
    row 0 of a batch that starts with it."""
    _, _, tm = gpt_pair
    ids = np.random.default_rng(6).integers(0, 128, (3, 5)).astype(np.int32)
    kw = dict(temperature=1.0, top_k=50, rng=3)
    both = generate(tm, torch.from_numpy(ids), 6, **kw)
    one = generate(tm, torch.from_numpy(ids[:1]), 6, **kw)
    np.testing.assert_array_equal(one.numpy()[0], both.numpy()[0])


@pytest.mark.parametrize("args,exc,match", [
    ((1.0, None, None, None), ValueError, "explicit rng"),
    ((0.0, 5, None, None), ValueError, "require temperature"),
    ((0.0, None, None, 3), ValueError, "require temperature"),
    ((1.0, 0, None, 3), ValueError, "top_k must be"),
    ((1.0, None, 0.0, 3), ValueError, "top_p must be"),
    ((1.0, None, 1.5, 3), ValueError, "top_p must be"),
])
def test_validate_sampling_errors_match_the_reference(args, exc, match):
    with pytest.raises(exc, match=match):
        validate_sampling(*args)
    jargs = list(args)
    if jargs[3] is not None:
        jargs[3] = jax.random.PRNGKey(jargs[3])
    with pytest.raises(exc, match=match):
        jax_generation.validate_sampling(*jargs)
    assert validate_sampling(0.0, None, None, None) == 0
    assert validate_sampling(1.0, 4, 0.5, 8) == 8


def test_generation_example_runs_on_the_cpu():
    """The port's generation example: greedy, sampled, speculative (its
    own greedy-parity check) and beam decode on a tiny Llama; its
    tensor-parallel decode raises."""
    from apex_tpu_torch.examples.generation import generate_llama

    lines = []
    out = generate_llama.run_generation(temperature=0.9, top_k=8, seed=3,
                                        device="cpu", verbose=lines.append)
    assert out.shape == (2, 18) and len(lines) == 3
    generate_llama.run_speculative(device="cpu", verbose=lines.append)
    generate_llama.run_beam(device="cpu", verbose=lines.append)
    with pytest.raises(NotImplementedError, match="item 10"):
        generate_llama.run_generation(tp=2, device="cpu")
