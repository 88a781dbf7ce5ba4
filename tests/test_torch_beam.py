"""Port parity: beam search (``generate_beam``, ``t5_beam_search``) and
sampled ``t5_generate`` against the JAX reference on the CPU.

Tiny GPT and tiny T5 (relu, tied) with flax weights bridged into the port;
fp32. Beam sequences equal JAX's and scores agree within 1e-5 relative
(the two sides' log-softmax round in their own orders): GPT without EOS
at length penalty 1 and with one at 2, T5 with EOS. The reference's own
beam tests are mirrored on the port: one beam is greedy, every score is
its sequence's teacher-forced log-prob (penalty 0), an EOS beam freezes,
the penalty divides by the generated length. Sampled ``t5_generate`` with
the reference's Gumbel draw in place of the port's noise gives JAX's
tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import generation as jax_generation
from apex_tpu.models import t5 as jax_t5
from apex_tpu.models.gpt import GPTModel as JaxGPT
from apex_tpu.models.gpt import gpt_tiny_config as jax_tiny
from apex_tpu_torch.bridge import gpt_params_from_flax, t5_params_from_flax
from apex_tpu_torch.models import (GPTModel, T5Model, generate,
                                   generate_beam, gpt_tiny_config,
                                   t5_beam_search, t5_generate,
                                   t5_tiny_config)
from apex_tpu_torch.models import generation

SCORE_RTOL = 1e-5


@pytest.fixture(scope="module")
def gpt_pair():
    jm = JaxGPT(jax_tiny())
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tm = GPTModel(gpt_tiny_config(), device="cpu")
    tm.load_state_dict(gpt_params_from_flax(
        jax.tree.map(np.asarray, variables)))
    return jm, variables, tm.eval()


@pytest.fixture(scope="module")
def t5_pair():
    jm = jax_t5.T5Model(jax_t5.t5_tiny_config())
    enc = np.random.default_rng(5).integers(0, 128, (2, 4)).astype(np.int32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(enc),
                        jnp.asarray(enc[:, :3]))
    tm = T5Model(t5_tiny_config(), device="cpu")
    tm.load_state_dict(t5_params_from_flax(
        jax.tree.map(np.asarray, variables)))
    return jm, variables, tm.eval(), enc


def _ids(b, s, seed):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


def _check(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=SCORE_RTOL, atol=0)


@pytest.mark.parametrize("eos,penalty", [(None, 1.0), ("first", 2.0)])
def test_beam_matches_jax(gpt_pair, eos, penalty):
    jm, variables, tm = gpt_pair
    ids = _ids(2, 5, 1)
    if eos == "first":     # the greedy first token: some beams end at once
        eos = int(generate(tm, torch.from_numpy(ids), 1)[0, -1])
    kw = dict(num_beams=3, eos_token_id=eos, length_penalty=penalty)
    want = jax_generation.generate_beam(jm, variables, jnp.asarray(ids), 6,
                                        **kw)
    got = generate_beam(tm, torch.from_numpy(ids), 6, **kw)
    assert got[0].shape == (2, 3, 11) and got[0].dtype == torch.int32
    _check(got, want)


def test_beam1_equals_greedy(gpt_pair):
    _, _, tm = gpt_pair
    ids = torch.from_numpy(_ids(2, 5, 2))
    ref = generate(tm, ids, 7)
    seqs, scores = generate_beam(tm, ids, 7, num_beams=1)
    assert seqs.shape == (2, 1, 12)
    np.testing.assert_array_equal(seqs[:, 0].numpy(), ref.numpy())
    assert torch.isfinite(scores).all()


def _teacher_forced(tm, ids, s0, t):
    with torch.no_grad():
        logp = torch.log_softmax(tm(torch.from_numpy(ids[None]))[0].float(),
                                 dim=-1)
    return sum(float(logp[s0 - 1 + k, ids[s0 + k]]) for k in range(t))


def test_beam_scores_match_teacher_forced(gpt_pair):
    _, _, tm = gpt_pair
    seqs, scores = generate_beam(tm, torch.from_numpy(_ids(1, 4, 3)), 4,
                                 num_beams=3, length_penalty=0.0)
    seqs, scores = seqs.numpy(), scores.numpy()
    assert (np.diff(scores[0]) <= 1e-6).all()        # best first
    for j in range(3):
        np.testing.assert_allclose(scores[0, j],
                                   _teacher_forced(tm, seqs[0, j], 4, 4),
                                   rtol=2e-4, atol=2e-4)


def test_beam_eos_freezes_and_ranks(gpt_pair):
    _, _, tm = gpt_pair
    ids = torch.from_numpy(_ids(1, 4, 4))
    free, _ = generate_beam(tm, ids, 5, num_beams=2)
    eos = int(free[0, 0, 4])                 # the best beam's first token
    seqs, _ = generate_beam(tm, ids, 5, num_beams=2, eos_token_id=eos)
    for j in range(2):
        row = seqs[0, j, 4:].numpy()
        hits = np.where(row == eos)[0]
        if hits.size:
            assert (row[hits[0]:] == eos).all()
    assert (seqs[0, :, 4] == eos).any()


def test_beam_length_penalty_normalizes_generated_length(gpt_pair):
    _, _, tm = gpt_pair
    s0, t = 4, 3
    seqs, scores = generate_beam(tm, torch.from_numpy(_ids(1, s0, 5)), t,
                                 num_beams=2, length_penalty=1.0)
    for j in range(2):
        raw = _teacher_forced(tm, seqs[0, j].numpy(), s0, t)
        np.testing.assert_allclose(scores[0, j].item(), raw / t, rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("eos", [1])
def test_t5_beam_matches_jax(t5_pair, eos):
    jm, variables, tm, enc = t5_pair
    kw = dict(num_beams=4, eos_token_id=eos)
    want = jax_t5.t5_beam_search(jm, variables, jnp.asarray(enc), 4, **kw)
    got = t5_beam_search(tm, torch.from_numpy(enc), 4, **kw)
    assert got[0].shape == (2, 4, 4)
    _check(got, want)


def test_t5_beam1_equals_greedy(t5_pair):
    _, _, tm, enc = t5_pair
    ref = t5_generate(tm, torch.from_numpy(enc), 5)
    seqs, _ = t5_beam_search(tm, torch.from_numpy(enc), 5, num_beams=1)
    np.testing.assert_array_equal(seqs[:, 0].numpy(), ref.numpy())


def test_sampled_t5_generate_matches_jax_under_shared_noise(t5_pair,
                                                            monkeypatch):
    jm, variables, tm, enc = t5_pair
    key = jax.random.PRNGKey(2)
    kw = dict(temperature=0.9, top_k=30, top_p=0.9)
    want = np.asarray(jax_t5.t5_generate(jm, variables, jnp.asarray(enc), 4,
                                         rng=key, eos_token_id=1, **kw))

    def noise(seed, streams, index, vocab):
        return torch.from_numpy(np.array(jax.random.gumbel(
            jax.random.fold_in(key, int(index)), (streams.shape[0], vocab))))

    monkeypatch.setattr(generation, "sample_noise", noise)
    got = t5_generate(tm, torch.from_numpy(enc), 4, rng=2, eos_token_id=1,
                      **kw)
    np.testing.assert_array_equal(got.numpy(), want)
