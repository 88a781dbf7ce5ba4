"""Port parity: the sliding window of flash attention, paged attention and
``cached_attention`` against apex_tpu's.

Same numpy inputs through both; on the CPU the port runs the kernels' plain
twins, the JAX side its Pallas kernels in interpret mode (and their
references). Flash: causal windows of 1, 5, 7 and one wider than the
sequence, MHA, GQA and MQA, q_len equal to and below kv_len (the band sits
on the default diagonal ``kv_len - q_len``), O and LSE at atol = rtol =
1e-5. Paged, s = 1: window 10 over page 8, lengths below, at and past the
window, the table entries wholly below the band nulled to a poisoned page 0
(as ``drop_slot_pages`` leaves them), over an fp32 pool and an int8 pool
with per-(page, kv head) scales, at atol = rtol = 1e-5 (2e-5 quantized:
fp32 sums in other orders). ``cached_attention(window=)`` for one and three
query positions at atol = rtol = 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import generation as jgen
from apex_tpu.ops import flash_attention as jax_flash
from apex_tpu.ops import flash_attention_with_lse as jax_flash_lse
from apex_tpu.ops import paged_attention as jax_paged
from apex_tpu.ops.paged_attention import \
    paged_attention_reference as jax_paged_ref
from apex_tpu_torch.models import generation as tgen
from apex_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_with_lse)
from apex_tpu_torch.ops.paged_attention import (paged_attention,
                                                paged_attention_reference)
from apex_tpu_torch.ops.quant import kv_quantize

D = 16
TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(sq, sk, h, hkv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, h, sq, D)).astype(np.float32),
            rng.standard_normal((2, hkv, sk, D)).astype(np.float32),
            rng.standard_normal((2, hkv, sk, D)).astype(np.float32))


FLASH_CASES = [
    (33, 33, 4, 2, 5),       # GQA, a band narrower than any block
    (64, 64, 4, 4, 1),       # MHA, the diagonal alone
    (24, 40, 4, 2, 7),       # q_len < kv_len: the band on kv_len - q_len
    (40, 40, 4, 1, 64),      # MQA, a window wider than the sequence
]


@pytest.mark.parametrize("sq,sk,h,hkv,window", FLASH_CASES)
def test_windowed_flash_o_and_lse_match_jax(sq, sk, h, hkv, window):
    q, k, v = _qkv(sq, sk, h, hkv, seed=sq + window)
    jo, jlse = jax_flash_lse(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=True, window=window)
    to, tlse = flash_attention_with_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True,
        window=window)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True, window=window).numpy()
    want = np.asarray(jax_flash(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=True, window=window))
    np.testing.assert_allclose(got, want, **TOL)


def test_window_requires_causal_and_a_positive_width():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 8, 4, 2))
    with pytest.raises(ValueError, match="window requires causal"):
        flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="window must be >= 1"):
        flash_attention(q, k, v, causal=True, window=0)
    with pytest.raises(ValueError, match="window"):
        jax_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                  causal=False, window=4)


WINDOW, PS, MAXP = 10, 8, 6
LENGTHS = [0, 1, 9, 10, 11, 17, 18, 19, 33, 48]


def _windowed_case(h, kv, seed=0):
    """A shuffled pool, each slot's entries past its length and wholly
    below its band nulled to page 0, and page 0 poisoned."""
    rng = np.random.default_rng(seed)
    b = len(LENGTHS)
    num_pages = 1 + b * MAXP
    q = rng.standard_normal((b, h, 1, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((num_pages, kv, PS, D)).astype(np.float32)
              for _ in range(2))
    kp[0], vp[0] = 1e4, -1e4
    perm = rng.permutation(num_pages - 1) + 1
    bt = np.zeros((b, MAXP), np.int32)
    for i, n in enumerate(LENGTHS):
        bt[i, :-(-n // PS)] = perm[i * MAXP:i * MAXP - (-n // PS)]
        bt[i, :max(n - WINDOW, 0) // PS] = 0      # dropped below the band
    return q, kp, vp, bt, np.asarray(LENGTHS, np.int32)


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 1), (8, 2)])
def test_windowed_paged_matches_jax_kernel_and_reference(h, kv):
    q, kp, vp, bt, ln = _windowed_case(h, kv, seed=h + kv)
    assert (bt[-1, :4] == 0).all() and bt[-1, 4] != 0
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, ln)]
    targs = [torch.from_numpy(a) for a in (q, kp, vp, bt, ln)]
    got = paged_attention(*targs, window=WINDOW).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_paged(
        *jargs, window=WINDOW)), **TOL)
    np.testing.assert_allclose(
        paged_attention_reference(*targs, window=WINDOW).numpy(),
        np.asarray(jax_paged_ref(*jargs, window=WINDOW)), **TOL)
    assert (got[0] == 0).all()


def test_windowed_paged_over_an_int8_pool_matches_jax():
    q, kp, vp, bt, ln = _windowed_case(8, 2, seed=3)
    (qk, sk), (qv, sv) = (kv_quantize(torch.from_numpy(p) * 2, torch.int8,
                                      127.0, axes=(2, 3)) for p in (kp, vp))
    sk, sv = sk[:, :, 0, 0], sv[:, :, 0, 0]
    kw = dict(window=WINDOW, k_scales=sk, v_scales=sv)
    got = paged_attention(torch.from_numpy(q), qk, qv, torch.from_numpy(bt),
                          torch.from_numpy(ln), **kw).numpy()
    jargs = [jnp.asarray(a) for a in (q, qk.numpy(), qv.numpy(), bt, ln)]
    jkw = dict(window=WINDOW, k_scales=jnp.asarray(sk.numpy()),
               v_scales=jnp.asarray(sv.numpy()))
    np.testing.assert_allclose(got, np.asarray(jax_paged(*jargs, **jkw)),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jax_paged_ref(*jargs, **jkw)),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,t0", [(1, 20), (3, 12)])
def test_cached_attention_window_matches_reference(s, t0):
    rng = np.random.default_rng(s)
    q = rng.standard_normal((2, 4, s, D)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 32, D)).astype(np.float32)
            for _ in range(2))
    want = jgen.cached_attention(
        jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                         "len": t0}, window=WINDOW)
    got = tgen.cached_attention(
        torch.from_numpy(q), {"k": torch.from_numpy(k),
                              "v": torch.from_numpy(v), "len": t0},
        window=WINDOW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
