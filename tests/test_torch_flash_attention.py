"""Port parity: apex_tpu_torch causal flash attention vs the JAX kernel.

Same numpy inputs through both; on the CPU the port runs the kernel's
plain twin, the JAX side its Pallas kernel in interpret mode (and the
pure-jnp ``mha_reference``). Covers MHA and GQA (H=4, Hkv=2) at
S in {8, 33, 64}, O and LSE. fp32 tolerance atol = rtol = 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flash_attention as jax_flash
from apex_tpu.ops import flash_attention_with_lse as jax_flash_lse
from apex_tpu.ops import mha_reference as jax_mha
from apex_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_with_lse,
                                                mha_reference)

D = 16


def _qkv(s, h, hkv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, h, s, D)).astype(np.float32)
    k = rng.standard_normal((2, hkv, s, D)).astype(np.float32)
    v = rng.standard_normal((2, hkv, s, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("s", [8, 33, 64])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)])
def test_flash_o_and_lse_match_jax(s, h, hkv):
    q, k, v = _qkv(s, h, hkv, seed=s)
    jo, jlse = jax_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True)
    to, tlse = flash_attention_with_lse(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), causal=True)
    assert tlse.dtype == torch.float32 and tlse.shape == (2, h, s)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)])
def test_flash_attention_matches_jax_kernel_and_reference(h, hkv):
    q, k, v = _qkv(33, h, hkv, seed=7)
    args = [jnp.asarray(a) for a in (q, k, v)]
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_flash(*args,
                                                         causal=True)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_mha(*args, causal=True)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        mha_reference(*(torch.from_numpy(a) for a in (q, k, v))).numpy(),
        got, atol=0, rtol=0)


def test_flash_cross_length_causal_offset_matches_jax():
    """Sq < Sk: query row r sees keys j <= r + (Sk - Sq), the reference's
    default diagonal."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 5, D)).astype(np.float32)
    k = rng.standard_normal((1, 2, 12, D)).astype(np.float32)
    v = rng.standard_normal((1, 2, 12, D)).astype(np.float32)
    jo, jlse = jax_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True)
    to, tlse = flash_attention_with_lse(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("kwargs", [
    dict(causal=False),
    dict(causal=True, window=4),
    dict(causal=True, dropout_rate=0.1),
])
def test_unported_flash_options_raise(kwargs):
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 4, 4))
    with pytest.raises(NotImplementedError, match="causal=True only"):
        flash_attention(q, k, v, **kwargs)


def test_flash_bias_and_segments_raise():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 4, 4))
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v, torch.zeros(1, 1, 8, 8), causal=True)
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v, segment_ids=torch.zeros(2, 8), causal=True)


def test_gqa_heads_must_divide():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 4, 3))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(q, k, v, causal=True)
