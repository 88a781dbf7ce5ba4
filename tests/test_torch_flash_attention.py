"""Port parity: apex_tpu_torch causal flash attention vs the JAX kernels.

Same numpy inputs through both; on the CPU the port runs the kernels'
plain twins, the JAX side its Pallas kernels in interpret mode (and the
pure-jnp ``mha_reference``). Covers MHA and GQA (H=4, Hkv=2) at
S in {8, 33, 64}, O and LSE, fp32 tolerance atol = rtol = 1e-5; and the
backward (dq, dk, dv) against ``jax.grad`` at S in {33, 128}, atol = rtol =
1e-4.
"""

import importlib

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


# --- backward -------------------------------------------------------------


@pytest.mark.parametrize("s", [33, 128])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)])
def test_flash_grads_match_jax(s, h, hkv):
    """dq, dk, dv through the autograd Function vs ``jax.grad`` of the
    reference's ``flash_attention(causal=True)`` (its ``_dq_kernel`` and
    ``_dkdv_kernel`` in interpret mode), MHA and GQA. fp32 atol = rtol =
    1e-4: the two sum the same fp32 products over up to S keys in other
    orders."""
    import jax

    q, k, v = _qkv(s, h, hkv, seed=100 + s)
    do = np.random.default_rng(s + h + hkv).standard_normal(q.shape).astype(
        np.float32)

    def f(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, causal=True) * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    flash_attention(qt, kt, vt, causal=True).backward(torch.from_numpy(do))
    for t, w in zip((qt, kt, vt), want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_flash_lse_cotangent_matches_jax():
    """The LSE cotangent folds into delta, as the reference's
    ``flash_attention_with_lse`` backward does."""
    import jax

    q, k, v = _qkv(33, 4, 2, seed=11)
    rng = np.random.default_rng(12)
    do = rng.standard_normal(q.shape).astype(np.float32)
    dl = rng.standard_normal(q.shape[:3]).astype(np.float32)

    def f(q_, k_, v_):
        o, lse = jax_flash_lse(q_, k_, v_, causal=True)
        return jnp.sum(o * jnp.asarray(do)) + jnp.sum(lse * jnp.asarray(dl))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = flash_attention_with_lse(qt, kt, vt, causal=True)
    ((o * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dl)).sum()).backward()
    for t, w in zip((qt, kt, vt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_flash_backward_calls_the_backward_twins(monkeypatch):
    """On the CPU the Function's backward is the twins of the two backward
    kernels, not autograd through the forward twin; its output equals the
    whole-backward twin's."""
    mod = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    calls = []

    def spy(name):
        real = getattr(mod, name)

        def wrapped(*args, **kw):
            calls.append(name)
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    spy("flash_bwd_dq_reference")
    spy("flash_bwd_dkdv_reference")
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(8, 4, 4, seed=13))
    o = flash_attention(q, k, v, causal=True)
    assert "FlashAttentionFunction" in type(o.grad_fn).__name__
    o.sum().backward()
    assert calls == ["flash_bwd_dq_reference", "flash_bwd_dkdv_reference"]
    ro, rlse = mod.flash_attention_reference(q.detach(), k.detach(),
                                             v.detach(), scale=0.25)
    want = mod.flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), ro, rlse, torch.ones_like(ro),
        scale=0.25)
    for t, w in zip((q, k, v), want):
        torch.testing.assert_close(t.grad, w, atol=0, rtol=0)
