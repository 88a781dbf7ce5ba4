"""Port parity: the windowed flash-attention backward of apex_tpu_torch
against ``jax.grad`` of apex_tpu's.

Same numpy inputs through both; on the CPU the port's autograd Function
runs the twins of the dq and dk/dv kernels under the window's masking, the
JAX side ``jax.grad`` through its ``_dq_kernel`` and ``_dkdv_kernel`` in
interpret mode over their band-restricted grids (``_fa_bwd_impl``). Causal
windows of 1 (the diagonal alone), 8, 20 (no multiple of any tile) and one
at least as long as the sequence (plain causal), MHA and GQA; through
``flash_attention_with_lse`` with a cotangent on the LSE too, and with
q_len below kv_len (the band on the diagonal ``kv_len - q_len``). fp32 at
atol = rtol = 1e-4: the two sum the same fp32 products over up to S keys
in other orders.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flash_attention as jax_flash
from apex_tpu.ops import flash_attention_with_lse as jax_flash_lse
from apex_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_with_lse)

D = 16
TOL = dict(atol=1e-4, rtol=1e-4)
S = 70


def _qkv(sq, sk, h, hkv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, h, sq, D)).astype(np.float32),
            rng.standard_normal((2, hkv, sk, D)).astype(np.float32),
            rng.standard_normal((2, hkv, sk, D)).astype(np.float32),
            rng.standard_normal((2, h, sq, D)).astype(np.float32),
            rng.standard_normal((2, h, sq)).astype(np.float32))


def _check(got, want):
    for t, w in zip(got, want):
        assert t.grad is not None and t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("window", [1, 8, 20, S])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)])
def test_windowed_flash_grads_match_jax(h, hkv, window):
    q, k, v, do, _ = _qkv(S, S, h, hkv, seed=window + hkv)

    def f(q_, k_, v_):
        o = jax_flash(q_, k_, v_, causal=True, window=window)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    flash_attention(qt, kt, vt, causal=True, window=window).backward(
        torch.from_numpy(do))
    _check((qt, kt, vt), want)


@pytest.mark.parametrize("sq,sk,h,hkv,window", [
    (S, S, 4, 2, 8),          # GQA
    (S, S, 4, 4, 20),         # MHA, a window no tile divides
    (24, 40, 4, 2, 7),        # q_len < kv_len
])
def test_windowed_flash_lse_cotangent_matches_jax(sq, sk, h, hkv, window):
    """The LSE cotangent folds into delta under the window, as the
    reference's ``flash_attention_with_lse`` backward does."""
    q, k, v, do, dl = _qkv(sq, sk, h, hkv, seed=sq + window)

    def f(q_, k_, v_):
        o, lse = jax_flash_lse(q_, k_, v_, causal=True, window=window)
        return jnp.sum(o * jnp.asarray(do)) + jnp.sum(lse * jnp.asarray(dl))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = flash_attention_with_lse(qt, kt, vt, causal=True, window=window)
    ((o * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dl)).sum()).backward()
    _check((qt, kt, vt), want)


def test_window_at_least_the_sequence_is_plain_causal():
    """The twins under a window >= S give the causal backward bit for bit;
    under a narrower window they differ (the band bites)."""
    q, k, v, do, _ = (torch.from_numpy(a) for a in _qkv(S, S, 4, 2, seed=3))
    grads = {}
    for window in (None, S, S + 9, 8):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_attention(*ts, causal=True, window=window).backward(do)
        grads[window] = [t.grad for t in ts]
    for window in (S, S + 9):
        for a, b in zip(grads[window], grads[None]):
            assert torch.equal(a, b)
    assert not torch.allclose(grads[8][0], grads[None][0])


def test_windowed_backward_calls_the_backward_twins(monkeypatch):
    """On the CPU the Function's backward under a window is the twins of
    the two backward kernels, each given the window's masking."""
    mod = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    seen = []

    def spy(name):
        real = getattr(mod, name)

        def wrapped(*args, masking, **kw):
            seen.append((name, masking.window))
            return real(*args, masking=masking, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    spy("flash_bwd_dq_reference")
    spy("flash_bwd_dkdv_reference")
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(12, 12, 4, 2, seed=4)[:3])
    flash_attention(q, k, v, causal=True, window=5).sum().backward()
    assert seen == [("flash_bwd_dq_reference", 5),
                    ("flash_bwd_dkdv_reference", 5)]
