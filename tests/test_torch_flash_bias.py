"""Port parity: the additive-bias branch of apex_tpu_torch flash attention
vs the JAX kernels.

The same numpy inputs go through both: on the CPU the port runs the
kernels' plain twins, the JAX side its Pallas kernels in interpret mode
(``flash_attention``, its internal ``_fa_fwd`` for the LSE, ``jax.grad``
through ``_dq_kernel`` and ``_dkdv_kernel``) and the pure-jnp
``mha_reference``. Bias shapes ``(1, H, Sq, Sk)`` (T5's table, one batch
entry serving B = 3), ``(B, 1, 1, Sk)`` with -1e9 on padded keys and ``(B,
H, Sq, Sk)``; causal or not, a window, GQA, segment ids with dropout, Sq !=
Sk, and T5's start token (Sq = Sk = 1). fp32; O and LSE within atol = rtol
= 1e-5, (dq, dk, dv) within atol = rtol = 1e-4 (the two sum the same fp32
products over up to Sk keys in other orders); the bias's gradient is
exactly 0 on both sides (the reference does not differentiate it). Also
the repaired ``mha_reference`` signature (no keywords, a positional bias)
and ``cached_attention(bias=)`` against the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import generation as jax_gen
from apex_tpu.ops import flash_attention as jax_flash
from apex_tpu.ops import mha_reference as jax_mha
from apex_tpu.ops.flash_attention import _fa_fwd as jax_fa_fwd
from apex_tpu_torch.models.generation import cached_attention
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.flash_attention import (Masking, flash_attention,
                                                flash_fwd, launch_name,
                                                mha_reference)

D = 16
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)

#: (id, batch, heads, kv heads, Sq, Sk, bias kind, causal, window,
#: segments, dropout rate)
CASES = [
    ("t5_encoder", 3, 4, 4, 24, 24, "table", False, None, False, 0.0),
    ("t5_decoder", 3, 4, 4, 24, 24, "table", True, None, False, 0.0),
    ("padding", 3, 4, 2, 20, 20, "padding", False, None, False, 0.0),
    ("full_cross", 2, 4, 2, 12, 30, "full", True, None, False, 0.0),
    ("window", 2, 4, 4, 33, 33, "table", True, 5, False, 0.0),
    ("segments_dropout", 2, 4, 2, 24, 24, "table", False, None, True, 0.2),
    ("start_token", 3, 4, 4, 1, 1, "table", True, None, False, 0.0),
]


def _bias(kind, b, h, sq, sk, rng):
    if kind == "table":
        return rng.standard_normal((1, h, sq, sk)).astype(np.float32)
    if kind == "full":
        return rng.standard_normal((b, h, sq, sk)).astype(np.float32)
    lengths = rng.integers(sk // 2, sk + 1, b)
    lengths[0] = sk - 3
    pad = np.arange(sk)[None, :] >= lengths[:, None]
    return np.where(pad, -1e9, 0.0).astype(np.float32)[:, None, None, :]


def _inputs(case, seed=0):
    _, b, h, hkv, sq, sk, kind, causal, window, segs, rate = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, D)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, D)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, D)).astype(np.float32)
    bias = _bias(kind, b, h, sq, sk, rng)
    jkw = dict(causal=causal, window=window, dropout_rate=rate,
               dropout_seed=seed + 7)
    tkw = dict(jkw)
    if segs:
        seg = (np.arange(sq)[None, :] < np.array([sq - 5, sq])[:, None])
        seg = seg.astype(np.int32)
        jkw["segment_ids"] = jnp.asarray(seg)
        tkw["segment_ids"] = torch.from_numpy(seg)
    return (q, k, v, bias), jkw, tkw


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bias_forward_matches_jax_kernel(case):
    (q, k, v, bias), jkw, tkw = _inputs(case)
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v, bias)), **jkw)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                          **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if not jkw["dropout_rate"]:
        ref = jax_mha(*(jnp.asarray(a) for a in (q, k, v, bias)),
                      **{n: a for n, a in jkw.items()
                         if n not in ("dropout_rate", "dropout_seed")})
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("case", CASES[:4], ids=[c[0] for c in CASES[:4]])
def test_bias_lse_matches_jax_kernel(case):
    """The forward twin's LSE against the reference's ``_fa_fwd`` (the
    public ``flash_attention_with_lse`` takes no bias)."""
    (q, k, v, bias), jkw, _ = _inputs(case, seed=3)
    causal, scale = jkw["causal"], D ** -0.5
    _, want = jax_fa_fwd(*(jnp.asarray(a) for a in (q, k, v, bias)), None,
                         None, None, scale, causal, 0.0, None, None)
    _, got = flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                       scale=scale, masking=Masking(causal=causal),
                       bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bias_grads_match_jax_and_bias_grad_is_zero(case):
    """(dq, dk, dv) through the backward twins against ``jax.grad`` of the
    reference's ``flash_attention`` with the same bias; the bias's gradient
    is zeros on both sides."""
    (q, k, v, bias), jkw, tkw = _inputs(case, seed=11)
    do = np.random.default_rng(12).standard_normal(q.shape).astype(
        np.float32)

    def f(q_, k_, v_, b_):
        return jnp.sum(jax_flash(q_, k_, v_, b_, **jkw) * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    qt, kt, vt, bt = (torch.from_numpy(a).requires_grad_()
                      for a in (q, k, v, bias))
    flash_attention(qt, kt, vt, bt, **tkw).backward(torch.from_numpy(do))
    for t, w in zip((qt, kt, vt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   **GRAD_TOL)
    assert not np.asarray(want[3]).any()
    assert bt.grad is not None and bt.grad.shape == bt.shape
    assert not bt.grad.any()


def test_broadcast_batch_bias_equals_repeated_bias():
    """A (1, H, S, S) bias serving B = 3 gives what the same bias repeated
    over the batch gives (a stride off by a factor of B would read other
    entries): forward and every gradient, bit for bit on the twins."""
    (q, k, v, bias), _, tkw = _inputs(CASES[1], seed=5)
    outs = []
    for bb in (bias, np.repeat(bias, 3, axis=0)):
        qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        o = flash_attention(qt, kt, vt, torch.from_numpy(bb), **tkw)
        o.square().sum().backward()
        outs.append([o.detach(), qt.grad, kt.grad, vt.grad])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_bias_in_q_dtype_or_fp32():
    """bf16 q takes a bf16 or an fp32 bias; the twin adds it in fp32."""
    (q, k, v, bias), _, _ = _inputs(CASES[0], seed=9)
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    bias_t = torch.from_numpy(bias)
    o32 = flash_attention(qb, kb, vb, bias_t.bfloat16().float())
    o16 = flash_attention(qb, kb, vb, bias_t.bfloat16())
    assert o16.dtype == torch.bfloat16
    torch.testing.assert_close(o16, o32, atol=0, rtol=0)


def test_bias_launch_names_are_registered():
    """With a bias each branch counts under its own name, ``_bias`` after
    the window's, and every such name is a registered kernel."""
    bias = torch.zeros(1)
    windowed = Masking(causal=True, window=4)
    names = {launch_name(kernel, m, b, 8, 8)
             for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")
             for m in (Masking(), windowed) for b in (None, bias)}
    assert launch_name("flash_fwd", windowed, bias, 8, 8) == \
        "flash_fwd_window_bias"
    assert launch_name("flash_bwd_dq", Masking(), bias, 8, 8) == \
        "flash_bwd_dq_bias"
    assert len(names) == 12 and names <= set(_build.KERNELS)
    for name in names:
        assert _build.KERNELS[name][0] in ("flash_fwd.cu", "flash_bwd.cu")


def test_mha_reference_defaults_match_jax_with_no_keywords():
    """``mha_reference(q, k, v)`` means the same in both packages
    (non-causal, scale 1/sqrt(d)), and a fourth positional argument is the
    bias in both."""
    (q, k, v, bias), _, _ = _inputs(CASES[3], seed=21)
    jargs = [jnp.asarray(a) for a in (q, k, v, bias)]
    targs = [torch.from_numpy(a) for a in (q, k, v, bias)]
    np.testing.assert_allclose(mha_reference(*targs[:3]).numpy(),
                               np.asarray(jax_mha(*jargs[:3])), **TOL)
    np.testing.assert_allclose(mha_reference(*targs).numpy(),
                               np.asarray(jax_mha(*jargs)), **TOL)
    np.testing.assert_allclose(
        mha_reference(*targs, causal=True, scale=0.5).numpy(),
        np.asarray(jax_mha(*jargs, causal=True, scale=0.5)), **TOL)


@pytest.mark.parametrize("s", [1, 3])
def test_cached_attention_bias_matches_jax(s):
    """The cached path adds a ``(1, H, s, T)`` bias to the scaled scores
    before masking, as the reference's: T5's decode steps."""
    rng = np.random.default_rng(30 + s)
    b, h, hkv, t_max, t0 = 2, 4, 2, 10, 4
    q = rng.standard_normal((b, h, s, D)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, t_max, D)).astype(np.float32)
            for _ in range(2))
    bias = rng.standard_normal((1, h, s, t_max)).astype(np.float32)
    want = jax_gen.cached_attention(
        jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                         "len": t0}, bias=jnp.asarray(bias), scale=1.0)
    got = cached_attention(
        torch.from_numpy(q), {"k": torch.from_numpy(k),
                              "v": torch.from_numpy(v), "len": t0},
        bias=torch.from_numpy(bias), scale=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
