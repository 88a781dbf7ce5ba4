"""Port parity: apex_tpu_torch flash attention vs the JAX kernels.

Same numpy inputs through both; on the CPU the port runs the kernels'
plain twins, the JAX side its Pallas kernels in interpret mode (and the
pure-jnp ``mha_reference``). Covers MHA and GQA (H=4, Hkv=2) at
S in {8, 33, 64}, O and LSE, fp32 tolerance atol = rtol = 1e-5; and the
backward (dq, dk, dv) against ``jax.grad`` at S in {33, 128}, atol = rtol =
1e-4. Then the BERT surface: non-causal, padding as segment ids, attention
dropout (whose keep mask must be the reference's bit for bit) and GQA,
forward and all three gradients, at the same tolerances.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flash_attention as jax_flash
from apex_tpu.ops import flash_attention_with_lse as jax_flash_lse
from apex_tpu.ops import mha_reference as jax_mha
from apex_tpu_torch.ops.flash_attention import (Masking, dropout_hash,
                                                flash_attention,
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
    dict(causal=False, window=4),
    dict(causal=True, window=4),
    dict(causal=True, dropout_rate=0.1, window=4),
])
def test_unported_flash_options_raise(kwargs):
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 4, 4))
    with pytest.raises(NotImplementedError, match="no bias, window"):
        flash_attention(q, k, v, **kwargs)


def test_flash_bias_and_segments_raise():
    """A bias is not ported; segment ids must fit q and k."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 4, 4))
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v, torch.zeros(1, 1, 8, 8), causal=True)
    with pytest.raises(ValueError, match="segment ids"):
        flash_attention(q, k, v, segment_ids=torch.zeros(2, 7), causal=True)
    with pytest.raises(NotImplementedError):
        flash_attention_with_lse(q, k, v, causal=True, window=2)


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


# --- the BERT surface: non-causal, segment ids, dropout ---------------------


def _np_hash(seed, bh, rows, cols):
    """The reference tests' numpy restatement of the keep-mask hash
    (``tests/test_flash_attention.py::_np_keep``), before the threshold."""
    with np.errstate(over="ignore"):
        x = (np.asarray(rows, np.uint32) * np.uint32(0x9E3779B1)
             + np.asarray(cols, np.uint32) * np.uint32(0x85EBCA77)
             + np.asarray(bh, np.uint32) * np.uint32(0xC2B2AE3D)
             + np.uint32(seed & 0xFFFFFFFF))
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
    return x


def test_dropout_hash_matches_numpy_over_random_positions():
    """The port's int64 restatement of the hash equals the uint32 one at
    random (seed, bh, row, col), including seeds whose int32 form is
    negative and products that wrap."""
    rng = np.random.default_rng(21)
    n = 4096
    bh, rows, cols = (rng.integers(0, 2 ** 31, n) for _ in range(3))
    for seed in (0, 7, 2 ** 31 - 1, -5, -(2 ** 31), 123456789):
        got = dropout_hash(seed, *(torch.from_numpy(a) for a in
                                   (bh, rows, cols)))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                      _np_hash(seed, bh, rows, cols))


def test_keep_mask_is_the_reference_mask():
    """``Masking.keep`` over a whole grid equals ``_np_keep``: 0 where
    dropped and ``1 / (1 - rate)`` (fp32) where kept, ``bh = b * H + h``."""
    b, h, sq, sk, rate, seed = 2, 3, 17, 40, 0.3, 11
    got = Masking(dropout_rate=rate, dropout_seed=seed).keep(b, h, sq, sk,
                                                             "cpu")
    for bi in range(b):
        for hi in range(h):
            x = _np_hash(seed, bi * h + hi, np.arange(sq)[:, None],
                         np.arange(sk)[None, :])
            thr = np.uint32(min(int(rate * 2.0 ** 32), 2 ** 32 - 1))
            want = (x >= thr).astype(np.float32) / np.float32(1.0 - rate)
            np.testing.assert_array_equal(got[bi, hi].numpy(), want)
    share = (got > 0).float().mean().item()
    assert abs(share - (1 - rate)) < 0.05


def _padded_segments(lengths, s):
    """Per-row padding as segment ids, as BERT's attention mask: 1 on the
    first ``length`` tokens, 0 on the padding."""
    return (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.int32)


#: (causal, segment lengths or None, dropout rate, h, hkv)
SURFACE = [
    (False, None, 0.0, 4, 4),
    (False, (20, 9), 0.0, 4, 4),
    (False, (20, 9), 0.2, 4, 4),
    (False, None, 0.2, 4, 2),
    (True, (24, 13), 0.2, 4, 2),
]


def _surface_inputs(causal, lengths, rate, h, hkv, s=24, seed=31):
    q, k, v = _qkv(s, h, hkv, seed=seed)
    seg = None if lengths is None else _padded_segments(lengths, s)
    jkw = dict(causal=causal, dropout_rate=rate, dropout_seed=seed)
    if seg is not None:
        jkw["segment_ids"] = jnp.asarray(seg)
    tkw = dict(causal=causal, dropout_rate=rate, dropout_seed=seed,
               segment_ids=None if seg is None else torch.from_numpy(seg))
    return (q, k, v), jkw, tkw


@pytest.mark.parametrize("causal,lengths,rate,h,hkv", SURFACE)
def test_flash_bert_surface_forward_matches_jax(causal, lengths, rate, h,
                                                hkv):
    (q, k, v), jkw, tkw = _surface_inputs(causal, lengths, rate, h, hkv)
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), **jkw)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("causal,lengths,rate,h,hkv", SURFACE)
def test_flash_bert_surface_grads_match_jax(causal, lengths, rate, h, hkv):
    """dq, dk, dv against ``jax.grad`` through the reference's
    ``_dq_kernel`` and ``_dkdv_kernel``; the dropout mask regenerated in
    both backward kernels must be the forward's. atol = rtol = 1e-4."""
    import jax

    (q, k, v), jkw, tkw = _surface_inputs(causal, lengths, rate, h, hkv,
                                          seed=41)
    do = np.random.default_rng(42).standard_normal(q.shape).astype(
        np.float32)

    def f(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, **jkw) * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    flash_attention(qt, kt, vt, **tkw).backward(torch.from_numpy(do))
    for t, w in zip((qt, kt, vt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_flash_non_causal_dropout_lse_matches_jax():
    """O and LSE with dropout: the LSE sums the undropped probabilities."""
    q, k, v = _qkv(40, 4, 2, seed=51)
    jo, jlse = jax_flash_lse(*(jnp.asarray(a) for a in (q, k, v)),
                             dropout_rate=0.25, dropout_seed=9)
    to, tlse = flash_attention_with_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), dropout_rate=0.25,
        dropout_seed=9)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=1e-5)


def test_row_that_sees_no_key_outputs_zero_like_jax():
    """kv segment ids that some query rows match nowhere: those rows output
    exactly 0, as the reference's, and their LSE is the mask value."""
    q, k, v = _qkv(16, 4, 4, seed=61)
    qs = np.repeat(np.array([[0, 1, 2, 3]], np.int32), 4, axis=1)
    qs = np.concatenate([qs, qs])
    ks = np.where(qs == 3, 1, qs).astype(np.int32)     # segment 3 sees none
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)),
                     segment_ids=jnp.asarray(qs),
                     kv_segment_ids=jnp.asarray(ks))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          segment_ids=torch.from_numpy(qs),
                          kv_segment_ids=torch.from_numpy(ks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert (got[:, :, 12:] == 0).all()
    masking = Masking(causal=False, segment_ids=torch.from_numpy(qs),
                      kv_segment_ids=torch.from_numpy(ks))
    mod = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    _, lse = mod.flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), scale=0.25,
        masking=masking)
    assert (lse[:, :, 12:] == mod.DEFAULT_MASK_VALUE).all()
    np.testing.assert_allclose(
        mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                      torch.from_numpy(qs), torch.from_numpy(ks),
                      causal=False).numpy(),
        np.asarray(jax_mha(*(jnp.asarray(a) for a in (q, k, v)),
                           segment_ids=jnp.asarray(qs),
                           kv_segment_ids=jnp.asarray(ks))),
        atol=1e-5, rtol=1e-5)
