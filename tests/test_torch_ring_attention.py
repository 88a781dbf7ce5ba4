"""Port parity: ring attention and the flash kernels' ring branches.

1. ``flash_attention_with_lse`` with ``causal_offset`` (positive, 0,
   negative, past every key; with and without a window) and non-zero
   dropout origins, the port's twins against JAX's flash kernels in
   interpret mode: O, the LSE of the rows that see a key (JAX gives the
   others -inf, the port the mask value), and dq/dk/dv with an LSE
   cotangent on the live rows, fp32 within 1e-5.
2. The port's in-process ring (``LocalRing``) at cp 2 and 4,
   ``ring_attention`` causal or not, windowed (windows below and above
   S_loc, so offsets occur), and ``ring_attention_zigzag``, GQA, with
   dropout 0.2 and without, against JAX's unsharded flash attention on the
   gathered sequence (which ``tests/test_ring_attention.py`` holds equal to
   JAX's ring): output and gradients within 2e-5, that suite's tolerance.
   The JAX side is computed once per (causal, window, rate).
3. The distributed ring over ``gloo``, 2 and 4 spawned ranks (``file://``
   rendezvous), against the in-process ring within 1e-6 in the output and
   the gradients; each run joins with a limit of its own.
4. ``to_zigzag``/``from_zigzag`` against JAX's, the round trip, and the
   named errors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ring_worker import ring_case, ring_inputs, ring_worker, run_ranks
from apex_tpu.ops import flash_attention_with_lse as jax_flash_lse
from apex_tpu.ops import from_zigzag as jax_from_zigzag
from apex_tpu.ops import to_zigzag as jax_to_zigzag
from apex_tpu_torch.ops import from_zigzag, ring_attention, to_zigzag
from apex_tpu_torch.ops.flash_attention import (Masking, flash_attention,
                                                flash_attention_with_lse,
                                                launch_name)
from apex_tpu_torch.ops.ring_attention import (LocalRing, _merge,
                                               ring_attention_zigzag)

TOL = dict(atol=1e-5, rtol=1e-5)
RING_TOL = dict(atol=2e-5, rtol=2e-5)
B, H, HKV, S, D = 1, 4, 2, 64, 16


def _qkv(seed, sq, sk):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, H, sq, D), (B, HKV, sk, D),
                               (B, HKV, sk, D), (B, H, sq, D), (B, H, sq)))


# --- 1. the flash kernels' ring branches against JAX ------------------------


@pytest.mark.parametrize("offset,window,rate,row0,col0", [
    (16, None, 0.0, 0, 0),        # a chunk upstream
    (0, None, 0.0, 0, 0),         # the diagonal of an equal-length call
    (-8, None, 0.0, 0, 0),        # negative: the first rows see nothing
    (16, 8, 0.0, 0, 0),           # window off the default diagonal
    (-4, 7, 0.0, 0, 0),
    (60, 12, 0.0, 0, 0),          # the band past every key: all rows dead
    (None, None, 0.2, 100, 37),   # dropout origins only
    (30, 10, 0.2, 70000, 70),     # both
    (None, 6, 0.2, 24, 0),
])
def test_offset_and_origins_match_jax(offset, window, rate, row0, col0):
    q, k, v, do, dl = _qkv(abs(offset or 0) + row0, 24, 40)
    kw = dict(causal=True, window=window, causal_offset=offset,
              dropout_rate=rate, dropout_seed=5, dropout_row0=row0,
              dropout_col0=col0)
    o_j, lse_j = jax_flash_lse(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    lse_j = np.asarray(lse_j)
    live = np.isfinite(lse_j) & (lse_j > -1e30)
    dl = np.where(live, dl, 0.0).astype(np.float32)

    def f(q_, k_, v_):
        o, lse = jax_flash_lse(q_, k_, v_, **kw)
        lse = jnp.where(jnp.asarray(live), lse, 0.0)
        return jnp.sum(o * jnp.asarray(do)) + jnp.sum(lse * jnp.asarray(dl))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                            for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = flash_attention_with_lse(qt, kt, vt, **kw)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.detach().numpy()[live], lse_j[live],
                               **TOL)
    assert (o.detach().numpy()[~live] == 0).all()
    ((o * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dl)).sum()).backward()
    for t, w in zip((qt, kt, vt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL)


def test_ring_branch_launch_names_and_refusals():
    """A call whose diagonal is not Sk - Sq, or whose dropout is drawn at a
    non-zero origin, is the ``_ring`` branch; an offset or an origin that
    changes nothing is not; offsets and origins are host ints; a ring call
    takes no bias."""
    ring = Masking(causal=True, window=8, causal_offset=4)
    assert launch_name("flash_fwd", ring, None, 16, 16) == \
        "flash_fwd_window_ring"
    assert launch_name("flash_bwd_dq", Masking(
        causal=False, dropout_rate=0.1, dropout_col0=3), None, 16, 16) == \
        "flash_bwd_dq_ring"
    assert launch_name("flash_bwd_dkdv", Masking(), None, 16, 16) == \
        "flash_bwd_dkdv"
    for plain in (Masking(causal=True, window=8, causal_offset=4),  # Sk-Sq
                  Masking(causal=False, causal_offset=7),  # no diagonal
                  Masking(causal=True, dropout_row0=16, dropout_col0=8)):
        assert launch_name("flash_fwd", plain, None, 12, 16) in (
            "flash_fwd", "flash_fwd_window")
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(TypeError, match="causal_offset must be a host int"):
        flash_attention_with_lse(q, q, q, causal=True,
                                 causal_offset=torch.tensor(2))
    with pytest.raises(TypeError, match="dropout_row0"):
        flash_attention_with_lse(q, q, q, dropout_row0=1.5)
    with pytest.raises(ValueError, match="does not combine with a bias"):
        launch_name("flash_fwd", ring, torch.zeros(4, 4), 4, 4)
    # the default diagonal given explicitly is the default call's result
    a = flash_attention_with_lse(q + 1, q, q, causal=True, causal_offset=0)
    b = flash_attention_with_lse(q + 1, q, q, causal=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # origins shift the keep mask: row r of a call at row0 is row row0 + r
    m0, m1 = Masking(dropout_rate=0.5, dropout_seed=1), Masking(
        dropout_rate=0.5, dropout_seed=1, dropout_row0=3, dropout_col0=2)
    full = m0.keep(1, 2, 8, 8, "cpu")
    assert torch.equal(m1.keep(1, 2, 5, 6, "cpu"), full[:, :, 3:, 2:])
    assert flash_attention(q, q, q).shape == q.shape


def test_merge_weights_dead_partials_zero_without_nan():
    o1, o2 = torch.randn(2, 3, 4), torch.randn(2, 3, 4)
    lse1 = torch.randn(2, 3).requires_grad_()
    dead = torch.full((2, 3), float("-inf")).requires_grad_()
    o, lse = _merge(o1, lse1, o2, dead)
    assert torch.equal(o, o1) and torch.equal(lse, lse1)
    both, lse_b = _merge(o1, dead, o2, dead)
    assert torch.isneginf(lse_b).all() and (both == 0).all()
    (o.sum() + lse.sum() + both.sum()).backward()
    assert torch.isfinite(lse1.grad).all() and torch.isfinite(dead.grad).all()


# --- 2. the in-process ring against JAX's unsharded flash -------------------


@functools.cache
def _jax_reference(seed, causal, window, rate):
    """JAX's unsharded flash on the gathered sequence: output and the
    gradients of sum(o * do)."""
    q, k, v, do, _ = _qkv(seed, S, S)
    kw = dict(causal=causal, window=window, dropout_rate=rate,
              dropout_seed=11)

    def f(q_, k_, v_):
        return jnp.sum(jax_flash_lse(q_, k_, v_, **kw)[0] * jnp.asarray(do))

    args = [jnp.asarray(a) for a in (q, k, v)]
    out = jax_flash_lse(*args, **kw)[0]
    grads = jax.grad(f, argnums=(0, 1, 2))(*args)
    return [np.asarray(t) for t in (out, *grads)]


def _check_ring(got, want, tol=RING_TOL):
    for g, w, name in zip(got, want, ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


def _local_ring(layout, cp, causal, window, rate, seed):
    q, k, v, do, _ = _qkv(seed, S, S)
    ts = [torch.from_numpy(a) for a in (q, k, v, do)]
    if layout == "zigzag":
        ts = [to_zigzag(t, cp) for t in ts]
    qt, kt, vt = (t.requires_grad_() for t in ts[:3])
    kw = dict(ring=LocalRing(cp), window=window, dropout_rate=rate,
              dropout_seed=11)
    o = (ring_attention(qt, kt, vt, causal=causal, **kw) if layout == "ring"
         else ring_attention_zigzag(qt, kt, vt, **kw))
    o.backward(ts[3])
    out = [o.detach(), qt.grad, kt.grad, vt.grad]
    if layout == "zigzag":
        out = [from_zigzag(t, cp) for t in out]
    return [t.numpy() for t in out]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 5), (True, 20)])
def test_ring_matches_jax_unsharded(causal, window, cp, rate):
    """S_loc is 32 (cp 2) or 16 (cp 4): window 5 reaches one chunk back,
    window 20 two at cp 4."""
    _check_ring(_local_ring("ring", cp, causal, window, rate, seed=1),
                _jax_reference(1, causal, window, rate))


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("window", [None, 5, 20])
def test_zigzag_ring_matches_jax_unsharded(window, cp, rate):
    """S_h is 16 (cp 2) or 8 (cp 4): windows 5 and 20 give static hop
    offsets and the rank's own late-against-early offsets."""
    _check_ring(_local_ring("zigzag", cp, True, window, rate, seed=1),
                _jax_reference(1, True, window, rate))


def test_ring_refuses_what_the_reference_refuses():
    q = torch.zeros(1, 4, 16, 8)
    kv = torch.zeros(1, 2, 16, 8)
    with pytest.raises(ValueError, match="window requires causal"):
        ring_attention(q, kv, kv, ring=LocalRing(2), window=4)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        ring_attention(q, q[:, :3], q[:, :3], ring=LocalRing(2))
    with pytest.raises(ValueError, match="not divisible by the ring size"):
        ring_attention(q, kv, kv, ring=LocalRing(3))
    with pytest.raises(ValueError, match="two half-chunks"):
        ring_attention_zigzag(q[:, :, :12], kv[:, :, :12], kv[:, :, :12],
                              ring=LocalRing(4))
    with pytest.raises(TypeError, match="ring"):
        ring_attention(q, kv, kv)
    with pytest.raises(TypeError, match="ring"):
        ring_attention_zigzag(q, kv, kv)


# --- 3. the distributed ring over gloo --------------------------------------

GLOO_CASES = [(None, 0.2), (3, 0.2), (6, 0.0), (12, 0.2)]
GLOO_S = 32


@pytest.mark.parametrize("layout", ["ring", "zigzag"])
@pytest.mark.parametrize("cp", [2, 4])
def test_gloo_ring_equals_the_in_process_ring(tmp_path, cp, layout):
    ranks = run_ranks(ring_worker, cp, (layout, GLOO_CASES, GLOO_S),
                      tmp_path, timeout=60)
    for i, (window, rate) in enumerate(GLOO_CASES):
        ts = ring_inputs(i, GLOO_S)
        if layout == "zigzag":
            ts = [to_zigzag(t, cp) for t in ts]
        want = ring_case(LocalRing(cp), layout, window, rate, *ts)
        got = [np.concatenate([r[i][j] for r in ranks], axis=2)
               for j in range(4)]
        _check_ring(got, want, dict(atol=1e-6, rtol=1e-6))


# --- 4. the zigzag layout ---------------------------------------------------


@pytest.mark.parametrize("cp,axis", [(2, 2), (4, 2), (4, 1)])
def test_zigzag_layout_matches_jax_and_round_trips(cp, axis):
    shape = [2, 3, 2]
    shape.insert(axis, 16)
    x = np.arange(2 * 3 * 16 * 2, dtype=np.float32).reshape(shape)
    got = to_zigzag(torch.from_numpy(x), cp, axis=axis)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_to_zigzag(jnp.asarray(x), cp, axis)))
    np.testing.assert_array_equal(
        from_zigzag(got, cp, axis=axis).numpy(), x)
    np.testing.assert_array_equal(
        from_zigzag(got, cp, axis=axis).numpy(),
        np.asarray(jax_from_zigzag(jnp.asarray(got.numpy()), cp, axis)))
    with pytest.raises(ValueError, match="not divisible by 2\\*cp"):
        to_zigzag(torch.zeros(1, 1, 6, 1), 2)
