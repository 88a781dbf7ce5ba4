"""Port parity: the s > 1 query block of paged attention (a speculative
verify chunk, a chunked-prefill piece) against the JAX kernel.

Blocks of ``s`` in {2, 4, page_size} queries per slot at positions
``lengths - s + i``, MHA (rep 1) and GQA (rep 4), with and without a
sliding window, over fp32 pools and over int8 and fp8 pools with
per-(page, kv head) scales. Lengths include 0, ones shorter than ``s``
(whose leading query rows must output exactly 0), page edges and the whole
table. Under a window the table entries wholly below each slot's EARLIEST
query's band are nulled to page 0, as the serving engine drops them. On the
CPU the port runs the kernel's plain twin; the JAX side runs its Pallas
kernel in interpret mode and its jnp reference. fp32, atol = rtol = 1e-5
(both sum the same fp32 products in other orders); the quantized pools'
values reach |x| ~ 3 and their sums are held at 2e-5 (the port's
quantized-pool tests' bound). A poisoned dead page changes nothing, and
``s > page_size`` raises the reference's ``ValueError``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import paged_attention as jax_paged
from apex_tpu.ops.paged_attention import \
    paged_attention_reference as jax_paged_ref
from apex_tpu_torch.ops.paged_attention import (paged_attention,
                                                paged_attention_reference)
from apex_tpu_torch.ops.quant import kv_quantize

D, PS, MAXP, KV = 16, 8, 5, 2
TOL = dict(atol=1e-5, rtol=1e-5)
QUANT_TOL = dict(atol=2e-5, rtol=2e-5)
WINDOW = 10


def _lengths(s):
    return [0, 1, s - 1, s, PS, PS + 1, 2 * PS + 3, MAXP * PS]


def _case(s, rep, window=None, kv_dtype=None, seed=0):
    """q ``(b, rep * KV, s, D)``, a shuffled pool and its block table;
    dead entries (past the length, and under a window wholly below the
    earliest query's band floor ``len - s - window + 1``) hold page 0.
    Returns torch tensors and, for a quantized pool, its scales."""
    rng = np.random.default_rng(seed)
    lengths = _lengths(s)
    b = len(lengths)
    num_pages = 1 + b * MAXP
    q = torch.from_numpy(rng.standard_normal(
        (b, rep * KV, s, D)).astype(np.float32))
    pages = [torch.from_numpy(rng.standard_normal(
        (num_pages, KV, PS, D)).astype(np.float32) * 3) for _ in range(2)]
    scales = None
    if kv_dtype is not None:
        qdt, qmax = {"int8": (torch.int8, 127.0),
                     "fp8": (torch.float8_e4m3fn, 448.0)}[kv_dtype]
        quant = [kv_quantize(p, qdt, qmax, axes=(2, 3)) for p in pages]
        pages = [p for p, _ in quant]
        scales = [sc[:, :, 0, 0].contiguous() for _, sc in quant]
    perm = rng.permutation(num_pages - 1) + 1
    bt = np.zeros((b, MAXP), np.int32)
    for i, n in enumerate(lengths):
        used = -(-n // PS)
        bt[i, :used] = perm[i * MAXP:i * MAXP + used]
        if window is not None:
            bt[i, :max(n - s - window + 1, 0) // PS] = 0
    return (q, pages[0], pages[1], torch.from_numpy(bt),
            torch.tensor(lengths, dtype=torch.int32)), scales


def _jax(t):
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


def _kw(window, scales, to=lambda t: t):
    kw = {} if window is None else dict(window=window)
    if scales is not None:
        kw.update(k_scales=to(scales[0]), v_scales=to(scales[1]))
    return kw


def _check(s, rep, window, kv_dtype, seed):
    args, scales = _case(s, rep, window, kv_dtype, seed)
    got = paged_attention(*args, **_kw(window, scales))
    assert got.shape == args[0].shape
    jargs = [_jax(t) for t in args]
    jkw = _kw(window, scales, _jax)
    tol = TOL if kv_dtype is None else QUANT_TOL
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_paged(*jargs, **jkw)), **tol)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_paged_ref(*jargs, **jkw)),
                               **tol)
    for i, n in enumerate(_lengths(s)):
        if n < s:                        # rows before the sequence start
            assert (got[i, :, :s - n] == 0).all()
            assert (got[i, :, s - n:] != 0).any() or n == 0


@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("s", [2, 4, PS])
def test_block_matches_jax_kernel(s, rep, window):
    _check(s, rep, window, None, seed=10 * s + rep)


@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_block_over_a_quantized_pool_matches_jax_kernel(kv_dtype, rep,
                                                        window):
    _check(4, rep, window, kv_dtype, seed=rep + (window or 0))


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_block_of_a_whole_page_matches_jax_kernel(kv_dtype):
    _check(PS, 4, WINDOW, kv_dtype, seed=3)


@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_block_never_reads_dead_pages(window, kv_dtype):
    """Overwriting every page no slot's block reads (the null page
    included; under a window also the pages wholly below the earliest
    query's band) with large values leaves every output unchanged."""
    s = 4
    args, scales = _case(s, 4, window, kv_dtype, seed=7)
    q, kp, vp, bt, ln = args
    clean = paged_attention(*args, **_kw(window, scales))
    live = {int(p) for p in bt.flatten()} - {0}
    dead = [p for p in range(kp.shape[0]) if p not in live]
    kp2, vp2 = kp.clone(), vp.clone()
    big = 100 if kv_dtype else 1e4
    kp2[dead] = torch.tensor(big).to(kp.dtype)
    vp2[dead] = torch.tensor(-big).to(vp.dtype)
    if scales is not None:
        scales = [sc.clone() for sc in scales]
        for sc in scales:
            sc[dead] = 1e3
    poisoned = paged_attention(q, kp2, vp2, bt, ln, **_kw(window, scales))
    torch.testing.assert_close(poisoned, clean, atol=0, rtol=0)


def test_twin_takes_blocks_as_the_jax_reference():
    """The twin alone against the jnp reference at a ragged GQA shape
    (rep 3, s 5) under a window, fp32."""
    rng = np.random.default_rng(5)
    lengths = [0, 3, 5, 6, 17, 40]
    b, h, s, num_pages = len(lengths), 3 * KV, 5, 1 + len(lengths) * MAXP
    q = rng.standard_normal((b, h, s, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((num_pages, KV, PS, D)).astype(np.float32)
              for _ in range(2))
    bt = (np.arange(b * MAXP, dtype=np.int32).reshape(b, MAXP) + 1)
    ln = np.asarray(lengths, np.int32)
    want = jax_paged_ref(*(jnp.asarray(a) for a in (q, kp, vp, bt, ln)),
                         window=7)
    got = paged_attention_reference(*(torch.from_numpy(a) for a in
                                      (q, kp, vp, bt, ln)), window=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [None, WINDOW])
def test_block_longer_than_a_page_raises(window):
    args, _ = _case(4, 1, window)
    q9 = args[0][:, :, :1].repeat(1, 1, PS + 1, 1)
    with pytest.raises(ValueError, match="1..page_size"):
        jax_paged(*(_jax(t) for t in (q9, *args[1:])),
                  **({} if window is None else dict(window=window)))
    for fn in (paged_attention, paged_attention_reference):
        with pytest.raises(ValueError, match="1..page_size"):
            fn(q9, *args[1:], **({} if window is None
                                 else dict(window=window)))
