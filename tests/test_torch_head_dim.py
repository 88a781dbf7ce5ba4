"""Port parity at head dims above 128 (160, 192, 256): flash attention
forward and backward and paged attention against the JAX kernels.

On the CPU the port runs its plain twins; the JAX side runs its Pallas
kernels in interpret mode (which pad d to a multiple of 128, ``_head_pad``)
and ``jax.grad`` through them. Branches as the d <= 128 kernels take them:
causal, non-causal, a window, an additive bias table, segment ids with
dropout, ring attention's ``causal_offset`` with dropout origins; paged s =
1 and s > 1, a window, int8 and fp8 pools. fp32: O within atol = rtol =
1e-5, gradients within 1e-4 (the same fp32 products in other orders),
paged within 1e-5 (2e-5 over a quantized pool). The kernels at these
dims run on the card (``tests/test_torch_cuda_kernels.py``,
``test_wide_*``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flash_attention as jax_flash
from apex_tpu.ops import flash_attention_with_lse as jax_flash_lse
from apex_tpu.ops import paged_attention as jax_paged
from apex_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_with_lse)
from apex_tpu_torch.ops.paged_attention import paged_attention
from apex_tpu_torch.ops.quant import kv_quantize

DIMS = [160, 192, 256]
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
QUANT_TOL = dict(atol=2e-5, rtol=2e-5)

#: (batch, heads, kv heads, Sq, Sk, keywords, bias, segments)
FLASH_BRANCHES = {
    "causal": (2, 2, 1, 12, 12, dict(causal=True), False, False),
    "noncausal": (1, 2, 2, 9, 14, dict(causal=False), False, False),
    "window": (1, 2, 1, 16, 16, dict(causal=True, window=5), False, False),
    "bias": (2, 2, 2, 10, 10, dict(causal=True), True, False),
    "segments_dropout": (2, 2, 1, 12, 12, dict(causal=False,
                                               dropout_rate=0.2,
                                               dropout_seed=5), False, True),
}


def _flash_inputs(branch, d, seed):
    b, h, hkv, sq, sk, kw, with_bias, segs = FLASH_BRANCHES[branch]
    rng = np.random.default_rng(seed + d)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    bias = (rng.standard_normal((1, h, sq, sk)).astype(np.float32)
            if with_bias else None)
    seg = None
    if segs:
        seg = (np.arange(sq)[None, :] < np.array([sq - 4, sq])[:, None]
               ).astype(np.int32)
    return (q, k, v, do, bias, seg), kw


#: every branch at 160 (off a multiple of 16) and 256; two at 192
FLASH_CASES = ([(d, br) for d in (160, 256) for br in FLASH_BRANCHES]
               + [(192, "causal"), (192, "segments_dropout")])


@pytest.mark.parametrize("d,branch", FLASH_CASES)
def test_wide_flash_forward_and_grads_match_jax(d, branch):
    (q, k, v, do, bias, seg), kw = _flash_inputs(branch, d, seed=1)

    def f(q_, k_, v_):
        o = jax_flash(q_, k_, v_, None if bias is None else
                      jnp.asarray(bias),
                      None if seg is None else jnp.asarray(seg), **kw)
        return jnp.sum(o * jnp.asarray(do)), o

    (_, want), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = flash_attention(qt, kt, vt,
                          None if bias is None else torch.from_numpy(bias),
                          None if seg is None else torch.from_numpy(seg),
                          **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(torch.from_numpy(do))
    for t, w in zip((qt, kt, vt), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("d", DIMS)
def test_wide_ring_offset_and_dropout_origins_match_jax(d):
    """A ring step's branch: ``causal_offset`` off the default diagonal and
    the keep mask drawn at global origins, O, LSE and every gradient
    (through both outputs) against the reference's."""
    rng = np.random.default_rng(40 + d)
    q, k, v, do = (rng.standard_normal((1, 2, 8, d)).astype(np.float32)
                   for _ in range(4))
    dl = rng.standard_normal((1, 2, 8)).astype(np.float32)
    kw = dict(causal=True, causal_offset=5, dropout_rate=0.2,
              dropout_seed=3, dropout_row0=16, dropout_col0=8)

    def f(q_, k_, v_):
        o, lse = jax_flash_lse(q_, k_, v_, **kw)
        return (jnp.sum(o * jnp.asarray(do)) + jnp.sum(lse * jnp.asarray(dl)),
                (o, lse))

    (_, (wo, wlse)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = flash_attention_with_lse(qt, kt, vt, **kw)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(wo), **TOL)
    live = np.asarray(wlse) > -1e30
    np.testing.assert_allclose(lse.detach().numpy()[live],
                               np.asarray(wlse)[live], **TOL)
    ((o * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dl)).sum()).backward()
    for t, w in zip((qt, kt, vt), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)


PS, MAXP, KV = 8, 4, 2


def _paged_case(s, rep, d, window, kv_dtype, seed):
    rng = np.random.default_rng(seed)
    lengths = [0, 1, s, PS + 1, 2 * PS + 3, MAXP * PS]
    b, num_pages = len(lengths), 1 + len(lengths) * MAXP
    q = torch.from_numpy(rng.standard_normal(
        (b, rep * KV, s, d)).astype(np.float32))
    pages = [torch.from_numpy(rng.standard_normal(
        (num_pages, KV, PS, d)).astype(np.float32) * 3) for _ in range(2)]
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
        bt[i, :-(-n // PS)] = perm[i * MAXP:i * MAXP - (-n // PS)]
        if window is not None:
            bt[i, :max(n - s - window + 1, 0) // PS] = 0
    return (q, pages[0], pages[1], torch.from_numpy(bt),
            torch.tensor(lengths, dtype=torch.int32)), scales


def _jax(t):
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("branch", ["fp", "window", "int8", "fp8"])
@pytest.mark.parametrize("s,rep", [(1, 2), (4, 1)])
@pytest.mark.parametrize("d", DIMS)
def test_wide_paged_matches_jax_kernel(branch, s, rep, d):
    window = 6 if branch == "window" else None
    kv_dtype = branch if branch in ("int8", "fp8") else None
    args, scales = _paged_case(s, rep, d, window, kv_dtype, seed=d + s)
    kw = {} if window is None else dict(window=window)
    jkw = dict(kw)
    if scales is not None:
        kw.update(k_scales=scales[0], v_scales=scales[1])
        jkw.update(k_scales=_jax(scales[0]), v_scales=_jax(scales[1]))
    got = paged_attention(*args, **kw)
    want = jax_paged(*(_jax(t) for t in args), **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(TOL if kv_dtype is None else QUANT_TOL))
