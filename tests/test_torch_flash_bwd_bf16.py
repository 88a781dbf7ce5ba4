"""Port parity in bf16: the flash backward's twins against the JAX kernels.

The card holds the bf16 flash backward (``csrc/flash_bwd.cu``, the
tensor-core kernels) to its plain twins at ``chip_smoke.py``'s bars: dq,
dk and dv within ``TOL["bfloat16"]`` (atol 2e-2, rtol 1e-2), the atol cut
to ``RMS_ATOL`` (1e-2) of the twin's RMS on the windowed, bias and ring
rows. Here the same numpy inputs, rounded once to bf16, with an output
cotangent (and an LSE cotangent where the call returns the LSE), go
through ``jax.vjp`` of JAX's ``flash_attention_with_lse`` /
``flash_attention`` in bf16 (its Pallas kernels in interpret mode, as the
JAX package's tests run them) and through the port's autograd in bf16 on
the CPU (the twins), at tiny sizes over every branch of
``test_torch_flash_bf16.py``'s cases. The reference rounds each second
product's A operand once to bf16 (``_dq_kernel``: ``ds.astype(k.dtype)``;
``_dkdv_kernel``: ``p_dropped.astype(do.dtype)``, ``ds.astype(q.dtype)``)
and the twins do not. Every case holds JAX's gradients to the twins'
within ``TOL``. The RMS bar the card puts on the windowed, bias and ring
rows is not one the reference's rounding meets everywhere: on the offset
and dropout-origin cases it moves a few entries of dq and dk, and below
the diagonal of dv, past it (dq up to 1.6e-2 against an atol of 2.8e-3
to 3.6e-3); on the other cases it stays inside. Which gradients leave it
is pinned (``REFERENCE_OFF_RMS_BAR``); that rounding is why the kernels
take P and dS in two parts (last test).

The last test holds the twins against two emulations of the kernels'
operands at one of Mistral-7B's shapes (first rows of 1 x 8 x 512 x 128
over 2 kv heads, causal, and a window of 4 keys): P and dS rounded once to
bf16, as the reference does, leave the RMS bar in dq, dk and dv; P and dS
as two bf16 parts (hi and the rounded remainder lo), as the kernels take
them, stay inside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flash_attention as jax_flash
from apex_tpu.ops import flash_attention_with_lse as jax_flash_lse
from apex_tpu_torch.ops.flash_attention import (Masking, flash_attention,
                                                flash_attention_bwd_reference,
                                                flash_attention_reference,
                                                flash_attention_with_lse)

from test_torch_flash_bf16 import (CASES, RMS_ATOL, TOL, _assert_within,
                                   _bf16_jax, _bf16_torch, _inputs)


def _cotangents(case, seed):
    (_, b, h, _, sq, _, d, *_rest) = case
    rng = np.random.default_rng(seed + 1)
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    dlse = rng.standard_normal((b, h, sq)).astype(np.float32)
    return do, dlse


#: the gradients that the reference (one bf16 rounding of P and dS) moves
#: past the card's RMS bar against the fp32 twins, by case
REFERENCE_OFF_RMS_BAR = {"offset_up": ["dq", "dk"],
                         "offset_below": ["dq", "dk", "dv"],
                         "dropout_origins": ["dq", "dk"]}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_bf16_backward_sits_inside_the_card_bars(case):
    (case_id, b, h, hkv, sq, sk, d, causal, window, off, segs, rate,
     (row0, col0), _, rms_bar) = case
    seed = sq * 7 + sk
    (q, k, v), bias, seg = _inputs(case, seed=seed)
    do, dlse = _cotangents(case, seed)
    kw = dict(causal=causal, window=window, dropout_rate=rate,
              dropout_seed=5)
    qkv_j = tuple(_bf16_jax(a) for a in (q, k, v))
    qkv_t = tuple(_bf16_torch(a).requires_grad_() for a in (q, k, v))
    if bias is None and seg is None:
        lse_kw = dict(kw, causal_offset=off, dropout_row0=row0,
                      dropout_col0=col0)
        _, vjp = jax.vjp(lambda *a: jax_flash_lse(*a, **lse_kw), *qkv_j)
        want = vjp((_bf16_jax(do), jnp.asarray(dlse)))
        o_t, lse_t = flash_attention_with_lse(*qkv_t, **lse_kw)
        got = torch.autograd.grad((o_t, lse_t), qkv_t,
                                  (_bf16_torch(do), torch.from_numpy(dlse)))
    else:
        jb = None if bias is None else _bf16_jax(bias)
        tb = None if bias is None else _bf16_torch(bias)
        js = None if seg is None else jnp.asarray(seg)
        ts = None if seg is None else torch.from_numpy(seg)
        _, vjp = jax.vjp(lambda *a: jax_flash(*a, jb, js, **kw), *qkv_j)
        want = vjp(_bf16_jax(do))
        o_t = flash_attention(*qkv_t, tb, ts, **kw)
        got = torch.autograd.grad(o_t, qkv_t, _bf16_torch(do))
    off_rms = []
    for name, g_j, g_t in zip(("dq", "dk", "dv"), want, got):
        assert g_j.dtype == jnp.bfloat16 and g_t.dtype == torch.bfloat16
        ref = np.asarray(g_j.astype(jnp.float32))
        twin = g_t.float().numpy()
        _assert_within(ref, twin, *TOL, name)
        if rms_bar:
            atol = min(TOL[0], RMS_ATOL * float(np.sqrt(np.mean(twin ** 2))))
            if (np.abs(ref - twin) > atol + TOL[1] * np.abs(twin)).any():
                off_rms.append(name)
    assert off_rms == REFERENCE_OFF_RMS_BAR.get(case_id, [])


def _bf(x):
    return x.bfloat16().float()


def _one_part(x):
    return _bf(x)


def _two_parts(x):
    hi = _bf(x)
    return hi + _bf(x - hi)


@pytest.mark.parametrize("window", [None, 4])
def test_second_products_in_two_bf16_parts_keep_mistral_rows_inside_the_bar(
        window):
    """Why the kernels' second products take P (dv) and dS (dq, dk) as hi +
    lo: at Mistral-7B's d = 128 over GQA 4 the first rows of a causal
    prefill, and every row under a window of 4 keys, see a few keys each,
    and one bf16 rounding of the operand (2^-8 relative) moves dq, dk and
    dv (causal) or dq (window) past the RMS bar of the windowed rows; hi +
    lo keeps each operand to ~2^-16 and all three inside it. The
    products' sums are fp32 in both, as on the tensor cores."""
    rng = np.random.default_rng(0)
    b, h, hkv, s, d = 1, 8, 2, 512, 128
    rep, scale = h // hkv, d ** -0.5

    def draw(*shape):
        return _bf(torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)))

    q, do = draw(b, h, s, d), draw(b, h, s, d)
    k, v = draw(b, hkv, s, d), draw(b, hkv, s, d)
    dlse = torch.from_numpy(rng.standard_normal((b, h, s)).astype(
        np.float32))
    masking = Masking(causal=True, window=window)
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    o, lse = flash_attention_reference(qb, kb, vb, scale=scale,
                                       masking=masking)
    twin = [t.float() for t in flash_attention_bwd_reference(
        qb, kb, vb, o, lse, dob, scale=scale, dlse=dlse, masking=masking)]
    # the recompute, fp32 from the bf16 inputs: P and dS over the visible
    # pairs, K and V repeated over each GQA group
    kf, vf = (t.repeat_interleave(rep, dim=1) for t in (k, v))
    vis = masking.visible(s, s, "cpu")
    p = torch.exp(torch.where(vis, (q @ kf.transpose(-1, -2)) * scale
                              - lse[..., None], float("-inf")))
    delta = (do * o.float()).sum(-1) - dlse
    ds = p * (do @ vf.transpose(-1, -2) - delta[..., None]) * scale

    def per_kv(x):
        return x.reshape(b, hkv, rep, s, d).sum(2)

    def grads(operand):
        return (_bf(operand(ds) @ kf),
                _bf(per_kv(operand(ds).transpose(-1, -2) @ q)),
                _bf(per_kv(operand(p).transpose(-1, -2) @ do)))

    def off_bar(got, want):
        atol = RMS_ATOL * float(want.pow(2).mean().sqrt())
        return bool(((got - want).abs() > atol + TOL[1] * want.abs()).any())

    one = [off_bar(g, w) for g, w in zip(grads(_one_part), twin)]
    two = [off_bar(g, w) for g, w in zip(grads(_two_parts), twin)]
    assert one == ([True, True, True] if window is None
                   else [True, False, False])
    assert two == [False, False, False]
