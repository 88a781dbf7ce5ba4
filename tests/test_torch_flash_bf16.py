"""Port parity in bf16: the flash forward's twin against the JAX kernel.

The card holds the bf16 flash forward (``csrc/flash_fwd.cu``, the
tensor-core kernel) to its plain twin at ``chip_smoke.py``'s bars: O within
``TOL["bfloat16"]`` (atol 2e-2, rtol 1e-2), the atol cut to ``RMS_ATOL``
(1e-2) of the twin's RMS on the windowed, bias and ring rows, the LSE within
fp32's 1e-4. Here the same numpy inputs, rounded once to bf16, go through
JAX's ``flash_attention_with_lse`` / ``flash_attention`` in bf16 (its
Pallas kernels in interpret mode, as the JAX package's tests run them) and
the port's twin in bf16 on the CPU, at tiny sizes over every branch the
kernel takes: causal or not, ragged Sq and Sk, d 16-80, GQA, segment ids
with dropout, a window, the bias (a broadcast table and a full one), a
causal offset up, half-way and below the diagonal, dropout origins. The
reference rounds P to bf16 before its PV product (``_fwd_kernel``:
``p.astype(v.dtype)``) and the twin does not, so this holds that rounding
inside the bars at these sizes. The LSE is compared on the rows that see
a key (JAX gives the others -inf or its mask value, the port the mask
value).

The last test holds the twin against two emulations of the kernel's PV
operand at one of Mistral-7B's prefill shapes (first rows of 1 x 8 x 512
x 128, causal): P rounded once to bf16, as the reference does, leaves the
RMS bar; P as two bf16 parts (hi and the rounded remainder lo), as the
kernel does, stays inside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flash_attention as jax_flash
from apex_tpu.ops import flash_attention_with_lse as jax_flash_lse
from apex_tpu_torch.ops.flash_attention import (DEFAULT_MASK_VALUE,
                                                flash_attention,
                                                flash_attention_with_lse)

TOL = (2e-2, 1e-2)           # chip_smoke.TOL["bfloat16"]
LSE_TOL = (1e-4, 1e-4)       # chip_smoke.TOL["float32"]
RMS_ATOL = 1e-2              # chip_smoke.RMS_ATOL

#: (id, b, h, hkv, sq, sk, d, causal, window, offset, segments, rate,
#: (row0, col0), bias kind, RMS bar)
CASES = [
    ("causal_ragged", 1, 2, 2, 33, 33, 32, True, None, None, False, 0.0,
     (0, 0), None, False),
    ("decode_cross", 2, 2, 2, 1, 65, 64, False, None, None, False, 0.0,
     (0, 0), None, False),
    ("noncausal_d80", 1, 2, 2, 65, 33, 80, False, None, None, False, 0.0,
     (0, 0), None, False),
    ("causal_q_shorter", 1, 2, 2, 20, 70, 16, True, None, None, False, 0.0,
     (0, 0), None, False),
    ("gqa", 1, 8, 2, 65, 65, 16, True, None, None, False, 0.0, (0, 0), None,
     False),
    ("segments_dropout", 2, 2, 2, 48, 48, 16, False, None, None, True, 0.1,
     (0, 0), None, False),
    ("window", 1, 4, 2, 72, 72, 16, True, 20, None, False, 0.0, (0, 0), None,
     True),
    ("bias_table", 2, 2, 2, 33, 33, 16, False, None, None, False, 0.0,
     (0, 0), "table", True),
    ("bias_full_causal", 2, 2, 2, 24, 40, 16, True, None, None, False, 0.0,
     (0, 0), "full", True),
    ("offset_up", 1, 4, 2, 32, 32, 16, True, 32, 32, False, 0.0, (0, 0),
     None, True),
    ("offset_half", 1, 4, 2, 32, 32, 16, True, 32, 16, False, 0.0, (0, 0),
     None, True),
    ("offset_below", 1, 4, 2, 32, 32, 16, True, 32, -8, False, 0.0, (0, 0),
     None, True),
    ("dropout_origins", 2, 2, 2, 32, 32, 16, True, None, None, False, 0.1,
     (96, 96), None, True),
]


def _inputs(case, seed):
    (_, b, h, hkv, sq, sk, d, causal, window, off, segs, rate, (row0, col0),
     bias_kind, _) = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    bias = None
    if bias_kind == "table":
        bias = rng.standard_normal((1, h, sq, sk)).astype(np.float32)
    elif bias_kind == "full":
        bias = rng.standard_normal((b, h, sq, sk)).astype(np.float32)
    seg = None
    if segs:
        seg = (np.arange(sq)[None, :] < np.array([sq, sq - 11])[:, None])
        seg = seg.astype(np.int32)
    return (q, k, v), bias, seg


def _bf16_jax(a):
    return jnp.asarray(a, dtype=jnp.bfloat16)


def _bf16_torch(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _assert_within(got, want, atol, rtol, what):
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    assert not bad.any(), (f"{what}: {int(bad.sum())} entries off, max "
                           f"|err| {err.max():.3e} (atol {atol}, rtol "
                           f"{rtol})")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_bf16_rounding_sits_inside_the_card_bars(case):
    (_, b, h, hkv, sq, sk, d, causal, window, off, segs, rate, (row0, col0),
     _, rms_bar) = case
    (q, k, v), bias, seg = _inputs(case, seed=sq * 7 + sk)
    kw = dict(causal=causal, window=window, dropout_rate=rate,
              dropout_seed=5)
    want_lse = got_lse = None
    if bias is None and seg is None:
        lse_kw = dict(kw, causal_offset=off, dropout_row0=row0,
                      dropout_col0=col0)
        o_j, lse_j = jax_flash_lse(*(_bf16_jax(a) for a in (q, k, v)),
                                   **lse_kw)
        o_t, lse_t = flash_attention_with_lse(
            *(_bf16_torch(a) for a in (q, k, v)), **lse_kw)
        got_lse, want_lse = np.asarray(lse_j), lse_t.numpy()
    else:
        jb = None if bias is None else _bf16_jax(bias)
        tb = None if bias is None else _bf16_torch(bias)
        js = None if seg is None else jnp.asarray(seg)
        ts = None if seg is None else torch.from_numpy(seg)
        o_j = jax_flash(*(_bf16_jax(a) for a in (q, k, v)), jb, js, **kw)
        o_t = flash_attention(*(_bf16_torch(a) for a in (q, k, v)), tb, ts,
                              **kw)
    assert o_j.dtype == jnp.bfloat16 and o_t.dtype == torch.bfloat16
    got = np.asarray(o_j.astype(jnp.float32))
    want = o_t.float().numpy()
    atol, rtol = TOL
    if rms_bar:
        atol = min(atol, RMS_ATOL * float(np.sqrt(np.mean(want ** 2))))
    _assert_within(got, want, atol, rtol, "O")
    if want_lse is not None:
        live = want_lse != np.float32(DEFAULT_MASK_VALUE)
        assert live.any()
        _assert_within(got_lse[live], want_lse[live], *LSE_TOL, "LSE")


def test_pv_operand_in_two_bf16_parts_keeps_mistral_rows_inside_the_bar():
    """Why the kernel's PV operand is P = hi + lo: at Mistral-7B's d = 128
    the first rows of a causal prefill see a few keys each, with weights
    near 1/n, and one bf16 rounding of P (2^-8 relative) moves O by up to
    two bf16 ulps against the twin, past the RMS bar of the windowed rows;
    hi + lo keeps P to ~2^-16 and O inside the bar."""
    rng = np.random.default_rng(0)
    h, s, d = 8, 512, 128
    q, k, v = (_bf16_torch(rng.standard_normal((1, h, s, d)).astype(
        np.float32)).float() for _ in range(3))
    twin, _ = flash_attention_with_lse(*(t.bfloat16() for t in (q, k, v)),
                                       causal=True)
    twin = twin.float()
    scores = (q @ k.transpose(-1, -2)) * d ** -0.5
    scores = scores.masked_fill(~torch.ones(s, s).tril().bool(),
                                float("-inf"))
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True)
    hi = e.bfloat16().float()
    lo = (e - hi).bfloat16().float()
    one_part = ((hi @ v) / l).bfloat16().float()
    two_parts = ((hi @ v + lo @ v) / l).bfloat16().float()
    atol = RMS_ATOL * float(twin.pow(2).mean().sqrt())
    bar = atol + TOL[1] * twin.abs()
    assert ((one_part - twin).abs() > bar).any()
    assert not ((two_parts - twin).abs() > bar).any()
