"""Port parity: the quantized KV pool and the quantized branch of paged
attention against apex_tpu's.

int8 and fp8 pools on tiny GPT's shapes (4 kv heads, head_dim 16, page 8):
the same alloc, the same contiguous prefill K/V and the same decode chunk
(numpy from a seed) must leave pages and scales bit-equal to JAX's, across
a page boundary; alloc zeroes the scales of reused pages; an append leaves
full pages bit-stable; the ``paged_attention`` twin over quantized pages
with their scales agrees with JAX's Pallas kernel (interpret mode) and its
reference within 2e-5 (fp32 sums in other orders); the pool sizing pins
match (an int8 page costs 0.502 of a bf16 page at head_dim 64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import generation as jgen
from apex_tpu.models.gpt import gpt_tiny_config as jax_tiny
from apex_tpu.ops import paged_attention as jax_paged
from apex_tpu.ops.paged_attention import \
    paged_attention_reference as jax_paged_ref
from apex_tpu.serving import kv_pool as jpool
from apex_tpu_torch.models import generation as tgen
from apex_tpu_torch.models import gpt2_small_config, gpt_tiny_config
from apex_tpu_torch.ops.paged_attention import (paged_attention,
                                                paged_attention_reference)
from apex_tpu_torch.ops.quant import kv_quantize
from apex_tpu_torch.serving import kv_pool as tpool

PS, KV, D = 8, 4, 16
NAMES = ("k_pages", "v_pages", "k_scales", "v_scales")


def _np(t):
    """A tensor or array as numpy, fp8 as its uint8 bits."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn
                else t).numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _assert_layers_equal(jlayer, tlayer, pages):
    for name in NAMES:
        np.testing.assert_array_equal(_np(tlayer[name])[pages],
                                      _np(jlayer[name])[pages], err_msg=name)


def _pools(kv_dtype, allocs):
    """The same alloc sequence on a JAX and a port pool (12 pages, 2
    slots)."""
    jc = jpool.init_paged_cache(jax_tiny(), num_slots=2, num_pages=12,
                                page_size=PS, kv_dtype=kv_dtype)
    tc = tpool.init_paged_cache(gpt_tiny_config(), 2, num_pages=12,
                                page_size=PS, kv_dtype=kv_dtype, device="cpu")
    for slot, n in allocs:
        jc = jpool.alloc_slot(jc, slot, n)
        tpool.alloc_slot(tc, slot, n)
    return jc, tc


def _contig(rng, n_layers=2, length=3 * PS):
    return [{"k": rng.standard_normal((1, KV, length, D)).astype(np.float32),
             "v": rng.standard_normal((1, KV, length, D)).astype(np.float32)}
            for _ in range(n_layers)]


@pytest.mark.parametrize("kv_dtype,want", [("int8", torch.int8),
                                           ("fp8", torch.float8_e4m3fn)])
def test_init_paged_cache_shapes(kv_dtype, want):
    tc = tpool.init_paged_cache(gpt_tiny_config(), 3, num_pages=10,
                                page_size=PS, kv_dtype=kv_dtype, device="cpu")
    jc = jpool.init_paged_cache(jax_tiny(), num_slots=3, num_pages=10,
                                page_size=PS, kv_dtype=kv_dtype)
    for tl, jl in zip(tc["layers"], jc["layers"]):
        assert set(tl) == set(jl) == set(NAMES)
        assert tl["k_pages"].dtype == tl["v_pages"].dtype == want
        for name in NAMES:
            assert tuple(tl[name].shape) == jl[name].shape
        assert tl["k_scales"].dtype == torch.float32
        assert not tl["k_scales"].any()


def test_init_paged_cache_errors():
    cfg = gpt_tiny_config()
    with pytest.raises(ValueError, match="kv-dtype-conflict"):
        tpool.init_paged_cache(cfg, 2, num_pages=4, kv_dtype="int8",
                               dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="kv-dtype-unsupported"):
        tpool.init_paged_cache(cfg, 2, num_pages=4, kv_dtype="int4",
                               device="cpu")
    unq = tpool.init_paged_cache(cfg, 2, num_pages=4, device="cpu")
    assert "k_scales" not in unq["layers"][0]


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_prefill_and_append_bit_equal_to_jax(kv_dtype):
    """Slot 0: a prefill of 2 full pages and 3 tail tokens, then a 6-token
    chunk across the page boundary; slot 1: a 5-token prefill and the same
    chunk inside its page. Live pages and scales bit-equal to JAX's after
    each write; slot 0's full pages bit-stable under the append."""
    rng = np.random.default_rng(7)
    jc, tc = _pools(kv_dtype, [(0, 4), (1, 2)])
    s0 = 2 * PS + 3
    for slot, n in ((0, s0), (1, 5)):
        contig = _contig(rng)
        jc = jpool.prefill_into_pages(
            jc, slot, [{k: jnp.asarray(v) for k, v in c.items()}
                       for c in contig], n)
        tpool.prefill_into_pages(
            tc, slot, [{k: torch.from_numpy(v) for k, v in c.items()}
                       for c in contig], n)
    live = np.asarray(jc["block_tables"]).ravel()
    live = live[live > 0]
    for jl, tl in zip(jc["layers"], tc["layers"]):
        _assert_layers_equal(jl, tl, live)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))

    row0 = np.asarray(jc["block_tables"][0])
    full_before = _np(tc["layers"][0]["k_pages"])[row0[:2]].copy()
    ck, cv = (rng.standard_normal((2, KV, 6, D)).astype(np.float32)
              for _ in range(2))
    jl = jgen.update_paged_layer_cache(jgen.layer_cache(jc, 0),
                                       jnp.asarray(ck), jnp.asarray(cv))
    tl = tgen.update_paged_layer_cache(tgen.layer_cache(tc, 0),
                                       torch.from_numpy(ck),
                                       torch.from_numpy(cv))
    _assert_layers_equal(jl, tl, live)
    np.testing.assert_array_equal(_np(tl["k_pages"])[row0[:2]], full_before)
    # the append grew the boundary page's scales or kept them
    grown = _np(tl["k_scales"])[row0[2]]
    assert (grown >= _np(tc["layers"][0]["k_scales"])[row0[2]]).all()


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_decode_step_append_matches_jax_on_every_read_value(kv_dtype):
    """The decode step's one-token append (the port's one-round path): slot
    0 mid-page, slot 1 at a page boundary (its token opens a fresh page
    with scale 0), then four more steps. Every position below each slot's
    length and every live page's scales bit-equal to JAX's two-round
    append."""
    rng = np.random.default_rng(11)
    jc, tc = _pools(kv_dtype, [(0, 4), (1, 4)])
    for slot, n in ((0, 2 * PS + 3), (1, 2 * PS)):
        contig = _contig(rng)
        jc = jpool.prefill_into_pages(
            jc, slot, [{k: jnp.asarray(v) for k, v in c.items()}
                       for c in contig], n)
        tpool.prefill_into_pages(
            tc, slot, [{k: torch.from_numpy(v) for k, v in c.items()}
                       for c in contig], n)
    jl, tl = jgen.layer_cache(jc, 0), tgen.layer_cache(tc, 0)
    for _ in range(5):
        ck, cv = (rng.standard_normal((2, KV, 1, D)).astype(np.float32)
                  for _ in range(2))
        jl = jgen.update_paged_layer_cache(jl, jnp.asarray(ck),
                                           jnp.asarray(cv))
        tl = tgen.update_paged_layer_cache(tl, torch.from_numpy(ck),
                                           torch.from_numpy(cv))
        jl = dict(jl, len=jl["len"] + 1)
        tl = dict(tl, len=tl["len"] + 1)
    bt = np.asarray(jc["block_tables"])
    for slot in (0, 1):
        n = int(tl["len"][slot])
        pages = bt[slot, :-(-n // PS)]
        for name in ("k_scales", "v_scales"):
            np.testing.assert_array_equal(_np(tl[name])[pages],
                                          _np(jl[name])[pages])
        for name in ("k_pages", "v_pages"):
            got = _np(tl[name])[pages].transpose(1, 0, 2, 3).reshape(
                KV, -1, D)[:, :n]
            want = _np(jl[name])[pages].transpose(1, 0, 2, 3).reshape(
                KV, -1, D)[:, :n]
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_prefill_error_within_half_a_step(kv_dtype):
    """The reference's bound (tests/test_quantized_kv.py): each prefilled
    value dequantizes within scale/2 + 1e-6 of the K written (int8); e4m3
    keeps 3 mantissa bits, so within 1/16 of |k| plus scale/2."""
    rng = np.random.default_rng(3)
    _, tc = _pools(kv_dtype, [(0, 3)])
    s0 = 2 * PS + 3
    contig = _contig(rng, length=3 * PS)
    tpool.prefill_into_pages(
        tc, 0, [{k: torch.from_numpy(v) for k, v in c.items()}
                for c in contig], s0)
    row = tc["block_tables"][0].long()
    for lc, src in zip(tc["layers"], contig):
        for pg in range(3):
            n = min(s0 - pg * PS, PS)
            sc = lc["k_scales"][row[pg]][:, None, None]
            got = lc["k_pages"][row[pg], :, :n].float() * sc
            want = torch.from_numpy(src["k"][0, :, pg * PS:pg * PS + n])
            bound = sc / 2 + 1e-6
            if kv_dtype == "fp8":
                bound = bound + want.abs() / 16
            assert ((got - want).abs() <= bound).all()


def test_alloc_zeroes_reused_page_scales():
    rng = np.random.default_rng(5)
    _, tc = _pools("int8", [(0, 3)])
    tpool.prefill_into_pages(
        tc, 0, [{k: torch.from_numpy(v) for k, v in c.items()}
                for c in _contig(rng)], 3 * PS)
    pages = tc["block_tables"][0, :3].long()
    assert (tc["layers"][0]["k_scales"][pages] > 0).all()
    tpool.free_slot(tc, 0)
    tpool.alloc_slot(tc, 1, 3)               # the same pages, LIFO
    assert set(tc["block_tables"][1, :3].tolist()) == set(pages.tolist())
    for lc in tc["layers"]:
        assert not lc["k_scales"][pages].any()
        assert not lc["v_scales"][pages].any()


def _quant_case(kv_dtype, lengths, h=4, kv=2, seed=0):
    """A quantized pool made by the port's quantizer from random K/V, with
    per-(page, head) scales, a shuffled block table and dead entries at
    page 0."""
    rng = np.random.default_rng(seed)
    b, maxp = len(lengths), 4
    num_pages = 1 + b * maxp
    q = rng.standard_normal((b, h, 1, D)).astype(np.float32)
    qdt, qmax = {"int8": (torch.int8, 127.0),
                 "fp8": (torch.float8_e4m3fn, 448.0)}[kv_dtype]
    pools = []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal(
            (num_pages, kv, PS, D)).astype(np.float32) * 3)
        pq, sc = kv_quantize(x, qdt, qmax, axes=(2, 3))
        pools += [pq, sc[:, :, 0, 0]]
    perm = rng.permutation(num_pages - 1) + 1
    bt = np.zeros((b, maxp), np.int32)
    for i, n in enumerate(lengths):
        used = -(-n // PS)
        bt[i, :used] = perm[i * maxp:i * maxp + used]
    return (torch.from_numpy(q), pools[0], pools[2], torch.from_numpy(bt),
            torch.tensor(lengths, dtype=torch.int32), pools[1], pools[3])


def _jax(t):
    a = _np(t)
    if isinstance(t, torch.Tensor) and t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(a).view(jnp.float8_e4m3fn)
    return jnp.asarray(a)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("lengths,h,kv", [([0, 1, 8, 9, 32], 4, 4),
                                          ([5, 0, 16, 31, 17], 4, 2)])
def test_quantized_paged_twin_matches_jax(kv_dtype, lengths, h, kv):
    q, kp, vp, bt, ln, ks, vs = _quant_case(kv_dtype, lengths, h, kv,
                                            seed=len(lengths) + kv)
    got = paged_attention(q, kp, vp, bt, ln, k_scales=ks, v_scales=vs)
    args = [_jax(t) for t in (q, kp, vp, bt, ln)]
    jkw = dict(k_scales=_jax(ks), v_scales=_jax(vs))
    for want in (jax_paged(*args, **jkw), jax_paged_ref(*args, **jkw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)
    for i, n in enumerate(lengths):
        if n == 0:
            assert (got[i] == 0).all()
    np.testing.assert_array_equal(
        got.numpy(), paged_attention_reference(
            q, kp, vp, bt, ln, k_scales=ks, v_scales=vs).numpy())


def test_quantized_paged_argument_errors():
    q, kp, vp, bt, ln, ks, vs = _quant_case("int8", [3, 4, 5, 6])
    with pytest.raises(ValueError, match="together"):
        paged_attention(q, kp, vp, bt, ln, k_scales=ks)
    with pytest.raises(ValueError, match="num_pages, kv_heads"):
        paged_attention(q, kp, vp, bt, ln, k_scales=ks[:-1], v_scales=vs)
    with pytest.raises(RuntimeError, match="no backward"):
        paged_attention(q.requires_grad_(), kp, vp, bt, ln, k_scales=ks,
                        v_scales=vs)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_page_bytes_and_slot_capacity_match_jax(kv_dtype):
    from apex_tpu.models.gpt import gpt2_small_config as jax_small

    tcfg = gpt2_small_config(dtype=torch.bfloat16)
    jcfg = jax_small(dtype=jnp.bfloat16)
    assert tpool.page_bytes(tcfg, 16, kv_dtype=kv_dtype) == \
        jpool.page_bytes(jcfg, 16, kv_dtype=kv_dtype)
    budget = 3 * 2 ** 30
    assert tpool.max_slots_for_pool_bytes(
        tcfg, budget, pages_per_slot=64, kv_dtype=kv_dtype) == \
        jpool.max_slots_for_pool_bytes(jcfg, budget, pages_per_slot=64,
                                       kv_dtype=kv_dtype)
    if kv_dtype == "int8":
        ratio = tpool.page_bytes(tcfg, 16, kv_dtype="int8") / \
            tpool.page_bytes(tcfg, 16)
        assert round(ratio, 3) == 0.502
