"""Port parity: apex_tpu_torch's scaled softmax and FusedScaleMaskSoftmax
vs apex_tpu's.

The same numpy scores, masks and cotangents go through the reference's
public functions (its Pallas ``_fwd_kernel`` and ``_bwd_kernel`` in
interpret mode, the gradient through ``jax.vjp``) and the port's twins
through autograd: ``scaled_masked_softmax`` with a full, a padding
``(b, 1, 1, sk)``, a shared ``(1, 1, sq, sk)`` and a cyclic ``mb = 2``
mask over ``b = 3`` (the port matches the reference's ``b % mb``),
``scaled_upper_triang_masked_softmax`` at ``sq != sk`` (the triangle from
the top left), ``scaled_softmax``, a row masked everywhere (uniform
``1 / sk``), and ``FusedScaleMaskSoftmax``'s fused and unfused paths. fp32
within 1e-6 and bf16 within 1e-2 (the reference's own bars,
``tests/test_scaled_softmax.py``); fp16 within 1e-3 (one fp16 ulp of a
probability below 1, both sides rounding the same fp32 value once).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer.enums import AttnMaskType as JaxMaskType
from apex_tpu.transformer.functional import (
    FusedScaleMaskSoftmax as JaxFusedSoftmax)
from apex_tpu_torch.ops import _build
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.functional import (
    FusedScaleMaskSoftmax, ScaledMaskedSoftmax, ScaledSoftmax,
    ScaledUpperTriangMaskedSoftmax)

# the modules (``scaled_softmax`` in either package's ``ops`` is the function)
jss = importlib.import_module("apex_tpu.ops.scaled_softmax")
tss = importlib.import_module("apex_tpu_torch.ops.scaled_softmax")

TOL = {"float32": 1e-6, "bfloat16": 1e-2, "float16": 1e-3}


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _t(a, dtype, grad=False):
    t = torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))
    return t.requires_grad_() if grad else t


def _j(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _f32(t):
    return t.detach().float().numpy()


def _jax_fwd_bwd(fn, x, dy, dtype):
    """y and dx of the reference's ``fn`` at numpy x and cotangent dy."""
    y, vjp = jax.vjp(fn, _j(x, dtype))
    (dx,) = vjp(_j(dy, dtype))
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(dx.astype(jnp.float32)))


def _port_fwd_bwd(fn, x, dy, dtype):
    xt = _t(x, dtype, grad=True)
    y = fn(xt)
    assert y.dtype == xt.dtype
    y.backward(_t(dy, dtype))
    assert xt.grad.dtype == xt.dtype
    return _f32(y), _f32(xt.grad)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32) * 2,
            rng.standard_normal(shape).astype(np.float32), rng)


def _mask(kind, b, sq, sk, rng):
    if kind == "full":
        return rng.random((b, 1, sq, sk)) < 0.3
    if kind == "padding":                    # per-sequence valid lengths
        lengths = rng.integers(1, sk + 1, b)
        lengths[0] = 1                       # all but one token padded
        return (np.arange(sk)[None, :] >= lengths[:, None])[:, None, None]
    if kind == "shared":
        return rng.random((1, 1, sq, sk)) < 0.3
    raise ValueError(kind)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["full", "padding", "shared"])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_scaled_masked_softmax_matches_jax(dtype, kind, scale):
    b, h, sq, sk = 2, 3, 40, 100
    x, dy, rng = _inputs((b, h, sq, sk), seed=sk + len(kind))
    mask = _mask(kind, b, sq, sk, rng)
    want = _jax_fwd_bwd(lambda a: jss.scaled_masked_softmax(
        a, jnp.asarray(mask), scale), x, dy, dtype)
    got = _port_fwd_bwd(lambda a: tss.scaled_masked_softmax(
        a, torch.from_numpy(mask), scale), x, dy, dtype)
    for g, w in zip(got, want):
        _close(g, w, dtype)


def test_mask_batch_block_is_cyclic_as_the_reference():
    """mb = 2 over b = 3: sample 2 takes the mask's block 0 (2 % 2), as
    the reference's index map ``b % mb`` does; the port does not raise."""
    b, h, sq, sk = 3, 2, 8, 24
    x, dy, rng = _inputs((b, h, sq, sk), seed=3)
    mask = rng.random((2, 1, sq, sk)) < 0.4
    want = _jax_fwd_bwd(lambda a: jss.scaled_masked_softmax(
        a, jnp.asarray(mask), 0.7), x, dy, "float32")
    got = _port_fwd_bwd(lambda a: tss.scaled_masked_softmax(
        a, torch.from_numpy(mask), 0.7), x, dy, "float32")
    for g, w in zip(got, want):
        _close(g, w, "float32")
    y2 = tss.scaled_masked_softmax(torch.from_numpy(x[2:]),
                                   torch.from_numpy(mask[:1]), 0.7)
    _close(got[0][2:], _f32(y2), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_row_is_uniform(dtype):
    b, h, sq, sk = 2, 2, 6, 50
    x, dy, rng = _inputs((b, h, sq, sk), seed=5)
    mask = rng.random((b, 1, sq, sk)) < 0.3
    mask[1, 0, 2, :] = True
    want = _jax_fwd_bwd(lambda a: jss.scaled_masked_softmax(
        a, jnp.asarray(mask), 1.0), x, dy, dtype)
    got = _port_fwd_bwd(lambda a: tss.scaled_masked_softmax(
        a, torch.from_numpy(mask), 1.0), x, dy, dtype)
    for g, w in zip(got, want):
        _close(g, w, dtype)
    _close(got[0][1, :, 2], np.full((h, sk), 1.0 / sk), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(33, 33), (20, 33), (33, 20)])
def test_upper_triang_matches_jax_from_the_top_left(dtype, sq, sk):
    x, dy, _ = _inputs((6, sq, sk), seed=sq * sk)
    want = _jax_fwd_bwd(lambda a: jss.scaled_upper_triang_masked_softmax(
        a, 2.0), x, dy, dtype)
    got = _port_fwd_bwd(lambda a: tss.scaled_upper_triang_masked_softmax(
        a, 2.0), x, dy, dtype)
    for g, w in zip(got, want):
        _close(g, w, dtype)
    # row 0 sees column 0 alone, whatever sq and sk
    _close(got[0][:, 0, 0], np.ones(6), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_scaled_softmax_matches_jax(dtype):
    x, dy, _ = _inputs((2, 2, 16, 130), seed=7)
    want = _jax_fwd_bwd(lambda a: jss.scaled_softmax(a, 1.3), x, dy, dtype)
    got = _port_fwd_bwd(lambda a: tss.scaled_softmax(a, 1.3), x, dy, dtype)
    for g, w in zip(got, want):
        _close(g, w, dtype)


def test_integer_mask_masks_where_nonzero():
    x, _, rng = _inputs((2, 2, 8, 40), seed=9)
    mask = (rng.random((2, 1, 8, 40)) < 0.3).astype(np.int32) * 2
    want = jss.scaled_masked_softmax(jnp.asarray(x), jnp.asarray(mask), 1.0)
    got = tss.scaled_masked_softmax(torch.from_numpy(x),
                                    torch.from_numpy(mask), 1.0)
    _close(_f32(got), want, "float32")
    _close(_f32(got), _f32(tss.scaled_masked_softmax(
        torch.from_numpy(x), torch.from_numpy(mask != 0), 1.0)), "float32")


def test_backward_saves_y_in_x_dtype_and_gives_the_mask_no_gradient():
    x, _, rng = _inputs((2, 2, 8, 40), seed=11)
    mask = torch.from_numpy(rng.random((2, 1, 8, 40)) < 0.3)
    xt = _t(x, "bfloat16", grad=True)
    y = tss.scaled_masked_softmax(xt, mask, 0.5)
    (saved,) = y.grad_fn.saved_tensors
    assert saved.dtype == torch.bfloat16 and torch.equal(saved, y)
    assert y.grad_fn.next_functions[1][0] is None


def test_twins_on_the_cpu_launch_no_kernel():
    x, dy, _ = _inputs((2, 2, 8, 40), seed=13)
    before = dict(_build.launches)
    xt = _t(x, "float32", grad=True)
    tss.scaled_upper_triang_masked_softmax(xt[0], 1.0).backward(
        _t(dy[0], "float32"))
    tss.scaled_softmax(xt.detach(), 1.0)
    assert _build.launches == before


def test_shape_errors():
    with pytest.raises(ValueError):
        tss.scaled_softmax(torch.zeros(2, 3, 4), 1.0)
    with pytest.raises(ValueError):
        tss.scaled_upper_triang_masked_softmax(torch.zeros(1, 2, 3, 3), 1.0)


# --- FusedScaleMaskSoftmax ---------------------------------------------------


def _modules(mask_type, dtype, scale, mask_func=None):
    flags = dict(input_in_fp16=dtype == "float16",
                 input_in_bf16=dtype == "bfloat16", scale=scale)
    port = FusedScaleMaskSoftmax(
        attn_mask_type=getattr(AttnMaskType, mask_type),
        mask_func=mask_func and mask_func[0], **flags)
    ref = JaxFusedSoftmax(attn_mask_type=getattr(JaxMaskType, mask_type),
                          mask_func=mask_func and mask_func[1], **flags)
    return port, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_type", ["padding", "causal"])
@pytest.mark.parametrize("scale", [None, 0.5])
def test_fused_module_matches_jax(dtype, mask_type, scale):
    b, h, s = 2, 2, 24
    x, dy, rng = _inputs((b, h, s, s), seed=17)
    mask = _mask("padding", b, s, s, rng)
    port, ref = _modules(mask_type, dtype, scale)
    want = _jax_fwd_bwd(lambda a: ref(a, jnp.asarray(mask)), x, dy, dtype)
    got = _port_fwd_bwd(lambda a: port(a, torch.from_numpy(mask)), x, dy,
                        dtype)
    for g, w in zip(got, want):
        _close(g, w, dtype)


def _jax_fill(x, mask):
    return jnp.where(mask, -30.0, x)


def _torch_fill(x, mask):
    return x.masked_fill(mask, -30.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("mask_type", ["padding", "causal"])
@pytest.mark.parametrize("mask_func", [False, True])
def test_torch_softmax_path_matches_jax(dtype, mask_type, mask_func):
    b, h, s = 2, 3, 16
    x, _, rng = _inputs((b, h, s, s), seed=19)
    mask = rng.random((b, 1, s, s)) < 0.3
    port, ref = _modules(mask_type, dtype, 0.5,
                         (_torch_fill, _jax_fill) if mask_func else None)
    for m in (mask, None):
        want = ref.forward_torch_softmax(
            _j(x, dtype), None if m is None else jnp.asarray(m))
        got = port.forward_torch_softmax(
            _t(x, dtype), None if m is None else torch.from_numpy(m))
        assert got.dtype == getattr(torch, dtype)
        _close(_f32(got), np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("mask_type", ["padding", "causal"])
def test_fused_matches_unfused_in_the_port(mask_type):
    """Megatron's own check: the fused path against the module's torch
    path on the same inputs."""
    x, _, rng = _inputs((2, 2, 24, 24), seed=23)
    mask = torch.from_numpy(_mask("padding", 2, 24, 24, rng))
    m = FusedScaleMaskSoftmax(attn_mask_type=getattr(AttnMaskType,
                                                     mask_type), scale=0.5)
    xt = torch.from_numpy(x)
    _close(_f32(m(xt, mask)), _f32(m.forward_torch_softmax(
        xt, None if mask_type == "causal" else mask)), "float32")


def test_fused_module_dispatch_and_reference_errors():
    with pytest.raises(RuntimeError):
        FusedScaleMaskSoftmax(input_in_fp16=True, input_in_bf16=True)
    with pytest.raises(RuntimeError):
        FusedScaleMaskSoftmax(scale=2.0, softmax_in_fp32=False)
    off = FusedScaleMaskSoftmax(scaled_masked_softmax_fusion=False)
    assert not off.is_kernel_available(None, 1, 1, 8, 8)
    assert FusedScaleMaskSoftmax().is_kernel_available(None, 1, 1, 8, 9999)
    x = torch.from_numpy(_inputs((1, 2, 8, 8), seed=29)[0])
    _close(_f32(off(x)), _f32(off.forward_torch_softmax(x, None)),
           "float32")
    with pytest.raises(AssertionError):
        FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.causal)(
            torch.zeros(1, 2, 8, 9))
    x3 = torch.from_numpy(_inputs((4, 8, 8), seed=31)[0])
    _close(_f32(ScaledUpperTriangMaskedSoftmax.apply(x3, 1.0)),
           np.asarray(jss.scaled_upper_triang_masked_softmax(
               jnp.asarray(x3.numpy()), 1.0)), "float32")
    _close(_f32(ScaledSoftmax.apply(x, 1.0)),
           _f32(ScaledMaskedSoftmax.apply(x, None, 1.0)), "float32")


# --- the forward kernel's path by sk, and its arithmetic emulated ------------

@pytest.mark.parametrize("dtype,pack", [(torch.float32, 4),
                                        (torch.bfloat16, 8),
                                        (torch.float16, 8)])
def test_forward_path_by_sk(dtype, pack):
    """Up to ``SOFTMAX_WARP_COLS`` columns a warp holds the row, its lanes'
    16-byte units covering it (a power of two of them, at most 8); wider
    rows (1025, 8193) take a block each. There is no cap on sk."""
    assert tss.SOFTMAX_WARP_COLS == 1024
    for sk in (1, 31, 32, 33, 256, 257, 512, 1000, 1023, 1024):
        nvec = tss.fwd_path(sk, dtype)
        assert nvec in (1, 2, 4, 8) and 32 * nvec * pack >= sk
        assert nvec == 1 or 32 * nvec // 2 * pack < sk
    assert tss.fwd_path(1024, dtype) == 1024 // (32 * pack)
    for sk in (1025, 2048, 8193, 100000):
        assert tss.fwd_path(sk, dtype) == 0


def _butterfly(vals, op):
    """A warp's xor-shuffle reduction over its 32 lanes' ``vals``: every
    lane ends with the same value, combined in the kernel's order."""
    vals = list(vals)
    for o in (16, 8, 4, 2, 1):
        vals = [op(vals[i], vals[i ^ o]) for i in range(32)]
    assert all(v == vals[0] or (np.isnan(v) and np.isnan(vals[0]))
               for v in vals)
    return vals[0]


def _merge(a, b):
    """The kernel's merge of (max, sum of exp to it) pairs; a side that
    holds no value is (-inf, 0)."""
    (m, s), (m2, s2) = a, b
    mn = np.maximum(m, m2)
    f32 = np.float32
    s = (s if m == mn else s * np.exp(f32(m - mn))) + \
        (s2 if m2 == mn else s2 * np.exp(f32(m2 - mn)))
    return (mn, f32(s))


def _emulated_forward(x, mask, scale, causal, dtype):
    """The forward kernel's fp32 arithmetic on one score tensor: the warp
    path (lane l's units l + 32 j, its sum in unit order, the warp's
    butterfly, exp once an element, one reciprocal a row) or the block
    path (each of 256 threads' units merged online into (max, sum), the
    warps' butterflies, the warps in order, then exp again)."""
    f32 = np.float32
    b, np_, sq, sk = x.shape
    nvec = tss.fwd_path(sk, getattr(torch, dtype))
    pack = 16 // torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    v = _f32(_t(x, dtype)) * f32(scale)
    if mask is not None:
        v = np.where(np.broadcast_to(mask, (mask.shape[0], 1, sq, sk))[
            np.arange(b) % mask.shape[0]], f32(tss.MASK_FILL), v)
    if causal:
        v = np.where(np.arange(sq)[:, None] < np.arange(sk)[None, :],
                     f32(tss.MASK_FILL), v)
    rows = v.reshape(-1, sk)
    out = np.empty_like(rows)
    threads = 32 if nvec else 256
    units = -(-sk // pack)
    for i, row in enumerate(rows):
        lane_units = [[u for u in range(t, units, threads)]
                      for t in range(threads)]
        if nvec:
            m = _butterfly([max([row[u * pack:(u + 1) * pack].max()
                                 for u in us], default=-np.inf)
                            for us in lane_units], max)
            e = np.exp(row - m).astype(f32)
            sums = []
            for us in lane_units:
                s = f32(0)
                for u in us:
                    for val in e[u * pack:(u + 1) * pack]:
                        s = f32(s + val)
                sums.append(s)
            inv = f32(1) / _butterfly(sums, lambda p, q: f32(p + q))
            out[i] = e * inv
            continue
        pairs = []
        for us in lane_units:
            ms = (f32(-np.inf), f32(0))
            for u in us:
                vals = row[u * pack:(u + 1) * pack]
                um = vals.max()
                ms = _merge(ms, (um, np.exp(vals - um).astype(f32).sum(
                    dtype=f32)))
            pairs.append(ms)
        warps = [_butterfly(pairs[w * 32:(w + 1) * 32], _merge)
                 for w in range(8)]
        m, s = warps[0]
        for p in warps[1:]:
            m, s = _merge((m, s), p)
        out[i] = np.exp(row - m).astype(f32) * (f32(1) / s)
    return out.reshape(x.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,masked,causal", [
    ((2, 2, 3, 33), True, False), ((1, 2, 5, 512), False, True),
    ((2, 1, 2, 1025), True, False), ((1, 1, 3, 1040), False, True)])
def test_emulated_forward_matches_jax(shape, masked, causal, dtype):
    """Both paths' arithmetic (a reciprocal of the sum instead of a
    division; the block path's online max and sum, whose threads past the
    row's units hold (-inf, 0)) within the reference's bars of its kernel,
    a row masked everywhere uniform."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((shape[0], 1, 1, shape[3])) < 0.3
        mask[0, 0, 0, :] = True
    got = _emulated_forward(x, mask, 0.5, causal, dtype)
    if causal:
        want = jss.scaled_upper_triang_masked_softmax(
            _j(x.reshape(-1, *shape[2:]), dtype), 0.5).reshape(shape)
    else:
        want = jss.scaled_masked_softmax(
            _j(x, dtype), None if mask is None else jnp.asarray(mask), 0.5)
    got = _f32(torch.from_numpy(got).to(getattr(torch, dtype)))
    _close(got, np.asarray(want.astype(jnp.float32)), dtype)
    if masked:
        np.testing.assert_allclose(got[0, 0], 1.0 / shape[3], rtol=TOL[dtype])
