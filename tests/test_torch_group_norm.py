"""Port parity: apex_tpu_torch's NHWC GroupNorm and the contrib ``GroupNorm``
module vs apex_tpu's.

The same numpy inputs, weights and cotangents go through the reference's
``group_norm_nhwc`` (its Pallas forward and backward kernels in interpret
mode where it runs them, ``cg % 128 == 0``; its jnp formula elsewhere; the
gradients through ``jax.vjp``) and the port's twins through autograd, at
the reference's kernel route ``(2, 4, 4, 256)``, ``g = 2``, its jnp route
``(2, 3, 5, 24)``, ``g = 4``, and a Stable-Diffusion-like ``(2, 8, 8,
320)``, ``g = 32`` (``cg = 10``), with and without SiLU and the affine
transform. fp32 forward within 1e-5 and the three gradients within 2e-4,
the reference's own bars (``tests/test_contrib_tail.py``); bf16 within one
bf16 ulp (1e-2 relative and absolute, 2e-2 for dx, whose two slab sums are
taken in fp32 in another order on each side). The port's twin takes the
two-pass variance at every shape; the reference's kernel takes
``E[x^2] - mean^2``: they agree within fp32 rounding on inputs of mean 0.3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.group_norm import GroupNorm as JaxGroupNorm
from apex_tpu.ops.group_norm import group_norm_nhwc as jax_group_norm
from apex_tpu.ops.group_norm import group_norm_reference as jax_reference
from apex_tpu_torch.bridge import group_norm_params_from_flax
from apex_tpu_torch.contrib.group_norm import GroupNorm
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops.group_norm import (group_norm_bwd_reference,
                                           group_norm_fwd_reference,
                                           group_norm_nhwc,
                                           group_norm_reference)

SHAPES = [((2, 4, 4, 256), 2), ((2, 3, 5, 24), 4), ((2, 8, 8, 320), 32)]
SHAPE_IDS = ["kernel_route", "jnp_route", "sd_cg10"]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) + 0.3).astype(np.float32)
    w = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, w, b, dy


def _jax(x, w, b, dy, g, eps, act, affine, dtype=jnp.float32):
    xj = jnp.asarray(x).astype(dtype)
    dyj = jnp.asarray(dy).astype(dtype)
    if affine:
        y, vjp = jax.vjp(lambda a, wv, bv: jax_group_norm(a, wv, bv, g, eps,
                                                          act),
                         xj, jnp.asarray(w), jnp.asarray(b))
        grads = vjp(dyj)
    else:
        y, vjp = jax.vjp(lambda a: jax_group_norm(a, None, None, g, eps, act),
                         xj)
        grads = vjp(dyj)
    return [np.asarray(t.astype(jnp.float32)) for t in (y, *grads)]


def _port(x, w, b, dy, g, eps, act, affine, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_() if affine else None
    bt = torch.from_numpy(b).requires_grad_() if affine else None
    y = group_norm_nhwc(xt, wt, bt, g, eps, act)
    assert y.dtype == dtype and y.shape == xt.shape
    y.backward(torch.from_numpy(dy).to(dtype))
    return [t.detach().float().numpy() for t in
            (y, xt.grad, *((wt.grad, bt.grad) if affine else ()))]


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape,groups", SHAPES, ids=SHAPE_IDS)
def test_group_norm_nhwc_matches_jax(shape, groups, affine, act):
    x, w, b, dy = _inputs(shape, seed=shape[-1] + groups)
    want = _jax(x, w, b, dy, groups, 1e-5, act, affine)
    got = _port(x, w, b, dy, groups, 1e-5, act, affine)
    _close(got[0], want[0], 1e-5)
    for g_, w_ in zip(got[1:], want[1:]):
        _close(g_, w_, 2e-4)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,groups", [SHAPES[0], SHAPES[2]],
                         ids=[SHAPE_IDS[0], SHAPE_IDS[2]])
def test_group_norm_nhwc_bf16_matches_jax(shape, groups, act):
    x, w, b, dy = _inputs(shape, seed=7)
    want = _jax(x, w, b, dy, groups, 1e-6, act, True, jnp.bfloat16)
    got = _port(x, w, b, dy, groups, 1e-6, act, True, torch.bfloat16)
    _close(got[0], want[0], 1e-2)
    _close(got[1], want[1], 2e-2)
    for g_, w_ in zip(got[2:], want[2:]):       # fp32 sums of bf16 terms
        np.testing.assert_allclose(g_, w_, rtol=1e-2,
                                   atol=1e-2 * np.abs(w_).max())


@pytest.mark.parametrize("act", [None, "silu"])
def test_forward_twin_is_the_reference_formula(act):
    x, w, b, _ = _inputs((2, 3, 5, 24), seed=3)
    y, mean, rstd = group_norm_fwd_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 4,
        1e-5, act)
    _close(y.numpy(), np.asarray(jax_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 4, 1e-5, act)), 1e-6)
    assert mean.shape == rstd.shape == (2, 4)
    assert mean.dtype == rstd.dtype == torch.float32
    slabs = x.reshape(2, 15, 4, 6)
    _close(mean.numpy(), slabs.mean(axis=(1, 3)), 1e-6)
    _close(rstd.numpy(), 1 / np.sqrt(slabs.var(axis=(1, 3)) + 1e-5), 1e-5)
    assert torch.equal(group_norm_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 4,
        1e-5, act), y)


def test_backward_twin_takes_the_saved_statistics():
    """dx from the saved statistics: statistics moved off the data's move
    dx, so the twin reads them rather than recomputing."""
    x, w, b, dy = _inputs((2, 3, 5, 24), seed=5)
    args = [torch.from_numpy(a) for a in (x, dy, w, b)]
    _, mean, rstd = group_norm_fwd_reference(args[0], args[2], args[3], 4)
    dx, dw, db = group_norm_bwd_reference(*args, mean, rstd, 4, "silu")
    dx2 = group_norm_bwd_reference(*args, mean + 0.1, rstd, 4, "silu")[0]
    assert dx.dtype == torch.float32 and dw.shape == db.shape == (24,)
    assert not torch.allclose(dx, dx2)


def test_twins_on_the_cpu_launch_no_kernel():
    x, w, b, dy = _inputs((2, 3, 5, 24), seed=9)
    before = dict(_build.launches)
    _port(x, w, b, dy, 4, 1e-5, "silu", True)
    assert _build.launches == before


def test_argument_errors():
    x = torch.zeros(2, 3, 5, 24)
    with pytest.raises(ValueError, match="act"):
        group_norm_nhwc(x, None, None, 4, 1e-5, "gelu")
    with pytest.raises(ValueError, match="divisible"):
        group_norm_nhwc(x, None, None, 5)
    with pytest.raises(ValueError):
        group_norm_nhwc(x[0], None, None, 4)
    with pytest.raises(ValueError):
        group_norm_nhwc(x, torch.ones(24), None, 4)
    with pytest.raises(ValueError):
        group_norm_nhwc(x, torch.ones(12), torch.zeros(12), 4)
    y = group_norm_nhwc(x + torch.arange(24.0), None, None, 4, 1e-5, "")
    assert torch.isfinite(y).all()


# --- the GroupNorm module ----------------------------------------------------


def _module_case(act, affine, seed=11):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 6, 6, 64)) + 0.3).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    ref = JaxGroupNorm(num_groups=8, num_channels=64, act=act, affine=affine)
    variables = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0),
                                                  jnp.asarray(x)))
    if affine:                                 # away from ones and zeros
        variables = {"params": {
            "weight": (rng.standard_normal(64) * 0.1 + 1).astype(np.float32),
            "bias": (rng.standard_normal(64) * 0.1).astype(np.float32)}}
    return x, dy, ref, variables


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("affine", [True, False])
def test_module_bridged_matches_jax(act, affine):
    x, dy, ref, variables = _module_case(act, affine)

    def f(params, a):
        return ref.apply({"params": params}, a) if affine else ref.apply(
            {}, a)

    y, vjp = jax.vjp(f, variables.get("params", {}), jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(dy))

    gn = GroupNorm(8, 64, act=act, affine=affine, device="cpu")
    gn.load_state_dict(group_norm_params_from_flax(variables))
    # NCHW in channels_last memory: the NHWC bytes
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    assert xt.is_contiguous(memory_format=torch.channels_last)
    out = gn(xt)
    assert out.shape == (2, 64, 6, 6)
    assert out.is_contiguous(memory_format=torch.channels_last)
    out.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    _close(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y), 1e-5)
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(dx), 2e-4)
    if affine:
        _close(gn.weight.grad.numpy(), np.asarray(dparams["weight"]), 2e-4)
        _close(gn.bias.grad.numpy(), np.asarray(dparams["bias"]), 2e-4)
        assert gn.weight.dtype == gn.bias.dtype == torch.float32
    else:
        assert list(gn.parameters()) == []


def test_module_converts_other_layouts_and_keeps_reference_init():
    x, _, _, _ = _module_case("silu", True)
    gn = GroupNorm(8, 64, act="silu", device="cpu")
    assert torch.equal(gn.weight, torch.ones(64))
    assert torch.equal(gn.bias, torch.zeros(64))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    torch.testing.assert_close(gn(nchw.contiguous()), gn(nchw), rtol=0,
                               atol=0)


def test_module_and_bridge_errors():
    gn = GroupNorm(8, 64, device="cpu")
    with pytest.raises(ValueError):
        gn(torch.zeros(2, 6, 6, 64))          # NHWC-shaped: channels at 3
    with pytest.raises(ValueError):
        gn(torch.zeros(2, 64, 6))
    with pytest.raises(ValueError):
        GroupNorm(8, 64, act="relu", device="cpu")(torch.zeros(1, 64, 2, 2))
    ok = {"params": {"weight": np.ones(64, np.float32),
                     "bias": np.zeros(64, np.float32)}}
    assert set(group_norm_params_from_flax(ok)) == {"weight", "bias"}
    with pytest.raises(KeyError):
        group_norm_params_from_flax({"params": {**ok["params"],
                                                "scale": np.ones(64)}})
    with pytest.raises(KeyError):
        group_norm_params_from_flax({**ok, "batch_stats": {}})
