"""Port parity: apex_tpu_torch LayerNorm forward and backward vs
apex_tpu.ops.layer_norm.

Same numpy inputs through both packages; on the CPU the port runs the
kernels' plain twins, the JAX side its Pallas kernels in interpret mode
(the backward through ``jax.grad``).
Tolerances: fp32 atol = rtol = 1e-5 (same formula, other summation order);
bf16 x compares after float() with atol 2e-2 (one bf16 ulp near 2-4).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import layer_norm as jax_layer_norm
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.layer_norm import (layer_norm, layer_norm_bwd,
                                           layer_norm_fwd,
                                           layer_norm_fwd_reference)

COLS = 96


def _inputs(rows, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, COLS)) * 2 + 0.5).astype(np.float32)
    w = (rng.random(COLS) + 0.5).astype(np.float32)
    b = rng.standard_normal(COLS).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("rows", [7, 37, 300])
def test_layer_norm_fp32_matches_jax(rows):
    x, w, b = _inputs(rows)
    want = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b)))
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rows", [7, 300])
def test_layer_norm_bf16_x_fp32_params_matches_jax(rows):
    x, w, b = _inputs(rows, seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax_layer_norm(xb, jnp.asarray(w), jnp.asarray(b))
    assert want.dtype == jnp.bfloat16
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    got = layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=0)


def test_layer_norm_without_affine_matches_jax():
    x, _, _ = _inputs(13, seed=2)
    want = np.asarray(jax_layer_norm(jnp.asarray(x)))
    got = layer_norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_layer_norm_fwd_returns_fp32_stats():
    x, w, b = _inputs(5, seed=3)
    xt = torch.from_numpy(x).bfloat16()
    y, mean, rstd = layer_norm_fwd(xt, torch.from_numpy(w),
                                   torch.from_numpy(b))
    assert y.dtype == torch.bfloat16 and y.shape == xt.shape
    assert mean.dtype == rstd.dtype == torch.float32
    assert mean.shape == rstd.shape == (5, 1)
    xf = xt.float()
    torch.testing.assert_close(mean[:, 0], xf.mean(-1))
    torch.testing.assert_close(rstd[:, 0],
                               torch.rsqrt(xf.var(-1, unbiased=False)
                                           + 1e-5))


def test_cpu_tensor_takes_the_twin():
    x, w, b = _inputs(4, seed=4)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    for got, want in zip(layer_norm_fwd(*args),
                         layer_norm_fwd_reference(*args)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_bias_without_weight_raises():
    x, _, b = _inputs(3)
    with pytest.raises(ValueError, match="bias requires weight"):
        layer_norm(torch.from_numpy(x), None, torch.from_numpy(b))


def test_fused_layer_norm_module_keeps_fp32_params_over_bf16_x():
    mod = FusedLayerNorm(COLS)
    assert mod.weight.dtype == mod.bias.dtype == torch.float32
    assert mod.eps == 1e-5
    x = torch.from_numpy(_inputs(6)[0]).bfloat16().reshape(2, 3, COLS)
    y = mod(x)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    ref = layer_norm_fwd_reference(x.reshape(-1, COLS), mod.weight,
                                   mod.bias)[0].reshape(x.shape)
    torch.testing.assert_close(y, ref, atol=0, rtol=0)


# --- backward -------------------------------------------------------------


def _jax_ln_grads(x, w, b, dy):
    import jax

    def f(x_, w_, b_):
        return jnp.sum(jax_layer_norm(x_, w_, b_) * jnp.asarray(dy))

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))]


@pytest.mark.parametrize("rows", [7, 37, 300])
def test_layer_norm_grads_match_jax(rows):
    """dx, dgamma, dbeta through the autograd Function vs ``jax.grad`` of
    the reference (its ``_ln_bwd_kernel`` in interpret mode), at row
    counts that are not multiples of 8. fp32: dx atol = rtol = 1e-5;
    dgamma/dbeta sum ``rows`` products, atol 1e-4."""
    x, w, b = _inputs(rows, seed=10 + rows)
    dy = np.random.default_rng(rows).standard_normal(x.shape).astype(
        np.float32)
    jdx, jdw, jdb = _jax_ln_grads(x, w, b, dy)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    layer_norm(xt, wt, bt).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), jdx, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), jdw, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), jdb, atol=1e-4, rtol=1e-5)


def test_layer_norm_bwd_twin_dtypes_and_no_affine():
    x, w, _ = _inputs(9, seed=5)
    xt = torch.from_numpy(x).bfloat16()
    dy = torch.randn(9, COLS).bfloat16()
    _, mean, rstd = layer_norm_fwd(xt, torch.from_numpy(w))
    dx, dw, db = layer_norm_bwd(dy, xt, mean, rstd, torch.from_numpy(w))
    assert dx.dtype == torch.bfloat16
    assert dw.dtype == db.dtype == torch.float32 and dw.shape == (COLS,)
    torch.testing.assert_close(db, dy.float().sum(0))
    dx0, dw0, db0 = layer_norm_bwd(dy, xt, mean, rstd, None)
    assert dw0 is None and db0 is None and dx0.shape == dy.shape


def test_autograd_backward_calls_the_backward_twin(monkeypatch):
    """On the CPU the Function's backward is ``layer_norm_bwd_reference``,
    not autograd through the forward twin."""
    mod = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    calls = []
    real = mod.layer_norm_bwd_reference

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(mod, "layer_norm_bwd_reference", spy)
    x, w, b = _inputs(6, seed=6)
    xt = torch.from_numpy(x).reshape(2, 3, COLS).requires_grad_()
    y = layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b))
    assert y.grad_fn is not None
    assert "FusedLayerNormFunction" in type(y.grad_fn).__name__
    y.sum().backward()
    assert calls == [(6, COLS)]
    assert xt.grad.shape == xt.shape


def test_fused_layer_norm_module_gets_param_grads_without_bias():
    mod = FusedLayerNorm(COLS)
    x = torch.from_numpy(_inputs(5, seed=7)[0]).requires_grad_()
    mod(x).square().sum().backward()
    assert mod.weight.grad.dtype == torch.float32
    assert torch.isfinite(mod.weight.grad).all()
    assert torch.isfinite(mod.bias.grad).all()
    nb = torch.from_numpy(_inputs(5, seed=8)[1]).requires_grad_()
    layer_norm(x, nb, None).sum().backward()
    assert nb.grad is not None


@pytest.mark.parametrize("kw,match", [
    (dict(memory_efficient=True), "memory_efficient"),
    (dict(rms=True, memory_efficient=True), "RMSNorm"),
])
def test_unported_layer_norm_modes_raise(kw, match):
    x, w, b = _inputs(3)
    with pytest.raises(NotImplementedError, match=match):
        layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), **kw)
