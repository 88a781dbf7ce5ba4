"""Port parity: apex_tpu_torch LayerNorm forward vs apex_tpu.ops.layer_norm.

Same numpy inputs through both packages; on the CPU the port runs the
kernel's plain twin, the JAX side its Pallas kernel in interpret mode.
Tolerances: fp32 atol = rtol = 1e-5 (same formula, other summation order);
bf16 x compares after float() with atol 2e-2 (one bf16 ulp near 2-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import layer_norm as jax_layer_norm
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.layer_norm import (layer_norm, layer_norm_fwd,
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
