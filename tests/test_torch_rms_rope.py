"""Port parity: RMSNorm and RoPE against apex_tpu's.

``rms_norm`` (the RMS branch of the LayerNorm kernel's twin on the CPU)
against ``apex_tpu.ops.rms_norm`` (its Pallas kernel in interpret mode),
with and without a weight, over 2-D and 3-D inputs, and ``FusedRMSNorm``
against the flax module with the same weight; fp32 atol = rtol = 1e-5.
Both RoPE functions against ``transformer/functional/fused_rope.py``, full
and partial rotary, per-position and per-slot tables; fp32 atol = rtol =
1e-6. (That the RMS path refuses autograd on the card, its backward kernel
not ported, is held by ``tests/test_torch_cuda_kernels.py``, which the GPU
machine can import without JAX.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.normalization import FusedRMSNorm as JaxFusedRMSNorm
from apex_tpu.ops import rms_norm as jax_rms_norm
from apex_tpu.transformer.functional import fused_rope as jax_rope
from apex_tpu_torch.normalization import FusedRMSNorm
from apex_tpu_torch.ops.layer_norm import (layer_norm, rms_norm,
                                           rms_norm_fwd_reference)
from apex_tpu_torch.transformer.functional import (
    fused_apply_rotary_pos_emb, fused_apply_rotary_pos_emb_cached)

TOL = dict(atol=1e-5, rtol=1e-5)


def _x(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)


@pytest.mark.parametrize("shape", [(7, 64), (2, 5, 96)])
@pytest.mark.parametrize("affine", [True, False])
def test_rms_norm_matches_jax(shape, affine):
    x = _x(shape, seed=len(shape))
    w = (np.random.default_rng(1).random(shape[-1]) + 0.5).astype(
        np.float32) if affine else None
    want = np.asarray(jax_rms_norm(
        jnp.asarray(x), None if w is None else jnp.asarray(w), 1e-5))
    got = rms_norm(torch.from_numpy(x),
                   None if w is None else torch.from_numpy(w), 1e-5)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    via_ln = layer_norm(torch.from_numpy(x),
                        None if w is None else torch.from_numpy(w),
                        eps=1e-5, rms=True)
    torch.testing.assert_close(via_ln, got, atol=0, rtol=0)


def test_rms_twin_statistics():
    """mean is exactly 0 and rstd = rsqrt(mean(x^2) + eps), fp32 (rows, 1),
    y in x's dtype."""
    x = torch.from_numpy(_x((6, 32), seed=3)).to(torch.bfloat16)
    y, mean, rstd = rms_norm_fwd_reference(x, None, 1e-6)
    assert y.dtype == torch.bfloat16
    assert mean.shape == rstd.shape == (6, 1) and (mean == 0).all()
    xf = x.float()
    torch.testing.assert_close(
        rstd, torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6))


def test_fused_rms_norm_module_matches_flax():
    x = _x((3, 4, 48), seed=4)
    w = (np.random.default_rng(2).random(48) + 0.5).astype(np.float32)
    jm = JaxFusedRMSNorm(48, eps=1e-6)
    want = np.asarray(jm.apply({"params": {"weight": jnp.asarray(w)}},
                               jnp.asarray(x)))
    tm = FusedRMSNorm(48, eps=1e-6)
    assert tm.weight.dtype == torch.float32 and (tm.weight == 1).all()
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(w))
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert set(tm.state_dict()) == {"weight"}
    bf = FusedRMSNorm(48, param_dtype=torch.bfloat16)
    assert bf.weight.dtype == torch.bfloat16
    with torch.no_grad():
        assert bf(torch.from_numpy(x)).dtype == torch.float32


def test_rms_norm_memory_efficient_raises():
    with pytest.raises(NotImplementedError, match="memory_efficient"):
        rms_norm(torch.ones(2, 8), memory_efficient=True)


@pytest.mark.parametrize("hn2", [16, 8])       # full and partial rotary
def test_rope_matches_jax(hn2):
    rng = np.random.default_rng(hn2)
    t = rng.standard_normal((5, 2, 3, 16)).astype(np.float32)
    freqs = rng.standard_normal((5, 1, 1, hn2)).astype(np.float32)
    want = np.asarray(jax_rope.fused_apply_rotary_pos_emb(
        jnp.asarray(t), jnp.asarray(freqs)))
    got = fused_apply_rotary_pos_emb(torch.from_numpy(t),
                                     torch.from_numpy(freqs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hn2,table_b", [(16, 1), (8, 1), (16, 2)])
def test_rope_cached_matches_jax(hn2, table_b):
    """Cached cos/sin tables, one per position ([sq, 1, 1, hn2]) or one per
    position and slot ([sq, b, 1, hn2], the paged path's layout)."""
    rng = np.random.default_rng(hn2 + table_b)
    t = rng.standard_normal((4, 2, 3, 16)).astype(np.float32)
    ang = rng.standard_normal((4, table_b, 1, hn2)).astype(np.float32)
    cos_, sin_ = np.cos(ang), np.sin(ang)
    want = np.asarray(jax_rope.fused_apply_rotary_pos_emb_cached(
        jnp.asarray(t), jnp.asarray(cos_), jnp.asarray(sin_)))
    got = fused_apply_rotary_pos_emb_cached(
        torch.from_numpy(t), torch.from_numpy(cos_), torch.from_numpy(sin_))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got.numpy()[..., hn2:], t[..., hn2:])
