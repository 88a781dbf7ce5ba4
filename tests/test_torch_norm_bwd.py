"""Port parity: the RMSNorm and memory_efficient backward of apex_tpu_torch
against apex_tpu.ops.rms_norm / layer_norm.

Same numpy inputs through both packages, rows that are no multiple of 8 or
32; on the CPU the port's autograd Functions run the backward kernel's
plain twin, the JAX side ``jax.grad`` through its Pallas ``_ln_bwd_kernel``
in interpret mode (its ``rms`` and ``from_y`` branches). Tolerances:
fp32 dx atol = rtol = 1e-5 (the same formula, other summation order);
dgamma/dbeta sum every row's product, atol 1e-4 / rtol 1e-5. bf16 x: dx
after float() at atol 2e-2 / rtol 1e-2 (one bf16 ulp near 2-4);
dgamma/dbeta at atol 1e-3 / rtol 1e-4 from the saved x (fp32 sums of
products of the same bf16 values, up to ~55), and at atol 5e-2 / rtol 1e-4
from a bf16 y: an element of y that rounds one ulp apart in the two
forwards moves its term ``dy * (y - b) / w`` by up to |dy| ulp(y) / w,
~0.03 at these values (0.0123 seen).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import layer_norm as jax_layer_norm
from apex_tpu.ops import rms_norm as jax_rms_norm
from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm
from apex_tpu_torch.ops.layer_norm import (layer_norm,
                                           layer_norm_bwd_reference,
                                           rms_norm_fwd_reference)

COLS = 96
ROWS = [7, 37, 300]


def _inputs(rows, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, COLS)) * 2 + 0.5).astype(np.float32)
    w = (rng.random(COLS) + 0.5).astype(np.float32)
    b = rng.standard_normal(COLS).astype(np.float32)
    dy = rng.standard_normal((rows, COLS)).astype(np.float32)
    return x, w, b, dy


def _jax_grads(x, w, b, dy, *, rms, memory_efficient, dtype):
    """``jax.grad`` of ``sum(norm(x) * dy)`` in x (in ``dtype``) and in the
    fp32 weight and bias that are given."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    args = [jnp.asarray(x).astype(jdt)]
    args += [jnp.asarray(a) for a in (w, b) if a is not None]
    cot = jnp.asarray(dy).astype(jdt)

    def f(*a):
        it = iter(a[1:])
        wt = next(it) if w is not None else None
        if rms:
            y = jax_rms_norm(a[0], wt, memory_efficient=memory_efficient)
        else:
            bt = next(it) if b is not None else None
            y = jax_layer_norm(a[0], wt, bt,
                               memory_efficient=memory_efficient)
        return jnp.sum((y * cot).astype(jnp.float32))

    grads = jax.grad(f, argnums=tuple(range(len(args))))(*args)
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(x, w, b, dy, *, rms, memory_efficient, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    params = [torch.from_numpy(a).requires_grad_() for a in (w, b)
              if a is not None]
    it = iter(params)
    wt = next(it) if w is not None else None
    bt = next(it) if b is not None else None
    y = layer_norm(xt, wt, bt, rms=rms, memory_efficient=memory_efficient)
    assert y.dtype == dtype
    y.backward(torch.from_numpy(dy).to(dtype))
    assert xt.grad.dtype == dtype
    return [t.grad.float().numpy() for t in [xt, *params]]


def _check(got, want, dtype, from_y):
    if dtype == torch.float32:
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
        sums = dict(atol=1e-4, rtol=1e-5)
    else:
        np.testing.assert_allclose(got[0], want[0], atol=2e-2, rtol=1e-2)
        sums = dict(atol=5e-2 if from_y else 1e-3, rtol=1e-4)
    assert len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, **sums)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("rows", ROWS)
def test_rms_norm_grads_match_jax(rows, affine, dtype):
    """The RMS branch from the saved x: dx with no c2 term, dgamma with no
    mean, no dbeta."""
    x, w, _, dy = _inputs(rows, seed=20 + rows)
    w = w if affine else None
    kw = dict(rms=True, memory_efficient=False, dtype=dtype)
    _check(_port_grads(x, w, None, dy, **kw),
           _jax_grads(x, w, None, dy, **kw), dtype, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rms,params", [
    (False, "wb"), (False, "w"), (False, ""), (True, "w"), (True, "")])
@pytest.mark.parametrize("rows", ROWS)
def test_memory_efficient_grads_match_jax(rows, rms, params, dtype):
    """The from_y branch: xhat recovered from the saved output as
    ``(y - b) / w`` (``y`` without a weight), LayerNorm with and without
    weight and bias, and RMSNorm."""
    x, w, b, dy = _inputs(rows, seed=40 + rows)
    w = w if "w" in params else None
    b = b if "b" in params else None
    kw = dict(rms=rms, memory_efficient=True, dtype=dtype)
    _check(_port_grads(x, w, b, dy, **kw), _jax_grads(x, w, b, dy, **kw),
           dtype, True)


def test_rms_norm_bwd_twin_dtypes_and_no_affine():
    x, w, _, dy = _inputs(9, seed=5)
    xt, dyt = torch.from_numpy(x).bfloat16(), torch.from_numpy(dy).bfloat16()
    _, mean, rstd = rms_norm_fwd_reference(xt, torch.from_numpy(w))
    assert (mean == 0).all()
    dx, dw, db = layer_norm_bwd_reference(dyt, xt, None, rstd,
                                          torch.from_numpy(w), rms=True)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert dw.shape == (COLS,) and db is None
    xhat = xt.float() * rstd
    torch.testing.assert_close(dw, (dyt.float() * xhat).sum(0))
    dx0, dw0, db0 = layer_norm_bwd_reference(dyt, xt, None, rstd, None,
                                             rms=True)
    assert dw0 is None and db0 is None and dx0.shape == dyt.shape


@pytest.mark.parametrize("memory_efficient", [False, True])
@pytest.mark.parametrize("rms", [False, True])
def test_autograd_backward_calls_the_branch_twin(monkeypatch, rms,
                                                 memory_efficient):
    """On the CPU the Function's backward is the twin, with the flags of
    the branch the kernel would take, not autograd through the forward
    twin; and under ``memory_efficient`` the Function keeps the output, not
    x."""
    mod = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    calls = []
    real = mod.layer_norm_bwd_reference

    def spy(*args, **kw):
        calls.append((args[0].shape, *args[6:8]))
        return real(*args, **kw)

    monkeypatch.setattr(mod, "layer_norm_bwd_reference", spy)
    x, w, b, _ = _inputs(6, seed=6)
    xt = torch.from_numpy(x).reshape(2, 3, COLS).requires_grad_()
    y = layer_norm(xt, torch.from_numpy(w),
                   None if rms else torch.from_numpy(b), rms=rms,
                   memory_efficient=memory_efficient)
    assert "FusedLayerNormFunction" in type(y.grad_fn).__name__
    saved = y.grad_fn.saved_tensors[0]
    want = y if memory_efficient else xt
    assert saved.untyped_storage().data_ptr() == \
        want.untyped_storage().data_ptr()
    y.sum().backward()
    assert calls == [((6, COLS), rms, memory_efficient)]
    assert xt.grad.shape == xt.shape


@pytest.mark.parametrize("cls", [FusedLayerNorm, FusedRMSNorm])
def test_modules_take_memory_efficient(cls):
    """The reference's ``memory_efficient`` field: the same output and
    gradients as the default (fp32, unit weight)."""
    x = torch.from_numpy(_inputs(5, seed=7)[0])
    grads = []
    for me in (False, True):
        mod = cls(COLS, memory_efficient=me)
        assert mod.memory_efficient is me
        xt = x.clone().requires_grad_()
        y = mod(xt)
        y.square().sum().backward()
        grads.append((y.detach(), xt.grad, mod.weight.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)

