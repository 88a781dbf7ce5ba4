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



# --- the backward kernel's tile plan and summation order ---------------------

LN = importlib.import_module("apex_tpu_torch.ops.layer_norm")


@pytest.mark.parametrize("rows,cols,elt", [
    (77, 4096, 2), (77, 4096, 4), (640, 1024, 2), (640, 1024, 4),
    (4096, 1024, 2), (8192, 768, 2), (8192, 768, 4), (8192, 4096, 2),
    (8192, 4096, 4), (4224, 4096, 2), (1, 768, 2), (7, 1000, 2),
    (7, 1001, 4), (100, 8192, 2), (3, 40000, 4)])
def test_norm_bwd_plan_covers_the_row_and_fills_the_card(rows, cols, elt):
    """Every row's slots are held (team x slots x passes x 16 bytes cover
    the width, at most 2 slots a thread in bf16 and 4 in fp32), teams
    divide the 256-thread block, and the grid spreads the rows: a team for
    every row up to two blocks on each of the 132 SMs (the co-resident
    grid that the one-launch dgamma/dbeta sum needs), on a smaller card
    two blocks on each of its SMs."""
    plan = LN.norm_bwd_plan(rows, cols, elt)
    pack = 16 // elt
    assert plan["team"] in (32, 64, 128, 256)
    assert plan["teams"] * plan["team"] == LN.NORM_BWD_THREADS
    assert 1 <= plan["slots"] <= LN.NORM_BWD_MAX_SLOTS[elt]
    covered = plan["team"] * plan["slots"] * plan["passes"] * pack
    assert covered >= cols
    assert (plan["passes"] - 1) * plan["team"] * plan["slots"] * pack < cols
    units = -(-rows // plan["teams"])
    assert plan["blocks"] == min(units, 2 * 132)
    assert LN.norm_bwd_plan(rows, cols, elt, sms=114)["blocks"] == \
        min(units, 2 * 114)


def test_norm_bwd_plan_at_the_paths_shapes():
    """Mistral's 77 ragged rows spread over 77 blocks, a block a row, in
    one launch; its 8192 training rows, BERT's MLM norm (640 x 1024) and
    GPT-2's rows fill the card; GPT-2's 768 bf16 columns are two warps a
    row, Mistral's 4096 a block; 8192 bf16 columns take two passes."""
    assert LN.norm_bwd_plan(77, 4096, 2) == dict(
        team=256, slots=2, passes=1, teams=1, blocks=77, acc_smem=False)
    assert LN.norm_bwd_plan(8192, 4096, 2)["blocks"] == 264
    assert LN.norm_bwd_plan(640, 1024, 2) == dict(
        team=64, slots=2, passes=1, teams=4, blocks=160, acc_smem=False)
    assert LN.norm_bwd_plan(8192, 768, 2) == dict(
        team=64, slots=2, passes=1, teams=4, blocks=264, acc_smem=False)
    assert LN.norm_bwd_plan(8192, 768, 4) == dict(
        team=64, slots=3, passes=1, teams=4, blocks=264, acc_smem=False)
    assert LN.norm_bwd_plan(100, 8192, 2)["passes"] == 2
    # rows walked in passes keep dgamma/dbeta in shared memory: two blocks
    # an SM at 8192 columns, one at 16384, none past ~28 K columns
    assert LN.norm_bwd_plan(2048, 8192, 2) == dict(
        team=256, slots=2, passes=2, teams=1, blocks=264, acc_smem=True)
    assert LN.norm_bwd_plan(2048, 16384, 4) == dict(
        team=256, slots=2, passes=8, teams=1, blocks=132, acc_smem=True)
    assert LN.norm_bwd_plan(3, 40000, 4)["acc_smem"] is False


def _fma(a, b, c):
    """fp32 fmaf(a, b, c): the exact product and sum, rounded once."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _emulated_kernel_grads(x, w, b, dy, *, rms, memory_efficient, dtype,
                           sms=LN.NORM_BWD_SMS):
    """The backward kernel's arithmetic on the forward twin's saved
    tensors, in fp32 numpy: xhat as the kernel forms it (``(y - b) * (1 /
    w)`` with one correctly rounded reciprocal a column under
    ``memory_efficient``), dx by its formula, and dgamma/dbeta summed in
    the plan's order (on a card of ``sms`` SMs): each team's rows in turn
    by fma, the block's teams in team order, then (behind the grid
    barrier) the blocks' partial rows in 8 warp stripes added in warp
    order."""
    f32 = np.float32
    xt = torch.from_numpy(x).to(dtype)
    wt = torch.from_numpy(w) if w is not None else None
    if rms:
        y, mean, rstd = LN.rms_norm_fwd_reference(xt, wt)
    else:
        y, mean, rstd = LN.layer_norm_fwd_reference(
            xt, wt, torch.from_numpy(b) if b is not None else None)
    src = (y if memory_efficient else xt).float().numpy()
    g = torch.from_numpy(dy).to(dtype).float().numpy()
    rows, cols = src.shape
    rs, mu = rstd.numpy(), mean.numpy()
    if memory_efficient:
        xhat = src
        if w is not None:
            rcp = (1.0 / w.astype(np.float64)).astype(f32)
            xhat = (src - (b if b is not None else f32(0))) * rcp
    else:
        xhat = src * rs if rms else (src - mu) * rs
    wdy = g * (w if w is not None else f32(1))
    inv_cols = f32(1) / f32(cols)
    c1 = (xhat.astype(np.float64) * wdy).sum(1, keepdims=True).astype(f32)
    c2 = f32(0) if rms else wdy.astype(np.float64).sum(
        1, keepdims=True).astype(f32) * inv_cols
    dx = (wdy - xhat * (c1 * inv_cols) - c2) * rs
    dx = torch.from_numpy(dx).to(dtype).float().numpy()
    if w is None:
        return [dx]
    plan = LN.norm_bwd_plan(rows, cols, xt.element_size(), sms=sms)
    blocks, teams = plan["blocks"], plan["teams"]
    n_teams = blocks * teams
    parts = []
    for blk in range(blocks):
        buf = None
        for k in range(teams):
            acc = [np.zeros(cols, f32), np.zeros(cols, f32)]
            for r in range(blk * teams + k, rows, n_teams):
                acc = [_fma(g[r], xhat[r], acc[0]), acc[1] + g[r]]
            buf = acc if buf is None else [buf[0] + acc[0], buf[1] + acc[1]]
        parts.append(buf)
    stripes = []
    for warp in range(8):
        a = [np.zeros(cols, f32), np.zeros(cols, f32)]
        for t in range(warp, blocks, 8):
            a = [a[0] + parts[t][0], a[1] + parts[t][1]]
        stripes.append(a)
    sums = [np.zeros(cols, f32), np.zeros(cols, f32)]
    for a in stripes:
        sums = [sums[0] + a[0], sums[1] + a[1]]
    return [dx, sums[0]] + ([] if rms or b is None and not
                             memory_efficient else [sums[1]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rms,memory_efficient,params", [
    (False, False, "wb"), (True, False, "w"), (False, True, "wb"),
    (True, True, "w"), (False, False, "")])
@pytest.mark.parametrize("sms", [132, 4])
@pytest.mark.parametrize("rows", [37, 300])
def test_emulated_kernel_order_matches_jax(rows, sms, rms, memory_efficient,
                                           params, dtype):
    """The kernel's fixed summation order (a team a row across the card,
    or on a 4-SM card several rows a team) and its division-free xhat
    under ``memory_efficient`` give dx, dgamma and dbeta within this
    file's bars of ``jax.grad`` through the reference's kernel."""
    x, w, b, dy = _inputs(rows, seed=60 + rows)
    w = w if "w" in params else None
    b = b if "b" in params else None
    kw = dict(rms=rms, memory_efficient=memory_efficient, dtype=dtype)
    got = _emulated_kernel_grads(x, w, b, dy, sms=sms, **kw)
    want = _jax_grads(x, w, b, dy, **kw)
    _check(got, want[:len(got)] if w is not None else want[:1], dtype,
           memory_efficient)
