"""The LayerNorm/RMSNorm forward kernel's tile plan and summation order.

``csrc/layer_norm_fwd.cu`` cannot run here (no card), so its arithmetic is
pinned twice on the CPU: ``norm_fwd_plan`` (a team of threads a row, the
16-byte slots each thread holds, the passes over a wide row) must cover
every column of every width exactly once and depend on the width alone,
and a numpy emulation of the kernel's fp32 order (each thread's values in
slot order, the warp's xor butterfly, the team's warps in warp order; the
mean, then the centred variance from the same values) must match
``apex_tpu.ops.layer_norm``'s forward through its Pallas kernel in
interpret mode at ``tests/test_torch_layer_norm.py``'s tolerances: fp32
atol = rtol = 1e-5, bf16 x atol 2e-2 on y.
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

LN = importlib.import_module("apex_tpu_torch.ops.layer_norm")
JAX_LN = importlib.import_module("apex_tpu.ops.layer_norm")

ELTS = (2, 4)


def _plan_columns(cols: int, elt: int) -> np.ndarray:
    """The column of every (thread, pass, slot, element) position of the
    plan, ``[team, passes * slots * pack]`` in each thread's order."""
    plan = LN.norm_fwd_plan(cols, elt)
    ts, nv, passes, pack = (plan["team"], plan["slots"], plan["passes"],
                            16 // elt)
    p, j, tt, e = np.meshgrid(np.arange(passes), np.arange(nv),
                              np.arange(ts), np.arange(pack), indexing="ij")
    col = ((p * nv + j) * ts + tt) * pack + e
    return col.transpose(2, 0, 1, 3).reshape(ts, -1)


def test_norm_fwd_plan_depends_on_the_width_alone():
    """No row count reaches the plan, so a row's tiling (and its bits) is
    the same alone, in a decode step's batch or in a prefill's."""
    assert list(inspect.signature(LN.norm_fwd_plan).parameters) == [
        "cols", "elt"]


@pytest.mark.parametrize("elt", ELTS)
def test_norm_fwd_plan_covers_every_column_once_at_every_width(elt):
    """Widths 1-40000: the team is a power of two from 32 to 256, a
    thread holds 1 to ``NORM_FWD_MAX_SLOTS`` slots (``NORM_FWD_SLOTS`` a
    pass when the row is walked in passes, by a team of 256), the slots
    cover the row, no pass is empty, and a team below 256 holds at most
    ``NORM_FWD_SLOTS``; each width's positions enumerated at every width
    up to 2048 and at every 97th past it: every column exactly once."""
    pack, want = 16 // elt, LN.NORM_FWD_SLOTS[elt]
    for cols in range(1, 40001):
        plan = LN.norm_fwd_plan(cols, elt)
        ts, nv, passes = plan["team"], plan["slots"], plan["passes"]
        n_slots = -(-cols // pack)
        assert ts in (32, 64, 128, 256)
        assert 1 <= nv <= LN.NORM_FWD_MAX_SLOTS[elt]
        assert passes * nv * ts >= n_slots
        assert (passes - 1) * nv * ts < n_slots
        if passes > 1:
            assert (ts, nv) == (256, want)
        if ts < 256:
            assert nv <= want
        if ts > 32:
            assert (ts // 2) * want < n_slots
        if cols <= 2048 or cols % 97 == 0 or cols == 40000:
            col = _plan_columns(cols, elt)
            got = np.sort(col[col < cols])
            np.testing.assert_array_equal(got, np.arange(cols))


def test_norm_fwd_plan_at_the_paths_shapes():
    """A warp a row at T5's 512, GPT-2's 768 and BERT's 1024 columns (both
    dtypes), 128 threads at Mistral's 4096, a block at 8192; bf16 holds up
    to 16384 columns in registers, fp32 8192; wider rows take passes."""
    for cols, elt, plan in [
            (512, 2, (32, 2, 1)), (512, 4, (32, 4, 1)),
            (768, 2, (32, 3, 1)), (768, 4, (32, 6, 1)),
            (1024, 2, (32, 4, 1)), (1024, 4, (32, 8, 1)),
            (4096, 2, (128, 4, 1)), (4096, 4, (128, 8, 1)),
            (4097, 2, (256, 3, 1)), (8192, 2, (256, 4, 1)),
            (8192, 4, (256, 8, 1)), (16384, 2, (256, 8, 1)),
            (16384, 4, (256, 8, 2)), (16385, 2, (256, 4, 3)),
            (40000, 2, (256, 4, 5)), (40000, 4, (256, 8, 5))]:
        assert LN.norm_fwd_plan(cols, elt) == dict(
            zip(("team", "slots", "passes"), plan)), (cols, elt)


@pytest.mark.parametrize("cols,dtype,offset,vec", [
    (768, torch.bfloat16, 0, 1), (768, torch.float32, 0, 1),
    (1000, torch.bfloat16, 0, 1), (1002, torch.bfloat16, 0, 0),
    (1002, torch.float32, 0, 0), (768, torch.bfloat16, 1, 0),
    (4096, torch.float32, 1, 0), (40000, torch.bfloat16, 0, 1)])
def test_wrapper_passes_the_plan_and_element_loads(monkeypatch, cols, dtype,
                                                   offset, vec):
    """The wrapper hands the C entry point the plan of the row's width and
    element size, and asks for element loads (``vec`` 0) where a row is no
    whole 16-byte slots or x is a view off a 16-byte boundary."""
    calls = []
    monkeypatch.setattr(LN._build, "launch",
                        lambda name, sym, types, *args: calls.append(
                            (name, args)))
    monkeypatch.setattr(LN._build, "check_cuda", lambda *t: None)
    monkeypatch.setattr(LN._build, "stream_of", lambda t: 0)
    monkeypatch.setattr(LN, "_sm_count", lambda device: 132)
    flat = torch.zeros(3 * cols + offset, dtype=dtype)
    x = flat[offset:].view(3, cols)
    w, b = torch.ones(cols), torch.zeros(cols)
    for rms in (False, True):
        LN._norm_fwd_kernel("rms_norm_fwd" if rms else "layer_norm_fwd", x,
                            w, None if rms else b, 1e-5, rms)
    plan = LN.norm_fwd_plan(cols, x.element_size())
    for (name, args), rms in zip(calls, (False, True)):
        assert name == ("rms_norm_fwd" if rms else "layer_norm_fwd")
        assert args[6:8] == (3, cols) and args[9] == int(rms)
        assert args[11:17] == (plan["team"], plan["slots"], plan["passes"],
                               1, 1, vec)


def test_grid_spreads_few_rows_and_fills_blocks_with_many():
    """A decode step's 8 rows take 8 blocks (8 SMs), MLM's 640 rows of a
    warp 5 a block (128 blocks), GPT-2's 1024 prefill rows full blocks of
    8 warps; a team of 128 at most 2 a block. w and b are read with x
    while the grid is at most a block an SM (1056 rows of a warp, 264 of
    128 threads), not past it."""
    for rows, team, teams, hoist in [
            (8, 32, 1, True), (8, 128, 1, True), (640, 32, 5, True),
            (1024, 32, 8, True), (1056, 32, 8, True), (1057, 32, 8, False),
            (4096, 32, 8, False), (8192, 32, 8, False),
            (264, 128, 2, True), (4224, 128, 2, False),
            (300, 256, 1, False)]:
        assert LN.norm_fwd_grid(rows, team, 132) == dict(
            teams=teams, hoist=hoist), (rows, team)


def test_launch_is_worked_out_once_per_shape(monkeypatch):
    """The wrapper's launch arguments are the plan's and the grid's, and a
    second call at the same shape reads them from the cache instead of
    working the plan out again."""
    monkeypatch.setattr(LN._build, "launch", lambda *a: None)
    monkeypatch.setattr(LN._build, "check_cuda", lambda *t: None)
    monkeypatch.setattr(LN._build, "stream_of", lambda t: 0)
    monkeypatch.setattr(LN, "_sm_count", lambda device: 132)
    LN._norm_fwd_launch.cache_clear()
    plans = []
    real_plan = LN.norm_fwd_plan
    monkeypatch.setattr(LN, "norm_fwd_plan",
                        lambda cols, elt: plans.append(cols)
                        or real_plan(cols, elt))
    x, w = torch.zeros(640, 1024), torch.ones(1024)
    for _ in range(3):
        LN._norm_fwd_kernel("rms_norm_fwd", x, w, None, 1e-6, True)
    assert plans == [1024]
    plan, grid = real_plan(1024, 4), LN.norm_fwd_grid(640, 32, 132)
    assert LN._norm_fwd_launch(640, 1024, 4, 132) == (
        plan["team"], plan["slots"], plan["passes"], grid["teams"],
        int(grid["hoist"]))
    LN._norm_fwd_launch.cache_clear()


# --- the kernel's order, emulated ------------------------------------------


def _fma(a, b, c):
    """fp32 fmaf(a, b, c): the exact product and sum, rounded once."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _team_sum(v):
    """``[rows, team]`` per-thread fp32 sums -> ``[rows]``: each warp's xor
    butterfly (offsets 16 .. 1; every lane ends with the same bits), then
    the team's warps in warp order."""
    rows, ts = v.shape
    lanes = v.reshape(rows, ts // 32, 32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, :, np.arange(32) ^ o]
    assert (lanes == lanes[:, :, :1]).all()
    t = lanes[:, 0, 0]
    for i in range(1, ts // 32):
        t = t + lanes[:, i, 0]
    return t


def _emulated_fwd(x, w, b, eps, rms, elt):
    """The forward kernel's fp32 arithmetic on ``x`` (fp32 values, already
    rounded to x's dtype): ``(y in fp32, mean, rstd)``. Each thread sums
    its values in its slot order (``_plan_columns``), the team by
    ``_team_sum``; the mean is that sum / cols, the variance the centred
    squares summed by fma in the same order / cols."""
    f32 = np.float32
    rows, cols = x.shape
    order = _plan_columns(cols, elt)
    ts = order.shape[0]

    def thread_sums(step):
        acc = np.zeros((rows, ts), f32)
        for k in range(order.shape[1]):
            c = order[:, k]
            ok = c < cols
            v = x[:, np.minimum(c, cols - 1)]
            acc = np.where(ok, step(acc, v), acc)
        return acc

    mean = np.zeros(rows, f32)
    if not rms:
        mean = _team_sum(thread_sums(lambda acc, v: acc + v)) / f32(cols)
    m = mean[:, None]
    ss = _team_sum(thread_sums(lambda acc, v: _fma(v - m, v - m, acc)))
    rstd = f32(1) / np.sqrt(ss / f32(cols) + f32(eps))
    y = (x - m) * rstd[:, None]
    if w is not None:
        y = y * w
        if b is not None:
            y = y + b
    return y, mean, rstd


#: widths: T5's, ragged, a team of 256 with a ragged slot, passes in bf16
#: (over 16384) and fp32 (over 8192)
EMU_WIDTHS = [512, 1000, 4097, 9000, 16385]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rms,params", [
    (False, "wb"), (False, "w"), (False, ""), (True, "w"), (True, "")])
@pytest.mark.parametrize("cols", EMU_WIDTHS)
def test_emulated_kernel_order_matches_jax(cols, rms, params, dtype):
    """The kernel's fixed order gives y, mean and rstd within this file's
    bars of JAX's forward (``_ln_fwd``, the Pallas kernel in interpret
    mode), in every branch and at every kind of tile: a warp, a team of
    256, passes."""
    rng = np.random.default_rng(cols + 7 * len(params) + rms)
    x = (rng.standard_normal((3, cols)) * 2 + 0.5).astype(np.float32)
    w = (rng.random(cols) + 0.5).astype(np.float32) if "w" in params \
        else None
    b = rng.standard_normal(cols).astype(np.float32) if "b" in params \
        else None
    eps = 1e-6 if rms else 1e-5
    xt = torch.from_numpy(x).to(dtype)
    xr = xt.float().numpy()
    y, mean, rstd = _emulated_fwd(xr, w, b, eps, rms, xt.element_size())
    jx = jnp.asarray(xr).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                else jnp.float32)
    jy, jmean, jrstd = (np.asarray(t.astype(jnp.float32)) for t in
                        JAX_LN._ln_fwd(jx, None if w is None
                                       else jnp.asarray(w),
                                       None if b is None else jnp.asarray(b),
                                       eps, rms))
    got = torch.from_numpy(y).to(dtype).float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, jy, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, jy, atol=2e-2, rtol=0)
    np.testing.assert_allclose(mean, jmean[:, 0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rstd, jrstd[:, 0], atol=1e-5, rtol=1e-5)
