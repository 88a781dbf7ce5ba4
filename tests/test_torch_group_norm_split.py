"""Port parity: the split statistics of the GroupNorm kernels against the
JAX reference.

``csrc/group_norm.cu`` tiles NHWC as it lies: a block takes a chunk of a
sample's rows across a tile of whole vector columns (8 channels a thread),
keeps per channel (mean, M2) over its thread's rows (sums shifted by the
thread's first value of the channel), merges a channel's thread rows (a
xor butterfly over the column's lanes, two passes), folds them per group
(a segment of lanes: stripes, then a xor butterfly; the counted mean, then
the M2s plus each pair's count times its squared distance from it) into one
(count, mean, M2) partial of (sample, chunk, tile, group), and a sample's
last block folds its partials over its chunks the same way. The backward keeps per channel sum d and sum d xhat, sums the
thread rows into the chunk's per-channel dw/db partials, forms per group
sum dyw = sum_ch w db and sum dyw xhat = sum_ch w dw, sums those over the
chunks, and finishes dw and db per sample over the chunks, then over the
samples in stripes. The CUDA code runs only on the card; here the cut of
``group_norm_split_plan`` and the tile and group maps are checked by
enumeration, and a torch emulation of that order (fp32, in this file) is
held against the reference: the forward against
``apex_tpu.ops.group_norm.group_norm_reference`` and the fp64 two-pass
statistics, the backward against ``_gn_bwd_jnp`` (the reference's own
gradient at every shape whose cg is not a multiple of 128), both at Stable
Diffusion's shapes cut to a few rows, and on data of mean 100, where fp32
E[x^2] - mean^2 loses the variance.

Tolerances: y 1e-5 (fp32 both sides; the sums in other orders), the
variance 1e-5 relative to the fp64 two-pass one, dx 1e-5 absolute and
relative, dw and db 1e-5 of their largest value (sums over 2 x 256 rows in
other orders).
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.group_norm import _gn_bwd_jnp
from apex_tpu.ops.group_norm import group_norm_reference as jax_reference

gn = importlib.import_module("apex_tpu_torch.ops.group_norm")

#: Stable Diffusion v1.5's four UNet norm widths at 32 groups, rows cut to
#: 16 x 16 and 8 x 8 (several chunks each, and a ragged last chunk at 15 x
#: 15), batch 2
SD_CASES = [((2, 16, 16, 320), 32), ((2, 16, 16, 640), 32),
            ((2, 8, 8, 1280), 32), ((2, 15, 15, 1280), 32)]
SD_IDS = ["c320", "c640", "c1280", "c1280_ragged_rows"]


def _segment(plan, n_groups):
    """The lanes that fold one group (the kernels' ``by_group``): the
    largest power of 2 up to 32 that puts every group of the tile in one
    round, when they fit."""
    seg = 32
    while seg > 1 and n_groups * seg > plan.threads:
        seg //= 2
    return seg


def _seg_sum(items, seg, lane_of=None):
    """A segment's sum of ``items`` (tuples of tensors): lane ``lane_of[it]``
    (default it % seg) adds item it, in item order, then a xor butterfly
    (lane l adds lane l ^ o for o = seg / 2, ..., 1); lane 0's result, which
    every lane of the segment holds."""
    lanes = [None] * seg
    for it, v in enumerate(items):
        lane = it % seg if lane_of is None else lane_of[it]
        lanes[lane] = v if lanes[lane] is None else tuple(
            a + b for a, b in zip(lanes[lane], v))
    zero = tuple(torch.zeros_like(t) for t in items[0])
    lanes = [zero if v is None else v for v in lanes]
    o = seg // 2
    while o:
        lanes = [tuple(a + b for a, b in zip(lanes[lane], lanes[lane ^ o]))
                 for lane in range(seg)]
        o //= 2
    return lanes[0]


def _butterfly(values):
    """A xor butterfly over a column's thread rows (a power of 2 of them):
    row l adds row l ^ o for o = tr / 2, ..., 1; row 0's result."""
    vals = list(values)
    o = len(vals) // 2
    while o:
        vals = [vals[lane] + vals[lane ^ o] for lane in range(len(vals))]
        o //= 2
    return vals[0]


def _two_pass(items, seg, lane_of=None):
    """The kernels' fold of (count, mean, M2) items of a group: the counted
    mean, then the M2s plus each item's count times its squared distance
    from that mean."""
    cnt, s = _seg_sum([(n, n * m) for n, m, _ in items], seg, lane_of)
    mean = s / cnt
    (m2,) = _seg_sum([(q + (n * (m - mean)) * (m - mean),)
                      for n, m, q in items], seg, lane_of)
    return cnt, mean, m2


def _thread_rows(plan, hw, k, r):
    """The rows of chunk k that thread row r walks, in order: the kernels'
    ``r + u tr`` for u < rows, within the chunk."""
    length = min(plan.chunk_rows, hw - k * plan.chunk_rows)
    return [k * plan.chunk_rows + r + u * plan.thread_rows
            for u in range(plan.rows)
            if r + u * plan.thread_rows < length]


def _emulate_fwd(x, g, eps, w=None, b=None, act=None, elt=4):
    """The forward kernels' arithmetic on ``x`` (n, h, w, c) fp32, cut as
    for elements of ``elt`` bytes: y, mean, rstd and the per-group M2 /
    count (the variance)."""
    n, h, wd, c = x.shape
    hw, cg = h * wd, c // g
    plan = gn.group_norm_split_plan(hw, c, cg, elt)
    assert plan.tiles == 1             # the emulation's shapes: one tile
    xs = x.reshape(n, hw, c)
    seg = _segment(plan, g)             # one tile: its groups are all g
    partials = []                      # per chunk: (count, mean, M2) [n, g]
    for k in range(plan.chunks):
        # each thread row's per-channel (mean, M2) over its rows: sums
        # shifted by its first row
        per_row = []
        for r in range(plan.thread_rows):
            rows = _thread_rows(plan, hw, k, r)
            cnt = torch.tensor(float(len(rows)))
            if not rows:
                per_row.append((cnt, torch.zeros(n, c), torch.zeros(n, c)))
                continue
            shift = xs[:, rows[0]]
            s1, s2 = torch.zeros(n, c), torch.zeros(n, c)
            for row in rows[1:]:
                d = xs[:, row] - shift
                s1 = s1 + d
                s2 = s2 + d * d
            d = s1 * (1 / cnt)
            per_row.append((cnt, shift + d, torch.clamp(s2 - d * s1, min=0)))
        # each channel over the chunk: its thread rows in two passes, a
        # butterfly over the column's lanes
        length = float(min(plan.chunk_rows, hw - k * plan.chunk_rows))
        cm = _butterfly(cnt * mean for cnt, mean, _ in per_row) * (
            1 / torch.tensor(length))
        cq = _butterfly(m2 + (cnt * (mean - cm)) * (mean - cm)
                        for cnt, mean, m2 in per_row)
        # per group, its channels (each of `length` rows) in two passes,
        # lane l taking channels l, l + seg, ...
        sums = _seg_sum([(cm[:, j::cg],) for j in range(cg)], seg)[0]
        mg = sums / cg
        (q,) = _seg_sum([((cq[:, j::cg] + (length * (cm[:, j::cg] - mg))
                           * (cm[:, j::cg] - mg)),) for j in range(cg)], seg)
        partials.append((torch.full_like(mg, length * cg), mg, q))
    # the sample's last block: the chunks' partials, lane l taking chunks
    # l, l + seg, ...
    cnt, mean, m2 = _two_pass(partials, _segment(plan, g))
    var = m2 / cnt
    rstd = 1 / torch.sqrt(var + eps)
    mu = mean.repeat_interleave(cg, dim=1)[:, None]
    rs = rstd.repeat_interleave(cg, dim=1)[:, None]
    scale = rs * (w if w is not None else 1.0)
    y = (xs - mu) * scale + (b if b is not None else 0.0)
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape), mean, rstd, var


def _emulate_bwd(x, dy, mean, rstd, g, w=None, b=None, act=None, elt=4):
    """The backward kernels' arithmetic, cut as for elements of ``elt``
    bytes: dx, dw, db (dw and db None without affine)."""
    n, h, wd, c = x.shape
    hw, cg = h * wd, c // g
    plan = gn.group_norm_split_plan(hw, c, cg, elt, backward=True)
    assert plan.tiles == 1
    xs, gs = x.reshape(n, hw, c), dy.reshape(n, hw, c)
    mu = mean.repeat_interleave(cg, dim=1)
    rs = rstd.repeat_interleave(cg, dim=1)
    wv = w if w is not None else torch.ones(c)
    bv = b if b is not None else torch.zeros(c)

    def upstream(dyv, xh):
        if act != "silu":
            return dyv
        pre = xh * wv + bv
        sig = torch.sigmoid(pre)
        return dyv * sig * (pre * (1 - sig) + 1)

    seg = _segment(plan, g)
    gparts, cparts = [], []
    for k in range(plan.chunks):
        per_row = []
        for r in range(plan.thread_rows):
            dw, db = torch.zeros(n, c), torch.zeros(n, c)
            for row in _thread_rows(plan, hw, k, r):
                xh = (xs[:, row] - mu) * rs
                d = upstream(gs[:, row], xh)
                db = db + d
                dw = dw + d * xh
            per_row.append((dw, db))
        # the thread rows: a butterfly over the column's lanes
        sdw = _butterfly(dw for dw, _ in per_row)
        sdb = _butterfly(db for _, db in per_row)
        cparts.append((sdw, sdb))
        items = [((wv * sdb)[:, j::cg], (wv * sdw)[:, j::cg])
                 for j in range(cg)]
        gparts.append(_seg_sum(items, seg))
    sum_dyw, sum_dyw_xhat = _seg_sum(gparts, seg)
    m = hw * cg
    a = (sum_dyw / m).repeat_interleave(cg, dim=1)[:, None]
    bq = (sum_dyw_xhat / m).repeat_interleave(cg, dim=1)[:, None]
    xh = (xs - mu[:, None]) * rs[:, None]
    dyw = upstream(gs, xh) * wv
    dx = rs[:, None] * ((dyw - a) - xh * bq)
    if w is None:
        return dx.reshape(x.shape), None, None
    # dw, db: each sample's chunks in order, then the samples in stripes of
    # the block's warps, then the stripes in order
    warps = plan.threads // 32
    fin = []
    for plane in (0, 1):
        stripe = [torch.zeros(c) for _ in range(warps)]
        for i in range(n):
            s = torch.zeros(c)
            for k in range(plan.chunks):
                s = s + cparts[k][plane][i]
            stripe[i % warps] = stripe[i % warps] + s
        tot = torch.zeros(c)
        for s in stripe:
            tot = tot + s
        fin.append(tot)
    return dx.reshape(x.shape), fin[0], fin[1]


def _case(shape, seed, shift=0.3):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) + shift).astype(np.float32)
    w = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, w, b, dy


def _two_pass64(x, g):
    n, h, w, c = x.shape
    s = x.astype(np.float64).reshape(n, h * w, g, c // g)
    mean = s.mean(axis=(1, 3))
    var = ((s - mean[:, None, :, None]) ** 2).mean(axis=(1, 3))
    return mean, var


# --- the cut ----------------------------------------------------------------

PLAN_SHAPES = [(hw, c, cg, elt)
               for hw in (1, 2, 7, 64, 97, 225, 256, 1024, 4099, 4096)
               for c, cg in ((320, 10), (640, 20), (1280, 40), (24, 6),
                             (2048, 2048), (12, 3), (8200, 8))
               for elt in (2, 4)]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("hw,c,cg,elt", PLAN_SHAPES)
def test_plan_covers_every_row_once(hw, c, cg, elt, backward):
    plan = gn.group_norm_split_plan(hw, c, cg, elt, backward)
    seen = np.zeros(hw, np.int64)
    for k in range(plan.chunks):
        for r in range(plan.thread_rows):
            rows = _thread_rows(plan, hw, k, r)
            assert len(rows) <= plan.rows
            seen[rows] += 1
    np.testing.assert_array_equal(seen, 1)
    assert (plan.chunks - 1) * plan.chunk_rows < hw <= (
        plan.chunks * plan.chunk_rows)
    assert plan.threads % 32 == 0 and plan.threads <= 320
    assert plan.thread_rows * plan.col_threads <= plan.threads
    assert 1 <= plan.rows <= gn.MAX_ROWS[elt] and gn.MAX_ROWS[elt] * elt <= 32
    assert plan.thread_rows & (plan.thread_rows - 1) == 0
    assert plan.chunk_rows == plan.thread_rows * plan.rows
    # the columns: each of ceil(c / 8) vectors in one tile, once
    cols = [q * plan.col_threads + j for q in range(plan.tiles)
            for j in range(plan.col_threads)
            if q * plan.col_threads + j < plan.cols]
    assert cols == list(range(-(-c // 8)))


def test_plan_depends_on_the_shape_alone():
    """No batch in the plan: a sample's statistics are merged from its own
    chunks in an order fixed by (hw, c, cg, elt)."""
    assert list(inspect.signature(gn.group_norm_split_plan).parameters) == [
        "hw", "c", "cg", "elt", "backward"]
    sd = gn.group_norm_split_plan(4096, 320, 10, 2)
    assert sd.chunks >= gn.MIN_CHUNKS[False] and sd.threads == 320
    assert sd.rows == gn.MAX_ROWS[2] and sd.thread_rows == 8
    assert gn.group_norm_split_plan(4096, 320, 10, 2) == sd
    with pytest.raises(ValueError):
        gn.group_norm_split_plan(16, 30, 4, 2)
    with pytest.raises(ValueError):
        gn.group_norm_split_plan(16, 32, 4, 8)


#: (cg, c): cg 1, 2, 3, 4, 8, 10, 20, 40 and 2048, each at a c that is no
#: whole vectors where cg allows one (cg % 8 != 0: the kRagged instances)
#: and at a row of several tiles (more than 320 vectors) where it fits
MAP_CASES = [(1, 12), (1, 8200), (2, 6), (2, 64), (3, 21), (3, 48), (4, 12),
             (4, 4100), (8, 64), (8, 8200), (10, 70), (10, 320), (20, 100),
             (20, 640), (40, 1280), (40, 8200), (2048, 2048), (2048, 6144)]


@pytest.mark.parametrize("cg,c", MAP_CASES)
def test_vector_to_group_map(cg, c):
    """Every channel's group is one of its tile's groups (the kernels'
    ``min(c0 + e, c - 1) / cg - g_lo`` indexes the tile's statistics), a
    group's channels lie in exactly the tiles ``group_tiles`` names, and a
    vector spans at most two groups once cg >= 8."""
    plan = gn.group_norm_split_plan(16, c, cg, 2)
    span = plan.col_threads * gn.VEC
    for q in range(plan.tiles):
        groups = gn.tile_groups(plan, c, cg, q)
        for j in range(plan.col_threads):
            c0 = q * span + j * gn.VEC
            if c0 >= c:
                continue
            slots = []
            for e in range(gn.VEC):
                gi = min(c0 + e, c - 1) // cg - groups.start
                assert 0 <= gi < len(groups)
                if c0 + e < c:
                    assert groups.start + gi == (c0 + e) // cg
                    slots.append(gi)
            if cg >= 8:
                assert len(set(slots)) <= 2
    for g in range(c // cg):
        tiles = gn.group_tiles(plan, cg, g)
        held = [ch for q in tiles
                for ch in range(q * span, min(c, (q + 1) * span))
                if ch // cg == g]
        assert held == list(range(g * cg, (g + 1) * cg))
        for q in range(plan.tiles):
            assert (g in gn.tile_groups(plan, c, cg, q)) == (q in tiles)


def test_ragged_takes_odd_widths_and_unaligned_views():
    x = torch.zeros(2, 4, 4, 64)
    assert not gn.ragged(64, x)
    assert gn.ragged(60, torch.zeros(2, 4, 4, 60))
    flat = torch.zeros(x.numel() + 1)
    assert gn.ragged(64, flat[1:].view(x.shape))
    assert gn.ragged(64, x, flat[1:].view(x.shape))


# --- the arithmetic -----------------------------------------------------------


#: the cuts of 2-byte (bf16, fp16) and 4-byte elements (fp32: half the
#: rows a thread), the arithmetic in fp32 either way
ELTS = [2, 4]


@pytest.mark.parametrize("elt", ELTS)
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,groups", SD_CASES, ids=SD_IDS)
def test_split_forward_matches_jax(shape, groups, act, elt):
    x, w, b, _ = _case(shape, seed=shape[-1] + shape[1])
    y, mean, rstd, var = _emulate_fwd(torch.from_numpy(x), groups, 1e-5,
                                      torch.from_numpy(w),
                                      torch.from_numpy(b), act, elt)
    want = np.asarray(jax_reference(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), groups, 1e-5, act))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)
    mean64, var64 = _two_pass64(x, groups)
    np.testing.assert_allclose(mean.numpy(), mean64, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), var64, rtol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(var64 + 1e-5),
                               rtol=1e-5)


@pytest.mark.parametrize("shape,groups", SD_CASES[:3], ids=SD_IDS[:3])
def test_split_variance_keeps_two_pass_accuracy_at_mean_100(shape, groups):
    """x + 100: the merged (count, mean, M2) stay within 1e-5 of the fp64
    two-pass variance, where fp32 E[x^2] - mean^2 (the reference kernel's
    formula at cg % 128 == 0) misses it by far more."""
    x, _, _, _ = _case(shape, seed=5, shift=100.0)
    y, mean, _, var = _emulate_fwd(torch.from_numpy(x), groups, 1e-6)
    mean64, var64 = _two_pass64(x, groups)
    np.testing.assert_allclose(var.numpy(), var64, rtol=1e-5)
    np.testing.assert_allclose(mean.numpy(), mean64, rtol=1e-6)
    want = np.asarray(jax_reference(jnp.asarray(x), None, None, groups, 1e-6))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-4, atol=1e-4)
    n, h, w, c = shape
    s = torch.from_numpy(x).reshape(n, h * w, groups, c // groups)
    raw = (s * s).mean(dim=(1, 3)) - s.mean(dim=(1, 3)) ** 2
    assert np.abs(raw.numpy() / var64 - 1).max() > 1e-3


@pytest.mark.parametrize("elt", ELTS)
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,groups", SD_CASES, ids=SD_IDS)
def test_split_backward_matches_jax(shape, groups, act, affine, elt):
    x, w, b, dy = _case(shape, seed=shape[-1] + 7)
    mean64, var64 = _two_pass64(x, groups)
    mean = mean64.astype(np.float32)
    rstd = (1 / np.sqrt(var64 + 1e-5)).astype(np.float32)
    wt, bt = ((torch.from_numpy(w), torch.from_numpy(b)) if affine
              else (None, None))
    dx, dw, db = _emulate_bwd(torch.from_numpy(x), torch.from_numpy(dy),
                              torch.from_numpy(mean), torch.from_numpy(rstd),
                              groups, wt, bt, act, elt)
    res = (jnp.asarray(x), jnp.asarray(w) if affine else None,
           jnp.asarray(b) if affine else None,
           (jnp.asarray(mean), jnp.asarray(rstd)))
    rdx, rdw, rdb = _gn_bwd_jnp(groups, 1e-5, act, res, jnp.asarray(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), rtol=1e-5,
                               atol=1e-5)
    if not affine:
        assert dw is None and db is None and rdw is None
        return
    for got, want in ((dw, rdw), (db, rdb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_emulated_sample_alone_matches_the_batch():
    """The kernels' order for a sample is fixed by the shape: sample 1's
    y, mean, rstd and dx alone are the bits of sample 1 in the batch."""
    shape, groups = SD_CASES[0]
    x, w, b, dy = _case(shape, seed=3)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    batch = _emulate_fwd(xt, groups, 1e-5, wt, bt, "silu")
    alone = _emulate_fwd(xt[1:], groups, 1e-5, wt, bt, "silu")
    for got, want in zip(alone, batch):
        assert torch.equal(got, want[1:])
    dx = _emulate_bwd(xt, dyt, batch[1], batch[2], groups, wt, bt, "silu")[0]
    dx1 = _emulate_bwd(xt[1:], dyt[1:], alone[1], alone[2], groups, wt, bt,
                       "silu")[0]
    assert torch.equal(dx1, dx[1:])
