"""The stats kernel's segment pass and summation order, on the CPU.

``csrc/segment_stats.cu`` cannot run here (no card). Its row pass writes
one fp32 partial per row (a warp's lanes in order, then an xor butterfly)
and one partial per group of ``STATS_GROUP_ROWS`` rows (fp64 sums, an
integer count); its segment pass finds each segment's rows with a search
all its threads share, and sums the whole groups inside the segment from
their partials and the rows before and after them from theirs, each of
512 threads a fixed stripe, then the threads in a fixed order. Pinned
here: the search's rounds against ``np.searchsorted`` (the same search,
``segment_reduce.cuh``'s ``segment_bounds``, finds a segment's rows in
LAMB's reduce, a block of 256 threads); that the groups and
rows a segment reads cover each of its rows once and never reach past it;
and a numpy emulation of the whole order over BERT-Large's layout with
every segment's rows cut by 60 (302 segments, 1 to 508 rows, most starting
inside a group) against ``apex_tpu.ops.optim_kernels.segment_stats``
through its Pallas kernel in interpret mode: sums within rtol 1e-5 (the
reference's fp32 sums, as ``tests/test_torch_lamb.py``), and within 1e-6
of the port's fp64 twin; with injected inf and NaN the non-finite counts
exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import optim_kernels as jax_optim
from apex_tpu_torch.models import BertForPreTraining, bert_large_config
from apex_tpu_torch.ops import flat_buffer

OA = importlib.import_module("apex_tpu_torch.ops.optim_kernels")
G = OA.STATS_GROUP_ROWS
THREADS = 512           # the segment pass's block (kSegThreads)
LANE = flat_buffer.LANE


def _bounds(seg, s, threads=THREADS):
    """The segment pass's search for segment ``s``: ``(lo, hi)``, both
    bounds at once, each round every thread probing the last entry of its
    chunk of the open range."""
    n = len(seg)
    rng = [[0, n], [0, n]]
    rounds = 0
    while any(h > lo for lo, h in rng):
        rounds += 1
        for k, key in ((0, s), (1, s + 1)):
            lo, hi = rng[k]
            if hi <= lo:
                continue
            c = max(1, -(-(hi - lo) // threads))
            probes = lo + (np.arange(threads) + 1) * c - 1
            ok = probes < hi
            below = int((seg[probes[ok]] < key).sum())
            rng[k] = [lo + below * c, min(hi, lo + (below + 1) * c - 1)]
    return rng[0][0], rng[1][0], rounds


def _items(lo, hi):
    """The whole groups ``[g0, g1)`` a segment ``[lo, hi)`` reads from
    their partials, and the rows before and after them (every row when no
    group is whole), as the segment pass forms them."""
    g0, g1 = -(-lo // G), hi // G
    if g0 < g1:
        return range(g0, g1), [*range(lo, g0 * G), *range(g1 * G, hi)]
    return range(0), list(range(lo, hi))


def _scaled_bert_rows():
    """Rows of each BERT-Large tensor in the flat buffers, cut by 60."""
    named = list(BertForPreTraining(bert_large_config(),
                                    device="meta").named_parameters())
    counts = np.bincount(flat_buffer.build_spec(named).segment_rows())
    return np.maximum(1, counts // 60)


@pytest.mark.parametrize("threads", [THREADS, 256, 4])
def test_search_finds_every_segments_rows(threads):
    """Against ``np.searchsorted`` over BERT's scaled layout, BERT's own
    (328353 rows: three rounds at 512 threads), runs of one-row segments,
    segments with no rows, at the segment pass's block, LAMB's reduce's
    (256 threads) and a block of 4 threads (many rounds)."""
    rng = np.random.default_rng(0)
    layouts = [np.repeat(np.arange(302), _scaled_bert_rows())]
    named = list(BertForPreTraining(bert_large_config(),
                                    device="meta").named_parameters())
    bert = flat_buffer.build_spec(named).segment_rows().numpy()
    layouts += [bert, np.arange(37), np.sort(rng.integers(0, 50, 300)),
                np.array([], dtype=np.int64), np.zeros(9, np.int64)]
    for seg in layouts:
        top = int(seg.max()) + 2 if len(seg) else 3
        keys = range(top) if len(seg) < 10000 else rng.integers(0, top, 40)
        for s in keys:
            lo, hi, rounds = _bounds(seg, int(s), threads)
            assert (lo, hi) == (np.searchsorted(seg, s),
                                np.searchsorted(seg, s + 1))
            if threads == THREADS and len(seg) == len(bert):
                assert rounds <= 3


def test_groups_and_rows_cover_each_segment_once():
    """Every layout's segments: the whole groups' rows and the rows read
    singly are each segment's rows exactly once, and every group read
    lies inside its segment, whether the segment is one row, shorter than
    a group, starts inside a group or spans hundreds."""
    rng = np.random.default_rng(1)
    layouts = [_scaled_bert_rows(), np.ones(40, np.int64),
               rng.integers(1, 30, 200), np.array([7, 1, 8, 16, 9, 3, 24])]
    for counts in layouts:
        starts = np.concatenate([[0], np.cumsum(counts)])
        for lo, hi in zip(starts[:-1], starts[1:]):
            groups, rows = _items(int(lo), int(hi))
            covered = [r for g in groups for r in range(g * G, g * G + G)]
            assert all(lo <= g * G and g * G + G <= hi for g in groups)
            assert sorted(covered + rows) == list(range(lo, hi))


def _fma(a, b, c):
    """fp32 fmaf(a, b, c): the exact product and sum, rounded once."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _butterfly(v):
    """A warp's xor butterfly over the last axis (32 lanes): lane 0."""
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., np.arange(32) ^ o]
    return v[..., 0]


def _row_partials(x):
    """The row pass's per-row fp32 sum of squares (lane l takes float4s l,
    l + 32, ..., each by fma in x, y, z, w order, then the butterfly) and
    non-finite count."""
    rows = x.shape[0]
    v = x.reshape(rows, LANE // 128, 32, 4)
    acc = np.zeros((rows, 32), np.float32)
    for i in range(v.shape[1]):
        for c in range(4):
            acc = _fma(v[:, i, :, c], v[:, i, :, c], acc)
    return _butterfly(acc), (~np.isfinite(x)).sum(1)


def _emulated_stats(a, seg, segments, b=None):
    """The kernel's result in its order: row partials, group partials
    (a group's rows in order, fp64), then per segment each thread's stripe
    of whole groups and then of single rows, in fp64, the threads by
    ``_butterfly`` per warp and the warps in order."""
    rows = a.shape[0]
    pa, bad = _row_partials(a)
    pb = _row_partials(b)[0] if b is not None else np.zeros(rows, np.float32)
    groups = -(-rows // G)

    def grouped(p):
        q = np.zeros(groups * G, p.dtype)
        q[:rows] = p
        out = np.zeros(groups, np.float64 if p.dtype != np.int64
                       else np.int64)
        for w in range(G):
            out = out + q[w::G]
        return out

    parts = [(pa.astype(np.float64), grouped(pa.astype(np.float64))),
             (pb.astype(np.float64), grouped(pb.astype(np.float64))),
             (bad.astype(np.int64), grouped(bad.astype(np.int64)))]
    out = np.zeros((3, segments), np.float32)
    for s in range(segments):
        lo, hi, _ = _bounds(seg, s)
        gs, rs = _items(lo, hi)
        for k, (per_row, per_group) in enumerate(parts):
            acc = np.zeros(THREADS, per_row.dtype)
            items = [per_group[g] for g in gs]
            stripe = [per_row[r] for r in rs]
            for vals in (items, stripe):
                for j in range(0, len(vals), THREADS):
                    chunk = np.zeros(THREADS, per_row.dtype)
                    chunk[:len(vals[j:j + THREADS])] = vals[j:j + THREADS]
                    acc = acc + chunk
            warps = _butterfly(acc.reshape(THREADS // 32, 32))
            total = warps[0]
            for w in warps[1:]:
                total = total + w
            out[k, s] = np.float32(total)
    return out


@pytest.mark.parametrize("with_b", [False, True])
def test_emulated_order_matches_jax_at_berts_scaled_layout(with_b):
    counts = _scaled_bert_rows()
    seg = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    rows, segments = len(seg), len(counts)
    rng = np.random.default_rng(2)
    a = rng.standard_normal((rows, LANE)).astype(np.float32)
    b = rng.standard_normal((rows, LANE)).astype(np.float32) if with_b \
        else None

    def jax_stats(a_):
        return np.asarray(jax_optim.segment_stats(
            jnp.asarray(a_), jnp.asarray(seg), segments,
            jnp.asarray(b) if with_b else None))[:3, :segments]

    got = _emulated_stats(a, seg, segments, b)
    np.testing.assert_allclose(got, jax_stats(a), rtol=1e-5)
    twin = OA.segment_stats_reference(
        torch.from_numpy(a), torch.from_numpy(seg), segments,
        torch.from_numpy(b) if with_b else None).numpy()
    np.testing.assert_allclose(got, twin, rtol=1e-6)
    assert (got[1] > 0).all() == with_b
    # an inf in the first row, NaNs in a mid-group row of the largest
    # segment and in a one-row segment: counts exact
    big, one = int(np.argmax(counts)), int(np.argmin(counts))
    a[0, 3] = np.inf
    first = int(np.searchsorted(seg, big)) + 5
    a[first, 10] = a[first, 11] = np.nan
    a[int(np.searchsorted(seg, one)), 0] = -np.inf
    got = _emulated_stats(a, seg, segments, b)
    want = jax_stats(a)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].sum() == 4
    np.testing.assert_array_equal(got[2], np.bincount(
        seg, weights=(~np.isfinite(a)).sum(1), minlength=segments))
    assert not np.isfinite(got[0].sum()) and not np.isfinite(want[0].sum())
