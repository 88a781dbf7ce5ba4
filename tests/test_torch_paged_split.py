"""Port parity: the split page walk of the paged kernel (flash-decode)
against the JAX kernel.

``csrc/paged_attention.cu`` cuts each slot's live pages into splits of
``paged_split_plan(...).split_pages`` pages anchored at absolute page
indices, walks each split 16 positions at a time with the warps of a block
taking the chunks in turn (``warps_a_chunk``), merges the warps' online-
softmax states in warp order, then the slot's splits in split order. The
CUDA code runs only on the card; here the plan's arithmetic (which pages a
slot reads and how they are cut) is checked against a brute-force walk of
the positions, and a torch emulation of the split-then-merge order (fp32,
in this file) is held against the JAX kernel in interpret mode at tiny
sizes: rep 1, 2 and 4; s = 1, 4 and page_size; windows whose band floor
falls inside a split; int8 and e4m3 pools; zero-length slots and splits
that see nothing (exact 0, never NaN); lengths at split boundaries +-1.

Tolerances: fp32 atol = rtol = 1e-5 (both sides sum the same fp32
products, in other orders); the quantized pools' values reach |x| ~ 3 and
are held at 2e-5, as in ``test_torch_paged_block.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import paged_attention as jax_paged
from apex_tpu_torch.ops.paged_attention import (BLOCK_ROWS, MAX_SPLIT_PAGES,
                                                SPLIT_KEYS, paged_split_plan)
from apex_tpu_torch.ops.quant import kv_quantize

D, KV = 16, 2
TOL = dict(atol=1e-5, rtol=1e-5)
QUANT_TOL = dict(atol=2e-5, rtol=2e-5)
CHUNK = 16          # positions a kernel chunk stages (csrc kChunkKeys)
WARPS = 4


def _warps_a_chunk(rows):
    """csrc ``warps_a_chunk``: warps sharing one tile of 16 rows."""
    tiles = -(-rows // 16)
    return max(1, WARPS // tiles)


def _live_splits(length, s, window, page_size, max_pages, split_pages):
    """``[(first page, end page), ...]`` of each live split of a slot of
    ``length``, in the order the merge takes them, as the kernel's
    ``slot_span`` (``csrc/paged_attention.cu``) finds them: the live pages
    run from the page holding the earliest row's band floor ``length - s -
    window + 1`` (0 without a window) to the one holding the last position,
    within the table."""
    n = max(length, 0)
    hi = min(n, max_pages * page_size)
    lo = max(n - s - window + 1, 0) if window else 0
    page_lo, page_hi = lo // page_size, -(-hi // page_size)
    if page_hi <= page_lo:
        return []
    return [(max(k * split_pages, page_lo),
             min((k + 1) * split_pages, page_hi))
            for k in range(page_lo // split_pages,
                           (page_hi - 1) // split_pages + 1)]


def _live_pages(length, s, window, ps, max_pages):
    """Brute force: the pages holding a position some row of the block
    sees, and the pages the reference's gate keeps (JAX ``_paged_kernel``:
    ``j * ps < len`` and, under a window, ``(j + 1) * ps + window + s - 1 >
    len``), which must agree."""
    seen = set()
    for i in range(s):
        qpos = length - s + i
        for pos in range(min(qpos + 1, max_pages * ps)):
            if pos >= 0 and (not window or pos > qpos - window):
                seen.add(pos // ps)
    gate = {j for j in range(max_pages) if j * ps < length and (
        not window or (j + 1) * ps + window + s - 1 > length)}
    return sorted(seen), sorted(gate)


@pytest.mark.parametrize("window", [0, 5, 21, 64])
@pytest.mark.parametrize("s", [1, 4, 8])
@pytest.mark.parametrize("ps,split_pages", [(8, 2), (8, 3), (16, 1),
                                            (16, 8)])
def test_splits_cover_exactly_the_live_pages(ps, split_pages, s, window):
    """Every page a row sees, from the earliest row's band-floor page to
    the last position's page, lies in exactly one split; no split holds a
    dead page or crosses a boundary of ``split_pages``; a slot never has
    more live splits than the plan's grid."""
    max_pages = 9
    plan = paged_split_plan(ps, D, s, 1, window, max_pages)
    for length in range(0, max_pages * ps + 4):
        splits = _live_splits(length, s, window, ps, max_pages,
                                   split_pages)
        pages = [j for a, b in splits for j in range(a, b)]
        seen, gate = _live_pages(length, s, window, ps, max_pages)
        if length <= max_pages * ps:
            assert seen == gate
        assert pages == gate, (length, splits)
        assert len(pages) == len(set(pages))
        for a, b in splits:
            assert a < b and a // split_pages == (b - 1) // split_pages
        if split_pages == plan.split_pages:
            assert len(splits) <= plan.grid_splits


@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("window", [0, 7, 4096])
@pytest.mark.parametrize("s,rep", [(1, 1), (1, 4), (4, 1), (16, 4),
                                   (16, 7)])
def test_plan_depends_on_the_shape_alone(s, rep, window, d):
    """The split size never moves with the table width (nor can it see the
    batch or the lengths: they are not arguments), so a slot's splits at
    one table width are its splits at any other that holds it; the grid
    covers the most live splits any length can have."""
    ps = 16
    plans = [paged_split_plan(ps, d, s, rep, window, mp)
             for mp in (4, 64, 400)]
    assert len({p.split_pages for p in plans}) == 1
    sp = plans[0].split_pages
    keys = SPLIT_KEYS[64 if d <= 64 else 128]
    assert sp == max(1, min(MAX_SPLIT_PAGES, keys // ps))
    rows = s * rep
    for p in plans:
        assert p.groups == -(-rows // BLOCK_ROWS)
        assert p.block_rows == min(rows, BLOCK_ROWS)
    for length in range(0, 64 * ps, 7):
        narrow = _live_splits(length, s, window, ps, 64, sp)
        assert narrow == _live_splits(length, s, window, ps, 400, sp)
        assert len(narrow) <= plans[1].grid_splits


def _emulate(q, kp, vp, bt, lengths, window, k_scales, v_scales,
             split_pages):
    """The kernel's order in fp32 torch: per (slot, kv head, row group)
    the live splits; in each, 16-position chunks folded into the online
    state of warp ``chunk % warps_a_chunk(rows)``; the warps merged in warp
    order, then the splits in split order; a slot with one live split
    normalises its own rows, with none outputs 0."""
    b, h, s, d = q.shape
    _, kv, ps, _ = kp.shape
    rep, max_pages = h // kv, bt.shape[1]
    scale = 1.0 / d ** 0.5
    out = torch.zeros(b, h, s, d)
    rows_total = s * rep
    for bi in range(b):
        n = int(lengths[bi])
        splits = _live_splits(n, s, window, ps, max_pages, split_pages)
        for hk in range(kv):
            for row0 in range(0, rows_total, BLOCK_ROWS):
                rows = torch.arange(row0, min(rows_total, row0 + BLOCK_ROWS))
                qi, g = rows // rep, rows % rep
                qr = q[bi, hk * rep + g, qi].float()
                qpos = n - s + qi
                ks_n = _warps_a_chunk(len(rows))
                parts = []
                for pg0, pg1 in splits:
                    states = [(torch.full((len(rows),), -torch.inf),
                               torch.zeros(len(rows)),
                               torch.zeros(len(rows), d))
                              for _ in range(ks_n)]
                    chunks = [(pg, sub) for pg in range(pg0, pg1)
                              for sub in range(0, ps, CHUNK)]
                    for ci, (pg, sub) in enumerate(chunks):
                        pid = int(bt[bi, pg])
                        nk = min(CHUNK, ps - sub)
                        pos = pg * ps + sub + torch.arange(nk)
                        kk = kp[pid, hk, sub:sub + nk].float()
                        vv = vp[pid, hk, sub:sub + nk].float()
                        ksc = float(k_scales[pid, hk]) if k_scales is not \
                            None else 1.0
                        vsc = float(v_scales[pid, hk]) if v_scales is not \
                            None else 1.0
                        live = pos[None, :] <= qpos[:, None]
                        if window:
                            live &= pos[None, :] > qpos[:, None] - window
                        sc = torch.where(live, (qr @ kk.T) * (scale * ksc),
                                         -torch.inf)
                        m, l, acc = states[ci % ks_n]
                        tmax = sc.max(dim=1).values
                        seen = tmax > -torch.inf
                        m_new = torch.where(seen, torch.maximum(m, tmax), m)
                        alpha = torch.where(seen, torch.exp(m - m_new), 1.0)
                        p = torch.where(live & seen[:, None],
                                        torch.exp(sc - m_new[:, None]), 0.0)
                        states[ci % ks_n] = (
                            m_new, l * alpha + p.sum(dim=1),
                            acc * alpha[:, None] + (p * vsc) @ vv)
                    parts.append(_merge(states))
                if not parts:
                    o = torch.zeros(len(rows), d)
                else:
                    m, l, acc = _merge(parts) if len(parts) > 1 else parts[0]
                    o = torch.where(l[:, None] == 0, 0.0,
                                    acc / torch.where(l == 0, 1.0, l)[:, None])
                out[bi, hk * rep + g, qi] = o
    return out.to(q.dtype)


def _merge(states):
    """(m, l, acc) states merged in list order: each weighed by exp(m_i -
    m), one that saw nothing (m_i = -inf) by 0."""
    m = torch.stack([st[0] for st in states]).max(dim=0).values
    l = torch.zeros_like(states[0][1])
    acc = torch.zeros_like(states[0][2])
    for mi, li, ai in states:
        wt = torch.where((mi == -torch.inf) | (m == -torch.inf), 0.0,
                         torch.exp(mi - m))
        l = l + li * wt
        acc = acc + ai * wt[:, None]
    return m, l, acc


def _case(s, rep, ps, max_pages, lengths, window, kv_dtype, seed):
    """q ``(b, rep * KV, s, D)`` and a shuffled pool; entries past a length
    and (under a window) wholly below the earliest row's band floor hold
    page 0, which is filled with large values so that a read would show."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    num_pages = 1 + b * max_pages
    q = torch.from_numpy(rng.standard_normal(
        (b, rep * KV, s, D)).astype(np.float32))
    pages = [torch.from_numpy(rng.standard_normal(
        (num_pages, KV, ps, D)).astype(np.float32) * 3) for _ in range(2)]
    for p in pages:
        p[0] = 1e4
    scales = (None, None)
    if kv_dtype is not None:
        qdt, qmax = {"int8": (torch.int8, 127.0),
                     "fp8": (torch.float8_e4m3fn, 448.0)}[kv_dtype]
        quant = [kv_quantize(p, qdt, qmax, axes=(2, 3)) for p in pages]
        pages = [p for p, _ in quant]
        scales = tuple(sc[:, :, 0, 0].contiguous() for _, sc in quant)
    perm = rng.permutation(num_pages - 1) + 1
    bt = np.zeros((b, max_pages), np.int32)
    for i, n in enumerate(lengths):
        used = -(-n // ps)
        bt[i, :used] = perm[i * max_pages:i * max_pages + used]
        if window:
            bt[i, :max(n - s - window + 1, 0) // ps] = 0
    return (q, pages[0], pages[1], torch.from_numpy(bt),
            torch.tensor(lengths, dtype=torch.int32)), scales


def _jax(t):
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


def _check(s, rep, ps, lengths, window=0, kv_dtype=None, split_pages=2,
           max_pages=12, seed=0):
    args, (ks, vs) = _case(s, rep, ps, max_pages, lengths, window, kv_dtype,
                           seed)
    got = _emulate(*args, window, ks, vs, split_pages)
    jkw = {} if not window else dict(window=window)
    if ks is not None:
        jkw.update(k_scales=_jax(ks), v_scales=_jax(vs))
    want = np.asarray(jax_paged(*(_jax(t) for t in args), **jkw))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want,
                               **(TOL if kv_dtype is None else QUANT_TOL))
    for i, n in enumerate(lengths):
        if n < s:                    # rows before the start see nothing
            assert (got[i, :, :s - n] == 0).all()
    return got


@pytest.mark.parametrize("window", [0, 11])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("s", [1, 4, 8])
def test_split_then_merge_matches_jax_kernel(s, rep, window):
    """Page 8, splits of 2 pages (16 positions): lengths 0, 1, shorter
    than s, on page and split edges +-1, the whole table; under window 11
    the earliest row's band floor falls inside a split."""
    lengths = [0, 1, s - 1, 15, 16, 17, 33, 47, 49, 96]
    _check(s, rep, 8, lengths, window, seed=10 * s + rep + window)


@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("s,rep", [(1, 4), (4, 1), (8, 2)])
def test_split_then_merge_over_a_quantized_pool(s, rep, kv_dtype, window):
    """int8 and e4m3 pages: the k scale joins the score scale, the v scale
    weighs p in PV only, l sums the unscaled p, split by split."""
    lengths = [0, 2, 16, 17, 31, 40, 65, 96]
    _check(s, rep, 8, lengths, window, kv_dtype, seed=s + rep + window)


@pytest.mark.parametrize("split_pages", [1, 3, 5])
def test_band_floor_inside_a_split_and_splits_that_see_nothing(split_pages):
    """Window 3 at s = 8 over page 8: the later rows' bands lie wholly
    inside the last split, so the earlier splits see nothing for them (m =
    -inf, l = 0); merged, those rows stay finite and equal the kernel's."""
    lengths = [3, 8, 9, 23, 24, 25, 50, 96]
    _check(8, 2, 8, lengths, 3, split_pages=split_pages, seed=split_pages)


def test_chunks_of_a_page_wider_than_sixteen_positions():
    """Page 32: two 16-position chunks a page, taken by the warps in
    turn; splits of 1 and 2 pages."""
    lengths = [0, 5, 16, 17, 32, 33, 70, 128]
    for split_pages in (1, 2):
        _check(4, 4, 32, lengths, 0, split_pages=split_pages, max_pages=4,
               seed=split_pages)
        _check(1, 1, 32, lengths, 20, split_pages=split_pages, max_pages=4,
               seed=split_pages + 5)


def test_plan_split_and_row_groups_match_jax_kernel():
    """The plan's own split size at page 16 and a block of more than 64
    rows (s = 16, rep 5: 80 rows, two row groups of 64 and 16)."""
    ps, s, rep, max_pages = 16, 16, 5, 6
    plan = paged_split_plan(ps, D, s, rep, 0, max_pages)
    assert plan.groups == 2 and plan.block_rows == 64
    lengths = [0, 7, 16, 17, 95, 96]
    _check(s, rep, ps, lengths, 0, split_pages=plan.split_pages,
           max_pages=max_pages, seed=4)
    _check(s, rep, ps, lengths, 20, split_pages=1, max_pages=max_pages,
           seed=5)


def test_slot_alone_equals_slot_in_the_batch():
    """The emulated order makes a slot's rows a function of its own length
    and pages alone: the same bits alone, in the batch and at a wider
    table."""
    args, _ = _case(4, 4, 8, 12, [0, 17, 40, 96], 11, None, seed=9)
    q, kp, vp, bt, ln = args
    batch = _emulate(q, kp, vp, bt, ln, 11, None, None, 2)
    wide = torch.cat([bt, torch.zeros(bt.shape[0], 5, dtype=bt.dtype)], 1)
    for i in range(q.shape[0]):
        alone = _emulate(q[i:i + 1], kp, vp, wide[i:i + 1], ln[i:i + 1], 11,
                         None, None, 2)
        assert torch.equal(alone[0], batch[i])
