"""Paged attention over the KV page pool: the Hopper kernels of
``csrc/paged_attention.cu`` and their plain PyTorch twin.

Counterpart of ``apex_tpu/ops/paged_attention.py`` (``_paged_kernel``,
``paged_attention``, ``paged_attention_reference``) for query blocks of
``1 <= s <= page_size`` positions per slot (``s = 1`` is a decode step,
``s = draft_len + 1`` a speculative verify, ``s = prefill_chunk`` a
chunked-prefill piece), with or without a sliding window, in both its
branches: an fp32 or bf16 pool (kernel ``paged_attention``), and a
quantized pool of int8 or fp8 e4m3 pages with fp32 per-(page, kv head)
scales ``k_scales``/``v_scales`` (kernel ``paged_attention_quant``), where
the true K of page ``p``, head ``h`` is ``k_pages[p, h].float() *
k_scales[p, h]``. The pool is ``(num_pages, kv_heads, page_size,
head_dim)`` and is read through the int32 ``(batch, max_pages)`` block
table. Slot ``b``'s ``s`` queries sit at positions ``lengths[b] - s + i``;
query ``i`` sees every position up to its own and, under a ``window``
``w``, only the positions ``> lengths[b] - s + i - w`` (the reference's
per-query band). Entries past a slot's length must hold a valid page id
(page 0, the pool's null page) and are never read; under a window neither
are the entries of pages that lie wholly below the earliest query's band,
which the serving engine nulls (``kv_pool.drop_slot_pages``). A query
with nothing to see (a slot of length 0, or the leading queries of a slot
shorter than ``s``) outputs exactly 0. It has no backward, as the
reference kernel has no VJP, so a call under autograd on an input that
requires grad raises on either device.

Each ``s > 1`` branch counts its launches under a name of its own
(``paged_attention_block``, ``paged_attention_window_block``,
``paged_attention_quant_block``), so a run can tell verify and chunk
launches from decode steps. A call counts once under its name, though the
kernel is two launches: the split pass and the merge
(:func:`paged_split_plan` says how a slot's page walk is split).

A tensor on the CPU takes the twin; a CUDA tensor always takes the kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.ops import _build


def _validate(q, k_pages, v_pages, block_tables, lengths, window, k_scales,
              v_scales):
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together "
                         "(a quantized pool quantizes both tensors)")
    if k_scales is not None:
        if k_pages.dtype not in _build.NARROW_DTYPES:
            raise NotImplementedError(
                f"quantized paged attention (k_scales/v_scales) takes int8 "
                f"or float8_e4m3fn pages in this port, got {k_pages.dtype}")
        want = tuple(k_pages.shape[:2])
        for name, sc in (("k_scales", k_scales), ("v_scales", v_scales)):
            if tuple(sc.shape) != want:
                raise ValueError(
                    f"{name} must be (num_pages, kv_heads) = {want} "
                    f"per-page/per-kv-head scales, got {tuple(sc.shape)}")
            if not sc.is_floating_point():
                raise ValueError(f"{name} must be float scales, got "
                                 f"{sc.dtype}")
    if window is not None and (not isinstance(window, int) or window < 1):
        raise ValueError(f"window must be a positive int, got {window!r}")
    if q.ndim != 4:
        raise ValueError(f"q must be (batch, heads, s, d), got "
                         f"{tuple(q.shape)}")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} != v_pages "
                         f"{tuple(v_pages.shape)}")
    _, kv, page_size, d = k_pages.shape
    b, h, s, qd = q.shape
    if not 1 <= s <= page_size:
        raise ValueError(
            f"paged attention takes query blocks of 1..page_size "
            f"({page_size}) positions per step, got s={s}; longer "
            f"chunks must use the contiguous prefill path")
    if qd != d:
        raise ValueError(f"head_dim mismatch: q {qd} vs pages {d}")
    if h % kv != 0:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads "
                         f"({kv})")
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be (batch, max_pages), got "
                         f"{tuple(block_tables.shape)} for batch {b}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be ({b},), got "
                         f"{tuple(lengths.shape)}")


def paged_attention_reference(q, k_pages, v_pages, block_tables, lengths, *,
                              scale: Optional[float] = None, window=None,
                              k_scales=None, v_scales=None):
    """Plain twin: gather every table entry into a contiguous
    ``(b, kv, max_pages * page_size, d)`` view (dequantized in fp32 with the
    gathered per-page scales when given) and run dense masked GQA attention
    with fp32 scores: query ``i`` at ``qpos = lengths[b] - s + i`` sees
    ``pos <= qpos``, banded to ``pos > qpos - window`` under a window."""
    _validate(q, k_pages, v_pages, block_tables, lengths, window, k_scales,
              v_scales)
    _, kv, page_size, d = k_pages.shape
    b, h, s_q = q.shape[0], q.shape[1], q.shape[2]
    rep = h // kv
    max_pages = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    bt = block_tables.long()

    def contig(pages, scales):
        g = pages[bt].float()                        # (b, mp, kv, ps, d)
        if scales is not None:
            g = g * scales[bt].float()[..., None, None]
        return g.transpose(1, 2).reshape(b, kv, max_pages * page_size, d)

    k, v = contig(k_pages, k_scales), contig(v_pages, v_scales)
    qf = q.reshape(b, kv, rep, s_q, d).float()
    sc = torch.einsum("bkrsd,bktd->bkrst", qf, k) * scale
    pos = torch.arange(max_pages * page_size, device=q.device)[None, None, :]
    # query i of the block sits at position lengths[b] - s + i
    qpos = (lengths.long()[:, None, None] - s_q
            + torch.arange(s_q, device=q.device)[None, :, None])
    mask = pos <= qpos                                # (b, s, T)
    if window is not None:
        mask = mask & (pos > qpos - window)
    mask = mask[:, None, None, :, :]
    sc = torch.where(mask, sc, float("-inf"))
    p = torch.where(mask, torch.softmax(sc, dim=-1), 0.0)
    ctx = torch.einsum("bkrst,bktd->bkrsd", p, v)
    return ctx.reshape(b, h, s_q, d).to(q.dtype)


#: the positions one block of the split pass walks (a split), by the
#: kernel's head-dim bucket (64: d <= 64, else 128), from a sweep on the
#: card (``paged_split_sweep.py``): GPT-2's 12 heads of 64 want more, shorter
#: splits (the pool's live bytes sit in L2 and latency rules), Mistral-7B's
#: 8 kv heads of 128 over a 4096-position window fewer, longer ones
SPLIT_KEYS = {64: 128, 128: 512}
#: the kernel's limits: rows of one block (a kv head's ``s * rep``; more
#: make row groups), pages of one split (its table entries sit in shared
#: memory)
BLOCK_ROWS = 64
MAX_SPLIT_PAGES = 64


class PagedSplitPlan(NamedTuple):
    """How ``csrc/paged_attention.cu`` cuts a call: ``split_pages`` pages a
    split (splits anchored at absolute page indices), ``grid_splits``
    splits a slot in the grid, ``groups`` row groups of up to
    ``BLOCK_ROWS`` rows a kv head, ``block_rows`` rows in the first."""
    split_pages: int
    grid_splits: int
    groups: int
    block_rows: int


@functools.lru_cache(maxsize=1024)
def paged_split_plan(page_size: int, d: int, s: int, rep: int, window: int,
                     max_pages: int) -> PagedSplitPlan:
    """The split pass's cut of a call, from the shape alone: never the batch
    or the lengths, so the wrapper reads nothing from the card. A split is
    ``SPLIT_KEYS[64 if d <= 64 else 128]`` positions of pages (at least one
    page, at most ``MAX_SPLIT_PAGES``), whatever the table width, so where
    a slot's splits fall, and so its bits, depend only on its own length
    and the shape. The grid holds as
    many splits as a slot can have live: every page of the table, or under
    a ``window`` (0: none) the pages of the ``s + window - 1`` positions from
    the earliest row's band floor to the last position."""
    keys = SPLIT_KEYS[64 if d <= 64 else 128]
    split_pages = max(1, min(MAX_SPLIT_PAGES, keys // page_size))
    grid = -(-max_pages // split_pages)
    if window:
        span = -(-(s + window - 1) // page_size) + 1
        grid = min(grid, -(-(span - 1) // split_pages) + 1)
    rows = s * rep
    return PagedSplitPlan(split_pages, max(grid, 1), -(-rows // BLOCK_ROWS),
                          min(rows, BLOCK_ROWS))


def _paged_kernel(q, k_pages, v_pages, block_tables, lengths, scale,
                  window=None, k_scales=None, v_scales=None):
    """Launch ``paged_attention`` (``paged_attention_window`` under a
    window) or, with scales, ``paged_attention_quant`` (q in fp32 or bf16,
    pages int8 or e4m3); an ``s > 1`` block counts under the branch's
    ``_block`` name. The split pass's partials go to fp32 scratch
    allocated here."""
    _, kv, page_size, d = k_pages.shape
    b, h, s = q.shape[0], q.shape[1], q.shape[2]
    if d > 128:
        raise NotImplementedError(
            f"paged kernel takes head_dim <= 128, got d={d}")
    quant = k_scales is not None
    if k_pages.dtype != v_pages.dtype or (
            not quant and q.dtype != k_pages.dtype):
        raise TypeError(f"q and page dtypes differ: {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    ln = lengths.to(torch.int32).contiguous()
    _build.check_cuda(q, k_pages, v_pages, bt, ln)
    out = torch.empty_like(q)
    if b == 0:
        return out
    plan = paged_split_plan(page_size, d, s, h // kv, int(window or 0),
                            bt.shape[1])
    part = torch.empty(b * kv * plan.groups * plan.grid_splits
                       * plan.block_rows * (d + 2), dtype=torch.float32,
                       device=q.device)
    P, I, F = _build.P, _build.I, _build.F
    shape = (b, h, kv, s, page_size, d, bt.shape[1], float(scale),
             int(window or 0), plan.split_pages, plan.grid_splits)
    block = "_block" if s > 1 else ""
    if quant:
        ks = k_scales.float().contiguous()
        vs = v_scales.float().contiguous()
        _build.check_cuda(q, ks, vs)
        _build.launch(
            "paged_attention_quant" + block, "apex_paged_attention_quant",
            (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, I, I, I,
             I, P),
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            ks.data_ptr(), vs.data_ptr(), bt.data_ptr(), ln.data_ptr(),
            out.data_ptr(), part.data_ptr(), *shape, _build.dtype_code(q),
            _build.dtype_code(k_pages, _build.NARROW_DTYPES),
            _build.stream_of(q))
    else:
        _build.launch(
            ("paged_attention" if window is None
             else "paged_attention_window") + block,
            "apex_paged_attention",
            (P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, I, I, I, P),
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            bt.data_ptr(), ln.data_ptr(), out.data_ptr(), part.data_ptr(),
            *shape, _build.dtype_code(q), _build.stream_of(q))
    return out


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale: Optional[float] = None,
                    window: Optional[int] = None,
                    k_scales=None, v_scales=None):
    """GQA attention of ``s`` queries per slot over a paged KV pool (a
    quantized one with ``k_scales``/``v_scales``). Returns ``(batch, heads,
    s, head_dim)`` in q's dtype."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_pages, v_pages)):
        raise RuntimeError(
            "paged_attention has no backward (decode only, as the reference "
            "kernel): call it under torch.no_grad() or on inputs that do not "
            "require grad")
    _validate(q, k_pages, v_pages, block_tables, lengths, window, k_scales,
              v_scales)
    if scale is None:
        scale = 1.0 / (k_pages.shape[3] ** 0.5)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         lengths, scale=scale, window=window,
                                         k_scales=k_scales, v_scales=v_scales)
    return _paged_kernel(q, k_pages, v_pages, block_tables, lengths, scale,
                         window, k_scales, v_scales)
