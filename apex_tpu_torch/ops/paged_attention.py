"""Paged-attention decode: the Hopper kernel ``csrc/paged_attention.cu``
and its plain PyTorch twin.

Counterpart of ``apex_tpu/ops/paged_attention.py`` (``_paged_kernel``,
``paged_attention``, ``paged_attention_reference``) in its unquantized
branch at ``s = 1`` with no window. The pool is ``(num_pages, kv_heads,
page_size, head_dim)`` and is read through the int32 ``(batch, max_pages)``
block table; slot ``b``'s query sits at position ``lengths[b] - 1`` and sees
every position below ``lengths[b]``. Entries past a slot's length must hold
a valid page id (page 0, the pool's null page) and are never read. A slot
of length 0 outputs exactly 0. Decode only: it has no backward, as the
reference kernel has no VJP, so a call under autograd on an input that
requires grad raises on either device.

A tensor on the CPU takes the twin; a CUDA tensor always takes the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import _build


def _validate(q, k_pages, v_pages, block_tables, lengths, window, k_scales,
              v_scales):
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "quantized KV pages (k_scales/v_scales) are not ported yet "
            "(ROADMAP queue B item 6: quantized paged attention)")
    if window is not None:
        raise NotImplementedError(
            "sliding-window paged attention is not ported yet (ROADMAP "
            "queue B item 7: window and s>1 paged attention)")
    if q.ndim != 4:
        raise ValueError(f"q must be (batch, heads, s, d), got "
                         f"{tuple(q.shape)}")
    if q.shape[2] != 1:
        raise NotImplementedError(
            f"paged attention takes s=1 decode queries in this port, got "
            f"s={q.shape[2]} (ROADMAP queue B item 7: window and s>1 paged "
            f"attention)")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} != v_pages "
                         f"{tuple(v_pages.shape)}")
    _, kv, page_size, d = k_pages.shape
    b, h, _, qd = q.shape
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
    ``(b, kv, max_pages * page_size, d)`` view and run dense masked GQA
    attention with fp32 scores."""
    _validate(q, k_pages, v_pages, block_tables, lengths, window, k_scales,
              v_scales)
    _, kv, page_size, d = k_pages.shape
    b, h = q.shape[0], q.shape[1]
    rep = h // kv
    max_pages = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    bt = block_tables.long()

    def contig(pages):
        g = pages[bt].float()                        # (b, mp, kv, ps, d)
        return g.transpose(1, 2).reshape(b, kv, max_pages * page_size, d)

    k, v = contig(k_pages), contig(v_pages)
    qf = q.reshape(b, kv, rep, 1, d).float()
    s = torch.einsum("bkrsd,bktd->bkrst", qf, k) * scale
    pos = torch.arange(max_pages * page_size, device=q.device)
    mask = pos[None, :] < lengths.long()[:, None]    # (b, T)
    mask = mask[:, None, None, None, :]
    s = torch.where(mask, s, float("-inf"))
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    ctx = torch.einsum("bkrst,bktd->bkrsd", p, v)
    return ctx.reshape(b, h, 1, d).to(q.dtype)


def _paged_kernel(q, k_pages, v_pages, block_tables, lengths, scale):
    _, kv, page_size, d = k_pages.shape
    b, h = q.shape[0], q.shape[1]
    if d > 128 or h // kv > 16:
        raise NotImplementedError(
            f"paged kernel takes head_dim <= 128 and <= 16 query heads per "
            f"kv head, got d={d}, rep={h // kv}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"q and page dtypes differ: {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    ln = lengths.to(torch.int32).contiguous()
    _build.check_cuda(q, k_pages, v_pages, bt, ln)
    out = torch.empty_like(q)
    if b == 0:
        return out
    P, I, F = _build.P, _build.I, _build.F
    _build.launch(
        "paged_attention", "apex_paged_attention",
        (P, P, P, P, P, P, I, I, I, I, I, I, F, I, P),
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), bt.data_ptr(),
        ln.data_ptr(), out.data_ptr(), b, h, kv, page_size, d, bt.shape[1],
        float(scale), _build.dtype_code(q), _build.stream_of(q))
    return out


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale: Optional[float] = None,
                    window: Optional[int] = None,
                    k_scales=None, v_scales=None):
    """Decode GQA attention over a paged KV pool. Returns ``(batch, heads,
    1, head_dim)`` in q's dtype."""
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
                                         lengths, scale=scale)
    return _paged_kernel(q, k_pages, v_pages, block_tables, lengths, scale)
