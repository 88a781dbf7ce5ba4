"""NHWC GroupNorm with an optional fused SiLU, forward and backward: the
Hopper kernels ``csrc/group_norm.cu`` and their plain PyTorch twins.

Counterpart of ``apex_tpu/ops/group_norm.py`` (``group_norm_reference``,
``_gn_fwd_kernel``, ``_gn_bwd_kernel``, ``_gn_bwd_jnp``,
``group_norm_nhwc``). On ``x`` of shape ``(n, h, w, c)`` in ``g`` groups of
``c / g`` channels, per (sample, group) slab, in fp32 whatever x's dtype:
``mean``, the two-pass variance ``mean((x - mean)^2)``, ``rstd =
rsqrt(var + eps)``; ``y = (x - mean) rstd w + b`` (no affine transform
when ``weight`` is None), then ``y sigmoid(y)`` under ``act="silu"``, in
x's dtype. The backward, from the forward's fp32 ``(n, g)`` mean and rstd,
is ``_gn_bwd_jnp``'s: the SiLU derivative recomputed from ``xhat w + b``,
``dw = sum(d xhat)`` and ``db = sum(d)`` over the samples and rows (in the
weight's dtype), ``dx = rstd (dw_ - sum(dw_)/m - xhat sum(dw_ xhat)/m)``
with ``dw_ = d w`` (x's dtype). fp32, bf16 and fp16.

The reference runs its Pallas kernels only where ``cg % 128 == 0`` and the
slab fits VMEM (``_kernel_eligible``, ``_bwd_kernel_eligible``) and the
two-pass jnp formula elsewhere, which at every Stable Diffusion shape (cg of
10, 20 or 40) is everywhere. Those gates are TPU layout and VMEM budgets:
on the card every shape takes the kernels, with the two-pass variance. At
``cg % 128 == 0`` the reference kernel's one-pass ``E[x^2] - mean^2``
agrees with it within fp32 rounding for data of moderate mean.

``group_norm_nhwc`` is differentiable in x, weight and bias through
``_GroupNormFunction``, which saves x, the weight and bias, and the mean
and rstd. A tensor on the CPU takes the twins; a CUDA tensor always takes
the kernels.

On the card each call is two launches, counted once under its name: the
kernels tile NHWC as it lies (whole rows, 8 channels a thread) and split
a sample's rows into chunks, one block each, whose partial statistics
the sample's last block of the first launch merges in a fixed order
(``csrc/group_norm.cu``). The cut is
:func:`group_norm_split_plan`'s, a function of ``(hw, c, cg)`` and the
element size alone, never of the batch: a sample's y, mean, rstd and dx
have the same bits alone and in a batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.ops import _build

#: channels a thread of the kernels holds: one 16-byte load of bf16 or
#: fp16, two of fp32
VEC = 8
#: the threads a block aims at (whole warps of thread rows x vector
#: columns), the most vector columns a block takes (a wider row is cut
#: into tiles) and the most thread rows
BLOCK_THREADS = 320
MAX_COL_THREADS = 320
MAX_THREAD_ROWS = 32
#: chunks of a sample the plan aims at, forward and backward (32 and 16:
#: the best of 4-32 at Stable Diffusion's shapes on an H100,
#: ``group_norm_sweep.py``), and the most rows a thread walks, by element
#: size: 256 bytes, in steps with the next step's loads in flight
#: (``csrc/group_norm.cu``'s kStep, kBwdStep)
MIN_CHUNKS = {False: 32, True: 16}
MAX_ROWS = {2: 16, 4: 8}


class GroupNormSplitPlan(NamedTuple):
    """The kernels' cut of a call (``csrc/group_norm.cu``'s ``Plan``)."""
    cols: int          # vector columns of a row, ceil(c / VEC)
    col_threads: int   # vector columns of a tile, one thread each
    tiles: int         # column tiles of a row
    thread_rows: int   # thread row r walks rows r, r + thread_rows, ...;
    #                    a power of 2, the lanes of a column
    threads: int       # a block: thread_rows x col_threads, whole warps
    rows: int          # rows a thread walks
    chunk_rows: int    # rows of a chunk (a block's rows): thread_rows x rows
    chunks: int        # chunks of a sample


def group_norm_split_plan(hw: int, c: int, cg: int, elt: int,
                          backward: bool = False) -> GroupNormSplitPlan:
    """The kernels' cut of a ``(n, hw, c)`` call in groups of ``cg``
    channels of ``elt`` bytes, forward or ``backward``, from the shape
    alone: never the batch, so a sample's statistics, and so its bits, do
    not depend on n. A block holds ``thread_rows`` rows of whole vector
    columns (a power of 2: the most up to ``BLOCK_THREADS`` threads; a
    column's thread rows are neighbouring lanes of one warp, summed by a
    xor butterfly), each thread ``rows`` rows: as many as give a
    sample ``MIN_CHUNKS[backward]`` chunks, between 1 and ``MAX_ROWS``.
    ``cg`` does not change the cut: any group is folded from
    its channels."""
    if hw <= 0 or c <= 0 or cg <= 0 or c % cg or elt not in (2, 4):
        raise ValueError(f"no GroupNorm plan for hw={hw}, c={c}, cg={cg}, "
                         f"elt={elt}")
    cols = -(-c // VEC)
    col_threads = min(cols, MAX_COL_THREADS)
    tiles = -(-cols // col_threads)
    most = max(1, min(MAX_THREAD_ROWS, BLOCK_THREADS // col_threads))
    thread_rows = 1 << (most.bit_length() - 1)
    threads = -(-thread_rows * col_threads // 32) * 32
    rows = max(1, min(MAX_ROWS[elt],
                      hw // (thread_rows * MIN_CHUNKS[backward])))
    chunk_rows = thread_rows * rows
    return GroupNormSplitPlan(cols, col_threads, tiles, thread_rows, threads,
                              rows, chunk_rows, -(-hw // chunk_rows))


def tile_groups(plan: GroupNormSplitPlan, c: int, cg: int, q: int) -> range:
    """The groups whose channels tile ``q`` of a row holds (the kernels'
    ``g_lo .. g_hi``)."""
    lo = q * plan.col_threads * VEC
    hi = min(c, lo + plan.col_threads * VEC)
    return range(lo // cg, (hi - 1) // cg + 1)


def group_tiles(plan: GroupNormSplitPlan, cg: int, g: int) -> range:
    """The tiles that hold group ``g``'s channels (the kernels'
    ``group_tiles``)."""
    span = plan.col_threads * VEC
    return range(g * cg // span, ((g + 1) * cg - 1) // span + 1)


def ragged(c: int, *tensors: torch.Tensor) -> bool:
    """Whether a call takes the kernels' element loads: a row that is no
    whole vectors, or a tensor off a 16-byte boundary."""
    return c % VEC != 0 or any(t.data_ptr() % 16 for t in tensors)


def _check(x: torch.Tensor, weight, bias, num_groups: int,
           act: Optional[str]) -> None:
    if act not in (None, "", "silu"):
        raise ValueError(f"unsupported act {act!r} (reference: silu only)")
    if x.ndim != 4:
        raise ValueError(f"expected NHWC input (n, h, w, c), got "
                         f"{tuple(x.shape)}")
    c = x.shape[-1]
    if num_groups <= 0 or c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups "
                         f"{num_groups}")
    if (weight is None) != (bias is None):
        raise ValueError("weight and bias go together (no affine: both "
                         "None)")
    for label, t in (("weight", weight), ("bias", bias)):
        if t is not None and tuple(t.shape) != (c,):
            raise ValueError(f"{label} of shape {tuple(t.shape)} does not "
                             f"fit {c} channels")


def _slabs(t: torch.Tensor, g: int) -> torch.Tensor:
    n, h, w, c = t.shape
    return t.float().reshape(n, h * w, g, c // g)


def group_norm_fwd_reference(x: torch.Tensor, weight, bias, num_groups: int,
                             eps: float = 1e-5, act: Optional[str] = None):
    """Plain twin of the forward kernel: ``(y, mean, rstd)``, y in x's
    dtype, mean and rstd fp32 ``(n, g)``; y is ``group_norm_reference``'s
    step by step."""
    _check(x, weight, bias, num_groups, act)
    n, h, w, c = x.shape
    x32 = _slabs(x, num_groups)
    mean = x32.mean(dim=(1, 3), keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = ((x32 - mean) * rstd).reshape(n, h, w, c)
    if weight is not None:
        y = y * weight.float() + bias.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    return (y.to(x.dtype), mean.reshape(n, num_groups),
            rstd.reshape(n, num_groups))


def group_norm_reference(x: torch.Tensor, weight, bias, num_groups: int,
                         eps: float = 1e-5, act: Optional[str] = None):
    """Plain GroupNorm (fp32 statistics), the reference's
    ``group_norm_reference``: y in x's dtype."""
    return group_norm_fwd_reference(x, weight, bias, num_groups, eps, act)[0]


def group_norm_bwd_reference(x: torch.Tensor, dy: torch.Tensor, weight,
                             bias, mean: torch.Tensor, rstd: torch.Tensor,
                             num_groups: int, act: Optional[str] = None):
    """Plain twin of the backward kernel, the reference's ``_gn_bwd_jnp``
    given the forward's statistics: ``(dx, dw, db)``, dx in x's dtype, dw
    and db in the weight's and bias's (None without affine)."""
    _check(x, weight, bias, num_groups, act)
    n, h, w, c = x.shape
    g = num_groups
    cg = c // g
    mean = mean.float().reshape(n, 1, g, 1)
    rstd = rstd.float().reshape(n, 1, g, 1)
    xhat = (_slabs(x, g) - mean) * rstd
    dy32 = _slabs(dy, g)
    affine = weight is not None
    if act == "silu":
        wv = weight.float().reshape(1, 1, g, cg) if affine else 1.0
        bv = bias.float().reshape(1, 1, g, cg) if affine else 0.0
        y_pre = xhat * wv + bv
        sig = torch.sigmoid(y_pre)
        dy32 = dy32 * (sig * (1.0 + y_pre * (1.0 - sig)))
    if affine:
        dw = (dy32 * xhat).sum(dim=(0, 1)).reshape(c).to(weight.dtype)
        db = dy32.sum(dim=(0, 1)).reshape(c).to(bias.dtype)
        dyw = dy32 * weight.float().reshape(1, 1, g, cg)
    else:
        dw = db = None
        dyw = dy32
    m = h * w * cg
    sum_dy = dyw.sum(dim=(1, 3), keepdim=True)
    sum_dy_xhat = (dyw * xhat).sum(dim=(1, 3), keepdim=True)
    dx = rstd * (dyw - sum_dy / m - xhat * sum_dy_xhat / m)
    return dx.reshape(n, h, w, c).to(x.dtype), dw, db


def _affine(weight, bias):
    if weight is None:
        return None, None
    return weight.float().contiguous(), bias.float().contiguous()


#: per (device, stream): int32 counts a sample, zero between calls (each
#: kernel's last block of a sample sets its count back to zero)
_counts: dict = {}


def _sample_counts(x: torch.Tensor, n: int) -> torch.Tensor:
    """The kernels' per-sample block counts on x's device and stream (one
    buffer a stream: calls on one stream run in order)."""
    key = (x.device, _build.stream_of(x))
    buf = _counts.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=x.device)
        _counts[key] = buf
    return buf


def _plan_args(plan: GroupNormSplitPlan):
    return (plan.col_threads, plan.tiles, plan.thread_rows, plan.threads,
            plan.rows, plan.chunk_rows, plan.chunks)


def _launch_shape(x: torch.Tensor, num_groups: int):
    n, h, w_, c = x.shape
    if n > 65535:
        raise ValueError(f"the GroupNorm kernels take at most 65535 "
                         f"samples a call, got {n}")
    hw, cg = h * w_, c // num_groups
    return n, hw, c, cg


def group_norm_fwd(x: torch.Tensor, weight, bias, num_groups: int,
                   eps: float = 1e-5, act: Optional[str] = None):
    """``(y, mean, rstd)``: the kernels on a CUDA tensor (two launches, one
    count), the twin on a CPU one."""
    if x.device.type == "cpu":
        return group_norm_fwd_reference(x, weight, bias, num_groups, eps, act)
    _check(x, weight, bias, num_groups, act)
    n, hw, c, cg = _launch_shape(x, num_groups)
    x = x.contiguous()
    w, b = _affine(weight, bias)
    y = torch.empty_like(x)
    mean = torch.empty((n, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    _build.check_cuda(*[t for t in (x, w, b) if t is not None])
    code = _build.dtype_code(x, _build.HALF_DTYPES)
    if n == 0 or hw == 0:
        return y, mean, rstd
    plan = group_norm_split_plan(hw, c, cg, x.element_size())
    part = torch.empty(n * plan.chunks * plan.tiles * num_groups * 3,
                       dtype=torch.float32, device=x.device)
    P, I, F = _build.P, _build.I, _build.F
    _build.launch("group_norm_fwd", "apex_group_norm_fwd",
                  (P,) * 8 + (I,) * 4 + (F,) + (I,) * 10 + (P,),
                  x.data_ptr(), w.data_ptr() if w is not None else None,
                  b.data_ptr() if b is not None else None, y.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), part.data_ptr(),
                  _sample_counts(x, n).data_ptr(), n, hw, c, cg, float(eps),
                  int(act == "silu"), code,
                  int(ragged(c, x, y)), *_plan_args(plan),
                  _build.stream_of(x))
    return y, mean, rstd


def group_norm_bwd(x: torch.Tensor, dy: torch.Tensor, weight, bias,
                   mean: torch.Tensor, rstd: torch.Tensor, num_groups: int,
                   act: Optional[str] = None):
    """``(dx, dw, db)``: the kernels on a CUDA tensor (two launches, one
    count; dw and db summed over the samples on the card, in a fixed
    order), the twin on a CPU one."""
    if x.device.type == "cpu":
        return group_norm_bwd_reference(x, dy, weight, bias, mean, rstd,
                                        num_groups, act)
    _check(x, weight, bias, num_groups, act)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match "
                         f"x {tuple(x.shape)} {x.dtype}")
    n, hw, c, cg = _launch_shape(x, num_groups)
    x, dy = x.contiguous(), dy.contiguous()
    mean, rstd = mean.float().contiguous(), rstd.float().contiguous()
    w, b = _affine(weight, bias)
    dx = torch.empty_like(x)
    dw = db = None
    run = n > 0 and hw > 0
    if w is not None:                   # the kernels write every channel
        dw = (torch.empty if run else torch.zeros)(
            c, dtype=torch.float32, device=x.device)
        db = torch.empty_like(dw) if run else torch.zeros_like(dw)
    _build.check_cuda(*[t for t in (x, dy, w, b, mean, rstd) if t is not None])
    code = _build.dtype_code(x, _build.HALF_DTYPES)
    if run:
        plan = group_norm_split_plan(hw, c, cg, x.element_size(),
                                     backward=True)
        blocks = n * plan.chunks
        gpart = torch.empty(blocks * plan.tiles * num_groups * 2,
                            dtype=torch.float32, device=x.device)
        cpart = (torch.empty(2 * blocks * c, dtype=torch.float32,
                             device=x.device) if w is not None else None)
        ab = torch.empty(n * num_groups * 2, dtype=torch.float32,
                         device=x.device)

        def ptr(t):
            return t.data_ptr() if t is not None else None

        P, I = _build.P, _build.I
        _build.launch("group_norm_bwd", "apex_group_norm_bwd",
                      (P,) * 13 + (I,) * 14 + (P,),
                      x.data_ptr(), dy.data_ptr(), ptr(w), ptr(b),
                      mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                      ptr(dw), ptr(db), gpart.data_ptr(), ptr(cpart),
                      ab.data_ptr(), _sample_counts(x, n).data_ptr(), n, hw,
                      c, cg, int(act == "silu"), code,
                      int(ragged(c, x, dy, dx)), *_plan_args(plan),
                      _build.stream_of(x))
    if w is None:
        return dx, None, None
    return dx, dw.to(weight.dtype), db.to(bias.dtype)


class _GroupNormFunction(torch.autograd.Function):
    """Autograd over the two kernels; saves x, the weight and bias, and the
    forward's mean and rstd."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, act):
        y, mean, rstd = group_norm_fwd(x, weight, bias, num_groups, eps, act)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.num_groups, ctx.act = num_groups, act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dw, db = group_norm_bwd(x, dy.to(x.dtype), weight, bias, mean,
                                    rstd, ctx.num_groups, ctx.act)
        return dx, dw, db, None, None, None


def group_norm_nhwc(x: torch.Tensor, weight: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor], num_groups: int,
                    eps: float = 1e-5, act: Optional[str] = None):
    """GroupNorm over an NHWC ``(n, h, w, c)`` tensor; ``act="silu"`` fuses
    the activation; ``weight``/``bias`` None means no affine transform.
    Differentiable in x, weight and bias."""
    return _GroupNormFunction.apply(x, weight, bias, int(num_groups),
                                    float(eps), act or None)
