"""LayerNorm and RMSNorm, forward and backward: the Hopper kernels
``csrc/layer_norm_fwd.cu`` and ``csrc/layer_norm_bwd.cu`` and their plain
PyTorch twins.

Counterpart of ``apex_tpu/ops/layer_norm.py`` (``_ln_fwd_kernel``,
``_ln_bwd_kernel``, ``_fused_norm``, ``layer_norm``, ``rms_norm``) in all
its branches: affine or not, LayerNorm or RMSNorm (``rms=True``: mean 0,
``var = mean(x^2)``, ``y = x * rstd * w``), and ``memory_efficient``
(the forward saves its output y instead of x; the backward recovers xhat as
``(y - b) / w``). Semantics: fp32 statistics whatever x's dtype, fp32
weight and bias over an fp32 or bf16 x (the reference's "mixed" variants),
output in x's dtype; the backward returns dx in dy's dtype and fp32
dgamma/dbeta summed over all rows. ``layer_norm`` and ``rms_norm`` are
differentiable through ``_FusedLayerNormFunction``, whose backward is the
backward kernel through one wrapper, ``layer_norm_bwd``, over one twin. Each
branch a main path must be shown to take has its own launch name:
``layer_norm_bwd`` (LayerNorm, saved x), ``rms_norm_bwd`` (RMSNorm, saved
x), ``layer_norm_bwd_from_y`` (``memory_efficient``, either norm).

A tensor on the CPU takes the twins; a CUDA tensor always takes the kernels.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from apex_tpu_torch.ops import _build


def _check_params(cols: int, weight, bias) -> None:
    """A weight or bias must be one value per column: the kernels read
    ``cols`` of each, and would read past a shorter one."""
    for label, t in (("weight", weight), ("bias", bias)):
        if t is not None and tuple(t.shape) != (cols,):
            raise ValueError(f"{label} of shape {tuple(t.shape)} does not "
                             f"fit the normalized width {cols}")


def layer_norm_fwd_reference(x2d: torch.Tensor, weight=None, bias=None,
                             eps: float = 1e-5):
    """Plain twin of the kernel: ``(y, mean, rstd)`` for a 2-D ``x``, with
    ``mean``/``rstd`` fp32 of shape ``(rows, 1)``."""
    xf = x2d.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd
    if weight is not None:
        y = y * weight.float()
        if bias is not None:
            y = y + bias.float()
    return y.to(x2d.dtype), mean, rstd


def rms_norm_fwd_reference(x2d: torch.Tensor, weight=None,
                           eps: float = 1e-5):
    """Plain twin of the kernel's RMS branch: ``(y, mean, rstd)`` for a 2-D
    ``x``, ``mean`` zeros and ``rstd = rsqrt(mean(x^2) + eps)``, both fp32
    ``(rows, 1)``; ``y = x * rstd * w`` in fp32, cast to x's dtype."""
    xf = x2d.float()
    mean = torch.zeros((x2d.shape[0], 1), dtype=torch.float32,
                       device=x2d.device)
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    y = xf * rstd
    if weight is not None:
        y = y * weight.float()
    return y.to(x2d.dtype), mean, rstd


#: the forward kernel's tiling (``csrc/layer_norm_fwd.cu``): blocks of 256
#: threads holding 256 / team teams of a row each; a team holds its row in
#: registers, this many 16-byte slots a thread by element size (bf16 4, fp32
#: 8: 32 values), up to ``NORM_FWD_MAX_SLOTS`` (64 bf16 values) once the
#: team is the whole block; a row wider than that is walked in passes of
#: ``NORM_FWD_SLOTS`` slots a thread
NORM_FWD_THREADS = 256
NORM_FWD_SLOTS = {2: 4, 4: 8}
NORM_FWD_MAX_SLOTS = {2: 8, 4: 8}


def norm_fwd_plan(cols: int, elt: int):
    """The forward kernel's tile choice for rows of ``cols`` ``elt``-byte
    elements: ``dict(team, slots, passes)``. A row's team is the fewest
    threads (a power of two from 32 to 256) that hold its 16-byte slots at
    ``NORM_FWD_SLOTS`` a thread, ``slots`` the slots a thread then holds
    (at most ``NORM_FWD_MAX_SLOTS`` in a team of 256); a wider row is walked
    in ``passes``. A function of the width and the element size alone,
    never of the row count: a row's bits are the same alone or in a
    batch."""
    pack = 16 // elt
    n_slots = max(1, -(-cols // pack))
    want = NORM_FWD_SLOTS[elt]
    team = 32
    while team * want < n_slots and team < NORM_FWD_THREADS:
        team *= 2
    slots, passes = -(-n_slots // team), 1
    if slots > NORM_FWD_MAX_SLOTS[elt]:
        slots, passes = want, -(-n_slots // (team * want))
    return dict(team=team, slots=slots, passes=passes)


def norm_fwd_grid(rows: int, team: int, sms: int):
    """The forward's launch for ``rows`` rows of teams of ``team``
    threads on a card of ``sms`` SMs: ``dict(teams, hoist)``. ``teams``
    rows a block: a full block of 256 threads once the rows give every SM
    one, fewer while they do not, so that a decode step's few rows spread
    over as many SMs. ``hoist`` while the grid is at most a block an SM: a
    row's latency is then the time, and a thread holding at most 32 values
    reads w and b with x (measured: 8 x 768 fp32 0.00348 ms against
    0.00431, 4096 x 1024 bf16 0.00809 against 0.00684, `NVIDIA H100 80GB
    HBM3, 700.00 W`, ``kernel_ab.py``). Only the launch depends on the row
    count: a team computes its row alike in any block, hoisted or not."""
    per_block = NORM_FWD_THREADS // team
    return dict(teams=max(1, min(per_block, -(-rows // sms))),
                hoist=rows <= sms * per_block)


@functools.lru_cache(maxsize=1024)
def _norm_fwd_launch(rows: int, cols: int, elt: int, sms: int):
    """``(team, slots, passes, teams, hoist)`` of the forward's launch,
    worked out once per shape and card: the plan and grid above."""
    plan = norm_fwd_plan(cols, elt)
    grid = norm_fwd_grid(rows, plan["team"], sms)
    return (plan["team"], plan["slots"], plan["passes"], grid["teams"],
            int(grid["hoist"]))


def _norm_fwd_kernel(name: str, x2d, weight, bias, eps: float, rms: bool):
    rows, cols = x2d.shape
    x2d = x2d.contiguous()
    w = weight.float().contiguous() if weight is not None else None
    b = bias.float().contiguous() if bias is not None else None
    y = torch.empty_like(x2d)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    _build.check_cuda(*[t for t in (x2d, w, b) if t is not None])
    elt = x2d.element_size()
    # 16-byte loads and stores: whole slots in every row, every base aligned
    # (y is a fresh allocation, aligned far past 16 bytes)
    vec = int(cols % (16 // elt) == 0
              and all(t.data_ptr() % 16 == 0
                      for t in (x2d, w, b) if t is not None))
    P, I, F = _build.P, _build.I, _build.F
    _build.launch(
        name, "apex_layer_norm_fwd",
        (P, P, P, P, P, P, I, I, F, I, I, I, I, I, I, I, I, P),
        x2d.data_ptr(), w.data_ptr() if w is not None else None,
        b.data_ptr() if b is not None else None, y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), rows, cols, float(eps), int(rms),
        _build.dtype_code(x2d),
        *_norm_fwd_launch(rows, cols, elt, _sm_count(x2d.device)), vec,
        _build.stream_of(x2d))
    return y, mean, rstd


def layer_norm_fwd(x2d: torch.Tensor, weight=None, bias=None,
                   eps: float = 1e-5):
    """``(y, mean, rstd)`` for a 2-D ``x``: the kernel on a CUDA tensor, the
    twin on a CPU one."""
    _check_params(x2d.shape[-1], weight, bias)
    if x2d.device.type == "cpu":
        return layer_norm_fwd_reference(x2d, weight, bias, eps)
    return _norm_fwd_kernel("layer_norm_fwd", x2d, weight, bias, eps, False)


def rms_norm_fwd(x2d: torch.Tensor, weight=None, eps: float = 1e-5):
    """RMSNorm's ``(y, mean, rstd)`` for a 2-D ``x``: the kernel's RMS branch
    on a CUDA tensor, the twin on a CPU one."""
    _check_params(x2d.shape[-1], weight, None)
    if x2d.device.type == "cpu":
        return rms_norm_fwd_reference(x2d, weight, eps)
    return _norm_fwd_kernel("rms_norm_fwd", x2d, weight, None, eps, True)


def layer_norm_bwd_reference(dy2d: torch.Tensor, src2d: torch.Tensor,
                             mean: Optional[torch.Tensor],
                             rstd: torch.Tensor, weight=None, bias=None,
                             rms: bool = False, from_y: bool = False):
    """Plain twin of the backward kernel in every branch: ``(dx, dw, db)``
    for 2-D ``dy`` and ``src`` and the forward's fp32 ``(rows, 1)``
    ``mean``/``rstd``. ``src`` is x, and xhat is ``(x - mean) * rstd``
    (``x * rstd`` under ``rms``, where ``mean`` is not read); under
    ``from_y`` it is the forward's output y, and xhat is ``(y - b) / w``
    (``y`` without a weight; ``bias`` is read only here). fp32 math, ``dx``
    in dy's dtype, ``dw = sum(dy * xhat)`` and ``db = sum(dy)`` fp32 over
    all rows; both None without a weight, and ``db`` None under ``rms``."""
    dy = dy2d.float()
    src = src2d.float()
    if from_y:
        xhat = src
        if weight is not None:
            shift = bias.float() if bias is not None else 0.0
            xhat = (src - shift) / weight.float()
    else:
        xhat = src * rstd if rms else (src - mean) * rstd
    wdy = dy * weight.float() if weight is not None else dy
    c1 = (xhat * wdy).mean(dim=-1, keepdim=True)
    c2 = 0.0 if rms else wdy.mean(dim=-1, keepdim=True)
    dx = ((wdy - xhat * c1 - c2) * rstd).to(dy2d.dtype)
    if weight is None:
        return dx, None, None
    return dx, (dy * xhat).sum(dim=0), None if rms else dy.sum(dim=0)


#: the backward kernel's tiling (``csrc/layer_norm_bwd.cu``): blocks of 256
#: threads holding 256 / team teams of a row each; at most this many
#: 16-byte slots of a row a thread keeps in registers, by element size (bf16
#: 2, fp32 4: 16 values, where the accumulators still fit 128 registers),
#: and 2 a pass over a row wider than that; at most two blocks on each SM
#: (the H100 has 132), so that the grid is co-resident for the barrier
#: behind which the kernel sums dgamma/dbeta (one launch). A row walked in
#: passes keeps dgamma/dbeta's accumulators, 8 bytes a column, in shared
#: memory where a block may take them (the H100's 227 KB a block, less the
#: kernel's own arrays), one block an SM where two would not fit its 228 KB,
#: and in device memory past that
NORM_BWD_THREADS = 256
NORM_BWD_MAX_SLOTS = {2: 2, 4: 4}
NORM_BWD_WIDE_SLOTS = 2
NORM_BWD_BLOCKS_PER_SM = 2
NORM_BWD_SMS = 132
NORM_BWD_ACC_SMEM = 220 * 1024
NORM_BWD_ACC_SMEM_TWO = 108 * 1024


def norm_bwd_plan(rows: int, cols: int, elt: int, sms: int = NORM_BWD_SMS):
    """The backward kernel's tile choice for a ``(rows, cols)`` input of
    ``elt``-byte elements on a card of ``sms`` SMs: ``dict(team, slots,
    passes, teams, blocks)``. A row's team is the fewest threads (a
    power of two from 32 to 256) that hold its 16-byte slots at
    ``NORM_BWD_MAX_SLOTS`` a thread, ``slots`` the slots a thread then
    holds; a row wider than 256 threads hold is walked in ``passes``. The
    rows are dealt to ``blocks * teams`` teams in turn, a team for every
    row up to two blocks an SM. A function of the shape (and the card)
    alone, so dgamma/dbeta are summed in one order at every call.
    ``acc_smem``: a row walked in passes keeps its accumulators in shared
    memory (``blocks`` then leaves them room)."""
    pack = 16 // elt
    n_slots = -(-cols // pack)
    cap = NORM_BWD_MAX_SLOTS[elt]
    team = 32
    while team * cap < n_slots and team < NORM_BWD_THREADS:
        team *= 2
    slots, passes = -(-n_slots // team), 1
    if slots > cap:
        passes, slots = -(-n_slots // (team * NORM_BWD_WIDE_SLOTS)), \
            NORM_BWD_WIDE_SLOTS
    teams = NORM_BWD_THREADS // team
    acc_smem = passes > 1 and 8 * cols <= NORM_BWD_ACC_SMEM
    per_sm = NORM_BWD_BLOCKS_PER_SM
    if acc_smem and 8 * cols > NORM_BWD_ACC_SMEM_TWO:
        per_sm = 1
    blocks = min(max(1, -(-rows // teams)), per_sm * sms)
    return dict(team=team, slots=slots, passes=passes, teams=teams,
                blocks=blocks, acc_smem=acc_smem)


_SMS = {}


def _sm_count(device) -> int:
    """The SMs of a CUDA device, once per device."""
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def _norm_bwd_kernel(dy2d, src2d, mean, rstd, weight, bias, rms: bool,
                     from_y: bool):
    rows, cols = src2d.shape
    if tuple(dy2d.shape) != (rows, cols):
        raise ValueError(f"dy {tuple(dy2d.shape)} != x {(rows, cols)}")
    if dy2d.dtype != src2d.dtype:
        raise TypeError(f"dy and x dtypes differ: {dy2d.dtype}, "
                        f"{src2d.dtype}")
    name = ("layer_norm_bwd_from_y" if from_y
            else "rms_norm_bwd" if rms else "layer_norm_bwd")
    dy2d, src2d = dy2d.contiguous(), src2d.contiguous()
    rstd = rstd.float().contiguous()
    mean = mean.float().contiguous() if not (rms or from_y) else None
    w = weight.float().contiguous() if weight is not None else None
    b = bias.float().contiguous() if (bias is not None and from_y) else None
    dtype = _build.dtype_code(dy2d)
    dx = torch.empty_like(dy2d)
    plan = norm_bwd_plan(rows, cols, dy2d.element_size(),
                         _sm_count(dy2d.device))
    dw = db = part = None
    if w is not None:
        dw = torch.empty(cols, dtype=torch.float32, device=dy2d.device)
        if not rms:
            db = torch.empty(cols, dtype=torch.float32, device=dy2d.device)
        part = torch.empty(2 * plan["blocks"] * cols, dtype=torch.float32,
                           device=dy2d.device)
    _build.check_cuda(*[t for t in (dy2d, src2d, mean, rstd, w, b)
                        if t is not None])
    # 16-byte loads: whole slots in every row, every row base aligned
    vec = int(cols % (16 // dy2d.element_size()) == 0
              and all(t.data_ptr() % 16 == 0
                      for t in (dy2d, src2d, dx, w, b) if t is not None))

    def ptr(t):
        return t.data_ptr() if t is not None else None

    P, I = _build.P, _build.I
    _build.launch(
        name, "apex_layer_norm_bwd",
        (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, P),
        dy2d.data_ptr(), src2d.data_ptr(), ptr(mean), rstd.data_ptr(),
        ptr(w), ptr(b), dx.data_ptr(), ptr(dw), ptr(db), ptr(part), rows,
        cols, int(rms), int(from_y), dtype, plan["team"], plan["slots"],
        plan["passes"], plan["blocks"], vec, int(plan["acc_smem"]),
        _build.stream_of(dy2d))
    return dx, dw, db


def layer_norm_bwd(dy2d: torch.Tensor, src2d: torch.Tensor,
                   mean: Optional[torch.Tensor], rstd: torch.Tensor,
                   weight=None, bias=None, rms: bool = False,
                   from_y: bool = False):
    """``(dx, dw, db)`` of :func:`layer_norm_bwd_reference`'s branches: the
    kernel on a CUDA tensor, the twin on a CPU one. The kernel launches
    under its branch's name: ``layer_norm_bwd`` (LayerNorm, saved x),
    ``rms_norm_bwd`` (``rms``, saved x) or ``layer_norm_bwd_from_y``
    (``from_y``, either norm)."""
    _check_params(src2d.shape[-1], weight, bias)
    if dy2d.device.type == "cpu":
        return layer_norm_bwd_reference(dy2d, src2d, mean, rstd, weight,
                                        bias, rms, from_y)
    return _norm_bwd_kernel(dy2d, src2d, mean, rstd, weight, bias, rms,
                            from_y)


class _FusedLayerNormFunction(torch.autograd.Function):
    """Autograd over the norm kernels, LayerNorm or (``rms``) RMSNorm.
    Saves what the reference's ``_norm_impl`` saves: ``x2d``, ``mean``
    (None under ``rms``) and ``rstd``, or under ``memory_efficient`` the
    output ``y`` and ``rstd``, whose backward recovers xhat from ``y``;
    and the weight and bias."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, rms, memory_efficient):
        cols = x.shape[-1]
        x2d = x.reshape(-1, cols)
        if rms:
            y, mean, rstd = rms_norm_fwd(x2d, weight, eps)
        else:
            y, mean, rstd = layer_norm_fwd(x2d, weight, bias, eps)
        if memory_efficient:
            ctx.save_for_backward(y, None, rstd, weight, bias)
        else:
            ctx.save_for_backward(x2d, None if rms else mean, rstd, weight,
                                  None)
        ctx.rms, ctx.memory_efficient = rms, memory_efficient
        ctx.has_bias = bias is not None
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        src, mean, rstd, weight, bias = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(dy.reshape(src.shape), src, mean, rstd,
                                    weight, bias, ctx.rms,
                                    ctx.memory_efficient)
        if weight is not None:
            dw = dw.to(weight.dtype)
            db = db.to(weight.dtype) if ctx.has_bias else None
        return dx.reshape(dy.shape), dw, db, None, None, None


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
               memory_efficient: bool = False, rms: bool = False):
    """Fused LayerNorm over the last dimension, differentiable in x, weight
    and bias. ``memory_efficient`` saves the output instead of x, and the
    backward recovers xhat from it (precise only with a weight well away
    from 0, as the reference warns); ``rms`` is :func:`rms_norm`."""
    if rms:
        if bias is not None:
            raise ValueError("RMSNorm takes no bias")
        return rms_norm(x, weight, eps, memory_efficient)
    if weight is None and bias is not None:
        raise ValueError("layer_norm: bias requires weight (the reference "
                         "API has no bias-only variant)")
    return _FusedLayerNormFunction.apply(x, weight, bias, float(eps), False,
                                         bool(memory_efficient))


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-5, memory_efficient: bool = False):
    """Fused RMSNorm over the last dimension (the reference's ``rms_norm``),
    output in x's dtype, differentiable in x and weight through the RMS
    branches of the forward and backward kernels."""
    return _FusedLayerNormFunction.apply(x, weight, None, float(eps), True,
                                         bool(memory_efficient))
