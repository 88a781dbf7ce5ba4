"""Collectives over a ``torch.distributed`` process group.

Counterpart of ``apex_tpu/collectives.py``: one place that fixes the
conventions of every collective the port issues (tensor-parallel regions,
the vocab-parallel loss, DDP, SyncBatchNorm, the amp overflow agreement).
Where the reference names a mesh axis, these take a process group (None:
the default group).

- ``all_reduce(x, group, op)``: sum, mean or max over the group;
- ``all_gather(x, group, dim)``: the ranks' tensors concatenated along
  ``dim`` in rank order (the reference's tiled gather);
- ``reduce_scatter(x, group, dim)``: the sum over the group, this rank's
  ``1/world`` block along ``dim``;
- ``broadcast(x, group, src)``: the tensor of group rank ``src``.

Each returns a new tensor and leaves ``x`` as it was. A group of one rank
returns ``x`` itself (all_reduce, all_gather, broadcast) or its only
block, as the reference's collectives over an axis of size 1.

Every op hands its tensor to ``torch.distributed`` as it is, on either
backend; none is staged through the host by this module:

============  ==========================================  =============
backend       op                                          path
============  ==========================================  =============
``nccl``      every op                                    direct
``gloo``      every op on CPU tensors                     direct
``gloo``      all_reduce, all_gather, reduce_scatter,     direct
              broadcast on CUDA tensors
============  ==========================================  =============

Gloo takes those four ops on CUDA tensors (torch 2.11 on an H100
computed each right with two ranks on one card) and copies them through
host memory itself. Gloo's point-to-point ``send``/``recv`` of a CUDA
tensor fails ("Bad address"): no op here uses it. :func:`timing`
collects the calls and host seconds of each op while it is open (the
host blocked in the op: under gloo its copies of CUDA tensors and the
wait for the peers).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
import torch.distributed as dist

#: ``{op: [calls, seconds]}`` while a :func:`timing` context is open
_TIMING: Optional[dict] = None


def world_size(group=None) -> int:
    """Ranks in ``group``; 1 without an initialized ``torch.distributed``."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 without ``torch.distributed``."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def backend(group=None) -> Optional[str]:
    """The group's backend name (``"gloo"``, ``"nccl"``), or None without
    ``torch.distributed``."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return str(dist.get_backend(group))


@contextlib.contextmanager
def timing():
    """Context: yields a dict that collects ``{op: [calls, seconds]}`` of
    this process's collectives inside it."""
    global _TIMING
    prev, _TIMING = _TIMING, {}
    try:
        yield _TIMING
    finally:
        _TIMING = prev


def _run(op: str, x: torch.Tensor, fn):
    """``fn(x)``, its calls and host seconds counted under ``op`` while a
    :func:`timing` context is open."""
    t0 = time.perf_counter() if _TIMING is not None else None
    out = fn(x)
    if t0 is not None:
        rec = _TIMING.setdefault(op, [0, 0.0])
        rec[0] += 1
        rec[1] += time.perf_counter() - t0
    return out


_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "mean": "SUM"}


def all_reduce(x: torch.Tensor, group=None, op: str = "sum"):
    """The reduction of ``x`` over the group (``"sum"``, ``"mean"`` or
    ``"max"``)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduce op: {op}")
    n = world_size(group)
    if n == 1:
        return x

    def fn(t):
        t = t.clone()
        dist.all_reduce(t, op=getattr(dist.ReduceOp, _REDUCE_OPS[op]),
                        group=group)
        return t

    out = _run("all_reduce", x, fn)
    return out / n if op == "mean" else out


def all_gather(x: torch.Tensor, group=None, dim: int = 0):
    """The ranks' ``x`` concatenated along ``dim``, in rank order."""
    n = world_size(group)
    if n == 1:
        return x
    dim %= x.ndim

    def fn(t):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    return _run("all_gather", x, fn)


def reduce_scatter(x: torch.Tensor, group=None, dim: int = 0):
    """The sum of ``x`` over the group, this rank's block of ``x.shape[dim]
    / world`` along ``dim``."""
    n = world_size(group)
    if n == 1:
        return x
    dim %= x.ndim
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} is not "
                         f"divisible by the group's {n} ranks")

    def fn(t):
        t = t.movedim(dim, 0).contiguous()
        out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t, group=group)
        return out

    return _run("reduce_scatter", x, fn).movedim(0, dim)


def broadcast(x: torch.Tensor, group=None, src: int = 0):
    """Group rank ``src``'s ``x`` on every rank (``src`` is a rank of the
    group, not a global rank)."""
    if world_size(group) == 1:
        return x
    g_src = src if group is None else dist.get_global_rank(group, src)

    def fn(t):
        t = t.clone().contiguous()
        dist.broadcast(t, g_src, group=group)
        return t

    return _run("broadcast", x, fn)
