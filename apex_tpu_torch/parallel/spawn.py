"""Start ``world`` ranks as processes over ``torch.distributed``.

``run_ranks(target, world, args, kwargs, device=)`` starts ``world``
processes with the ``spawn`` method; each takes its parent's cuDNN and
cuBLAS flags (:data:`BACKEND_FLAGS`: a spawned process would start from
torch's defaults, with cuDNN's TF32 on), initializes the default process
group (:func:`init_ranks`) at ``tcp://localhost:<a free port>`` with its
rank and the world size, calls ``target(rank, world, *args, **kwargs)``,
sends back what it returns (anything picklable) and destroys the group.
The parent returns the ranks' results in rank order, and fails when a rank
raises (with that rank's traceback), dies, or gives no result within
``timeout`` seconds; every process it started is stopped before it
returns. ``target`` must be importable by name from a module (``spawn``
re-imports it there, never from ``__main__``).

``torchrun --nproc-per-node N`` is the other way to start ranks: the
examples' command lines call :func:`init_ranks` with no rank, which reads
torchrun's environment.

The backend follows from where the ranks' tensors live
(:func:`choose_backend`): ``nccl`` when they are on the card and every
rank of the host has a card of its own (rank ``r`` then takes card ``r``
of its host), else ``gloo`` (NCCL refuses two ranks on one card; gloo
takes CPU tensors and, for the ops of ``collectives``, CUDA ones).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import socket
import time
import traceback


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


#: the process-wide cuDNN and cuBLAS switches a rank takes from its parent
BACKEND_FLAGS = (("cudnn", "deterministic"), ("cudnn", "benchmark"),
                 ("cudnn", "allow_tf32"), ("cuda.matmul", "allow_tf32"))


def _flag_owner(path: str):
    import torch

    owner = torch.backends
    for part in path.split("."):
        owner = getattr(owner, part)
    return owner


def backend_flags() -> dict:
    """This process's values of :data:`BACKEND_FLAGS`."""
    return {(o, n): getattr(_flag_owner(o), n) for o, n in BACKEND_FLAGS}


def set_backend_flags(flags: dict) -> None:
    for (o, n), value in flags.items():
        setattr(_flag_owner(o), n, value)


def choose_backend(local_world: int, device) -> str:
    """``nccl`` for ranks whose tensors live on ``device`` of type cuda
    when this host has a card for each of its ``local_world`` ranks and
    torch has NCCL; else ``gloo``."""
    import torch
    import torch.distributed as dist

    if (torch.device(device).type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= local_world):
        return "nccl"
    return "gloo"


def init_ranks(device, *, rank=None, world=None, port=None,
               timeout: float = 600.0) -> str:
    """Initialize this process's default group for ranks whose tensors
    live on ``device``, over :func:`choose_backend`'s backend, which it
    returns. With ``rank``, ``world`` and ``port``: at
    ``tcp://localhost:<port>``, every rank on this host; without: from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``). Under ``nccl`` the rank's current card is its
    local rank's, so ``"cuda"`` names its own card."""
    import torch
    import torch.distributed as dist

    from_env = rank is None
    if from_env:
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ["WORLD_SIZE"]))
    else:
        local, local_world = rank, world
    backend = choose_backend(local_world, device)
    if backend == "nccl":
        torch.cuda.set_device(local)
    kw = dict(timeout=datetime.timedelta(seconds=timeout))
    if not from_env:
        kw.update(init_method=f"tcp://localhost:{port}", rank=rank,
                  world_size=world)
    dist.init_process_group(backend, **kw)
    return backend


def _rank_main(target, rank, world, port, device, flags, timeout, threads,
               args, kwargs, out_q):
    import torch
    import torch.distributed as dist

    if threads is not None:
        torch.set_num_threads(threads)
    set_backend_flags(flags)
    try:
        init_ranks(device, rank=rank, world=world, port=port,
                   timeout=timeout)
        try:
            # pickled here: the queue's own pickler would share tensors
            # through file descriptors, which die with this process
            out_q.put((rank, True, pickle.dumps(
                target(rank, world, *args, **kwargs))))
        finally:
            dist.destroy_process_group()
    except BaseException:                       # noqa: BLE001 (reported)
        out_q.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(target, world: int, args=(), kwargs=None, *, device="cpu",
              timeout: float = 600.0, threads=None):
    """``target(r, world, *args, **kwargs)`` for every rank ``r``, each in
    its own process, in rank order; see the module docstring. ``device``
    is where the ranks' tensors live (it picks the backend); ``threads``
    sets each rank's ``torch.set_num_threads``."""
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = free_port()
    flags = backend_flags()
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, port, device, flags,
                               timeout, threads, tuple(args),
                               dict(kwargs or {}), out_q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, error = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world and error is None:
            try:
                rank, ok, value = out_q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    error = f"ranks {dead} died without a result"
                elif time.monotonic() > deadline:
                    late = sorted(set(range(world)) - set(results))
                    error = f"ranks {late} gave no result in {timeout} s"
                continue
            if ok:
                results[rank] = pickle.loads(value)
            else:
                error = f"rank {rank} failed:\n{value}"
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        raise RuntimeError(error)
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [results[r] for r in range(world)]
