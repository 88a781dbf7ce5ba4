"""Workers of the gloo ring tests (``tests/test_torch_ring_attention.py``,
``tests/test_torch_context_parallel.py``): one process per rank of a
``torch.distributed`` group over ``gloo`` with a ``file://`` rendezvous (no
network). Imports no JAX, so that spawned ranks start quickly; results go
back as numpy arrays."""

import numpy as np
import torch
import torch.distributed as dist


def ring_inputs(seed: int, s: int):
    """q [1, 4, s, 8] against k/v [1, 2, s, 8] (GQA) and a cotangent, from
    a numpy seed."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((1, 4, s, 8), (1, 2, s, 8), (1, 2, s, 8),
                                   (1, 4, s, 8)))


def ring_case(ring, layout, window, rate, q, k, v, do):
    """Output and (dq, dk, dv) of one ring call on the given chunks."""
    from apex_tpu_torch.ops.ring_attention import (ring_attention,
                                                   ring_attention_zigzag)

    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    kw = dict(ring=ring, window=window, dropout_rate=rate, dropout_seed=3)
    o = (ring_attention(q, k, v, causal=True, **kw) if layout == "ring"
         else ring_attention_zigzag(q, k, v, **kw))
    o.backward(do)
    return [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]


def ring_worker(rank, world, path, layout, cases, s, out_q):
    """Rank ``rank``'s chunk of each case ``(window, rate)`` through the
    distributed ring; puts ``(rank, [[o, dq, dk, dv] per case])``."""
    from apex_tpu_torch.ops.ring_attention import DistributedRing, to_zigzag

    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=world)
    try:
        ring = DistributedRing()
        out = []
        for i, (window, rate) in enumerate(cases):
            ts = ring_inputs(i, s)
            if layout == "zigzag":
                ts = [to_zigzag(t, world) for t in ts]
            sl = s // world
            out.append(ring_case(ring, layout, window, rate,
                                 *(t[:, :, rank * sl:(rank + 1) * sl]
                                   for t in ts)))
        out_q.put((rank, out))
    finally:
        dist.destroy_process_group()


def example_worker(rank, world, path, layout, steps, out_q):
    """The port's long-context example on this rank of a gloo ring; puts
    ``(rank, losses)``."""
    from apex_tpu_torch.examples.long_context.train_ring_attention import (
        run_training)

    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=world)
    try:
        out_q.put((rank, run_training(steps=steps, cp=world, layout=layout,
                                      device="cpu", verbose=lambda *_: None)))
    finally:
        dist.destroy_process_group()


def run_ranks(target, world: int, args, tmp_path, timeout: float):
    """Start ``world`` spawned ranks of ``target(rank, world, path, *args,
    queue)``; returns their results by rank. Fails if a rank does not
    answer or exit within ``timeout`` seconds."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    path = str(tmp_path / "rendezvous")
    procs = [ctx.Process(target=target, args=(r, world, path, *args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = dict(q.get(timeout=timeout) for _ in range(world))
    except queue_mod.Empty:
        results = None
    for p in procs:
        p.join(timeout=timeout)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert results is not None, f"a rank gave no result in {timeout} s"
    assert not alive, f"ranks {alive} still running after {timeout} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [results[r] for r in range(world)]
