"""Tensor-parallel GPT-2 over ``torch.distributed`` (BASELINE config #4):
served by ``TensorParallelPagedEngine`` and trained with ``FusedAdam``.

Each rank is one process holding its shard of the model (``num_heads /
tp`` heads, ``vocab / tp`` rows of the tied embedding). The model is built
from a seed on every rank: the layers draw the tp = 1 weights and keep
their rank's block, so the tp ranks together compute the tp = 1 model
built from the same seed.

- ``serve_rank(rank, world, ...)``: this rank's engine over a list of
  requests; returns the outputs (the same on every rank), the engine's
  stats, the wall seconds of the timed runs, the rank's pool bytes and its
  kernel launches;
- ``train_rank(rank, world, ...)``: ``steps`` FusedAdam steps on one
  seeded batch (the same batch on every rank: tensor parallelism splits
  the model, not the data); returns the losses, the step times, the
  launches and, on request, this rank's gradients of the first step;
- ``jobs_rank(rank, world, jobs)``: several of these in one set of
  processes; each can end with a profiled run (``collective_profile``:
  the collectives' host time, the device time of the host copies).

Run (2 ranks; ``--device cpu`` on a machine without a card)::

    python -m apex_tpu_torch.examples.tensor_parallel.gpt --tp 2 --mode serve
    torchrun --nproc-per-node 2 \
        -m apex_tpu_torch.examples.tensor_parallel.gpt --mode train

Without ``torchrun`` the script starts its ranks itself
(``parallel.spawn.run_ranks``). The backend follows from the cards
(``parallel.spawn.choose_backend``): with a card for every rank, each rank
runs on its own over ``nccl``; on one card every rank runs on ``cuda:0``
over ``gloo``, since NCCL refuses two ranks on one device.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from apex_tpu_torch.models import GPTModel, gpt2_small_config, gpt_tiny_config
from apex_tpu_torch.ops import _build
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.serving import Request, TensorParallelPagedEngine
from apex_tpu_torch.transformer import parallel_state

CONFIGS = {"gpt2_small": gpt2_small_config, "gpt_tiny": gpt_tiny_config}


def rank_device(device: str) -> str:
    """``device``, with ``cuda`` named by this rank's current card, which
    ``parallel.init_ranks`` chose (its own under ``nccl``, ``cuda:0`` for
    every rank of a one-card run)."""
    if device != "cuda":
        return device
    return f"cuda:{torch.cuda.current_device()}"


def build_model(config: str, cfg_kw: dict, seed: int, device: str):
    """``CONFIGS[config](**cfg_kw)`` on ``device``, initialized from a CPU
    generator seeded ``seed``."""
    cfg = CONFIGS[config](**cfg_kw)
    return GPTModel(cfg, device=device,
                    generator=torch.Generator().manual_seed(seed))


def pool_bytes(engine) -> int:
    """Bytes of this rank's K/V page pool (every layer)."""
    return sum(t.numel() * t.element_size() for lc in engine.cache["layers"]
               for t in lc.values())


def serve_rank(rank: int, world: int, config: str, cfg_kw: dict, seed: int,
               requests, engine_kw: dict, device: str = "cuda",
               runs: int = 1, profile: int = 0):
    """This rank's ``TensorParallelPagedEngine`` over ``requests`` (a list
    of ``Request``), ``runs`` times (the first warm when more than one),
    then, when ``profile`` > 0, its first ``profile`` requests once more
    under :func:`collective_profile` (the profiler's cost grows with the
    run); see the module docstring."""
    dev = rank_device(device)
    parallel_state.initialize_model_parallel(world)
    try:
        model = build_model(config, dict(cfg_kw, tensor_parallel_size=world),
                            seed, dev)
        engine = TensorParallelPagedEngine(model, **engine_kw)
        seconds = []
        for _ in range(runs):
            _build.reset_launches()
            _sync(dev)
            t0 = time.perf_counter()
            outs, stats = engine.run(requests)
            _sync(dev)
            seconds.append(time.perf_counter() - t0)
        launches = dict(_build.launches)
        prof = (collective_profile(
            lambda: engine.run(requests[:profile]), dev) if profile else None)
        return dict(outputs=outs, stats=stats, seconds=seconds,
                    pool_bytes=pool_bytes(engine), launches=launches,
                    rank=rank, profile=prof)
    finally:
        parallel_state.destroy_model_parallel()


def train_batch(vocab: int, batch: int, seq: int, seed: int):
    """Token ids and next-token labels from a numpy seed (GPT-2's 50257
    ids within a padded vocab)."""
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, min(50257, vocab), (batch, seq)))
    return ids, torch.roll(ids, -1, dims=1)


def no_decay(name: str) -> bool:
    """Biases, norms and the position table take no weight decay."""
    return name.endswith("bias") or "norm" in name or "position" in name


def train_rank(rank: int, world: int, config: str, cfg_kw: dict, seed: int,
               batch: int, seq: int, steps: int, lr: float = 1e-4,
               device: str = "cuda", return_grads: bool = False,
               timed_from: int = 0, profile: bool = False):
    """``steps`` FusedAdam steps of this rank's shard, then one more under
    :func:`collective_profile` when ``profile``; see the module docstring.
    Step times and launches count from step ``timed_from``."""
    from apex_tpu_torch.models import gpt_loss

    dev = rank_device(device)
    parallel_state.initialize_model_parallel(world)
    try:
        model = build_model(config, dict(cfg_kw, tensor_parallel_size=world),
                            seed, dev)
        ids, labels = train_batch(model.config.vocab_size, batch, seq, seed)
        ids, labels = ids.to(dev), labels.to(dev)
        opt = FusedAdam(model.named_parameters(), lr=lr, weight_decay=0.01,
                        exclude_from_weight_decay=no_decay)
        losses, step_ms, grads = [], [], None

        def step():
            opt.zero_grad()
            loss = gpt_loss(model, ids, labels)
            loss.backward()
            return loss

        for i in range(steps):
            if i == timed_from:
                _build.reset_launches()
            _sync(dev)
            t0 = time.perf_counter()
            loss = step()
            if i == 0 and return_grads:
                grads = {n: p.grad.detach().cpu().clone()
                         for n, p in model.named_parameters()}
            opt.step()
            _sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.detach()))
        launches = dict(_build.launches)
        prof = (collective_profile(lambda: (step(), opt.step()), dev)
                if profile else None)
        return dict(losses=losses, step_ms=step_ms, grads=grads,
                    launches=launches, rank=rank,
                    timed_steps=steps - timed_from, profile=prof)
    finally:
        parallel_state.destroy_model_parallel()


def _sync(dev: str) -> None:
    if dev.startswith("cuda"):
        torch.cuda.synchronize()


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def collective_profile(fn, dev: str) -> dict:
    """``fn()`` once under ``torch.profiler`` and the collectives' timing
    (``collectives.timing``): its wall ms; the host ms spent inside the
    collectives (under gloo their host copies of CUDA tensors and the wait
    for the peers) and their calls by op; the device ms of every kernel and
    copy, and of the copies between host and device alone (None when the
    profiler saw no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch import collectives as coll

    acts = [ProfilerActivity.CPU]
    if dev.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof, coll.timing() as ops:
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    device = sum(_device_us(e) for e in rows)
    copies = sum(_device_us(e) for e in rows if "memcpy" in e.key.lower())
    return dict(wall_ms=wall * 1e3,
                collective_host_ms=sum(s for _, s in ops.values()) * 1e3,
                collective_calls={op: n for op, (n, _) in ops.items()},
                device_ms=device / 1e3 if device else None,
                host_device_copy_ms=copies / 1e3 if device else None)


def jobs_rank(rank: int, world: int, jobs):
    """``jobs`` (``[("serve" | "train", keyword arguments)]``) in order on
    this rank, each with a model of its own; returns their results, each
    with its seconds (``job_s``). One set of processes serves every job
    (each process takes seconds to start and reach the card)."""
    import gc

    from apex_tpu_torch import collectives as coll

    out = []
    for kind, kw in jobs:
        fn = serve_rank if kind == "serve" else train_rank
        t0 = time.perf_counter()
        res = fn(rank, world, **kw)
        res.update(backend=coll.backend(), job_s=time.perf_counter() - t0)
        out.append(res)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def demo_requests(vocab: int, n: int = 8, seed: int = 1):
    """``n`` requests, prompts uniform in 32..128 tokens and budgets in
    16..32, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, min(50257, vocab),
                                        int(rng.integers(32, 129)))
                    .astype(np.int32),
                    max_new_tokens=int(rng.integers(16, 33)))
            for _ in range(n)]


def _main_rank(rank, world, args):
    from apex_tpu_torch import collectives as coll

    where = (f"rank {rank} on {rank_device(args.device)} over "
             f"{coll.backend()}")
    cfg_kw = dict(dtype=torch.float32 if args.fp32 else torch.bfloat16)
    if args.layers is not None:
        cfg_kw["num_layers"] = args.layers
    if args.mode == "serve":
        vocab = CONFIGS[args.config](**cfg_kw).vocab_size
        out = serve_rank(rank, world, args.config, cfg_kw, 0,
                         demo_requests(vocab), dict(num_slots=8,
                                                    page_size=16),
                         device=args.device)
        toks = sum(o.shape[0] for o in out["outputs"])
        return (f"{where}: {toks} tokens in {out['seconds'][-1]:.2f} s, "
                f"pool {out['pool_bytes']} bytes, decode steps "
                f"{out['stats']['decode_steps']}")
    out = train_rank(rank, world, args.config, cfg_kw, 0, args.batch,
                     args.seq, args.steps, device=args.device)
    return (f"{where}: losses {[round(x, 4) for x in out['losses']]}, "
            f"step ms {[round(x, 1) for x in out['step_ms']]}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["serve", "train"], default="serve")
    p.add_argument("--tp", type=int, default=2)
    p.add_argument("--config", choices=sorted(CONFIGS), default="gpt2_small")
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if "RANK" in os.environ:                     # started by torchrun
        import torch.distributed as dist

        from apex_tpu_torch.parallel import init_ranks

        init_ranks(args.device)
        try:
            print(_main_rank(dist.get_rank(), dist.get_world_size(), args))
        finally:
            dist.destroy_process_group()
        return
    from apex_tpu_torch.examples.tensor_parallel import gpt
    from apex_tpu_torch.parallel.spawn import run_ranks

    # by module name: spawned ranks cannot import ``__main__``'s functions
    for line in run_ranks(gpt._main_rank, args.tp, (args,),
                          device=args.device):
        print(line)


if __name__ == "__main__":
    main()
