"""Minimal data-parallel training loop over ``torch.distributed``.

Counterpart of ``examples/simple/distributed/distributed_data_parallel.py``
of the JAX package (the reference's, ~60 lines): a toy linear model
``x @ w`` fit to ``x @ w_true`` by ``FusedSGD(lr=0.2)`` on the mean squared
error, each step's batch of 32 rows drawn from a numpy seed. Under
``DistributedDataParallel`` every rank takes its ``32 / world`` rows of
the batch and ``allreduce_gradients`` averages the gradients, so every
rank steps on the whole batch's gradient, the reference's sharded batch
under ``jit``.

Run: ``python -m apex_tpu_torch.examples.simple.distributed_data_parallel
--ranks 2 --device cpu`` (the script starts its ranks), or under
``torchrun --nproc-per-node 2``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from torch import nn

from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import DistributedDataParallel

BATCH = 32


class Linear(nn.Module):
    """``x @ w`` with ``w`` (16, 4), zero at the start."""

    def __init__(self, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(16, 4, device=device))

    def forward(self, x):
        return x @ self.w


def run_training(steps: int = 10, device="cuda", verbose=print):
    """The example's loop on this rank; returns the whole batch's loss at
    each step (the mean of the ranks' losses), the same on every rank."""
    from apex_tpu_torch import collectives as coll

    rng = np.random.default_rng(0)
    w_true = torch.from_numpy(rng.standard_normal((16, 4)).astype(
        np.float32)).to(device)
    model = Linear(device=device)
    opt = FusedSGD(model.named_parameters(), lr=0.2)
    ddp = DistributedDataParallel(model)
    world = ddp.world_size
    me = coll.rank(ddp.process_group)
    per = BATCH // world
    losses = []
    for step in range(steps):
        x = torch.from_numpy(rng.standard_normal((BATCH, 16)).astype(
            np.float32)).to(device)[me * per:(me + 1) * per]
        y = x @ w_true
        opt.zero_grad()
        loss = torch.mean((ddp(x) - y) ** 2)
        loss.backward()
        ddp.allreduce_gradients()
        opt.step()
        whole = coll.all_reduce(loss.detach(), ddp.process_group, "mean")
        losses.append(float(whole))
        verbose(f"step {step} loss {losses[-1]:.5f}")
    return losses


def _rank(rank, world, steps, device):
    return run_training(steps, device=device,
                        verbose=print if rank == 0 else lambda *_: None)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if "RANK" in os.environ:                     # started by torchrun
        import torch.distributed as dist

        from apex_tpu_torch.parallel import init_ranks

        init_ranks(args.device)
        try:
            run_training(args.steps, device=args.device)
        finally:
            dist.destroy_process_group()
        return
    from apex_tpu_torch.examples.simple import distributed_data_parallel
    from apex_tpu_torch.parallel import run_ranks

    run_ranks(distributed_data_parallel._rank, args.ranks,
              (args.steps, args.device), device=args.device)


if __name__ == "__main__":
    main()
