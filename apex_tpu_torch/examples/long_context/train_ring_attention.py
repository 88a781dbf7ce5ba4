"""Long-context GPT training with ring-attention context parallelism.

Counterpart of ``examples/long_context/train_ring_attention.py`` of the JAX
package: tiny GPT (``gpt_tiny_config(context_parallel=True)``) trains on a
sequence sharded over a ring of ``cp`` ranks (``ring_attention``, or
``ring_attention_zigzag`` with the batch permuted by ``to_zigzag``), with
``FusedAdam(lr=3e-3)``, and the loss falls. Two ways to run the ring
(``transformer.parallel_state.initialize_model_parallel`` picks one):

- one process: the in-process ring of ``cp`` ranks; the model holds the
  whole sequence and every rank's ring schedule runs in turn (on the card,
  or on the CPU with ``--device cpu``);
- ``cp`` processes under ``torch.distributed`` (``gloo`` on the CPU, e.g.
  ``torchrun --nproc-per-node 4``): each holds its chunk, K/V rotate
  between the processes, the loss is the group's mean and the gradients
  are averaged over the group before the step (the reference's
  ``pmean``s).

The batch is one data-parallel replica's, two sequences (the reference
runs its mesh's remaining devices as data parallelism).

Run:  python -m apex_tpu_torch.examples.long_context.train_ring_attention
      torchrun --nproc-per-node 4 -m \\
          apex_tpu_torch.examples.long_context.train_ring_attention \\
          --device cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GPTModel, gpt_loss, gpt_tiny_config
from apex_tpu_torch.ops.ring_attention import to_zigzag
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer import parallel_state


def average_gradients(opt, ring) -> None:
    """The mean of every rank's gradients over a distributed ring's group
    (one all-reduce of the optimizer's flat gradient buffer); nothing to do
    on the in-process ring."""
    if ring.local or ring.size == 1:
        return
    torch.distributed.all_reduce(opt.grads, group=ring.group)
    opt.grads.div_(ring.size)


def run_training(steps: int = 8, seq_len: int = 128, cp: int = 4,
                 layout: str = "ring", *, device="cuda", verbose=print):
    """Train tiny GPT for ``steps`` steps on two seeded sequences of
    ``seq_len`` tokens over a ring of ``cp`` ranks; returns the losses.
    ``layout='zigzag'`` permutes the sequences with ``to_zigzag`` and the
    model's positions follow (``context_parallel_zigzag``)."""
    if layout not in ("ring", "zigzag"):
        raise ValueError(f"layout must be 'ring' or 'zigzag', got {layout!r}")
    ring = parallel_state.initialize_model_parallel(
        1, 1, context_parallel_size_=cp)
    try:
        cfg = gpt_tiny_config(context_parallel=True,
                              context_parallel_zigzag=layout == "zigzag",
                              max_position_embeddings=seq_len)
        model = GPTModel(cfg, device=device)
        rng = np.random.default_rng(0)
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, seq_len)))
        labels = torch.roll(ids, -1, dims=1)
        if layout == "zigzag":
            ids, labels = (to_zigzag(t, cp, axis=1) for t in (ids, labels))
        if not ring.local:
            s_loc = seq_len // cp
            ids, labels = (t[:, ring.rank * s_loc:(ring.rank + 1) * s_loc]
                           for t in (ids, labels))
        ids, labels = ids.to(device), labels.to(device)
        opt = FusedAdam(model.named_parameters(), lr=3e-3, weight_decay=0.0)
        losses = []
        for step in range(steps):
            opt.zero_grad()
            loss = gpt_loss(model, ids, labels)
            loss.backward()
            average_gradients(opt, ring)
            opt.step()
            losses.append(loss.item())
            verbose(f"step {step}: loss {losses[-1]:.4f}  "
                    f"(seq {seq_len} over cp={cp} {layout})")
        return losses
    finally:
        parallel_state.destroy_model_parallel()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layout", choices=("ring", "zigzag"), default="ring")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dist = torch.distributed
    launched = dist.is_available() and "RANK" in os.environ
    if launched:
        if args.device != "cpu":          # one card per rank
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
    try:
        # the ring: the launched processes, else 4 ranks in this one
        cp = dist.get_world_size() if launched else 4
        ls = run_training(cp=cp, layout=args.layout, device=args.device)
        if not ls[-1] < ls[0]:
            raise SystemExit(f"loss did not fall: {ls}")
        print(f"ring-attention CP training converges: {ls[0]:.3f} -> "
              f"{ls[-1]:.3f}")
    finally:
        if launched:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
