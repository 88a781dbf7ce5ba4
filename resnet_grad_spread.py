#!/usr/bin/env python3
"""Run-to-run spread of ``chip_smoke.py``'s ResNet-50 gradient bar on one
NVIDIA GPU.

    python3 resnet_grad_spread.py [--reps 6]

Repeats ``resnet_fp32``'s FusedSGD comparison (ResNet-50 at ImageNet
width, 8 images, amp O0, two steps, card against CPU from the same seeded
weights, the CPU stepping on the card's gradients) ``--reps`` times with
cuDNN's default algorithms and as many times with ``cudnn.deterministic``.
For each setting it prints a digest of the card's first-step gradients in
three runs, then one JSON line a repeat: for each step the four gradients
nearest their bar, as [err / bar, name, |card - CPU|, |CPU|, CPU floor],
with the bar ``chip_smoke.floor_grad_bars``' max(1e-3 |CPU|,
``RESNET_FLOOR_FACTOR`` x floor).
"""

import argparse
import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def bar_ratios(cs, card, cpu, floor):
    """[(err / bar, name, err, |CPU|, floor)] over every gradient, worst
    first."""
    rows = []
    for n, g in card.items():
        want, got = cpu[n], g.cpu()
        norm = want.norm().item()
        err = (got - want).norm().item()
        fl = (floor[n] - want).norm().item()
        bar = max(1e-3 * norm, cs.RESNET_FLOOR_FACTOR * fl)
        rows.append((err / max(bar, 1e-30), n, err, norm, fl))
    return sorted(rows, reverse=True)


def two_steps(cs, torch):
    """``resnet_card_vs_cpu("sgd")``'s steps, each step's gradients held
    against their bars without raising."""
    sides = {dev: cs.resnet_side(dev, "sgd") for dev in ("cuda", "cpu")}
    batch = {dev: cs.resnet_batch(cs.RESNET_FP32_BATCH, dev)
             for dev in ("cuda", "cpu")}
    steps = []
    for step in range(2):
        # gradients are views of the optimizer's flat buffer: the floor
        # is taken (and its running statistics undone) before the CPU's own
        model, opt, ddp = sides["cpu"][:3]
        saved = {k: v.clone() for k, v in model.named_buffers()}
        with cs.perturbed(model, cs.SEED + step):
            floor = {k: v.clone() for k, v in
                     cs.resnet_grads(model, opt, ddp, *batch["cpu"])[1]
                     .items()}
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(saved[k])
        grads = {dev: cs.resnet_grads(*sides[dev][:3], *batch[dev])[1]
                 for dev in ("cuda", "cpu")}
        rows = bar_ratios(cs, grads["cuda"], grads["cpu"], floor)
        steps.append([[round(r, 3), n, f"{e:.3e}", f"{no:.3e}", f"{f:.3e}"]
                      for r, n, e, no, f in rows[:4]])
        opt.grads.copy_(sides["cuda"][1].grads.cpu())
        sides["cuda"][1].step()
        torch.cuda.synchronize()
        opt.step()
    return steps


def grads_digest(cs):
    """A digest of the card's flat gradients after one forward and
    backward from the seeded weights."""
    model, opt, ddp, _, _ = cs.resnet_side("cuda", "sgd")
    cs.resnet_grads(model, opt, ddp,
                    *cs.resnet_batch(cs.RESNET_FP32_BATCH, "cuda"))
    return hashlib.sha1(opt.grads.cpu().numpy().tobytes()).hexdigest()[:12]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=6)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("resnet_grad_spread: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        print(json.dumps(dict(deterministic=det, digests=[
            grads_digest(cs) for _ in range(3)])), flush=True)
        for rep in range(args.reps):
            print(json.dumps(dict(
                deterministic=det, rep=rep,
                t_s=round(time.perf_counter() - t0, 1),
                steps=two_steps(cs, torch))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
