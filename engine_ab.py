#!/usr/bin/env python3
"""A/B of the serving engine of two checkouts of the port on one NVIDIA GPU.

    python3 engine_ab.py TREE_A TREE_B

Drives ``chip_smoke.py``'s ``engine_bf16`` workload (GPT-2-small, bf16,
seeded random weights, 24 requests with prompts and budgets uniform in
32..128 tokens, 8 slots, page 16) through the ``apex_tpu_torch`` of each
tree: one process per turn, in the order A, B, B, A, each building the
tree's kernels into that tree's ``apex_tpu_torch/_build/`` and timing
three engine runs after a warm one. Prints the card's name and power limit, one
JSON line per turn (tokens/s of each timed run, decode steps, paged-kernel
launches, a digest of the output tokens) and a last JSON line with each
tree's runs. Two trees are compared only within one call: the host sets
the engine's speed, and it differs between machines and calls.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ORDER, RUNS = "ABBA", 3


def one(tree: str, runs: int) -> dict:
    """The workload through ``tree``'s package, in this process."""
    import numpy as np
    import torch

    import chip_smoke as cs          # this checkout's workload, first

    sys.path.insert(0, os.path.abspath(tree))
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.serving import PagedDecodeEngine, Request

    build_s = _build.build_all()
    model = cs.build_model(torch.bfloat16)
    prompts, new_tokens = cs.workload()

    def drive():
        engine = PagedDecodeEngine(model, num_slots=cs.NUM_SLOTS,
                                   page_size=cs.PAGE_SIZE)
        reqs = [Request(p, n) for p, n in zip(prompts, new_tokens)]
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        outs, stats = engine.run(reqs)
        torch.cuda.synchronize()
        return outs, stats, time.perf_counter() - t0

    drive()                                                   # warm
    timed = [drive() for _ in range(runs)]
    outs, stats, _ = timed[0]
    digest = hashlib.sha256(np.concatenate(outs).tobytes()).hexdigest()[:16]
    return dict(tree=tree, build_s=build_s,
                package=os.path.dirname(_build.__file__),
                tokens_per_s=[st["generated_tokens"] / s
                              for _, st, s in timed],
                seconds=[s for _, _, s in timed],
                generated_tokens=stats["generated_tokens"],
                decode_steps=stats["decode_steps"],
                paged_launches=_build.launches["paged_attention"],
                tokens_digest=digest)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", help="TREE_A TREE_B")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("engine_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(one(args.one, RUNS)), flush=True)
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    by_tree = {t: [] for t in "AB"}
    for turn, t in enumerate(ORDER):
        tree = os.path.abspath(args.trees["AB".index(t)])
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree],
            capture_output=True, text=True, cwd=HERE, timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        res = json.loads(out.stdout.strip().splitlines()[-1])
        by_tree[t].append(res)
        print(json.dumps(dict(turn=turn, label=t, **res)), flush=True)
    digests = {r["tokens_digest"] for rs in by_tree.values() for r in rs}
    print(json.dumps(dict(
        nvidia_smi=smi, order=ORDER, same_tokens=len(digests) == 1,
        **{t: dict(tree=args.trees["AB".index(t)],
                   tokens_per_s=[x for r in rs for x in r["tokens_per_s"]],
                   decode_steps=sorted({r["decode_steps"] for r in rs}),
                   paged_launches=sorted({r["paged_launches"] for r in rs}))
           for t, rs in by_tree.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
