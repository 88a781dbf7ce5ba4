#!/usr/bin/env python3
"""Sweep the GroupNorm kernels' cut on one NVIDIA GPU.

    python3 group_norm_sweep.py [--chunks 16,32,64] [--rows 4,8,16]
                                [--threads 160,320]

For each combination of ``apex_tpu_torch.ops.group_norm``'s
``MIN_CHUNKS`` (the chunks of a sample the plan aims at, set alike for the
forward and the backward), the most rows a
thread walks (``MAX_ROWS`` for 2-byte elements; fp32 half of it)
and ``BLOCK_THREADS``
(the threads a block aims at), holds the forward and backward kernels
against their twins at ``chip_smoke.py``'s Stable Diffusion shapes
(``UNET_SHAPES``, batch 8, 32 groups, SiLU, fp32 and bf16) and times each
by ``queued_ms`` over copies of x (and dy) past the L2 cache, as
``check_group_norm`` does. Prints the card's name and power limit, then one
JSON line with each row's ms at every combination and the plan it ran. The
cut changes only the order of the sums, never what is computed, so every
combination must pass the same bars.
"""

import argparse
import importlib
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", default="16,32,64",
                    help="MIN_CHUNKS values, comma-separated")
    ap.add_argument("--rows", default="8,16",
                    help="MAX_ROWS values for 2-byte elements, "
                         "comma-separated")
    ap.add_argument("--threads", default="160,320",
                    help="BLOCK_THREADS values, comma-separated")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("group_norm_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from apex_tpu_torch.ops import _build

    gn = importlib.import_module("apex_tpu_torch.ops.group_norm")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all()
    cs.warm_card()
    dgen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    act, eps = cs.UNET_NORMS[0]
    cases = []
    for c, side in cs.UNET_SHAPES:
        w = torch.randn(c, generator=dgen, device=cs.DEV) * 0.1 + 1
        b = torch.randn(c, generator=dgen, device=cs.DEV) * 0.1
        for dtype in (torch.float32, torch.bfloat16):
            x = cs.unet_norm_input(dgen, c, side, dtype, cs.DEV)
            dy = cs.unet_norm_input(dgen, c, side, dtype, cs.DEV)
            cases.append((c, side, dtype, w, b, x.permute(0, 2, 3, 1),
                          dy.permute(0, 2, 3, 1)))
    table = {}
    for chunks, rows, threads in itertools.product(
            *(map(int, v.split(",")) for v in (args.chunks, args.rows,
                                                args.threads))):
        gn.MIN_CHUNKS, gn.BLOCK_THREADS = {False: chunks, True: chunks}, threads
        gn.MAX_ROWS = {2: rows, 4: max(1, rows // 2)}
        setting = f"chunks {chunks} rows {rows} threads {threads}"
        for c, side, dtype, w, b, xh, dyh in cases:
            dt = str(dtype).split(".")[-1]
            args_f = (w, b, cs.UNET_GROUPS, eps, act)
            y, mean, rstd = gn.group_norm_fwd(xh, *args_f)
            bargs = (w, b, mean, rstd, cs.UNET_GROUPS, act)
            dx, dw, db = gn.group_norm_bwd(xh, dyh, *bargs)
            ry, _, _ = gn.group_norm_fwd_reference(xh, *args_f)
            rdx, rdw, rdb = gn.group_norm_bwd_reference(xh, dyh, *bargs)
            label = f"{setting} {c}x{side} {dt}"
            cs.compare(f"{label} y", y, ry, dt)
            cs.compare(f"{label} dx", dx, rdx, dt)
            cs.compare(f"{label} dw", dw, rdw, "float32", cs.SUM_TOL)
            cs.compare(f"{label} db", db, rdb, "float32", cs.SUM_TOL)
            n = xh.numel() * xh.element_size()
            xs = [xh.clone() for _ in range(cs.copies_for(2 * n))]
            fwd = cs.queued_ms(cs.rotating(
                gn.group_norm_fwd, [(xc, *args_f) for xc in xs]))
            del xs
            pairs = [(xh.clone(), dyh.clone())
                     for _ in range(cs.copies_for(3 * n))]
            bwd = cs.queued_ms(cs.rotating(
                gn.group_norm_bwd, [(xc, dc, *bargs) for xc, dc in pairs]))
            del pairs
            shape = (side * side, c, c // cs.UNET_GROUPS, xh.element_size())
            table.setdefault(f"{c}x{side} {dt}", {})[setting] = dict(
                fwd_ms=fwd, bwd_ms=bwd,
                plan=gn.group_norm_split_plan(*shape)._asdict(),
                bwd_plan=gn.group_norm_split_plan(
                    *shape, backward=True)._asdict())
    print(json.dumps(dict(nvidia_smi=smi, act=act, batch=cs.UNET_BATCH,
                          rows=table)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
