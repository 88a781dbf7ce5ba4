#!/usr/bin/env python3
"""Sweep the paged kernel's split size on one NVIDIA GPU.

    python3 paged_split_sweep.py [--keys 64,128,256,512] [--checks ...]

For each value of ``apex_tpu_torch.ops.paged_attention.SPLIT_KEYS`` (the
positions one block of the split pass walks, set alike for both head-dim
buckets), runs ``chip_smoke.py``'s
paged checks (default ``check_paged, check_paged_quant,
check_paged_window, check_paged_block``: every branch against its twin,
timed by ``queued_ms``) from the same seed, and prints the card's name and
power limit, then one JSON line with each row's ms at every value. The
split size changes only the order of the sums, never which pages are read,
so every value must pass the same bars.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKS = ("check_paged", "check_paged_quant", "check_paged_window",
          "check_paged_block")
ROW_KEYS = ("name", "dtype", "kind", "use", "s", "window")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keys", default="64,128,256,512",
                    help="SPLIT_KEYS values, comma-separated")
    ap.add_argument("--checks", default=",".join(CHECKS))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("paged_split_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from apex_tpu_torch.ops import _build

    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all()
    cs.warm_card()
    table = {}
    for keys in (int(k) for k in args.keys.split(",")):
        pa.SPLIT_KEYS = {64: keys, 128: keys}
        pa.paged_split_plan.cache_clear()
        gen = torch.Generator().manual_seed(cs.SEED)
        for check in args.checks.split(","):
            for row, _ in getattr(cs, check)(gen, cs.DEV):
                key = json.dumps([row.get(k) for k in ROW_KEYS])
                table.setdefault(key, {})[keys] = row["ms"]
    print(json.dumps(dict(nvidia_smi=smi, row_keys=ROW_KEYS, rows=[
        dict(zip(ROW_KEYS, json.loads(k)), ms=v) for k, v in table.items()
    ])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
