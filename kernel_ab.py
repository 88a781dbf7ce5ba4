#!/usr/bin/env python3
"""A/B of kernel rows of two checkouts of the port on one NVIDIA GPU.

    python3 kernel_ab.py TREE_A TREE_B [--checks check_flash,check_flash_bert]
                         [--device-ms]

Runs ``chip_smoke.py``'s kernel checks (this checkout's ``check_*``
functions: the same shapes, seeds, tolerances and timings for both trees)
through the ``apex_tpu_torch`` of each tree: one process per turn, in the
order A, B, B, A, each building the tree's kernels into that tree's
``apex_tpu_torch/_build/``, warming the card and running the checks, which
hold every kernel against its twin and time it (default the seven flash
checks: every forward and backward branch; the paged kernel's are
``check_paged,check_paged_quant,check_paged_window,check_paged_block``,
whose rows the key ``ROW_KEYS`` tells apart by ``s`` and ``lengths``
too). Prints
the card's name and power limit, one JSON line per turn with its rows, and
a last JSON line with each row's ms in the four turns and B's time over
A's (the mean of B's two turns over the mean of A's), and, for a row
that carries a digest of its outputs (``bits``), whether all four turns
gave the same bits. ``--device-ms`` also
profiles each row's kernel (``chip_smoke.kernel_device_ms``: the
profiler's device ms per call, and per launched symbol for an op of
several launches) and, where a row's kernel carries its library call
(``fn.library``), that call's device ms. A check that fails (a kernel off
its twin) is reported in its turn's line with its error, the other checks
still run, and the script exits 1. Two trees are compared only within one
call: the card's clocks and neighbours differ between calls.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ORDER = "ABBA"
CHECKS = ("check_flash", "check_flash_bwd", "check_flash_bert",
          "check_flash_window", "check_flash_bwd_window", "check_flash_bias",
          "check_flash_ring")
ROW_KEYS = ("name", "dtype", "shape", "kind", "use", "path", "sk", "window",
            "causal_offset", "group_size", "s", "lengths")


def row_key(row: dict) -> str:
    return json.dumps([row.get(k) for k in ROW_KEYS])


def one(tree: str, checks, device_ms: bool = False) -> dict:
    """The checks through ``tree``'s package, in this process."""
    import torch

    import chip_smoke as cs          # this checkout's checks, first

    sys.path.insert(0, os.path.abspath(tree))
    from apex_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = _build.build_all()
    cs.warm_card()
    gen = torch.Generator().manual_seed(cs.SEED)
    rows, failed = [], {}
    for check in checks:
        try:
            pairs = getattr(cs, check)(gen, cs.DEV)
        except AssertionError as exc:
            failed[check] = str(exc)
            continue
        for row, fn in pairs:
            if device_ms:
                row["device_ms"], _, split = cs.kernel_device_ms(
                    fn, cs.kernel_symbol(row["name"], row["dtype"]))
                if len(split) > 1:
                    row["device_ms_by_symbol"] = split
                if hasattr(fn, "library"):
                    (row["library_device_ms"],
                     row["library_launches_seen"]) = cs.library_device_ms(
                        fn.library)
            rows.append(row)
    keep = ("ms", "plain_ms", "tflops", "tb_s", "max_abs_err", "bound_ms",
            "library_ms",
            "device_ms", "device_ms_by_symbol", "library_device_ms",
            "library_launches_seen", "x_copies", "bits")
    return dict(tree=tree, build_s=build_s, failed=failed,
                package=os.path.dirname(_build.__file__),
                registers=cs.ptxas_registers(),
                spill_bytes=cs.ptxas_spill_bytes(),
                rows=[dict({k: r.get(k) for k in ROW_KEYS},
                           **{k: r[k] for k in keep if k in r})
                      for r in rows])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", help="TREE_A TREE_B")
    ap.add_argument("--checks", default=",".join(CHECKS),
                    help="chip_smoke check functions, comma-separated")
    ap.add_argument("--device-ms", action="store_true",
                    help="profile each row's kernel too")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    checks = tuple(args.checks.split(","))

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(one(args.one, checks, args.device_ms)), flush=True)
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ms, dev_ms, bits, failed = {}, {}, {}, False
    for turn, t in enumerate(ORDER):
        tree = os.path.abspath(args.trees["AB".index(t)])
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree,
             "--checks", args.checks]
            + (["--device-ms"] if args.device_ms else []),
            capture_output=True, text=True, cwd=HERE, timeout=1800)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        res = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(turn=turn, label=t, **res)), flush=True)
        failed = failed or bool(res["failed"])
        for r in res["rows"]:
            ms.setdefault(row_key(r), {"A": [], "B": []})[t].append(r["ms"])
            if "bits" in r:
                bits.setdefault(row_key(r), []).append(r["bits"])
            if "device_ms" in r:
                dev_ms.setdefault(row_key(r), {"A": [], "B": []})[t].append(
                    r["device_ms"])
    table = []
    for key, by in ms.items():
        a, b = (sum(by[t]) / len(by[t]) if by[t] else None for t in "AB")
        dev = ({f"{t}_device_ms": dev_ms[key][t] for t in "AB"}
               if key in dev_ms else {})
        same = ({"same_bits": len(set(bits[key])) == 1} if key in bits
                else {})
        table.append(dict(zip(ROW_KEYS, json.loads(key)), A_ms=by["A"],
                          B_ms=by["B"], b_over_a=b / a if a and b else None,
                          **dev, **same))
    print(json.dumps(dict(nvidia_smi=smi, order=ORDER,
                          trees=dict(A=args.trees[0], B=args.trees[1]),
                          rows=table)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
