"""Repeat the flash forward's routing check under ``torch.profiler`` in one
process, and report every session that saw no device activity.

``tests/test_torch_cuda_kernels.py::test_flash_fwd_routes_by_dtype`` reads
the names of the kernels a bf16 forward runs from the profiler. This script
runs its body ``--reps`` times per dtype, first alone, then (with
``--after-tests``) after the rest of the ``cuda`` test file has run in the
same process, then after ``torch.cuda.empty_cache()``, with the card's
memory filled by live tensors and freed again, and prints one JSON line a
setting: the card's free memory, how many sessions saw no CUDA activity at
all, how many saw the kernel, and the port's own launch count over the
same calls. ``--warm`` opens and closes one profiler session before each
measured one; ``--no-alone`` skips the sessions before the test file. Last
it calls the test function itself ``--reps`` times per dtype, its profiled
call in ``tests/_torch_profile_worker.py`` as the test module runs it.

    python3 profiler_repeat.py --reps 60 --after-tests

Needs a CUDA device; the test file is run with ``--noconftest`` (its
conftest imports JAX).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def session(fn, warm, variant: str = "plain"):
    """The CUDA activity names of one profiled call of ``fn``. Variants:
    ``plain``; ``sleep`` (the card idle 0.2 s before the session closes);
    ``schedule`` (one warm-up step of the same profiler, then the measured
    step: tracing stays on across both); ``cpu`` (CPU activity traced
    too)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    if warm:
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if variant == "cpu":
        acts.insert(0, ProfilerActivity.CPU)
    if variant == "schedule":
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            torch.cuda.synchronize()
            prof.step()
            fn()
            torch.cuda.synchronize()
            prof.step()
    else:
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
            if variant == "sleep":
                time.sleep(0.2)
    return [e.key for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]


def repeat(label: str, reps: int, warm: bool, variant: str = "plain") -> dict:
    import torch

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops.flash_attention import flash_attention_with_lse

    free, total = torch.cuda.mem_get_info()
    out = {"label": label, "warm": warm, "variant": variant, "reps": reps,
           "free_gib": free / 2 ** 30, "total_gib": total / 2 ** 30,
           "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}
    for dtype, symbol in ((torch.bfloat16, "flash_fwd_mma_kernel"),
                          (torch.float32, "flash_fwd_kernel<float>")):
        g = torch.Generator().manual_seed(43)
        q, k, v = (torch.randn(1, 4, 256, 64, generator=g).to("cuda", dtype)
                   for _ in range(3))
        flash_attention_with_lse(q, k, v, causal=True)
        empty, seen, wrong, empty_at = 0, 0, 0, []
        before = _build.launches["flash_fwd"]
        t0 = time.perf_counter()
        for i in range(reps):
            names = session(
                lambda: flash_attention_with_lse(q, k, v, causal=True), warm,
                variant)
            if not names:
                empty += 1
                empty_at.append(i)
            elif sum(symbol in n for n in names) == 1:
                seen += 1
            else:
                wrong += 1
        out[str(dtype).split(".")[-1]] = dict(
            empty_sessions=empty, empty_at=empty_at[:20], seen=seen,
            other=wrong,
            port_launches=_build.launches["flash_fwd"] - before,
            seconds=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=60)
    ap.add_argument("--after-tests", action="store_true")
    ap.add_argument("--no-alone", action="store_true",
                    help="no profiler session before the test file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profiler_repeat: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    if not args.no_alone:
        repeat("alone", args.reps, warm=False)
        repeat("alone", args.reps, warm=True)
    if args.after_tests:
        import pytest

        rc = pytest.main(["--noconftest", "-q", "-p", "no:cacheprovider",
                          os.path.join(HERE, "tests",
                                       "test_torch_cuda_kernels.py"),
                          "-k", "not routes_by_dtype"])
        print(json.dumps({"cuda_tests_rc": int(rc)}), flush=True)
        repeat("after_tests", args.reps, warm=False)
        repeat("after_tests", args.reps, warm=True)
        for variant in ("sleep", "schedule", "cpu"):
            repeat("after_tests", args.reps, warm=False, variant=variant)
        # the caching allocator's blocks returned to CUDA
        torch.cuda.empty_cache()
        repeat("after_tests_empty_cache", args.reps, warm=False)
        # the card filled again, by tensors that stay live
        hold = []
        while torch.cuda.mem_get_info()[0] > 2 ** 30:
            hold.append(torch.empty(2 ** 28, dtype=torch.uint8,
                                    device="cuda"))
        repeat("card_full", args.reps, warm=False)
        del hold
        torch.cuda.empty_cache()
        repeat("card_freed", args.reps, warm=False)
    import subprocess

    import test_torch_cuda_kernels as t

    # the test itself, its profiled call in the worker process as the
    # test module's fixture runs it
    path = os.pathsep.join(p for p in (HERE, os.environ.get("PYTHONPATH"))
                           if p)
    worker = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "tests",
                                      "_torch_profile_worker.py")],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=HERE,
        env=dict(os.environ, PYTHONPATH=path))
    failed = 0
    try:
        for dtype, symbol in ((torch.bfloat16, "flash_fwd_mma_kernel"),
                              (torch.float32, "flash_fwd_kernel<float>")):
            for _ in range(args.reps):
                try:
                    t.test_flash_fwd_routes_by_dtype(torch.device("cuda"),
                                                     worker, dtype, symbol)
                except AssertionError:
                    failed += 1
    finally:
        worker.stdin.close()
        worker.wait(timeout=60)
    print(json.dumps({"test_function_reps": 2 * args.reps,
                      "test_function_failed": failed}), flush=True)
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
