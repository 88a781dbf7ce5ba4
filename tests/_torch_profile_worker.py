"""The profiling worker of the flash routing tests
(``tests/test_torch_cuda_kernels.py``, ``test_flash_*_routes_by_dtype``).

In a process that has already run a long mix of kernels (the ``cuda``
test file before these tests), ``torch.profiler`` sessions come back with
no device activity at all most of the time, with warm-up sessions, a
schedule or an idle card before closing alike (``profiler_repeat.py``
measures it; PERF.md §7). In a fresh process that only profiles, every
session sees its launches. So the routing tests hand their profiled call
to this worker, one process for the whole test module: it reads one
request a line on stdin (``flash_fwd bfloat16``, ``flash_bwd float32``),
runs the call once unprofiled, then under the profiler, and writes one
JSON line: the CUDA activity names the session saw, the port's own launch
count of the call (``_build.launches``) and the sessions it took (a
session that saw no device activity at all is run again, up to 3).
Imports no JAX.

    python tests/_torch_profile_worker.py   # then write requests to stdin
"""

import json
import sys

import torch


def profiled_names(fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]


def call(kind: str, dtype):
    """The routing tests' flash call: causal attention at (1, 4, 256, 64),
    seed 43 (forward) or 46 (backward)."""
    from apex_tpu_torch.ops.flash_attention import (Masking,
                                                    flash_attention_bwd,
                                                    flash_attention_with_lse)

    if kind == "flash_fwd":
        g = torch.Generator().manual_seed(43)
        q, k, v = (torch.randn(1, 4, 256, 64, generator=g).to("cuda", dtype)
                   for _ in range(3))
        return lambda: flash_attention_with_lse(q, k, v, causal=True)
    g = torch.Generator().manual_seed(46)
    q, k, v, do = (torch.randn(1, 4, 256, 64, generator=g).to("cuda", dtype)
                   for _ in range(4))
    o, lse = flash_attention_with_lse(q, k, v, causal=True)
    kw = dict(scale=0.125, masking=Masking(causal=True))
    return lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw)


def main() -> int:
    from apex_tpu_torch.ops import _build

    for line in sys.stdin:
        kind, dtype = line.split()
        fn = call(kind, getattr(torch, dtype))
        fn()
        names, sessions = [], 0
        while not names and sessions < 3:
            sessions += 1
            before = sum(_build.launches.values())
            names = profiled_names(fn)
            launched = sum(_build.launches.values()) - before
        print(json.dumps({"names": names, "launches": launched,
                          "sessions": sessions}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
