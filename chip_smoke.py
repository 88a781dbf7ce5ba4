#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``apex_tpu_torch``'s main path — GPT-2-small greedy paged decode
through ``PagedDecodeEngine`` — at full width and depth with seeded random
weights, after building every CUDA kernel of that path from
``apex_tpu_torch/csrc`` (into ``apex_tpu_torch/_build/``). Phases, one JSON
line each:

1. ``device``: the card, its power limit, the kernels' build time. The
   card is then kept busy for two seconds, and the phases that time it
   record its clock, power draw and temperature.
2. ``kernels``: each kernel against its plain PyTorch twin on the card, at
   the main path's shapes, in fp32 and bf16, with the tolerances below, plus
   its time, the twin's time, one PyTorch library call's time where one
   computes the same function, and the card's least time for the work.
3. ``engine_fp32``: the 24-request mixed-length workload (prompts and
   outputs uniform in 32..128 tokens, 8 slots, page 16, seed 1) must be
   token-identical, request by request, to per-request lock-step
   ``generate``, and must have launched every kernel.
4. ``engine_bf16``: the same workload in bf16, a warm run then two timed
   runs: generated tokens per second.
5. ``engine_bf16_profile`` and ``kernel_device_ms``: one more bf16 run under
   ``torch.profiler`` (device busy and idle share, the top device kernels),
   then each kernel's device time per call at the shapes of phase 2, then
   the timed bf16 run once more. Last, so that no profiler state can touch
   the times of phases 2-4.

Then the per-kernel summary line and, last, ``{"ok": true, "device": ...}``.
Any failure raises, so the run exits non-zero without the last line. With
no CUDA device, or without the ``apex_tpu_torch`` package beside it, it
exits non-zero at once. Imports nothing of JAX.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time
from functools import partial

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (dense): HBM bytes/s and FLOP/s per input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# |kernel - twin| <= ATOL + RTOL * |twin|, per dtype. fp32: both sum the
# same fp32 products in other orders. bf16: both compute in fp32 from the
# same bf16 inputs and round once to bf16, so they differ by at most about
# one bf16 ulp (2^-7 relative).
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}

N_REQUESTS, NUM_SLOTS, PAGE_SIZE, SEED = 24, 8, 16, 1

#: kernel name -> the CUDA symbol the profiler reports its launches under
KERNEL_SYMBOLS = {"layer_norm_fwd": "layer_norm_fwd_kernel",
                  "flash_fwd": "flash_fwd_kernel",
                  "paged_attention": "paged_decode_kernel"}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_state() -> str:
    """SM clock, its maximum, power draw and temperature, read now."""
    return nvidia_smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")


def warm_card(seconds: float = 2.0) -> None:
    """Keep the card busy with bf16 products for ``seconds``, so that the
    kernel times of phase 2 are taken at the clocks of a loaded card."""
    import torch

    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def time_ms(fn, iters: int = 50) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, reps: int = 1):
    """Run ``fn`` ``reps`` times under ``torch.profiler``; returns the wall
    seconds and ``{device activity name: (total ms, count)}`` for every
    kernel and copy the card ran. Empty when the profiler sees no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    acts = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        acts[e.key] = (us / 1e3, e.count)
    return wall, acts


def kernel_device_ms(fn, symbol: str, reps: int = 20):
    """Device time of one call of the kernel whose name holds ``symbol``,
    from the profiler (None when the profiler sees no device time)."""
    _, acts = device_profile(fn, reps)
    ms = sum(t for k, (t, _) in acts.items() if symbol in k)
    return ms / reps if ms > 0 else None


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compare(name: str, got, want, dtype: str) -> float:
    import torch

    atol, rtol = TOL[dtype]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: kernel disagrees with its twin, "
                             f"max |err| {err.max().item():.3e} "
                             f"(atol {atol}, rtol {rtol})")
    return err.max().item()


# --- phase 2: kernels against their twins ----------------------------------


def check_layer_norm(gen, dev):
    import torch
    import torch.nn.functional as F

    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (1024, 8):
            cols = 768
            x = (torch.randn(rows, cols, generator=gen) * 2 + 0.5).to(dev,
                                                                      dtype)
            w = (torch.rand(cols, generator=gen) + 0.5).to(dev)
            b = torch.randn(cols, generator=gen).to(dev)
            y, mean, rstd = ln.layer_norm_fwd(x, w, b, 1e-5)
            torch.cuda.synchronize()
            ry, rmean, rstd_ref = ln.layer_norm_fwd_reference(x, w, b, 1e-5)
            dn = str(dtype).split(".")[1]
            err = compare("layer_norm_fwd", y, ry, dn)
            compare("layer_norm_fwd mean", mean, rmean, "float32")
            compare("layer_norm_fwd rstd", rstd, rstd_ref, "float32")
            elt = x.element_size()
            nbytes = 2 * rows * cols * elt + 2 * cols * 4 + 2 * rows * 4
            bms, by = bound_ms(nbytes, 8 * rows * cols, dn)
            kernel = partial(ln.layer_norm_fwd, x, w, b, 1e-5)
            out.append((dict(
                name="layer_norm_fwd", dtype=dn, shape=[rows, cols],
                max_abs_err=err, ms=time_ms(kernel),
                plain_ms=time_ms(
                    partial(ln.layer_norm_fwd_reference, x, w, b, 1e-5)),
                library_ms=time_ms(partial(F.layer_norm, x, (cols,),
                                           w.to(dtype), b.to(dtype), 1e-5)),
                bound_ms=bms, bound_by=by), kernel))
    return out


def check_flash(gen, dev):
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

    out = []
    b, h, d = 1, 12, 64
    for dtype in (torch.float32, torch.bfloat16):
        for s in (16, 128, 1024):
            q, k, v = (torch.randn(b, h, s, d, generator=gen).to(dev, dtype)
                       for _ in range(3))
            scale = d ** -0.5
            o, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
            torch.cuda.synchronize()
            ro, rlse = fa.flash_attention_reference(q, k, v, scale=scale)
            dn = str(dtype).split(".")[1]
            err = compare("flash_fwd", o, ro, dn)
            compare("flash_fwd lse", lse, rlse, "float32")
            elt = q.element_size()
            pairs = b * h * s * (s + 1) // 2      # visible (query, key) pairs
            nbytes = 4 * b * h * s * d * elt + 4 * b * h * s
            bms, by = bound_ms(nbytes, 4 * pairs * d, dn)
            kernel = partial(fa.flash_attention_with_lse, q, k, v,
                             causal=True)
            out.append((dict(
                name="flash_fwd", dtype=dn, shape=[b, h, s, d],
                max_abs_err=err, ms=time_ms(kernel),
                plain_ms=time_ms(partial(fa.flash_attention_reference,
                                         q, k, v, scale=scale)),
                library_ms=time_ms(partial(F.scaled_dot_product_attention,
                                           q, k, v, is_causal=True)),
                bound_ms=bms, bound_by=by), kernel))
    return out


def check_paged(gen, dev):
    import torch

    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")

    out = []
    slots, h, d, ps, maxp = NUM_SLOTS, 12, 64, PAGE_SIZE, 64
    num_pages = 1 + slots * maxp
    lengths = torch.tensor([0, 1, 16, 17, 100, 255, 1000, maxp * ps],
                           dtype=torch.int32)
    perm = torch.randperm(num_pages - 1, generator=gen) + 1
    bt = torch.zeros(slots, maxp, dtype=torch.int32)
    for i in range(slots):
        n = -(-int(lengths[i]) // ps)
        bt[i, :n] = perm[i * maxp:i * maxp + n]
    bt, ln = bt.to(dev), lengths.to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(slots, h, 1, d, generator=gen).to(dev, dtype)
        kp, vp = (torch.randn(num_pages, h, ps, d, generator=gen)
                  .to(dev, dtype) for _ in range(2))
        o = pa.paged_attention(q, kp, vp, bt, ln)
        torch.cuda.synchronize()
        ro = pa.paged_attention_reference(q, kp, vp, bt, ln)
        dn = str(dtype).split(".")[1]
        err = compare("paged_attention", o, ro, dn)
        if (o[0] != 0).any():
            raise AssertionError("paged_attention: a zero-length slot must "
                                 "output exactly 0")
        elt = q.element_size()
        n_pos = int(lengths.sum())
        nbytes = (2 * n_pos * h * d * elt + 2 * slots * h * d * elt
                  + slots * maxp * 4 + slots * 4)
        bms, by = bound_ms(nbytes, 4 * n_pos * h * d, dn)
        kernel = partial(pa.paged_attention, q, kp, vp, bt, ln)
        out.append((dict(
            name="paged_attention", dtype=dn,
            shape=[slots, h, ps, d, maxp], lengths=lengths.tolist(),
            max_abs_err=err, ms=time_ms(kernel),
            plain_ms=time_ms(partial(pa.paged_attention_reference,
                                     q, kp, vp, bt, ln)),
            library_ms=None, bound_ms=bms, bound_by=by), kernel))
    return out


# --- phases 3 and 4: the engine --------------------------------------------


def workload():
    import numpy as np

    rng = np.random.default_rng(SEED)
    prompt_lens = rng.integers(32, 129, N_REQUESTS)
    new_tokens = rng.integers(32, 129, N_REQUESTS)
    prompts = [rng.integers(0, 50257, int(n)).astype(np.int32)
               for n in prompt_lens]
    return prompts, [int(n) for n in new_tokens]


def lockstep_steps(new_tokens, fifo: bool = False):
    """Decode steps lock-step batching at the same slot count would take:
    each batch of NUM_SLOTS requests pads to its longest budget. Batches
    group the longest budgets together (the bench's count) or, with
    ``fifo``, take requests in arrival order."""
    order = list(new_tokens) if fifo else sorted(new_tokens, reverse=True)
    return sum(max(order[g:g + NUM_SLOTS])
               for g in range(0, len(order), NUM_SLOTS))


def run_engine(model, prompts, new_tokens):
    import torch

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.serving import PagedDecodeEngine, Request

    engine = PagedDecodeEngine(model, num_slots=NUM_SLOTS,
                               page_size=PAGE_SIZE)
    reqs = [Request(p, n) for p, n in zip(prompts, new_tokens)]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    outs, stats = engine.run(reqs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(_build.launches)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the engine run launched no {missing} kernel")
    free = engine.cache["free_top"]
    usable = engine.cache["layers"][0]["k_pages"].shape[0] - 1
    if free != usable:
        raise AssertionError(f"pool leaked: {free} free of {usable} pages")
    return outs, stats, elapsed, launches


def build_model(dtype):
    import torch

    from apex_tpu_torch.models import GPTModel, gpt2_small_config

    return GPTModel(gpt2_small_config(dtype=dtype), device="cuda",
                    generator=torch.Generator().manual_seed(SEED)).eval()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from apex_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: apex_tpu_torch not found beside the script "
              f"({exc})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    build_s = _build.build_all()
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=build_s)
    print(smi, flush=True)

    warm_card()
    card_before = card_state()
    gen = torch.Generator().manual_seed(SEED)
    checks = (check_layer_norm(gen, "cuda") + check_flash(gen, "cuda")
              + check_paged(gen, "cuda"))
    rows = [row for row, _ in checks]
    emit("kernels", tolerances=TOL, card_before=card_before,
         card_after=card_state(), results=rows)

    prompts, new_tokens = workload()
    from apex_tpu_torch.models import generate

    model = build_model(torch.float32)
    outs, stats, elapsed, launches32 = run_engine(model, prompts, new_tokens)
    for i, (p, n, o) in enumerate(zip(prompts, new_tokens, outs)):
        ref = generate(model, torch.from_numpy(p)[None].cuda(), n)
        ref = ref[0, p.shape[0]:].cpu().numpy()
        if o.shape != ref.shape or (o != ref).any():
            raise AssertionError(f"request {i}: engine tokens differ from "
                                 f"lock-step generate")
    emit("engine_fp32", requests=N_REQUESTS, num_slots=NUM_SLOTS,
         page_size=PAGE_SIZE, layers=model.config.num_layers,
         token_identical=True, launches=launches32, **stats,
         seconds=elapsed)
    del model
    torch.cuda.empty_cache()

    model = build_model(torch.bfloat16)
    run_engine(model, prompts, new_tokens)                 # warm
    timed = [run_engine(model, prompts, new_tokens) for _ in range(2)]
    _, stats, elapsed, launches = timed[0]
    emit("engine_bf16", requests=N_REQUESTS, num_slots=NUM_SLOTS,
         page_size=PAGE_SIZE, layers=model.config.num_layers,
         tokens_per_s=stats["generated_tokens"] / elapsed, seconds=elapsed,
         repeat_tokens_per_s=stats["generated_tokens"] / timed[1][2],
         lockstep_steps=lockstep_steps(new_tokens),
         lockstep_steps_fifo=lockstep_steps(new_tokens, fifo=True),
         launches=launches, nvidia_smi=smi, card_after=card_state(),
         **stats)

    # where the time goes, last, so that no profiler state touches the times
    # above: one more run of the same workload, then each kernel alone at
    # the shapes of phase 2
    wall, acts = device_profile(partial(run_engine, model, prompts,
                                        new_tokens))
    busy = sum(t for t, _ in acts.values())
    top = sorted(acts.items(), key=lambda kv: -kv[1][0])[:15]
    emit("engine_bf16_profile", wall_s=wall, device_busy_s=busy / 1e3,
         device_idle_share=1.0 - busy / 1e3 / wall,
         top_device=[dict(name=k[:120], ms=t, count=c)
                     for k, (t, c) in top])
    emit("kernel_device_ms", card_before=card_state(), results=[
        dict(name=row["name"], dtype=row["dtype"], shape=row["shape"],
             device_ms=kernel_device_ms(fn, KERNEL_SYMBOLS[row["name"]]))
        for row, fn in checks])
    # the same timed run once more, after the profiler: its slowdown, if any
    _, stats_after, elapsed_after, _ = run_engine(model, prompts, new_tokens)
    emit("engine_bf16_after_profile",
         tokens_per_s=stats_after["generated_tokens"] / elapsed_after)

    # summary: each kernel at the main path's bf16 shapes (decode rows for
    # the norm, a 128-token prefill for flash, the 8-slot pool for paged)
    main_shape = {"layer_norm_fwd": [8, 768], "flash_fwd": [1, 12, 128, 64]}
    summary = []
    for name, (src, replaces) in _build.KERNELS.items():
        row = next(r for r in rows if r["name"] == name
                   and r["dtype"] == "bfloat16"
                   and r["shape"] == main_shape.get(name, r["shape"]))
        summary.append(dict(
            name=name, route="cuda",
            source=os.path.relpath(_build.source_path(name), HERE),
            replaces=replaces, launches=launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
