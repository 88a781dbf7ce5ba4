#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``apex_tpu_torch``'s three paths at full width with seeded random
weights, after building every CUDA kernel from ``apex_tpu_torch/csrc``
(into ``apex_tpu_torch/_build/``): GPT-2-small greedy paged decode through
``PagedDecodeEngine``; GPT-2-small training steps (``GPTModel``,
``gpt_loss``, ``loss.backward()``, ``FusedAdam.step()``); and BERT-Large
pretraining steps (``BertForPreTraining``, ``bert_pretrain_loss_fn``,
``loss.backward()``, ``FusedLAMB.step()``). Phases, one JSON line each:

1. ``device``: the card, its power limit, the kernels' build time and
   registers per thread (from the ptxas reports). The
   card is then kept busy for two seconds, and the phases that time it
   record its clock, power draw and temperature.
2. ``kernels``: each kernel against its plain PyTorch twin on the card, at
   the shapes of the serving and training paths, in fp32 and bf16 (the
   optimizer kernels in fp32 only, as their buffers are), with the
   tolerances below, plus its time, the twin's time, one PyTorch library
   call's time where one computes the same function, and the card's least
   time for the work. The BERT rows: LayerNorm forward and backward at
   width 1024, eps 1e-12, over the 4096 tokens in fp32 (the embedding
   norm) and bf16 (the sublayer norms) and over the MLM head's 640 rows in
   bf16; the flash kernels at 8x16x512x64,
   non-causal, with per-row padding lengths (from the seed) as segment ids
   and dropout 0.1; the xentropy kernels at the gathered MLM head's 640 x
   30528 and the NSP head's 8 x 2, with smoothing 0 and 0.1 and padded
   rows; the stats and LAMB kernels over BERT-Large's flat buffers, with
   an injected inf and NaNs whose count must be exact, and a skipped step
   that must leave every buffer bit-identical.
3. ``engine_fp32``: the 24-request mixed-length workload (prompts and
   outputs uniform in 32..128 tokens, 8 slots, page 16, seed 1) must be
   token-identical, request by request, to per-request lock-step
   ``generate``, and must have launched every kernel.
4. ``engine_bf16``: the same workload in bf16, a warm run then two timed
   runs: generated tokens per second.
5. ``train_fp32``: GPT-2-small, fp32, one batch of 2 x 256 tokens, on the
   card (kernels) and on the CPU (twins) from the same seeded weights: the
   losses agree to 1e-4 relative, every parameter has a gradient on the
   card within atol 1e-4 / rtol 1e-3 of the CPU's, two ``FusedAdam`` steps
   on each side leave a third forward's losses within 1e-4 relative, and
   every training kernel launched.
6. ``train_bf16``: bf16 compute over fp32 parameters, 8 x 1024 tokens,
   ``FusedAdam(lr=1e-4, weight_decay=0.01)`` with biases and norms
   excluded: 2 warm steps, then 10 timed steps. Step ms, tokens/s, FLOPs
   per step and MFU, the launches of each kernel per step, and a falling
   finite loss.
7. ``bert_fp32``: BERT-Large at full width, its depth cut to
   ``BERT_FP32_LAYERS`` so that the CPU side runs in seconds, fp32, B = 2,
   S = 128 with the last row's tail padded, hidden dropout 0 and attention
   dropout 0.1 (its keep masks are exact on both sides), card against CPU
   from the same seeded weights: losses within 1e-4 relative, every
   gradient within atol 1e-4 / rtol 1e-3, two ``FusedLAMB`` steps per side
   and a third forward's losses within 1e-4 relative, every BERT kernel
   launched.
8. ``bert_bf16``: ``bench.py``'s workload: BERT-Large, 24 layers, B = 8,
   S = 512, the MLM head gathered at 80 positions per row, bf16 compute
   over fp32 parameters, hidden and attention dropout 0.1,
   ``FusedLAMB(lr=1e-4, weight_decay=0.01, max_grad_norm=1.0)`` with biases
   and norms excluded from decay: 2 warm steps, then 10 timed steps. Step
   ms, tokens/s, FLOPs per step by ``bench.py``'s formula and MFU, the
   phase's own peak memory (above what earlier phases keep live), the
   launches of each kernel per step (asserted), and a falling finite loss.
9. ``engine_bf16_profile``, ``kernel_device_ms``, ``train_bf16_profile``
   and ``bert_bf16_profile``: one more bf16 engine run under
   ``torch.profiler`` (device busy and idle share, the top device kernels),
   each kernel's device time per call at the shapes of phase 2, the timed
   bf16 engine run once more, and last one profiled step of each training
   path. Last, so that no profiler state can touch the times of phases
   2-8.

Then the per-kernel summary line (serving kernels with the launches of the
timed engine run, GPT training kernels with those of its timed run, the
BERT kernels with those of the timed BERT run; every path's count beside
it) and, last, ``{"ok": true, "device": ...}``.
Any failure raises, so the run exits non-zero without the last line. With
no CUDA device, or without the ``apex_tpu_torch`` package beside it, it
exits non-zero at once. Imports nothing of JAX.
"""

from __future__ import annotations

import importlib
import json
import math
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
# dgamma/dbeta: fp32 sums over all 8192 rows, taken in another order than
# the twin's; magnitudes reach ~100, so 1e-4 relative and 1e-3 absolute
SUM_TOL = (1e-3, 1e-4)
# xentropy dx: softmax probabilities reach ~1e-5 at V = 30528, below the
# default atol; kernel and twin take the same fp32 exp of the same inputs, so
# they agree to a few fp32 ulps (bf16: one rounding, 2^-7 relative)
XENT_DX_TOL = {"float32": (1e-8, 1e-4), "bfloat16": (1e-8, 1e-2)}
# per-segment sums of squares over up to 31 M elements: the kernel adds
# fp32 row partials in fp64, the twin sums every row in fp64, so they differ
# by the partials' rounding (1.2e-7 and 1.4e-7 relative on an H100, the same
# in every run); the sums reach ~3e7, so their rows also report the largest
# relative error
SEGMENT_SUM_TOL = (1e-3, 1e-6)
# the Adam row is checked at a step where every term is seen: the update
# is ~ADAM_LR and the decoupled decay ADAM_LR * ADAM_WD * |p| ~ 1e-4|p|,
# both far above UPDATE_TOL's atol, which is two fp32 ulps of |p| ~ 4-8
ADAM_LR, ADAM_WD = 1e-3, 0.1
UPDATE_TOL = (1e-6, 1e-4)

N_REQUESTS, NUM_SLOTS, PAGE_SIZE, SEED = 24, 8, 16, 1
DEV = "cuda"       # the card; a CPU rehearsal of the phases may set "cpu"

# the training path: GPT-2's context, a fixed synthetic batch
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARM, TRAIN_TIMED = 8, 1024, 2, 10
TRAIN_LR, TRAIN_WD = 1e-4, 0.01
FP32_BATCH, FP32_SEQ = 2, 256

# the BERT slice: bench.py's workload (bench.py:230-328)
BERT_BATCH, BERT_SEQ, BERT_WARM, BERT_TIMED = 8, 512, 2, 10
BERT_LR, BERT_WD, BERT_MAX_NORM, BERT_DROPOUT = 1e-4, 0.01, 1.0, 0.1
BERT_HEADS, BERT_MLM_K = 16, 80       # K = 0.15 S rounded up to 8
# card against CPU: the full width, the depth cut so the CPU side runs in
# seconds; a larger lr than the timed run's so that two steps move the loss
BERT_FP32_BATCH, BERT_FP32_SEQ, BERT_FP32_LAYERS = 2, 128, 4
BERT_FP32_LR = 1e-3

#: the kernels of the serving path and of the two training paths
SERVING_KERNELS = ("layer_norm_fwd", "flash_fwd", "paged_attention")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv",
                 "layer_norm_fwd", "layer_norm_bwd", "adam")
BERT_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv",
                "layer_norm_fwd", "layer_norm_bwd", "xentropy_fwd",
                "xentropy_bwd", "segment_stats", "lamb_phase1",
                "lamb_phase2")
#: kernels whose buffers are fp32 on the path (the summary's dtype)
FP32_KERNELS = ("adam", "xentropy_fwd", "xentropy_bwd", "segment_stats",
                "lamb_phase1", "lamb_phase2")

#: kernel name -> the CUDA symbol the profiler reports its launches under
#: (for ``layer_norm_bwd`` its dx kernel, one launch per call; the small
#: dgamma/dbeta reduction that follows it is not counted)
KERNEL_SYMBOLS = {"layer_norm_fwd": "layer_norm_fwd_kernel",
                  "flash_fwd": "flash_fwd_kernel",
                  "paged_attention": "paged_decode_kernel",
                  "layer_norm_bwd": "layer_norm_bwd_dx_kernel",
                  "flash_bwd_dq": "flash_bwd_dq_kernel",
                  "flash_bwd_dkdv": "flash_bwd_dkdv_kernel",
                  "adam": "adam_kernel",
                  "xentropy_fwd": "xentropy_fwd_kernel",
                  "xentropy_bwd": "xentropy_bwd_kernel",
                  "segment_stats": "stats_rows_kernel",
                  "lamb_phase1": "lamb_phase1_kernel",
                  "lamb_phase2": "lamb_phase2_kernel"}


def ptxas_registers() -> dict:
    """Registers per thread of each built kernel (``<bf16>`` marks the bf16
    instantiation), from the ptxas reports the build keeps beside each
    library."""
    import re

    from apex_tpu_torch.ops import _build

    names = ("layer_norm_fwd_kernel", "layer_norm_bwd_dx_kernel",
             "layer_norm_bwd_dw_kernel", "flash_fwd_kernel",
             "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel",
             "paged_decode_kernel", "adam_kernel", "xentropy_fwd_kernel",
             "xentropy_bwd_kernel", "stats_rows_kernel",
             "segment_reduce_kernel", "lamb_phase1_kernel",
             "lamb_phase2_kernel")
    regs = {}
    for log in sorted(_build.BUILD.glob("*.log")):
        entry = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                name = next((n for n in names if n in entry), entry)
                bf16 = "<bf16>" if "nv_bfloat16" in entry else ""
                regs[name + bf16] = int(m.group(1))
                entry = None
    return regs


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


def phase_memory_start() -> int:
    """Reset the card's peak-memory counter; returns the bytes still live
    from earlier phases (the kernels phase keeps its buffers for the
    profiles at the end), which a phase's own peak is measured above."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def warm_card(seconds: float = 2.0) -> None:
    """Keep the card busy with bf16 products for ``seconds``, so that the
    kernel times of phase 2 are taken at the clocks of a loaded card."""
    import torch

    a = torch.randn(8192, 8192, device=DEV, dtype=torch.bfloat16)
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
    """``(device ms per launch, launches seen)`` of the kernels whose names
    hold ``symbol`` over ``reps`` calls of ``fn``, from the profiler: the
    time is divided by the launches the profiler reports, not by ``reps``,
    so launches it drops do not count as time ((None, 0) when it sees
    none)."""
    _, acts = device_profile(fn, reps)
    hits = [(t, c) for k, (t, c) in acts.items() if symbol in k]
    ms, seen = sum(t for t, _ in hits), sum(c for _, c in hits)
    return (ms / seen if seen else None), seen


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compare(name: str, got, want, dtype: str, tol=None) -> float:
    import torch

    atol, rtol = tol if tol is not None else TOL[dtype]
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


def max_rel_err(got, want) -> float:
    """max |got - want| / |want| over the entries where ``want`` is not 0."""
    got, want = got.float(), want.float()
    nz = want != 0
    return ((got[nz] - want[nz]).abs() / want[nz].abs()).max().item()


# --- phase 2: kernels against their twins ----------------------------------


def layer_norm_cases():
    """``(rows, cols, dtype, eps, extra row fields)`` of the LayerNorm
    checks: GPT-2's at width 768, eps 1e-5 (training rows, a prefill,
    decode rows), then BERT-Large's at width 1024, eps 1e-12: the
    embedding norm (fp32, before the cast), the 48 sublayer norms (bf16)
    and the gathered MLM head's norm (bf16, 640 rows)."""
    import torch

    gpt = [(rows, 768, dtype, 1e-5, {})
           for dtype in (torch.float32, torch.bfloat16)
           for rows in (TRAIN_BATCH * TRAIN_SEQ, 1024, 8)]
    tokens, heads = BERT_BATCH * BERT_SEQ, BERT_BATCH * BERT_MLM_K
    bert = [(tokens, 1024, torch.float32, 1e-12, dict(
                path="bert", use="embedding norm")),
            (tokens, 1024, torch.bfloat16, 1e-12, dict(
                path="bert", use="attention and MLP norms")),
            (heads, 1024, torch.bfloat16, 1e-12, dict(
                path="bert", use="MLM head norm"))]
    return gpt + bert


def check_layer_norm(gen, dev):
    import torch
    import torch.nn.functional as F

    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

    out = []
    for rows, cols, dtype, eps, extra in layer_norm_cases():
        x = (torch.randn(rows, cols, generator=gen) * 2 + 0.5).to(dev, dtype)
        w = (torch.rand(cols, generator=gen) + 0.5).to(dev)
        b = torch.randn(cols, generator=gen).to(dev)
        y, mean, rstd = ln.layer_norm_fwd(x, w, b, eps)
        torch.cuda.synchronize()
        ry, rmean, rstd_ref = ln.layer_norm_fwd_reference(x, w, b, eps)
        dn = str(dtype).split(".")[1]
        err = compare("layer_norm_fwd", y, ry, dn)
        compare("layer_norm_fwd mean", mean, rmean, "float32")
        compare("layer_norm_fwd rstd", rstd, rstd_ref, "float32")
        elt = x.element_size()
        nbytes = 2 * rows * cols * elt + 2 * cols * 4 + 2 * rows * 4
        bms, by = bound_ms(nbytes, 8 * rows * cols, dn)
        kernel = partial(ln.layer_norm_fwd, x, w, b, eps)
        out.append((dict(
            name="layer_norm_fwd", dtype=dn, shape=[rows, cols], eps=eps,
            **extra, max_abs_err=err, ms=time_ms(kernel),
            plain_ms=time_ms(
                partial(ln.layer_norm_fwd_reference, x, w, b, eps)),
            library_ms=time_ms(partial(F.layer_norm, x, (cols,),
                                       w.to(dtype), b.to(dtype), eps)),
            bound_ms=bms, bound_by=by), kernel))
    return out


def check_flash(gen, dev):
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

    out = []
    h, d = 12, 64
    for dtype in (torch.float32, torch.bfloat16):
        for b, s in ((1, 16), (1, 128), (1, 1024), (TRAIN_BATCH, TRAIN_SEQ)):
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


def check_layer_norm_bwd(gen, dev):
    import torch
    import torch.nn.functional as F

    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

    out = []
    # GPT-2's training rows, then BERT-Large's (the rows of the forward's
    # cases but its prefill and decode rows, which take no backward)
    cases = [c for c in layer_norm_cases()
             if c[0] == TRAIN_BATCH * TRAIN_SEQ or c[4]]
    for rows, cols, dtype, eps, extra in cases:
        x = (torch.randn(rows, cols, generator=gen) * 2 + 0.5).to(dev, dtype)
        dy = torch.randn(rows, cols, generator=gen).to(dev, dtype)
        w = (torch.rand(cols, generator=gen) + 0.5).to(dev)
        b = torch.randn(cols, generator=gen).to(dev)
        _, mean, rstd = ln.layer_norm_fwd_reference(x, w, b, eps)
        dx, dw, db = ln.layer_norm_bwd(dy, x, mean, rstd, w)
        torch.cuda.synchronize()
        rdx, rdw, rdb = ln.layer_norm_bwd_reference(dy, x, mean, rstd, w)
        dn = str(dtype).split(".")[1]
        err = max(compare("layer_norm_bwd dx", dx, rdx, dn),
                  compare("layer_norm_bwd dgamma", dw, rdw, dn, SUM_TOL),
                  compare("layer_norm_bwd dbeta", db, rdb, dn, SUM_TOL))
        elt = x.element_size()
        # read dy, x, mean, rstd, w; write dx, dgamma, dbeta
        nbytes = 3 * rows * cols * elt + 2 * rows * 4 + 3 * cols * 4
        bms, by = bound_ms(nbytes, 13 * rows * cols, dn)
        kernel = partial(ln.layer_norm_bwd, dy, x, mean, rstd, w)
        xl = x.detach().requires_grad_()
        wl, bl = (t.to(dtype).requires_grad_() for t in (w, b))
        y = F.layer_norm(xl, (cols,), wl, bl, eps)
        out.append((dict(
            name="layer_norm_bwd", dtype=dn, shape=[rows, cols], eps=eps,
            **extra, max_abs_err=err, ms=time_ms(kernel),
            plain_ms=time_ms(partial(ln.layer_norm_bwd_reference, dy, x,
                                     mean, rstd, w)),
            library_ms=time_ms(partial(torch.autograd.grad, y, (xl, wl, bl),
                                       dy, retain_graph=True)),
            library="backward of F.layer_norm",
            bound_ms=bms, bound_by=by), kernel))
    return out


def check_flash_bwd(gen, dev):
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

    out = []
    b, h, s, d = TRAIN_BATCH, 12, TRAIN_SEQ, 64
    scale = d ** -0.5
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen).to(dev, dtype)
                       for _ in range(4))
        o, lse = fa.flash_attention_reference(q, k, v, scale=scale)
        delta = fa.flash_bwd_delta(o, do)
        args = (q, k, v, do, lse, delta)
        dq = fa.flash_bwd_dq(*args, scale=scale)
        dk, dv = fa.flash_bwd_dkdv(*args, scale=scale)
        torch.cuda.synchronize()
        dn = str(dtype).split(".")[1]
        err_dq = compare("flash_bwd_dq", dq,
                         fa.flash_bwd_dq_reference(*args, scale=scale), dn)
        rdk, rdv = fa.flash_bwd_dkdv_reference(*args, scale=scale)
        err_dkdv = max(compare("flash_bwd_dkdv dk", dk, rdk, dn),
                       compare("flash_bwd_dkdv dv", dv, rdv, dn))
        # the size of what was compared: an error of 0 must not come from
        # outputs that are 0
        absmax = {"flash_bwd_dq": dq.abs().max().item(),
                  "flash_bwd_dkdv": max(dk.abs().max().item(),
                                        dv.abs().max().item())}
        # the library yardstick computes dq, dk and dv in one backward call
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        library_ms = time_ms(partial(torch.autograd.grad, ol, (ql, kl, vl),
                                     do, retain_graph=True))
        elt = q.element_size()
        pairs = b * h * s * (s + 1) // 2      # visible (query, key) pairs
        tile = b * h * s * d * elt
        inputs = 4 * tile + 2 * b * h * s * 4   # q, k, v, do, lse, delta
        for name, err, fn, plain, n_out, flops in (
                ("flash_bwd_dq", err_dq, fa.flash_bwd_dq,
                 fa.flash_bwd_dq_reference, 1, 6 * pairs * d),
                ("flash_bwd_dkdv", err_dkdv, fa.flash_bwd_dkdv,
                 fa.flash_bwd_dkdv_reference, 2, 8 * pairs * d)):
            bms, by = bound_ms(inputs + n_out * tile, flops, dn)
            kernel = partial(fn, *args, scale=scale)
            out.append((dict(
                name=name, dtype=dn, shape=[b, h, s, d], max_abs_err=err,
                out_absmax=absmax[name], ms=time_ms(kernel),
                plain_ms=time_ms(partial(plain, *args, scale=scale)),
                library_ms=library_ms,
                library="backward of F.scaled_dot_product_attention("
                        "is_causal=True): dq, dk and dv together",
                bound_ms=bms, bound_by=by), kernel))
    return out


def no_decay(name: str) -> bool:
    """Biases and norm parameters take no weight decay."""
    return name.endswith("bias") or "norm" in name


def check_adam(gen, dev):
    """The Adam kernel over GPT-2-small's flat buffers (fp32, as in the
    reference), with its per-tensor decay vector."""
    import torch

    from apex_tpu_torch.models import GPTModel, gpt2_small_config
    from apex_tpu_torch.ops import flat_buffer

    oa = importlib.import_module("apex_tpu_torch.ops.optim_kernels")

    named = list(GPTModel(gpt2_small_config(), device="meta")
                 .named_parameters())
    spec = flat_buffer.build_spec(named)
    rows = spec.total_rows
    seg = spec.segment_rows().to(dev)
    decays = torch.tensor([not no_decay(n) for n, _ in named], device=dev)
    wd = decays.float() * ADAM_WD
    g, p, m = (torch.randn(rows, flat_buffer.LANE, generator=gen).to(dev)
               for _ in range(3))
    v = torch.rand(rows, flat_buffer.LANE, generator=gen).to(dev)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd,
              lr=ADAM_LR, step=torch.tensor(3, device=dev), seg_rows=seg)
    p1, m1, v1 = oa.adam_update(g, p.clone(), m.clone(), v.clone(), **kw)
    torch.cuda.synchronize()
    rp, rm, rv = oa.adam_update_reference(g, p, m, v, **kw)
    # the update itself (~lr), not the parameter it lands on, whose own
    # tolerance would hide it
    err = max(compare("adam p - p0", p1 - p, rp - p, "float32", UPDATE_TOL),
              compare("adam m", m1, rm, "float32"),
              compare("adam v", v1, rv, "float32"))
    # the decay each row took, fitted from the kernel's parameters against
    # the twin's without decay: ADAM_WD on the decayed tensors' rows, 0 on
    # the biases' and norms'
    nd = oa.adam_update_reference(
        g, p, m, v, **dict(kw, weight_decay=torch.zeros_like(wd)))[0]
    fitted = ((nd - p1) * p).sum(1) / (ADAM_LR * (p * p).sum(1))
    decay_err = compare("adam decay per row", fitted, wd[seg.long()],
                        "float32", (1e-3, 0.0))
    if decays.all() or not decays.any():
        raise AssertionError("adam: the check needs decayed and excluded "
                             "tensors both")
    bufs = [t.clone() for t in (p, m, v)]
    kernel = partial(oa.adam_update, g, *bufs, **kw)
    # library: fused AdamW over the same tensors, one per parameter, with
    # the same decay groups
    lp = flat_buffer.unflatten(p.clone(), spec)
    lg = flat_buffer.unflatten(g, spec)
    for n, t in lp.items():
        t.grad = lg[n]
    lib = torch.optim.AdamW(
        [{"params": [lp[n] for n, _ in named if not no_decay(n)],
          "weight_decay": ADAM_WD},
         {"params": [lp[n] for n, _ in named if no_decay(n)],
          "weight_decay": 0.0}], lr=ADAM_LR, fused=True)
    # read g, p, m, v and seg_rows; write p, m, v
    nbytes = 7 * rows * flat_buffer.LANE * 4 + rows * 4 + wd.numel() * 4
    bms, by = bound_ms(nbytes, 17 * rows * flat_buffer.LANE, "float32")
    return [(dict(
        name="adam", dtype="float32", shape=[rows, flat_buffer.LANE],
        max_abs_err=err, decay_fit_err=decay_err, ms=time_ms(kernel),
        plain_ms=time_ms(partial(oa.adam_update_reference, g, p, m, v, **kw)),
        library_ms=time_ms(lib.step),
        library="torch.optim.AdamW(fused=True).step()",
        bound_ms=bms, bound_by=by), kernel)]


def check_flash_bert(gen, dev):
    """The three flash kernels at BERT-Large's shape: non-causal, per-row
    padding lengths as segment ids, dropout 0.1."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

    out = []
    b, h, s, d = BERT_BATCH, BERT_HEADS, BERT_SEQ, 64
    scale = d ** -0.5
    lengths = torch.randint(s // 4, s + 1, (b,), generator=gen)
    seg = (torch.arange(s)[None, :] < lengths[:, None]).int().to(dev)
    masking = fa.Masking(causal=False, segment_ids=seg, kv_segment_ids=seg,
                         dropout_rate=BERT_DROPOUT, dropout_seed=SEED)
    # the library yardstick: the same visibility as a boolean mask
    lib_mask = (seg[:, None, :, None] == seg[:, None, None, :])
    # visible (query, key) pairs: each row sees its own segment
    pairs = h * sum(int(n) ** 2 + (s - int(n)) ** 2 for n in lengths)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen).to(dev, dtype)
                       for _ in range(4))
        o, lse = fa.flash_fwd(q, k, v, scale=scale, masking=masking)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_reference(q, k, v, scale=scale,
                                                masking=masking)
        dn = str(dtype).split(".")[1]
        err_fwd = compare("flash_fwd (bert)", o, ro, dn)
        compare("flash_fwd (bert) lse", lse, rlse, "float32")
        delta = fa.flash_bwd_delta(ro, do)
        args = (q, k, v, do, rlse, delta)
        kw = dict(scale=scale, masking=masking)
        dq = fa.flash_bwd_dq(*args, **kw)
        dk, dv = fa.flash_bwd_dkdv(*args, **kw)
        torch.cuda.synchronize()
        err_dq = compare("flash_bwd_dq (bert)", dq,
                         fa.flash_bwd_dq_reference(*args, **kw), dn)
        rdk, rdv = fa.flash_bwd_dkdv_reference(*args, **kw)
        err_dkdv = max(compare("flash_bwd_dkdv (bert) dk", dk, rdk, dn),
                       compare("flash_bwd_dkdv (bert) dv", dv, rdv, dn))
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=lib_mask,
                                            dropout_p=BERT_DROPOUT)
        lib_fwd = time_ms(partial(F.scaled_dot_product_attention, q, k, v,
                                  attn_mask=lib_mask, dropout_p=BERT_DROPOUT))
        lib_bwd = time_ms(partial(torch.autograd.grad, ol, (ql, kl, vl), do,
                                  retain_graph=True))
        elt = q.element_size()
        tile = b * h * s * d * elt
        segs = 2 * b * s * 4
        common = dict(dtype=dn, shape=[b, h, s, d], path="bert",
                      masking="non-causal, padding segment ids, dropout "
                              f"{BERT_DROPOUT}", lengths=lengths.tolist())
        for name, err, fn, plain, nbytes, flops, lib, lib_name in (
                ("flash_fwd", err_fwd, fa.flash_fwd,
                 fa.flash_attention_reference,
                 4 * tile + b * h * s * 4 + segs, 4 * pairs * d, lib_fwd,
                 "F.scaled_dot_product_attention(attn_mask, dropout_p)"),
                ("flash_bwd_dq", err_dq, fa.flash_bwd_dq,
                 fa.flash_bwd_dq_reference,
                 5 * tile + 2 * b * h * s * 4 + segs, 6 * pairs * d, lib_bwd,
                 "backward of F.scaled_dot_product_attention(attn_mask, "
                 "dropout_p): dq, dk and dv together"),
                ("flash_bwd_dkdv", err_dkdv, fa.flash_bwd_dkdv,
                 fa.flash_bwd_dkdv_reference,
                 6 * tile + 2 * b * h * s * 4 + segs, 8 * pairs * d, lib_bwd,
                 "backward of F.scaled_dot_product_attention(attn_mask, "
                 "dropout_p): dq, dk and dv together")):
            call = (q, k, v) if name == "flash_fwd" else args
            bms, by = bound_ms(nbytes, flops, dn)
            kernel = partial(fn, *call, **kw)
            out.append((dict(
                name=name, **common, max_abs_err=err, ms=time_ms(kernel),
                plain_ms=time_ms(partial(plain, *call, **kw)),
                library_ms=lib, library=lib_name, bound_ms=bms,
                bound_by=by), kernel))
    return out


def check_xentropy(gen, dev):
    """Forward and backward at the gathered MLM head (640 x 30528; fp32 on
    the path, where the logits are cast before the loss) and the NSP head
    (8 x 2, padding_idx -1), smoothing 0 and 0.1, every seventh MLM row
    padded."""
    import torch
    import torch.nn.functional as F

    xe = importlib.import_module("apex_tpu_torch.ops.xentropy")

    out = []
    mlm_rows, vocab = BERT_BATCH * BERT_MLM_K, 30528
    cases = ((mlm_rows, vocab, 0.0, 0), (mlm_rows, vocab, 0.1, 0),
             (BERT_BATCH, 2, 0.0, -1))
    for dtype in (torch.float32, torch.bfloat16):
        for rows, width, smoothing, pad in cases:
            x = (torch.randn(rows, width, generator=gen) * 3).to(dev, dtype)
            labels = torch.randint(0, width, (rows,), generator=gen,
                                   dtype=torch.int32)
            if pad == 0:
                labels[::7] = 0
            labels = labels.to(dev)
            dy = torch.randn(rows, generator=gen).to(dev)
            loss, lse = xe.xentropy_fwd(x, labels, smoothing, pad)
            dx = xe.xentropy_bwd(x, labels, lse, dy, smoothing, pad)
            torch.cuda.synchronize()
            rloss, rlse = xe.xentropy_fwd_reference(x, labels, smoothing, pad)
            rdx = xe.xentropy_bwd_reference(x, labels, rlse, dy, smoothing,
                                            pad)
            dn = str(dtype).split(".")[1]
            err_fwd = max(compare("xentropy_fwd loss", loss, rloss,
                                  "float32"),
                          compare("xentropy_fwd lse", lse, rlse, "float32"))
            err_bwd = compare("xentropy_bwd dx", dx, rdx, dn,
                              XENT_DX_TOL[dn])
            if pad == 0 and ((loss[::7] != 0).any() or (dx[::7] != 0).any()):
                raise AssertionError("xentropy: a padded row must give loss "
                                     "0 and dx 0")
            n, elt = rows * width, x.element_size()
            lib_kw = dict(reduction="none", ignore_index=pad,
                          label_smoothing=smoothing)
            xl = x.detach().requires_grad_()
            ll = F.cross_entropy(xl, labels.long(), **lib_kw)
            common = dict(dtype=dn, shape=[rows, width], smoothing=smoothing,
                          padding_idx=pad, path="bert")
            for name, err, fn, plain, nbytes, lib, lib_name in (
                    ("xentropy_fwd", err_fwd,
                     partial(xe.xentropy_fwd, x, labels, smoothing, pad),
                     partial(xe.xentropy_fwd_reference, x, labels, smoothing,
                             pad),
                     n * elt + 3 * rows * 4,
                     partial(F.cross_entropy, x, labels.long(), **lib_kw),
                     "F.cross_entropy(reduction='none', ignore_index, "
                     "label_smoothing)"),
                    ("xentropy_bwd", err_bwd,
                     partial(xe.xentropy_bwd, x, labels, lse, dy, smoothing,
                             pad),
                     partial(xe.xentropy_bwd_reference, x, labels, lse, dy,
                             smoothing, pad),
                     2 * n * elt + 3 * rows * 4,
                     partial(torch.autograd.grad, ll, xl, dy,
                             retain_graph=True),
                     "backward of the same F.cross_entropy")):
                bms, by = bound_ms(nbytes, 4 * n, "float32")
                out.append((dict(
                    name=name, **common, max_abs_err=err, ms=time_ms(fn),
                    plain_ms=time_ms(plain), library_ms=time_ms(lib),
                    library=lib_name, bound_ms=bms, bound_by=by), fn))
    return out


def bert_no_decay(name: str) -> bool:
    """bench.py's exclusion: biases and norms take no weight decay."""
    return "bias" in name or "norm" in name.lower()


def check_lamb(gen, dev):
    """The stats kernel and both LAMB phases over the flat buffers of
    BertForPreTraining(bert_large_config()), with its per-tensor decay."""
    import torch

    from apex_tpu_torch.models import BertForPreTraining, bert_large_config
    from apex_tpu_torch.ops import flat_buffer

    oa = importlib.import_module("apex_tpu_torch.ops.optim_kernels")

    named = list(BertForPreTraining(bert_large_config(), device="meta")
                 .named_parameters())
    spec = flat_buffer.build_spec(named)
    rows, segs, lane = spec.total_rows, spec.num_tensors, flat_buffer.LANE
    n = rows * lane
    seg = spec.segment_rows().to(dev)
    dgen = torch.Generator(device=dev).manual_seed(SEED)

    def randn():
        return torch.randn(rows, lane, generator=dgen, device=dev)

    out = []
    # segment stats: an inf and two NaNs in the gradients, counted exactly
    g = randn()
    g[0, 5] = float("inf")
    g[rows // 2, 7] = g[rows // 2, 8] = float("nan")
    stats = oa.segment_stats(g, seg, segs)
    torch.cuda.synchronize()
    rstats = oa.segment_stats_reference(g, seg, segs)
    if not torch.equal(stats[2], rstats[2]) or stats[2].sum().item() != 3:
        raise AssertionError(f"segment_stats: non-finite count "
                             f"{stats[2].sum().item()}, twin "
                             f"{rstats[2].sum().item()}, injected 3")
    finite = torch.isfinite(rstats[:2])
    err = compare("segment_stats sumsq", stats[:2][finite],
                  rstats[:2][finite], "float32", SEGMENT_SUM_TOL)
    rel = max_rel_err(stats[:2][finite], rstats[:2][finite])
    again = oa.segment_stats(g, seg, segs)
    if not torch.equal(torch.nan_to_num(again), torch.nan_to_num(stats)):
        raise AssertionError("segment_stats: two runs differ")
    views = list(flat_buffer.unflatten(g, spec).values())
    bms, by = bound_ms(n * 4 + rows * 4 + 3 * segs * 4, 3 * n, "float32")
    kernel = partial(oa.segment_stats, g, seg, segs)
    out.append((dict(
        name="segment_stats", dtype="float32", shape=[rows, lane],
        segments=segs, params=sum(spec.sizes), path="bert",
        nonfinite_injected=3, max_abs_err=err, sums_max_rel_err=rel,
        sums_tolerance=SEGMENT_SUM_TOL, ms=time_ms(kernel),
        plain_ms=time_ms(partial(oa.segment_stats_reference, g, seg, segs)),
        library_ms=time_ms(partial(torch._foreach_norm, views)),
        library="torch._foreach_norm over the per-parameter views",
        bound_ms=bms, bound_by=by), kernel))
    del g, views

    # LAMB: phase 1 against its twin, the trust ratio, phase 2; then a
    # skipped step, which must leave every buffer bit-identical
    g, p, m = randn(), randn(), randn() * 0.1
    v = torch.rand(rows, lane, generator=dgen, device=dev) * 0.01
    wd = torch.tensor([0.0 if bert_no_decay(nm) else BERT_WD
                       for nm, _ in named], device=dev)
    hp = oa.lamb_hyperparams(beta1=0.9, beta2=0.999, eps=1e-6,
                             step=torch.tensor(3, device=dev),
                             grad_scale=0.5, noop=0.0, device=dev)
    u, m1, v1, st = oa.lamb_phase1(hp, g, p, m.clone(), v.clone(), seg, wd)
    torch.cuda.synchronize()
    ru, rm, rv, rst = oa.lamb_phase1_reference(hp, g, p, m, v, seg, wd)
    err1 = max(compare("lamb_phase1 u", u, ru, "float32"),
               compare("lamb_phase1 m", m1, rm, "float32"),
               compare("lamb_phase1 v", v1, rv, "float32"),
               compare("lamb_phase1 norms", st, rst, "float32",
                       SEGMENT_SUM_TOL))
    rel1 = max_rel_err(st, rst)
    del ru, rm, rv
    ratio = oa.lamb_trust_ratio(st, wd)
    hp2 = torch.stack([torch.tensor(ADAM_LR, device=dev), hp[7]])
    p1 = oa.lamb_phase2(hp2, u, p.clone(), ratio, seg)
    torch.cuda.synchronize()
    rp = oa.lamb_phase2_reference(hp2, u, p, ratio, seg)
    err2 = compare("lamb_phase2 p - p0", p1 - p, rp - p, "float32",
                   UPDATE_TOL)
    del rp, p1
    skip = hp.clone()
    skip[7] = 1.0
    mk, vk, pk = m.clone(), v.clone(), p.clone()
    uk, _, _, _ = oa.lamb_phase1(skip, g, p, mk, vk, seg, wd)
    oa.lamb_phase2(torch.stack([hp2[0], skip[7]]), u, pk, ratio, seg)
    torch.cuda.synchronize()
    if not (torch.equal(mk, m) and torch.equal(vk, v) and torch.equal(pk, p)
            and not uk.any()):
        raise AssertionError("lamb: a skipped step changed a buffer")
    del mk, vk, pk, uk, u
    bufs = [t.clone() for t in (m, v)]
    phase1 = partial(oa.lamb_phase1, hp, g, p, *bufs, seg, wd)
    u = phase1()[0]
    pb = p.clone()
    phase2 = partial(oa.lamb_phase2, hp2, u, pb, ratio, seg)
    tables = rows * 4 + 3 * segs * 4
    for name, err, extra, fn, plain, nbytes, flops in (
            ("lamb_phase1", err1,
             dict(norms_max_rel_err=rel1, norms_tolerance=SEGMENT_SUM_TOL),
             phase1,
             partial(oa.lamb_phase1_reference, hp, g, p, m, v, seg, wd),
             7 * n * 4 + tables, 20 * n),
            ("lamb_phase2", err2, {}, phase2,
             partial(oa.lamb_phase2_reference, hp2, u, p, ratio, seg),
             3 * n * 4 + tables, 2 * n)):
        bms, by = bound_ms(nbytes, flops, "float32")
        out.append((dict(
            name=name, dtype="float32", shape=[rows, lane], segments=segs,
            params=sum(spec.sizes), path="bert", max_abs_err=err, **extra,
            skip_bit_identical=True, ms=time_ms(fn), plain_ms=time_ms(plain),
            library_ms=None, bound_ms=bms, bound_by=by), fn))
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
    missing = [k for k in SERVING_KERNELS if launches[k] == 0]
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

    return GPTModel(gpt2_small_config(dtype=dtype), device=DEV,
                    generator=torch.Generator().manual_seed(SEED)).eval()


# --- phases 5 and 6: training ----------------------------------------------


def train_batch(cfg, batch: int, seq: int, dev):
    """Token ids (GPT-2's 50257, within the padded vocab) and next-token
    labels, from the seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, min(50257, cfg.vocab_size),
                                        (batch, seq)))
    return ids.to(dev), torch.roll(ids, -1, dims=1).to(dev)


def make_optimizer(model):
    from apex_tpu_torch.optimizers import FusedAdam

    return FusedAdam(model.named_parameters(), lr=TRAIN_LR,
                     weight_decay=TRAIN_WD, exclude_from_weight_decay=no_decay)


def train_fp32():
    """Card against CPU: loss, every gradient, and two FusedAdam steps."""
    import torch

    from apex_tpu_torch.models import GPTModel, gpt2_small_config, gpt_loss
    from apex_tpu_torch.ops import _build

    cfg = gpt2_small_config(dtype=torch.float32)
    sides = {}
    for side, dev in (("card", DEV), ("cpu", "cpu")):
        model = GPTModel(cfg, device=dev,
                         generator=torch.Generator().manual_seed(SEED))
        sides[side] = (model, *train_batch(cfg, FP32_BATCH, FP32_SEQ, dev))
    torch.cuda.synchronize()
    _build.reset_launches()
    losses, grads = {}, {}
    for side, (model, ids, labels) in sides.items():
        loss = gpt_loss(model, ids, labels)
        loss.backward()
        grads[side] = {n: p.grad for n, p in model.named_parameters()}
        losses[side] = [loss.item()]
    missing = [n for n, g in grads["card"].items() if g is None]
    if missing:
        raise AssertionError(f"train_fp32: no gradient on the card for "
                             f"{missing}")
    grad_err = 0.0
    for n, g in grads["card"].items():
        grad_err = max(grad_err, compare(f"train_fp32 grad {n}", g.cpu(),
                                         grads["cpu"][n], "float32",
                                         (1e-4, 1e-3)))
    for side, (model, ids, labels) in sides.items():
        opt = make_optimizer(model)          # keeps the gradients above
        opt.step()
        opt.zero_grad()
        loss = gpt_loss(model, ids, labels)
        loss.backward()
        opt.step()
        losses[side].append(loss.item())
        with torch.no_grad():
            losses[side].append(gpt_loss(model, ids, labels).item())
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for i, (a, b) in enumerate(zip(losses["card"], losses["cpu"])):
        if abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"train_fp32: loss {i} differs: card {a} "
                                 f"vs CPU {b}")
    idle = [k for k in TRAIN_KERNELS if launches[k] == 0]
    if idle:
        raise AssertionError(f"train_fp32: no launch of {idle}")
    emit("train_fp32", batch=FP32_BATCH, seq=FP32_SEQ,
         layers=cfg.num_layers, losses_card=losses["card"],
         losses_cpu=losses["cpu"], max_grad_abs_err=grad_err,
         params_with_grad=len(grads["card"]), launches=launches)


def train_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of one training step: 6 x the matmul parameters (the tied LM
    head included, embeddings' gathers and norms not) per token, plus causal
    attention, 3 x (forward) 2 products x 2 FLOPs x d per visible pair."""
    e, layers = cfg.hidden_size, cfg.num_layers
    matmul_params = layers * 12 * e * e + cfg.vocab_size * e
    pairs = batch * cfg.num_heads * seq * (seq + 1) // 2
    return (6 * matmul_params * batch * seq
            + layers * 12 * pairs * cfg.head_dim)


def train_bf16(smi):
    import torch

    from apex_tpu_torch.models import gpt_loss
    from apex_tpu_torch.ops import _build

    live = phase_memory_start()
    model = build_model(torch.bfloat16)
    cfg = model.config
    opt = make_optimizer(model)
    ids, labels = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, DEV)

    def step():
        opt.zero_grad()
        loss = gpt_loss(model, ids, labels)
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [step() for _ in range(TRAIN_WARM)]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    losses += [step() for _ in range(TRAIN_TIMED)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(_build.launches)
    with torch.no_grad():
        final = gpt_loss(model, ids, labels).item()
    losses = [x.item() for x in losses]
    want = {"flash_fwd": cfg.num_layers, "flash_bwd_dq": cfg.num_layers,
            "flash_bwd_dkdv": cfg.num_layers,
            "layer_norm_fwd": 2 * cfg.num_layers + 1,
            "layer_norm_bwd": 2 * cfg.num_layers + 1, "adam": 1}
    per_step = {k: launches[k] / TRAIN_TIMED for k in want}
    wrong = {k: n for k, n in per_step.items() if n != want[k]}
    if wrong:
        raise AssertionError(f"train_bf16: launches per step {wrong}, want "
                             f"{want}")
    if not all(map(math.isfinite, losses + [final])) or not final < losses[0]:
        raise AssertionError(f"train_bf16: loss not finite and falling: "
                             f"{losses} then {final}")
    step_s = elapsed / TRAIN_TIMED
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    emit("train_bf16", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         layers=cfg.num_layers, timed_steps=TRAIN_TIMED,
         step_ms=step_s * 1e3, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
         flops_per_step=flops,
         flops_formula="6 * (12 L e^2 + V e) * B * S + 12 L * B H S(S+1)/2 "
                       "* d",
         mfu=flops / step_s / PEAK_FLOPS["bfloat16"],
         peak_flops=PEAK_FLOPS["bfloat16"], losses=losses,
         loss_after=final, launches_per_step=per_step, launches=launches,
         peak_memory_gib=(torch.cuda.max_memory_allocated() - live)
         / 2 ** 30, earlier_phases_live_gib=live / 2 ** 30,
         nvidia_smi=smi, card_after=card_state())
    return step, launches


# --- phases 7 and 8: BERT-Large pretraining --------------------------------


def bert_batch(cfg, batch: int, seq: int, dev, pad_tail: int = 0):
    """``synthetic_batch`` from numpy seed 0, as bench.py draws it; with
    ``pad_tail``, the last row's last tokens are padding (mask 0)."""
    import numpy as np

    from apex_tpu_torch.models import synthetic_batch

    out = synthetic_batch(np.random.default_rng(0), cfg, batch, seq,
                          device=dev)
    if pad_tail:
        out["attention_mask"][-1, -pad_tail:] = 0
    return out


def make_lamb(model, lr: float):
    from apex_tpu_torch.optimizers import FusedLAMB

    return FusedLAMB(model.named_parameters(), lr=lr, weight_decay=BERT_WD,
                     max_grad_norm=BERT_MAX_NORM,
                     exclude_from_weight_decay=bert_no_decay)


def bert_fp32():
    """Card against CPU: loss, every gradient, and two FusedLAMB steps."""
    import torch

    from apex_tpu_torch.models import (BertForPreTraining, bert_large_config,
                                       bert_pretrain_loss_fn)
    from apex_tpu_torch.ops import _build

    cfg = bert_large_config(num_layers=BERT_FP32_LAYERS, dtype=torch.float32,
                            hidden_dropout=0.0,
                            attention_dropout=BERT_DROPOUT)
    sides = {}
    for side, dev in (("card", DEV), ("cpu", "cpu")):
        model = BertForPreTraining(
            cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
        sides[side] = (model, bert_batch(cfg, BERT_FP32_BATCH, BERT_FP32_SEQ,
                                         dev, pad_tail=BERT_FP32_SEQ // 4))
    torch.cuda.synchronize()
    _build.reset_launches()
    losses, grads = {}, {}
    for side, (model, batch) in sides.items():
        loss = bert_pretrain_loss_fn(model, batch, SEED)
        loss.backward()
        grads[side] = {n: p.grad for n, p in model.named_parameters()}
        losses[side] = [loss.item()]
    missing = [n for n, g in grads["card"].items() if g is None]
    if missing:
        raise AssertionError(f"bert_fp32: no gradient on the card for "
                             f"{missing}")
    grad_err = 0.0
    for n, g in grads["card"].items():
        grad_err = max(grad_err, compare(f"bert_fp32 grad {n}", g.cpu(),
                                         grads["cpu"][n], "float32",
                                         (1e-4, 1e-3)))
    for side, (model, batch) in sides.items():
        opt = make_lamb(model, BERT_FP32_LR)     # keeps the gradients above
        opt.step()
        opt.zero_grad()
        loss = bert_pretrain_loss_fn(model, batch, SEED + 1)
        loss.backward()
        opt.step()
        losses[side].append(loss.item())
        with torch.no_grad():
            losses[side].append(
                bert_pretrain_loss_fn(model, batch, SEED + 2).item())
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for i, (a, b) in enumerate(zip(losses["card"], losses["cpu"])):
        if abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"bert_fp32: loss {i} differs: card {a} "
                                 f"vs CPU {b}")
    idle = [k for k in BERT_KERNELS if launches[k] == 0]
    if idle:
        raise AssertionError(f"bert_fp32: no launch of {idle}")
    emit("bert_fp32", batch=BERT_FP32_BATCH, seq=BERT_FP32_SEQ,
         layers=cfg.num_layers, layers_cut_from=24,
         depth_cut="the CPU side's fp32 forward, backward and LAMB steps",
         hidden=cfg.hidden_size, vocab=cfg.vocab_size,
         attention_dropout=cfg.attention_dropout, lamb_lr=BERT_FP32_LR,
         losses_card=losses["card"], losses_cpu=losses["cpu"],
         max_grad_abs_err=grad_err, params_with_grad=len(grads["card"]),
         launches=launches)


def bert_flops_per_token(cfg, seq: int, mlm_k: int) -> float:
    """bench.py's ``model_flops_per_token`` (bench.py:152-163), copied:
    matmul FLOPs per token, forward and backward, the MLM head counted at
    its K of S gathered positions."""
    e, i, layers, v = (cfg.hidden_size, cfg.intermediate_size,
                       cfg.num_layers, cfg.vocab_size)
    per_layer = 8 * e * e + 4 * seq * e + 4 * e * i
    head = (2 * e * e + 2 * e * v) * (mlm_k / seq)
    return 3.0 * (layers * per_layer + head)


def bert_bf16(smi):
    import torch

    from apex_tpu_torch.models import (BertForPreTraining, bert_large_config,
                                       bert_pretrain_loss_fn)
    from apex_tpu_torch.ops import _build

    live = phase_memory_start()
    cfg = bert_large_config()
    model = BertForPreTraining(cfg, device=DEV,
                               generator=torch.Generator().manual_seed(SEED))
    opt = make_lamb(model, BERT_LR)
    batch = bert_batch(cfg, BERT_BATCH, BERT_SEQ, DEV)
    mlm_k = batch["mlm_positions"].shape[1]
    seeds = iter(range(10 ** 9))     # the step index is the dropout seed

    def step():
        opt.zero_grad()
        loss = bert_pretrain_loss_fn(model, batch, next(seeds))
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [step() for _ in range(BERT_WARM)]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    losses += [step() for _ in range(BERT_TIMED)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(_build.launches)
    with torch.no_grad():        # step 0's dropout masks, the trained weights
        final = bert_pretrain_loss_fn(model, batch, 0).item()
    losses = [x.item() for x in losses]
    layers = cfg.num_layers
    want = {"flash_fwd": layers, "flash_bwd_dq": layers,
            "flash_bwd_dkdv": layers, "layer_norm_fwd": 2 * layers + 2,
            "layer_norm_bwd": 2 * layers + 2, "xentropy_fwd": 2,
            "xentropy_bwd": 2, "segment_stats": 1, "lamb_phase1": 1,
            "lamb_phase2": 1}
    per_step = {k: launches[k] / BERT_TIMED for k in want}
    wrong = {k: n for k, n in per_step.items() if n != want[k]}
    if wrong:
        raise AssertionError(f"bert_bf16: launches per step {wrong}, want "
                             f"{want}")
    if not all(map(math.isfinite, losses + [final])) or not final < losses[0]:
        raise AssertionError(f"bert_bf16: loss not finite and falling: "
                             f"{losses} then {final}")
    step_s = elapsed / BERT_TIMED
    tokens = BERT_BATCH * BERT_SEQ
    per_token = bert_flops_per_token(cfg, BERT_SEQ, mlm_k)
    flops = per_token * tokens
    emit("bert_bf16", batch=BERT_BATCH, seq=BERT_SEQ, layers=layers,
         hidden=cfg.hidden_size, heads=cfg.num_heads, vocab=cfg.vocab_size,
         mlm_k=mlm_k, params=sum(p.numel() for p in model.parameters()),
         segments=opt.spec.num_tensors, timed_steps=BERT_TIMED,
         step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
         flops_per_token=per_token, flops_per_step=flops,
         flops_formula="bench.py model_flops_per_token: 3 (L (8 e^2 + 4 S e "
                       "+ 4 e i) + (2 e^2 + 2 e V) K / S) per token",
         mfu=flops / step_s / PEAK_FLOPS["bfloat16"],
         peak_flops=PEAK_FLOPS["bfloat16"], losses=losses,
         loss_after=final, launches_per_step=per_step, launches=launches,
         peak_memory_gib=(torch.cuda.max_memory_allocated() - live)
         / 2 ** 30, earlier_phases_live_gib=live / 2 ** 30,
         nvidia_smi=smi, card_after=card_state())
    return step, launches


def profile_phase(phase: str, fn) -> None:
    """One run of ``fn`` under the profiler: device busy and idle share and
    the top device items."""
    wall, acts = device_profile(fn)
    busy = sum(t for t, _ in acts.values())
    top = sorted(acts.items(), key=lambda kv: -kv[1][0])[:15]
    emit(phase, wall_s=wall, device_busy_s=busy / 1e3,
         device_idle_share=1.0 - busy / 1e3 / wall,
         top_device=[dict(name=k[:120], ms=t, count=c)
                     for k, (t, c) in top])


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
         build_s=build_s, registers=ptxas_registers())
    print(smi, flush=True)

    warm_card()
    card_before = card_state()
    gen = torch.Generator().manual_seed(SEED)
    checks = (check_layer_norm(gen, DEV) + check_flash(gen, DEV)
              + check_paged(gen, DEV) + check_layer_norm_bwd(gen, DEV)
              + check_flash_bwd(gen, DEV) + check_adam(gen, DEV)
              + check_flash_bert(gen, DEV) + check_xentropy(gen, DEV)
              + check_lamb(gen, DEV))
    rows = [row for row, _ in checks]
    emit("kernels", tolerances=TOL, card_before=card_before,
         card_after=card_state(), results=rows)

    prompts, new_tokens = workload()
    from apex_tpu_torch.models import generate

    model = build_model(torch.float32)
    outs, stats, elapsed, launches32 = run_engine(model, prompts, new_tokens)
    for i, (p, n, o) in enumerate(zip(prompts, new_tokens, outs)):
        ref = generate(model, torch.from_numpy(p)[None].to(DEV), n)
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

    train_fp32()
    train_step, train_launches = train_bf16(smi)
    bert_fp32()
    bert_step, bert_launches = bert_bf16(smi)

    # where the time goes, last, so that no profiler state touches the times
    # above: one more run of the same workload, then each kernel alone at
    # the shapes of phase 2
    profile_phase("engine_bf16_profile",
                  partial(run_engine, model, prompts, new_tokens))
    results = []
    for row, fn in checks:
        ms, seen = kernel_device_ms(fn, KERNEL_SYMBOLS[row["name"]])
        results.append(dict(name=row["name"], dtype=row["dtype"],
                            shape=row["shape"], device_ms=ms,
                            launches_seen=seen))
    emit("kernel_device_ms", card_before=card_state(), reps=20,
         results=results)
    # the same timed run once more, after the profiler: its slowdown, if any
    _, stats_after, elapsed_after, _ = run_engine(model, prompts, new_tokens)
    emit("engine_bf16_after_profile",
         tokens_per_s=stats_after["generated_tokens"] / elapsed_after)
    profile_phase("train_bf16_profile", train_step)
    profile_phase("bert_bf16_profile", bert_step)

    # summary: each serving kernel at the serving path's bf16 shapes (decode
    # rows for the norm, a 128-token prefill for flash, the 8-slot pool for
    # paged) with the timed engine run's launches; each GPT training kernel
    # at its training shapes with its timed run's; each kernel new with the
    # BERT path at BERT's shapes (fp32 optimizer buffers and logits) with
    # the timed BERT run's. A kernel that BERT shares with an earlier path
    # also carries, under "bert_train", its bf16 row at BERT's shape (the
    # sublayer norms' 4096 x 1024 for LayerNorm) with the BERT run's
    # launches. Every path's launches stand beside.
    main_shape = {"layer_norm_fwd": [8, 768], "flash_fwd": [1, 12, 128, 64],
                  "layer_norm_bwd": [TRAIN_BATCH * TRAIN_SEQ, 768],
                  "flash_bwd_dq": [TRAIN_BATCH, 12, TRAIN_SEQ, 64],
                  "flash_bwd_dkdv": [TRAIN_BATCH, 12, TRAIN_SEQ, 64],
                  "xentropy_fwd": [BERT_BATCH * BERT_MLM_K, 30528],
                  "xentropy_bwd": [BERT_BATCH * BERT_MLM_K, 30528]}
    bert_shape = {"layer_norm_fwd": [BERT_BATCH * BERT_SEQ, 1024],
                  "layer_norm_bwd": [BERT_BATCH * BERT_SEQ, 1024]}
    by_path = {"serving": launches, "gpt_train": train_launches,
               "bert_train": bert_launches}
    timing = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")
    summary = []
    for name, (src, replaces) in _build.KERNELS.items():
        path = ("serving" if name in SERVING_KERNELS else "gpt_train"
                if name in TRAIN_KERNELS else "bert_train")
        row = next(r for r in rows if r["name"] == name
                   and r["dtype"] == ("float32" if name in FP32_KERNELS
                                      else "bfloat16")
                   and (r.get("path") == "bert") == (path == "bert_train")
                   and r["shape"] == main_shape.get(name, r["shape"]))
        entry = dict(
            name=name, route="cuda",
            source=os.path.relpath(_build.source_path(name), HERE),
            replaces=replaces, launches=by_path[path][name],
            launches_by_path={k: v[name] for k, v in by_path.items()},
            max_abs_err=row["max_abs_err"],
            **{k: row[k] for k in ("sums_max_rel_err", "norms_max_rel_err")
               if k in row},
            ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"])
        if path != "bert_train" and name in BERT_KERNELS:
            bert = next(r for r in rows if r["name"] == name
                        and r.get("path") == "bert"
                        and r["dtype"] == "bfloat16"
                        and r["shape"] == bert_shape.get(name, r["shape"]))
            entry["bert_train"] = dict(
                shape=bert["shape"], dtype="bfloat16",
                launches=bert_launches[name], **{k: bert[k] for k in timing})
        summary.append(entry)
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
