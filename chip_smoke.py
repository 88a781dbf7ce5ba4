#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``apex_tpu_torch``'s six paths at full width with seeded random
weights, after building every CUDA kernel from ``apex_tpu_torch/csrc``
(into ``apex_tpu_torch/_build/``): GPT-2-small greedy paged decode through
``PagedDecodeEngine``; the same decode with quantized weights
(``GPTModel(gpt2_small_config(weight_policy=...))``,
``quantize_model_params``) and a quantized page pool
(``PagedDecodeEngine(..., kv_dtype=)``); Mistral-7B (GQA, sliding window
4096) greedy paged decode through ``LlamaModel(mistral_7b_config())`` and
the same engine; GPT-2-small training steps (``GPTModel``, ``gpt_loss``,
``loss.backward()``, ``FusedAdam.step()``); BERT-Large pretraining
steps (``BertForPreTraining``, ``bert_pretrain_loss_fn``,
``loss.backward()``, ``FusedLAMB.step()``); and Mistral-7B training steps
(``LlamaModel(mistral_7b_config(num_layers=4))``, ``llama_loss``,
``loss.backward()``, ``FusedAdam.step()``).
Phases, one JSON line each, ``t_s`` giving the seconds since the start:

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
   that must leave every buffer bit-identical. The quantized serving rows:
   the dequant-matmul kernels (int8 and fp8 per channel; int4 at group
   128) at GPT-2-small's four linear shapes, 8 and 128 rows, x in fp32 and
   bf16, timed over copies of the weight that together exceed the L2
   cache (a decode step streams 48 weights), against cuBLAS on the
   dequantized weight; a row alone must equal the same row in the batch,
   bit for bit. The quantized paged kernel with int8 and fp8 pools at the
   paged row's shape, beside the unquantized kernel's time there. The
   Mistral-7B rows, timed as the quantized ones: the RMS branch of the
   LayerNorm forward at width 4096 over a decode step's 8 rows and 4224
   prefill rows (library ``F.rms_norm``); the windowed flash forward at
   1 x 32 x S x 128 over 8 kv heads, window 4096, S = 4224 and 6016
   (library ``scaled_dot_product_attention`` with the band as a boolean
   mask); the windowed paged decode, unquantized and over int8 and fp8
   pools, at 8 slots, 32 heads over 8 kv heads, d = 128, page 16, lengths
   spread over 0..6100 with the entries below each band nulled. The
   Mistral-7B training rows, timed the same way: the RMS branch of the
   LayerNorm backward at width 4096 over a training step's 8192 rows and a
   ragged 77 (fp32, bf16; library: the backward of ``F.rms_norm``); its
   ``memory_efficient`` branch (x-hat from the saved y) for RMSNorm and for
   LayerNorm with a bias at 8192 x 4096 bf16 (the backward of
   ``F.rms_norm`` / ``F.layer_norm``); the windowed flash backward, dq and
   dk/dv, at 1 x 32 x S x 128 over 8 kv heads, window 4096 at S = 4224 and
   6016 and window 256 at S = 1024, with an LSE cotangent, fp32 and bf16
   (the backward of ``scaled_dot_product_attention`` with the band as a
   boolean mask), bound by operations over the band's visible pairs.
3. ``engine_fp32``: the 24-request mixed-length workload (prompts and
   outputs uniform in 32..128 tokens, 8 slots, page 16, seed 1) must be
   token-identical, request by request, to per-request lock-step
   ``generate``, and must have launched every kernel.
   ``engine_quant_fp32``: the workload over (a) int8 and (b) int4 (group
   128) weights, fp pool, each token-identical, request by request, to
   lock-step ``generate`` of the same quantized model; over an fp model
   with (c) an int8 and (d) an fp8 pool, every request's first token equal
   to ``engine_fp32``'s (prefill never reads the pool), with the count of
   fully identical requests and the mean common generated prefix (not
   gated); after one admission into each quantized pool, its pages,
   dequantized, within the bound of each value's quantization step of the
   contiguous prefill K/V. Each run must have launched its kernels.
4. ``engine_bf16``: the same workload in bf16, a warm run then two timed
   runs: generated tokens per second, and (first timed run) host and
   synchronized ms per decode step. ``engine_quant_bf16``: the same for
   ``w8_kv8`` (int8 weights, int8 pool) and ``w4_kv8`` (int4 group 128,
   int8 pool), with launches per kernel, block-linear weight bytes per
   decode step against bf16, a page's bytes against a bf16 page, and the
   slots a fixed pool budget admits.
   ``mistral_fp32`` (the bar): Mistral-7B at full width,
   ``MISTRAL_FP32_LAYERS`` deep, fp32 parameters and pool, window 4096;
   two long requests (prompts of 5,000 and 6,000 tokens, budgets of 64:
   their prefill runs the band, their decode crosses the window) and six
   short ones (32..128 tokens, seed 1), 8 slots, page 16, an explicit pool
   of 1024 pages: every request token-identical to lock-step ``generate``
   (else the first diverging step and its logit gap are printed and the
   phase fails), pages dropped below the band, the pool drained, and only
   the RMS, windowed-flash and windowed-paged kernel branches launched.
   ``mistral_bf16`` (the speed run): all 32 layers in bf16 (14.5 GB of
   weights), the two long requests and the 24-request workload's shape: a
   short warm run, then one timed run: generated tokens/s, decode steps,
   host and synchronized ms per decode step, admission seconds, peak
   memory, ``window_dropped_pages``.
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
9. ``mistral_train_fp32``: Mistral-7B at full width, 2 layers, window cut
   to 128, B = 1, S = 512, fp32, card against CPU from the same seeded
   weights: the loss and every gradient (atol 1e-4 / rtol 1e-3), two
   ``FusedAdam`` steps and a third forward (losses within 1e-4 relative),
   every kernel branch of the path launched and no unwindowed or non-RMS
   kernel; then the same model with every norm ``memory_efficient``: loss
   and every gradient again, and exactly 2L + 1 launches of the
   ``layer_norm_bwd_from_y`` branch on the card.
   ``mistral_train_bf16``: ``mistral_7b_config(num_layers=4)`` at its real
   window of 4096, B = 1, S = 8192 (two windows), bf16 over fp32
   parameters, ``FusedAdam(lr=1e-4, weight_decay=0.01)`` with the norms
   excluded: 2 warm steps, then 3 timed steps. Step ms, tokens/s, FLOPs
   per step (formula in the line) and MFU, peak memory above the earlier
   phases', launches per step asserted (RMSNorm forward and backward 2L +
   1, the three windowed flash kernels L, Adam 1, the unwindowed kernels
   0), and a falling finite loss.
10. ``engine_bf16_profile``, ``engine_quant_bf16_profile``,
   ``mistral_bf16_profile``, ``kernel_device_ms``, ``train_bf16_profile``
   ``bert_bf16_profile`` and ``mistral_train_bf16_profile``: one more bf16
   engine run (and one of each
   quantized configuration, with each kernel's device ms and launches, and
   one Mistral-7B run), the host's ops untraced, under ``torch.profiler``
   (device busy and idle share, the top device kernels),
   each kernel's device time per call at the shapes of phase 2, the timed
   bf16 engine run once more, and last one profiled step of each training
   path. Last, so that no profiler state can touch the times of phases
   2-9.

Then the per-kernel summary line (serving kernels with the launches of the
timed engine run, the quantized serving kernels with those of the timed
``w8_kv8`` or ``w4_kv8`` run, the windowed kernel branches with those of
the timed ``mistral_bf16`` run, GPT training kernels with those of its
timed run, the BERT kernels with those of the timed BERT run, the Mistral
training branches with those of its timed run (the ``memory_efficient``
branch with those of its run in ``mistral_train_fp32``); every path's
count beside it) and, last, ``{"ok": true, "device": ...}``.
Any failure raises, so the run exits non-zero without the last line. With
no CUDA device, or without the ``apex_tpu_torch`` package beside it, it
exits non-zero at once. Imports nothing of JAX.
"""

from __future__ import annotations

import importlib
import itertools
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
# the Mistral rows also cut the atol to RMS_ATOL of the twin's RMS: at
# window 4096 a softmax row spreads over ~4096 keys, so most entries of o,
# dq, dk and dv lie near 1e-2, about TOL's bf16 atol, where a missing key
# tile would pass. Kernel and twin round one fp32 result each, so they
# differ by about one ulp (bf16: 2^-7 |x|, inside rtol), and the atol only
# has to cover entries that round near 0.
RMS_ATOL = 1e-2
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

# the quantized serving slice: the int4 group, GPT-2-small's block linears
# (in, out), the rows of a decode step and of a prefill; fp8 values carry
# 3 mantissa bits, so a quantized page value is within 1/16 of |x| plus
# half the smallest subnormal step (scale / 1024) of the value written
QUANT_GS = 128
QUANT_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
QUANT_ROWS = (NUM_SLOTS, 128)
L2_BYTES = 50 * 2 ** 20

# the Mistral-7B serving slice (mistral_7b_config: 32 query heads over 8 kv
# heads, head_dim 128, window 4096): the kernel rows' shapes (a decode
# step's and a long prefill's rows for RMSNorm; a prefill whose band floor
# passes many key tiles for flash; slot lengths below, at and past the
# window for paged decode), and the engine workload's two long requests,
# whose prefill runs the band and whose decode crosses the window
MISTRAL_WINDOW, MISTRAL_HIDDEN = 4096, 4096
MISTRAL_HEADS, MISTRAL_KV_HEADS, MISTRAL_HEAD_DIM = 32, 8, 128
RMS_ROWS = (NUM_SLOTS, 4224)
FLASH_WINDOW_SEQS = (4224, 6016)
PAGED_WINDOW_LENGTHS = (0, 1, 100, 4095, 4096, 4097, 5000, 6100)
BIG_ITERS = 10            # calls per timing of the windowed flash rows
MISTRAL_LONG = ((5000, 64), (6000, 64))     # (prompt tokens, budget)
MISTRAL_SHORT_FP32 = 6
MISTRAL_FP32_LAYERS = 4
MISTRAL_VOCAB = 32000
# the pool, passed explicitly (the default sizes for 32768 positions): the
# two long requests and eight short ones fit at once
MISTRAL_POOL = dict(num_pages=1024, max_pages_per_seq=384)

# the Mistral-7B training slice: the norms' backward at a training step's
# 8192 rows and at a ragged few; the windowed flash backward at the windowed
# forward rows' shapes, at the training step's own (8192 tokens, two
# windows) and at a window that cuts most pairs ((S, window)); the
# card-against-CPU phase at full width, its depth, window and length cut so
# that the CPU side runs in seconds; the timed phase at two windows of
# tokens, its depth cut to fit the card beside the earlier phases
MISTRAL_TRAIN_LAYERS, MISTRAL_TRAIN_BATCH, MISTRAL_TRAIN_SEQ = 4, 1, 8192
NORM_BWD_ROWS = (MISTRAL_TRAIN_SEQ, 77)
FLASH_BWD_WINDOW_CASES = ((4224, MISTRAL_WINDOW), (6016, MISTRAL_WINDOW),
                          (MISTRAL_TRAIN_SEQ, MISTRAL_WINDOW), (1024, 256))
MISTRAL_TRAIN_FP32 = dict(layers=2, window=128, batch=1, seq=512)
MISTRAL_TRAIN_WARM, MISTRAL_TRAIN_TIMED = 2, 3

#: the kernels of the serving path and of the two training paths
SERVING_KERNELS = ("layer_norm_fwd", "flash_fwd", "paged_attention")
#: the kernel branches of the windowed Mistral serving path
MISTRAL_KERNELS = ("rms_norm_fwd", "flash_fwd_window",
                   "paged_attention_window")
#: the kernel each weight kind and each pool runs on the serving path
DEQUANT_KERNEL = {"int8": "dequant_matmul", "fp8": "dequant_matmul",
                  "int4": "dequant_matmul_w4"}
QUANT_KERNELS = ("dequant_matmul", "dequant_matmul_w4",
                 "paged_attention_quant")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv",
                 "layer_norm_fwd", "layer_norm_bwd", "adam")
BERT_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv",
                "layer_norm_fwd", "layer_norm_bwd", "xentropy_fwd",
                "xentropy_bwd", "segment_stats", "lamb_phase1",
                "lamb_phase2")
#: the kernel branches of the Mistral-7B training path (windowed flash and
#: RMSNorm, both directions, and Adam), and those this slice added
MISTRAL_TRAIN_KERNELS = ("rms_norm_fwd", "rms_norm_bwd", "flash_fwd_window",
                         "flash_bwd_dq_window", "flash_bwd_dkdv_window",
                         "adam")
MISTRAL_TRAIN_NEW = ("rms_norm_bwd", "layer_norm_bwd_from_y",
                     "flash_bwd_dq_window", "flash_bwd_dkdv_window")
#: the unwindowed and non-RMS kernels, which the Mistral paths must not launch
UNWINDOWED = ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd", "flash_bwd_dq",
              "flash_bwd_dkdv")
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
                  "lamb_phase2": "lamb_phase2_kernel",
                  "dequant_matmul": "dequant_matmul_kernel",
                  "dequant_matmul_w4": "dequant_matmul_w4_kernel",
                  "paged_attention_quant": "paged_decode_quant_kernel",
                  "rms_norm_fwd": "layer_norm_fwd_kernel",
                  "flash_fwd_window": "flash_fwd_kernel",
                  "paged_attention_window": "paged_decode_kernel",
                  "rms_norm_bwd": "layer_norm_bwd_dx_kernel",
                  "layer_norm_bwd_from_y": "layer_norm_bwd_dx_kernel",
                  "flash_bwd_dq_window": "flash_bwd_dq_kernel",
                  "flash_bwd_dkdv_window": "flash_bwd_dkdv_kernel"}


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
             "lamb_phase2_kernel", "dequant_matmul_kernel",
             "dequant_matmul_w4_kernel", "paged_decode_quant_kernel")
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
                # the RMS instantiation of the LayerNorm forward, and the
                # RMS and from_y instantiations of its backward
                rms = "<rms>" if (name == "layer_norm_fwd_kernel"
                                  and "Lb1E" in entry) else ""
                flags = re.search(r"Lb([01])ELb([01])E", entry)
                if name == "layer_norm_bwd_dx_kernel" and flags:
                    rms = ("<rms>" if flags.group(1) == "1" else "") + (
                        "<from_y>" if flags.group(2) == "1" else "")
                # the e4m3 instantiations of the quantized kernels
                fp8 = "<e4m3>" if ("fp8_e4m3" in entry or (
                    "dequant_matmul_kernel" in entry and "Li1E" in entry)) \
                    else ""
                regs[name + bf16 + fp8 + rms] = int(m.group(1))
                entry = None
    return regs


#: the script's start, for each phase line's ``t_s``
START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase line, with the seconds since the script started."""
    print(json.dumps({"phase": phase,
                      "t_s": time.perf_counter() - START, **fields}),
          flush=True)


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


def queued_ms(fn, iters: int = 50) -> float:
    """``time_ms`` with the calls queued behind a sleep on the card, so that
    the events time the card's work and not the host's launch rate: calls
    of tens of µs are launch-bound in ``time_ms``. The sleep (~0.4 ms of
    host time per call at the H100's 1.98 GHz) ends before the start
    event, so it is not timed."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(800_000 * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, reps: int = 1, cpu: bool = True):
    """Run ``fn`` ``reps`` times under ``torch.profiler``; returns the wall
    seconds and ``{device activity name: (total ms, count)}`` for every
    kernel and copy the card ran. Empty when the profiler sees no device
    activity. ``cpu=False`` leaves the host's ops untraced, which keeps a
    run of many small ops cheap to trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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


def rms_of(t) -> float:
    return t.float().pow(2).mean().sqrt().item()


def compare(name: str, got, want, dtype: str, tol=None,
            rms_atol: bool = False) -> float:
    """max |got - want|, or AssertionError past ``atol + rtol |want|``
    (``tol``, else ``TOL[dtype]``); ``rms_atol``: the atol no larger than
    ``RMS_ATOL * rms_of(want)``."""
    import torch

    atol, rtol = tol if tol is not None else TOL[dtype]
    got, want = got.float(), want.float()
    if rms_atol:
        atol = min(atol, RMS_ATOL * rms_of(want))
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


def cycling(fn, arg_sets):
    """``fn(*args)`` over the argument sets in turn, one set per call."""
    sets = itertools.cycle(arg_sets)
    return lambda: fn(*next(sets))


def copies_for(nbytes: int) -> int:
    """Copies of a tensor that together exceed the L2 cache by half, so that
    a timed loop over them reads each from device memory."""
    return max(1, min(256, math.ceil(1.5 * L2_BYTES / nbytes)))


def check_dequant(gen, dev):
    """The dequant-matmul kernels at GPT-2-small's block-linear shapes:
    int8 and fp8 per channel (``dequant_matmul``), int4 at group 128
    (``dequant_matmul_w4``), at a decode step's 8 rows and a 128-token
    prefill, x in fp32 and bf16. Kernel, twin and library are each timed
    by ``queued_ms`` over copies of their weight that exceed the L2 cache;
    the library is ``F.linear`` on the dequantized weight in x's dtype
    (cuBLAS on the full-width weight)."""
    import torch
    import torch.nn.functional as F

    quant = importlib.import_module("apex_tpu_torch.ops.quant")

    quantizers = {"int8": quant.quantize_weight,
                  "fp8": quant.quantize_weight_fp8,
                  "int4": partial(quant.quantize_weight_int4,
                                  group_size=QUANT_GS)}
    out = []
    for kind, quantize in quantizers.items():
        name = DEQUANT_KERNEL[kind]
        for n_in, n_out in QUANT_SHAPES:
            w = torch.randn(n_out, n_in, generator=gen) * n_in ** -0.5
            qw, sc = (t.to(dev) for t in quantize(w))
            wbytes = qw.numel() * qw.element_size() + sc.numel() * 4
            qsets = [(qw.clone(), sc.clone())
                     for _ in range(copies_for(wbytes))]
            for dtype in (torch.float32, torch.bfloat16):
                full = quant.dequantize_weight(qw, sc).to(dtype)
                fsets = [(full.clone(),) for _ in range(
                    copies_for(full.numel() * full.element_size()))]
                dn = str(dtype).split(".")[1]
                elt = full.element_size()
                for m in QUANT_ROWS:
                    x = torch.randn(m, n_in, generator=gen).to(dev, dtype)
                    y = quant.fused_dequant_matmul(x, qw, sc)
                    torch.cuda.synchronize()
                    err = compare(name, y,
                                  quant.fused_dequant_matmul_reference(
                                      x, qw, sc), dn)
                    # the kernel's rows do not depend on the batch (the
                    # twin's CPU matmul makes no such promise)
                    if x.is_cuda and not torch.equal(
                            quant.fused_dequant_matmul(x[3:4], qw, sc),
                            y[3:4]):
                        raise AssertionError(f"{name}: a row alone differs "
                                             f"from the same row in a batch")
                    nbytes = m * n_in * elt + wbytes + m * n_out * elt
                    bms, by = bound_ms(nbytes, 2 * m * n_in * n_out, dn)
                    kernel = cycling(partial(quant.fused_dequant_matmul, x),
                                     qsets)
                    out.append((dict(
                        name=name, kind=kind, dtype=dn, shape=[m, n_in, n_out],
                        **({"group_size": QUANT_GS} if kind == "int4" else {}),
                        path="quant_serving", max_abs_err=err,
                        ms=queued_ms(kernel),
                        plain_ms=queued_ms(cycling(partial(
                            quant.fused_dequant_matmul_reference, x), qsets)),
                        library_ms=queued_ms(cycling(partial(F.linear, x),
                                                   fsets)),
                        library="F.linear on the dequantized weight in x's "
                                "dtype (cuBLAS)",
                        weight_copies=len(qsets), bound_ms=bms, bound_by=by),
                        kernel))
    return out


def check_paged_quant(gen, dev):
    """The quantized paged kernel at ``check_paged``'s shape, over int8 and
    fp8 pools quantized from random K/V with per-(page, kv head) scales, q
    in fp32 and bf16; beside it the unquantized kernel's time at the same
    shape over the dequantized pool in q's dtype (all by ``queued_ms``)."""
    import torch

    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    quant = importlib.import_module("apex_tpu_torch.ops.quant")

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
    n_pos = int(lengths.sum())
    live_pages = sum(-(-int(n) // ps) for n in lengths)
    for kv_name in ("int8", "fp8"):
        qdt, qmax = quant.resolve_kv_dtype(kv_name)
        pools = [quant.kv_quantize(
            torch.randn(num_pages, h, ps, d, generator=gen).to(dev) * 2, qdt,
            qmax, axes=(2, 3)) for _ in range(2)]
        (kp, ks), (vp, vs) = ((p, sc[:, :, 0, 0].contiguous())
                              for p, sc in pools)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(slots, h, 1, d, generator=gen).to(dev, dtype)
            kw = dict(k_scales=ks, v_scales=vs)
            o = pa.paged_attention(q, kp, vp, bt, ln, **kw)
            torch.cuda.synchronize()
            ro = pa.paged_attention_reference(q, kp, vp, bt, ln, **kw)
            dn = str(dtype).split(".")[1]
            err = compare("paged_attention_quant", o, ro, dn)
            if (o[0] != 0).any():
                raise AssertionError("paged_attention_quant: a zero-length "
                                     "slot must output exactly 0")
            kpf, vpf = ((p.float() * sc[:, :, None, None]).to(dtype)
                        for p, sc in ((kp, ks), (vp, vs)))
            elt = q.element_size()
            nbytes = (2 * n_pos * h * d + 2 * live_pages * h * 4
                      + 2 * slots * h * d * elt + slots * maxp * 4
                      + slots * 4)
            bms, by = bound_ms(nbytes, 4 * n_pos * h * d, dn)
            kernel = partial(pa.paged_attention, q, kp, vp, bt, ln, **kw)
            out.append((dict(
                name="paged_attention_quant", kind=kv_name, dtype=dn,
                shape=[slots, h, ps, d, maxp], lengths=lengths.tolist(),
                path="quant_serving", max_abs_err=err, ms=queued_ms(kernel),
                plain_ms=queued_ms(partial(pa.paged_attention_reference, q, kp,
                                         vp, bt, ln, **kw)),
                unquantized_ms=queued_ms(partial(pa.paged_attention, q, kpf,
                                               vpf, bt, ln)),
                library_ms=None, bound_ms=bms, bound_by=by), kernel))
    return out


def check_rms_norm(gen, dev):
    """The RMS branch of the LayerNorm forward kernel at Mistral-7B's width,
    eps 1e-5: a decode step's rows, a long prefill's and a training step's
    (``path`` "mistral_train"). Kernel, twin and
    ``F.rms_norm`` (the library) are timed by ``queued_ms``."""
    import torch
    import torch.nn.functional as F

    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

    out = []
    cols, eps = MISTRAL_HIDDEN, 1e-5
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (*RMS_ROWS, MISTRAL_TRAIN_SEQ):
            x = (torch.randn(rows, cols, generator=gen) * 2 + 0.5).to(dev,
                                                                      dtype)
            w = (torch.rand(cols, generator=gen) + 0.5).to(dev)
            y, mean, rstd = ln.rms_norm_fwd(x, w, eps)
            torch.cuda.synchronize()
            ry, _, rstd_ref = ln.rms_norm_fwd_reference(x, w, eps)
            dn = str(dtype).split(".")[1]
            err = compare("rms_norm_fwd", y, ry, dn, rms_atol=True)
            compare("rms_norm_fwd rstd", rstd, rstd_ref, "float32")
            if (mean != 0).any():
                raise AssertionError("rms_norm_fwd: mean must be exactly 0")
            nbytes = 2 * rows * cols * x.element_size() + cols * 4 \
                + 2 * rows * 4
            bms, by = bound_ms(nbytes, 4 * rows * cols, dn)
            kernel = partial(ln.rms_norm_fwd, x, w, eps)
            lib = getattr(F, "rms_norm", None)
            out.append((dict(
                name="rms_norm_fwd", dtype=dn, shape=[rows, cols], eps=eps,
                path="mistral" if rows in RMS_ROWS else "mistral_train",
                max_abs_err=err, out_rms=rms_of(ry), ms=queued_ms(kernel),
                plain_ms=queued_ms(partial(ln.rms_norm_fwd_reference, x, w,
                                           eps)),
                library_ms=None if lib is None else queued_ms(
                    partial(lib, x, (cols,), w.to(dtype), eps)),
                library="F.rms_norm", bound_ms=bms, bound_by=by), kernel))
    return out


def band_pairs(s: int, window: int) -> int:
    """Visible (query, key) pairs of one head of a causal band of
    ``window`` keys over ``s`` positions."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def check_flash_window(gen, dev):
    """The windowed flash forward at Mistral-7B's prefill shapes: 1 x 32 x S
    x 128 queries over 8 kv heads, window 4096, at S = 4224 and 6016 (the
    band floor passes 4 and 60 key tiles of the last query tile), and at a
    training step's S = 8192 (``path`` "mistral_train"). The
    library call is ``scaled_dot_product_attention`` with the band as an
    explicit boolean mask and K/V expanded to the 32 heads. All timed by
    ``queued_ms`` over ``BIG_ITERS`` calls."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

    out = []
    h, hkv, d, w = MISTRAL_HEADS, MISTRAL_KV_HEADS, MISTRAL_HEAD_DIM, \
        MISTRAL_WINDOW
    masking = fa.Masking(causal=True, window=w)
    for dtype in (torch.float32, torch.bfloat16):
        for s in (*FLASH_WINDOW_SEQS, MISTRAL_TRAIN_SEQ):
            q = torch.randn(1, h, s, d, generator=gen).to(dev, dtype)
            k, v = (torch.randn(1, hkv, s, d, generator=gen).to(dev, dtype)
                    for _ in range(2))
            scale = d ** -0.5
            o, lse = fa.flash_attention_with_lse(q, k, v, causal=True,
                                                 window=w)
            torch.cuda.synchronize()
            ro, rlse = fa.flash_attention_reference(q, k, v, scale=scale,
                                                    masking=masking)
            dn = str(dtype).split(".")[1]
            err = compare("flash_fwd_window", o, ro, dn, rms_atol=True)
            compare("flash_fwd_window lse", lse, rlse, "float32")
            o_rms = rms_of(ro)
            del ro, rlse
            elt = q.element_size()
            nbytes = (2 * h + 2 * hkv) * s * d * elt + 4 * h * s
            bms, by = bound_ms(nbytes, 4 * h * band_pairs(s, w) * d, dn)
            kernel = partial(fa.flash_attention_with_lse, q, k, v,
                             causal=True, window=w)
            pos = torch.arange(s, device=dev)
            band = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - w)
            ke, ve = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
            out.append((dict(
                name="flash_fwd_window", dtype=dn, shape=[1, h, s, d],
                kv_heads=hkv, window=w,
                path="mistral" if s in FLASH_WINDOW_SEQS else "mistral_train",
                max_abs_err=err, out_rms=o_rms,
                ms=queued_ms(kernel, BIG_ITERS),
                plain_ms=queued_ms(partial(fa.flash_attention_reference, q,
                                           k, v, scale=scale,
                                           masking=masking), BIG_ITERS),
                library_ms=queued_ms(partial(
                    F.scaled_dot_product_attention, q, ke, ve,
                    attn_mask=band), BIG_ITERS),
                library="scaled_dot_product_attention, boolean band mask, "
                        "K/V expanded to 32 heads",
                bound_ms=bms, bound_by=by), kernel))
    return out


def windowed_tables(gen, dev, lengths, page_size: int, window: int):
    """``(block tables, max pages, pool pages)`` over a shuffled pool for
    slots of ``lengths``: entries past a slot's length, and those wholly
    below its band, hold the null page 0, as ``drop_slot_pages`` leaves
    them."""
    import torch

    slots = len(lengths)
    maxp = -(-max(lengths) // page_size)
    num_pages = 1 + slots * maxp
    perm = torch.randperm(num_pages - 1, generator=gen) + 1
    bt = torch.zeros(slots, maxp, dtype=torch.int32)
    for i, n in enumerate(lengths):
        live = -(-n // page_size)
        bt[i, :live] = perm[i * maxp:i * maxp + live]
        bt[i, :max(n - window, 0) // page_size] = 0
    return bt.to(dev), maxp, num_pages


def check_paged_window(gen, dev):
    """Windowed paged decode at Mistral-7B's shapes: 8 slots, 32 heads over
    8 kv heads, d = 128, page 16, window 4096, lengths spread over 0..6100
    with the entries below each band nulled; the unquantized kernel
    (``paged_attention_window``) and the quantized one over int8 and fp8
    pools, with the unquantized windowed kernel's time beside the latter.
    All timed by ``queued_ms``."""
    import torch

    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    quant = importlib.import_module("apex_tpu_torch.ops.quant")

    out = []
    slots, h, kv, d, ps, w = NUM_SLOTS, MISTRAL_HEADS, MISTRAL_KV_HEADS, \
        MISTRAL_HEAD_DIM, PAGE_SIZE, MISTRAL_WINDOW
    lengths = list(PAGED_WINDOW_LENGTHS)
    bt, maxp, num_pages = windowed_tables(gen, dev, lengths, ps, w)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    n_pos = sum(min(n, w) for n in lengths)       # positions each head reads
    live_pages = sum(-(-n // ps) - max(n - w, 0) // ps for n in lengths)
    shape = [slots, h, ps, d, maxp]

    def row(name, dtype, kp, vp, page_elt, scales=None, **extra):
        q = torch.randn(slots, h, 1, d, generator=gen).to(dev, dtype)
        kw = dict(window=w)
        if scales is not None:
            kw.update(k_scales=scales[0], v_scales=scales[1])
        o = pa.paged_attention(q, kp, vp, bt, ln, **kw)
        torch.cuda.synchronize()
        dn = str(dtype).split(".")[1]
        err = compare(name, o, pa.paged_attention_reference(
            q, kp, vp, bt, ln, **kw), dn)
        if (o[0] != 0).any():
            raise AssertionError(f"{name}: a zero-length slot must output "
                                 f"exactly 0")
        elt = q.element_size()
        nbytes = (2 * n_pos * kv * d * page_elt + 2 * slots * h * d * elt
                  + slots * maxp * 4 + slots * 4)
        if scales is not None:
            nbytes += 2 * live_pages * kv * 4
        bms, by = bound_ms(nbytes, 4 * n_pos * h * d, dn)
        kernel = partial(pa.paged_attention, q, kp, vp, bt, ln, **kw)
        if scales is not None:
            deq = [(p.float() * sc[:, :, None, None]).to(dtype)
                   for p, sc in ((kp, scales[0]), (vp, scales[1]))]
            extra["unquantized_ms"] = queued_ms(partial(
                pa.paged_attention, q, *deq, bt, ln, window=w))
        return (dict(
            name=name, dtype=dn, shape=shape, kv_heads=kv, window=w,
            lengths=lengths, path="mistral", max_abs_err=err,
            ms=queued_ms(kernel),
            plain_ms=queued_ms(partial(pa.paged_attention_reference, q, kp,
                                       vp, bt, ln, **kw)),
            library_ms=None, bound_ms=bms, bound_by=by, **extra), kernel)

    for dtype in (torch.float32, torch.bfloat16):
        kp, vp = (torch.randn(num_pages, kv, ps, d, generator=gen)
                  .to(dev, dtype) for _ in range(2))
        out.append(row("paged_attention_window", dtype, kp, vp,
                       kp.element_size()))
    for kv_name in ("int8", "fp8"):
        qdt, qmax = quant.resolve_kv_dtype(kv_name)
        pools = [quant.kv_quantize(
            torch.randn(num_pages, kv, ps, d, generator=gen).to(dev) * 2,
            qdt, qmax, axes=(2, 3)) for _ in range(2)]
        (kp, ks), (vp, vs) = ((p, sc[:, :, 0, 0].contiguous())
                              for p, sc in pools)
        for dtype in (torch.float32, torch.bfloat16):
            out.append(row("paged_attention_quant", dtype, kp, vp, 1,
                           scales=(ks, vs), kind=kv_name))
    return out


def check_norm_bwd_mistral(gen, dev):
    """The backward kernel's new branches at Mistral-7B's width 4096, eps
    1e-5: the RMS branch (saved x) over a training step's 8192 rows and a
    ragged 77, fp32 and bf16; the ``memory_efficient`` branch (x-hat from
    the saved y) for RMSNorm and for LayerNorm with a bias, bf16, 8192
    rows. The weight stays in [0.5, 1.5), so (y - b) / w is well
    conditioned. Library: the backward of ``F.rms_norm`` /
    ``F.layer_norm``. All timed by ``queued_ms``."""
    import torch
    import torch.nn.functional as F

    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

    out = []
    cols, eps = MISTRAL_HIDDEN, 1e-5
    cases = [("rms_norm_bwd", "rms", dtype, rows)
             for dtype in (torch.float32, torch.bfloat16)
             for rows in NORM_BWD_ROWS]
    cases += [("layer_norm_bwd_from_y", kind, torch.bfloat16,
               NORM_BWD_ROWS[0]) for kind in ("rms", "layer_norm")]
    for name, kind, dtype, rows in cases:
        rms = kind == "rms"
        x = (torch.randn(rows, cols, generator=gen) * 2 + 0.5).to(dev, dtype)
        dy = torch.randn(rows, cols, generator=gen).to(dev, dtype)
        w = (torch.rand(cols, generator=gen) + 0.5).to(dev)
        b = None if rms else torch.randn(cols, generator=gen).to(dev)
        if rms:
            y, _, rstd = ln.rms_norm_fwd_reference(x, w, eps)
        else:
            y, _, rstd = ln.layer_norm_fwd_reference(x, w, b, eps)
        from_y = name == "layer_norm_bwd_from_y"
        args = (dy, y if from_y else x, None, rstd, w, b, rms, from_y)
        kernel = partial(ln.layer_norm_bwd, *args)
        plain = partial(ln.layer_norm_bwd_reference, *args)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        dn = str(dtype).split(".")[1]
        err = max([compare(f"{name} dx", got[0], want[0], dn,
                           rms_atol=True),
                   compare(f"{name} dgamma", got[1], want[1], dn, SUM_TOL)]
                  + ([compare(f"{name} dbeta", got[2], want[2], dn,
                              SUM_TOL)] if b is not None else []))
        elt = x.element_size()
        # read dy, x (or y), rstd, w (and b); write dx, dgamma (and dbeta)
        n_vec = 2 if rms else 4
        nbytes = 3 * rows * cols * elt + rows * 4 + n_vec * cols * 4
        bms, by = bound_ms(nbytes, 12 * rows * cols, dn)
        xl = x.detach().requires_grad_()
        wl = w.to(dtype).requires_grad_()
        if rms:
            yl = F.rms_norm(xl, (cols,), wl, eps)
            leaves, lib = (xl, wl), "backward of F.rms_norm"
        else:
            bl = b.to(dtype).requires_grad_()
            yl = F.layer_norm(xl, (cols,), wl, bl, eps)
            leaves, lib = (xl, wl, bl), "backward of F.layer_norm"
        out.append((dict(
            name=name, dtype=dn, shape=[rows, cols], kind=kind, eps=eps,
            path="mistral_train", max_abs_err=err, out_rms=rms_of(want[0]),
            ms=queued_ms(kernel),
            plain_ms=queued_ms(plain),
            library_ms=queued_ms(partial(torch.autograd.grad, yl, leaves,
                                         dy, retain_graph=True)),
            library=lib, bound_ms=bms, bound_by=by), kernel))
        del yl, leaves, got, want
    return out


def check_flash_bwd_window(gen, dev):
    """The windowed flash backward (dq; dk and dv) at Mistral-7B's heads: 1
    x 32 x S x 128 queries over 8 kv heads, window 4096 at S = 4224 and 6016
    (the windowed forward rows' shapes) and at a training step's 8192, and
    window 256 at S = 1024, where the band cuts most pairs; with an LSE
    cotangent, as a training step's ``flash_attention_with_lse`` may give.
    The library call is the backward
    of ``scaled_dot_product_attention`` with the band as a boolean mask and
    K/V expanded (dq, dk and dv together). Timed by ``queued_ms`` over
    ``BIG_ITERS`` calls."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

    out = []
    h, hkv, d = MISTRAL_HEADS, MISTRAL_KV_HEADS, MISTRAL_HEAD_DIM
    scale = d ** -0.5
    for dtype in (torch.float32, torch.bfloat16):
        for s, w in FLASH_BWD_WINDOW_CASES:
            masking = fa.Masking(causal=True, window=w)
            q, do = (torch.randn(1, h, s, d, generator=gen).to(dev, dtype)
                     for _ in range(2))
            k, v = (torch.randn(1, hkv, s, d, generator=gen).to(dev, dtype)
                    for _ in range(2))
            o, lse = fa.flash_attention_reference(q, k, v, scale=scale,
                                                  masking=masking)
            dlse = torch.randn(1, h, s, generator=gen).to(dev)
            delta = fa.flash_bwd_delta(o, do, dlse)
            args = (q, k, v, do, lse, delta)
            kw = dict(scale=scale, masking=masking)
            dq = fa.flash_bwd_dq(*args, **kw)
            dk, dv = fa.flash_bwd_dkdv(*args, **kw)
            torch.cuda.synchronize()
            dn = str(dtype).split(".")[1]
            rdq = fa.flash_bwd_dq_reference(*args, **kw)
            err_dq = compare("flash_bwd_dq_window", dq, rdq, dn,
                             rms_atol=True)
            rdk, rdv = fa.flash_bwd_dkdv_reference(*args, **kw)
            err_dkdv = max(compare("flash_bwd_dkdv_window dk", dk, rdk, dn,
                                   rms_atol=True),
                           compare("flash_bwd_dkdv_window dv", dv, rdv, dn,
                                   rms_atol=True))
            absmax = {"flash_bwd_dq_window": dq.abs().max().item(),
                      "flash_bwd_dkdv_window": max(dk.abs().max().item(),
                                                   dv.abs().max().item())}
            out_rms = {"flash_bwd_dq_window": [rms_of(rdq)],
                       "flash_bwd_dkdv_window": [rms_of(rdk), rms_of(rdv)]}
            del rdq, rdk, rdv
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            pos = torch.arange(s, device=dev)
            band = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - w)
            ol = F.scaled_dot_product_attention(
                ql, kl.repeat_interleave(h // hkv, dim=1),
                vl.repeat_interleave(h // hkv, dim=1), attn_mask=band)
            library_ms = queued_ms(partial(torch.autograd.grad, ol,
                                           (ql, kl, vl), do,
                                           retain_graph=True), BIG_ITERS)
            del ol, ql, kl, vl
            elt = q.element_size()
            pairs = h * band_pairs(s, w)        # visible (query, key) pairs
            inputs = (2 * h + 2 * hkv) * s * d * elt + 2 * h * s * 4
            for name, err, fn, plain, out_bytes, flops in (
                    ("flash_bwd_dq_window", err_dq, fa.flash_bwd_dq,
                     fa.flash_bwd_dq_reference, h * s * d * elt,
                     6 * pairs * d),
                    ("flash_bwd_dkdv_window", err_dkdv, fa.flash_bwd_dkdv,
                     fa.flash_bwd_dkdv_reference, 2 * hkv * s * d * elt,
                     8 * pairs * d)):
                bms, by = bound_ms(inputs + out_bytes, flops, dn)
                kernel = partial(fn, *args, **kw)
                out.append((dict(
                    name=name, dtype=dn, shape=[1, h, s, d], kv_heads=hkv,
                    window=w, path="mistral_train", max_abs_err=err,
                    out_absmax=absmax[name], out_rms=out_rms[name],
                    visible_pairs=pairs,
                    ms=queued_ms(kernel, BIG_ITERS),
                    plain_ms=queued_ms(partial(plain, *args, **kw),
                                       BIG_ITERS),
                    library_ms=library_ms,
                    library="backward of scaled_dot_product_attention, "
                            "boolean band mask, K/V expanded to 32 heads: "
                            "dq, dk and dv together",
                    bound_ms=bms, bound_by=by), kernel))
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


def time_engine_steps(engine, into: dict) -> None:
    """Wrap ``engine``'s admission and decode chunk to add their seconds to
    ``into``: ``admit_s`` (an admission ends in a read of its first token),
    ``chunk_host_s`` (the host issuing a chunk's steps, up to its return)
    and ``chunk_s`` (the same chunk through a synchronize, which the
    engine's own read of the chunk's tokens would wait for next)."""
    import torch

    admit, chunk = engine._admit, engine._decode_chunk
    into.update(admit_s=0.0, admissions=0, chunk_host_s=0.0, chunk_s=0.0)

    def timed_admit(*args):
        t0 = time.perf_counter()
        out = admit(*args)
        into["admit_s"] += time.perf_counter() - t0
        into["admissions"] += 1
        return out

    def timed_chunk(*args):
        t0 = time.perf_counter()
        out = chunk(*args)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        into["chunk_host_s"] += t1 - t0
        into["chunk_s"] += time.perf_counter() - t0
        return out

    engine._admit, engine._decode_chunk = timed_admit, timed_chunk


def run_engine(model, prompts, new_tokens, kernels=SERVING_KERNELS,
               kv_dtype=None, step_times=None, **engine_kw):
    """One engine run over the workload, the launch counts set to 0 just
    before it and read just after; it fails if a kernel of ``kernels`` was
    not launched or the pool leaked. ``engine_kw`` sizes the pool;
    ``step_times``, a dict, receives ``time_engine_steps``' sums."""
    import torch

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.serving import PagedDecodeEngine, Request

    engine = PagedDecodeEngine(model, num_slots=NUM_SLOTS,
                               page_size=PAGE_SIZE, kv_dtype=kv_dtype,
                               **engine_kw)
    if step_times is not None:
        time_engine_steps(engine, step_times)
    reqs = [Request(p, n) for p, n in zip(prompts, new_tokens)]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    outs, stats = engine.run(reqs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(_build.launches)
    missing = [k for k in kernels if launches[k] == 0]
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


def build_quant_model(fp_model, kind: str):
    """``fp_model``'s configuration with its block linears quantized to
    ``kind`` (int4 at group ``QUANT_GS``), loaded from its weights."""
    import dataclasses

    import torch

    from apex_tpu_torch.models import (GPTModel, WeightPrecisionPolicy,
                                       assert_quantized_loaded,
                                       quantize_model_params)

    cfg = dataclasses.replace(fp_model.config, weight_policy=(
        WeightPrecisionPolicy(kind, group_size=QUANT_GS)))
    qmodel = GPTModel(cfg, device=DEV,
                      generator=torch.Generator().manual_seed(SEED))
    qmodel.load_state_dict(quantize_model_params(qmodel, fp_model))
    assert_quantized_loaded(qmodel)
    return qmodel.eval()


def quant_kernels(weights=None, kv_dtype=None):
    """The kernels a serving run with these weights and this pool runs."""
    paged = "paged_attention_quant" if kv_dtype else "paged_attention"
    return (("layer_norm_fwd", "flash_fwd", paged)
            + ((DEQUANT_KERNEL[weights],) if weights else ()))


def block_linear_bytes(model) -> int:
    """Bytes of the four block linears' weights (and scales) of every
    layer: what one decode step streams besides the head."""
    return sum(t.numel() * t.element_size()
               for n, t in model.state_dict().items()
               if n.startswith("layers.") and n.endswith((".weight", ".scale"))
               and n.split(".")[2] in ("qkv", "out_proj", "mlp_in",
                                       "mlp_out"))


def pool_error(model, prompt, n_new: int, kv_dtype: str) -> dict:
    """Admit ``prompt`` into a fresh engine's quantized pool and hold each
    written value, dequantized with its page's scale (in fp64), against the
    same prompt's contiguous prefill K/V: for int8 within half a
    quantization step, scale / 2 + 1e-6 (the reference's bound), plus
    |x| * 2^-22 for the two fp32 roundings of x * (1 / scale); for e4m3,
    whose values carry 3 mantissa bits, within |x| (1/16 + 2^-22) +
    scale / 1024 + 1e-6."""
    import torch

    from apex_tpu_torch.models.generation import init_cache
    from apex_tpu_torch.serving import PagedDecodeEngine, kv_pool
    from apex_tpu_torch.serving.scheduler import prompt_bucket

    cfg = model.config
    engine = PagedDecodeEngine(model, num_slots=NUM_SLOTS,
                               page_size=PAGE_SIZE, kv_dtype=kv_dtype)
    s0 = prompt.shape[0]
    with torch.no_grad():
        engine._admit(prompt, 0, kv_pool.pages_for(s0 + n_new, PAGE_SIZE))
        bucket = prompt_bucket(s0, PAGE_SIZE, cfg.max_position_embeddings)
        ids = torch.zeros((1, bucket), dtype=torch.int32)
        ids[0, :s0] = torch.from_numpy(prompt)
        contig = init_cache(cfg, 1, bucket, device=DEV)
        _, contig = model(ids.to(DEV), cache=contig)
    n_pages = kv_pool.pages_for(s0, PAGE_SIZE)
    row = engine.cache["block_tables"][0, :n_pages].long()
    worst, max_err = 0.0, 0.0
    for lc, src in zip(engine.cache["layers"], contig["layers"]):
        for t in ("k", "v"):
            sc = lc[f"{t}_scales"][row].double()             # (pages, kv)
            deq = lc[f"{t}_pages"][row].double() * sc[:, :, None, None]
            kv, d = deq.shape[1], deq.shape[3]
            deq = deq.transpose(0, 1).reshape(kv, -1, d)[:, :s0]
            ref = src[t][0, :, :s0].double()
            step = sc.T.repeat_interleave(PAGE_SIZE, dim=1)[:, :s0, None]
            rounding = ref.abs() * 2.0 ** -22
            bound = (step / 2 + rounding + 1e-6 if kv_dtype == "int8" else
                     ref.abs() / 16 + rounding + step / 1024 + 1e-6)
            err = (deq - ref).abs()
            max_err = max(max_err, err.max().item())
            worst = max(worst, (err / bound).max().item())
    if worst > 1.0:
        raise AssertionError(f"{kv_dtype} pool: a prefilled value is "
                             f"{worst:.3f}x its bound from the prefill K/V")
    return dict(prompt_tokens=int(s0), max_abs_err=max_err,
                max_err_over_bound=worst,
                bound="scale/2 + |x| 2^-22 + 1e-6" if kv_dtype == "int8"
                else "|x| (1/16 + 2^-22) + scale/1024 + 1e-6")


def common_prefix(a, b) -> int:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def engine_quant_fp32(model, prompts, new_tokens, fp_outs):
    """(a), (b): int8 and int4 weights over an fp pool, token identity with
    lock-step ``generate`` of the same quantized model; (c), (d): int8 and
    fp8 pools over the fp model, first tokens equal to ``engine_fp32``'s,
    and the pool's error bound after one admission."""
    import numpy as np
    import torch

    from apex_tpu_torch.models import generate

    results = {}
    for label, kind in (("w8", "int8"), ("w4", "int4")):
        qmodel = build_quant_model(model, kind)
        outs, stats, elapsed, launches = run_engine(
            qmodel, prompts, new_tokens, kernels=quant_kernels(kind))
        for i, (p, n, o) in enumerate(zip(prompts, new_tokens, outs)):
            ref = generate(qmodel, torch.from_numpy(p)[None].to(DEV), n)
            ref = ref[0, p.shape[0]:].cpu().numpy()
            if o.shape != ref.shape or (o != ref).any():
                raise AssertionError(f"{label}: request {i}: engine tokens "
                                     f"differ from lock-step generate")
        results[label] = dict(weights=kind, pool="fp32",
                              requests=len(outs), token_identical=True,
                              launches=launches, seconds=elapsed, **stats)
        del qmodel
    for label, kv_dtype in (("kv8", "int8"), ("kv_fp8", "fp8")):
        bound = pool_error(model, prompts[0], new_tokens[0], kv_dtype)
        outs, stats, elapsed, launches = run_engine(
            model, prompts, new_tokens, kernels=quant_kernels(None, kv_dtype),
            kv_dtype=kv_dtype)
        firsts = [int(o[0]) == int(r[0]) for o, r in zip(outs, fp_outs)]
        if not all(firsts):
            bad = [i for i, f in enumerate(firsts) if not f]
            raise AssertionError(f"{label}: first tokens differ from "
                                 f"engine_fp32's for requests {bad}")
        prefix = [common_prefix(o, r) for o, r in zip(outs, fp_outs)]
        results[label] = dict(
            weights="fp32", pool=kv_dtype, requests=len(outs),
            first_tokens_identical=True,
            fully_identical=sum(bool(np.array_equal(o, r))
                                for o, r in zip(outs, fp_outs)),
            mean_common_prefix=sum(prefix) / len(prefix),
            mean_generated=sum(len(r) for r in fp_outs) / len(fp_outs),
            pool_error=bound, launches=launches, seconds=elapsed, **stats)
    emit("engine_quant_fp32", requests=len(prompts), num_slots=NUM_SLOTS,
         page_size=PAGE_SIZE, layers=model.config.num_layers,
         group_size=QUANT_GS, runs=results)


def engine_quant_bf16(model, prompts, new_tokens, smi):
    """``w8_kv8`` and ``w4_kv8`` in bf16: a warm run, two timed runs;
    returns each configuration's run and its timed launches."""
    import torch

    from apex_tpu_torch.serving import kv_pool

    cfg = model.config
    bf16_linear_bytes = block_linear_bytes(model) // 2       # fp32 params
    runs, results = {}, {}
    for label, kind in (("w8_kv8", "int8"), ("w4_kv8", "int4")):
        qmodel = build_quant_model(model, kind)
        run = partial(run_engine, qmodel, prompts, new_tokens,
                      kernels=quant_kernels(kind, "int8"), kv_dtype="int8")
        run()                                                # warm
        timed = [run() for _ in range(2)]
        _, stats, elapsed, launches = timed[0]
        wbytes = block_linear_bytes(qmodel)
        results[label] = dict(
            weights=kind, pool="int8",
            tokens_per_s=stats["generated_tokens"] / elapsed,
            repeat_tokens_per_s=stats["generated_tokens"] / timed[1][2],
            seconds=elapsed, launches=launches,
            weight_bytes_per_step=wbytes,
            weight_bytes_ratio_vs_bf16=wbytes / bf16_linear_bytes, **stats)
        runs[label] = (run, launches, qmodel)
    budget = 2 ** 30
    pages_per_slot = kv_pool.cdiv(cfg.max_position_embeddings, PAGE_SIZE)
    pool = {kv or "bf16": dict(
        page_bytes=kv_pool.page_bytes(cfg, PAGE_SIZE, kv_dtype=kv),
        max_slots=kv_pool.max_slots_for_pool_bytes(
            cfg, budget, pages_per_slot=pages_per_slot, page_size=PAGE_SIZE,
            kv_dtype=kv)) for kv in (None, "int8")}
    emit("engine_quant_bf16", requests=N_REQUESTS, num_slots=NUM_SLOTS,
         page_size=PAGE_SIZE, layers=cfg.num_layers, group_size=QUANT_GS,
         runs=results, bf16_weight_bytes_per_step=bf16_linear_bytes,
         pool=pool, page_bytes_ratio_vs_bf16=pool["int8"]["page_bytes"]
         / pool["bf16"]["page_bytes"], pool_budget_bytes=budget,
         pages_per_slot=pages_per_slot, nvidia_smi=smi,
         card_after=card_state())
    return runs


def profile_quant(runs) -> None:
    """One profiled run of each quantized bf16 configuration: device busy
    and idle share, each quantized kernel's device ms and launches."""
    out = {}
    for label, (run, launches, _) in runs.items():
        wall, acts = device_profile(run, cpu=False)
        busy = sum(t for t, _ in acts.values())
        kernels = {}
        for name in QUANT_KERNELS:
            hits = [(t, c) for k, (t, c) in acts.items()
                    if KERNEL_SYMBOLS[name] in k]
            kernels[name] = dict(device_ms=sum(t for t, _ in hits),
                                 launches_seen=sum(c for _, c in hits),
                                 launches=launches[name])
        top = sorted(acts.items(), key=lambda kv: -kv[1][0])[:10]
        out[label] = dict(wall_s=wall, device_busy_s=busy / 1e3,
                          device_idle_share=1.0 - busy / 1e3 / wall,
                          kernels=kernels,
                          top_device=[dict(name=k[:120], ms=t, count=c)
                                      for k, (t, c) in top])
    emit("engine_quant_bf16_profile", runs=out)


# --- the Mistral-7B serving phases -----------------------------------------


def mistral_workload(n_short: int):
    """The two long requests (prompts of 5,000 and 6,000 tokens, budgets of
    64) first, then ``n_short`` requests with prompts and budgets uniform in
    32..128 tokens (numpy seed 1, ids below the vocabulary's 32,000)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    prompt_lens = rng.integers(32, 129, n_short)
    new_tokens = rng.integers(32, 129, n_short)
    short = [rng.integers(0, MISTRAL_VOCAB, int(n)).astype(np.int32)
             for n in prompt_lens]
    long = [rng.integers(0, MISTRAL_VOCAB, n).astype(np.int32)
            for n, _ in MISTRAL_LONG]
    return (long + short,
            [b for _, b in MISTRAL_LONG] + [int(n) for n in new_tokens])


def build_mistral(dtype, layers=None):
    """Mistral-7B at full width, all its layers or ``layers`` deep,
    parameters and compute in ``dtype``, seeded random weights drawn on the
    card."""
    import torch

    from apex_tpu_torch.models import LlamaModel, mistral_7b_config

    depth = {} if layers is None else dict(num_layers=layers)
    cfg = mistral_7b_config(dtype=dtype, param_dtype=dtype, **depth)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    return LlamaModel(cfg, device=DEV, generator=gen).eval()


def mistral_facts(model) -> dict:
    cfg = model.config
    from apex_tpu_torch.serving import kv_pool

    return dict(layers=cfg.num_layers, hidden=cfg.hidden_size,
                heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, window=cfg.sliding_window,
                parameters=sum(p.numel() for p in model.parameters()),
                weight_bytes=sum(p.numel() * p.element_size()
                                 for p in model.parameters()),
                page_bytes=kv_pool.page_bytes(cfg, PAGE_SIZE),
                num_slots=NUM_SLOTS, page_size=PAGE_SIZE, **MISTRAL_POOL)


def check_mistral_run(stats, launches, phase: str) -> None:
    """The windowed path's bars on one engine run: pages dropped below the
    band, and only the windowed branches of the attention kernels and the
    RMS branch of the norm launched (``run_engine`` has held the pool)."""
    if stats["window_dropped_pages"] <= 0:
        raise AssertionError(f"{phase}: no page was dropped below the band")
    stray = {k: launches[k] for k in ("layer_norm_fwd", "flash_fwd",
                                      "paged_attention") if launches[k]}
    if stray:
        raise AssertionError(f"{phase}: unwindowed kernels launched {stray}")


def divergence(model, prompt, got, want) -> dict:
    """Where the engine's tokens first leave lock-step ``generate``'s, with
    the lock-step logits there (a no-cache forward of the prompt and the
    tokens before): the two tokens' logits and the top-2 gap."""
    import numpy as np
    import torch

    n = min(len(got), len(want))
    step = next((i for i in range(n) if got[i] != want[i]), n)
    ids = torch.from_numpy(np.concatenate([prompt, want[:step]]))[None]
    with torch.no_grad():
        logits = model(ids.to(DEV))[0, -1].float()
    top = logits.topk(2).values
    out = dict(step=int(step), lengths=[len(got), len(want)],
               top2_logit_gap=(top[0] - top[1]).item())
    for label, toks in (("engine", got), ("lockstep", want)):
        if step < len(toks):
            out[f"{label}_token"] = int(toks[step])
            out[f"{label}_logit"] = logits[int(toks[step])].item()
    return out


def mistral_fp32() -> None:
    """The bar: Mistral-7B at full width, ``MISTRAL_FP32_LAYERS`` deep, fp32
    parameters and pool, window 4096; the two long requests and
    ``MISTRAL_SHORT_FP32`` short ones through the engine, each
    token-identical to lock-step ``generate`` on the card."""
    import torch

    from apex_tpu_torch.models import generate

    live = phase_memory_start()
    model = build_mistral(torch.float32, MISTRAL_FP32_LAYERS)
    prompts, new_tokens = mistral_workload(MISTRAL_SHORT_FP32)
    outs, stats, elapsed, launches = run_engine(
        model, prompts, new_tokens, kernels=MISTRAL_KERNELS, **MISTRAL_POOL)
    check_mistral_run(stats, launches, "mistral_fp32")
    diverged = {}
    for i, (p, n, o) in enumerate(zip(prompts, new_tokens, outs)):
        ref = generate(model, torch.from_numpy(p)[None].to(DEV), n)
        ref = ref[0, p.shape[0]:].cpu().numpy()
        if o.shape != ref.shape or (o != ref).any():
            diverged[i] = divergence(model, p, o, ref)
    facts = mistral_facts(model)
    emit("mistral_fp32", requests=len(prompts),
         prompt_tokens=[int(p.shape[0]) for p in prompts],
         token_identical=not diverged, diverged=diverged,
         launches=launches, seconds=elapsed, **stats, **facts,
         peak_memory_gib=(torch.cuda.max_memory_allocated() - live)
         / 2 ** 30)
    if diverged:
        raise AssertionError(f"mistral_fp32: engine tokens differ from "
                             f"lock-step generate: {diverged}")
    del model
    torch.cuda.empty_cache()


def mistral_bf16(smi):
    """The speed run: Mistral-7B at full width and all 32 layers, bf16
    parameters and compute (14.5 GB of weights), the GPT workload's 24
    requests plus the two long ones: a warm run over the first 8 requests
    at 16 tokens each, then one timed run. Returns the model, the timed
    run and its launches."""
    import torch

    live = phase_memory_start()
    model = build_mistral(torch.bfloat16)
    prompts, new_tokens = mistral_workload(N_REQUESTS)
    run = partial(run_engine, model, prompts, new_tokens,
                  kernels=MISTRAL_KERNELS, **MISTRAL_POOL)
    run_engine(model, prompts[:NUM_SLOTS],
               [min(n, 16) for n in new_tokens[:NUM_SLOTS]],
               kernels=MISTRAL_KERNELS, **MISTRAL_POOL)          # warm
    steps = {}
    outs, stats, elapsed, launches = run(step_times=steps)
    check_mistral_run(stats, launches, "mistral_bf16")
    n_steps = stats["decode_steps"]
    emit("mistral_bf16", requests=len(prompts),
         tokens_per_s=stats["generated_tokens"] / elapsed, seconds=elapsed,
         host_ms_per_decode_step=steps["chunk_host_s"] / n_steps * 1e3,
         synced_ms_per_decode_step=steps["chunk_s"] / n_steps * 1e3,
         admission_s=steps["admit_s"], admissions=steps["admissions"],
         lockstep_steps=lockstep_steps(new_tokens),
         launches=launches, **stats, **mistral_facts(model),
         peak_memory_gib=(torch.cuda.max_memory_allocated() - live)
         / 2 ** 30, earlier_phases_live_gib=live / 2 ** 30,
         nvidia_smi=smi, card_after=card_state())
    return model, run, launches


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


def make_optimizer(model, lr: float = TRAIN_LR):
    from apex_tpu_torch.optimizers import FusedAdam

    return FusedAdam(model.named_parameters(), lr=lr,
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


# --- the Mistral-7B training phases ----------------------------------------


def mistral_train_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of one training step: 6 x the matmul parameters (q, kv, o,
    SwiGLU's gate/up and down per layer, the untied head; embeddings'
    gathers and norms not) per token, plus the windowed attention, 3 x
    (forward) 2 products x 2 FLOPs x d per visible pair of each head."""
    e, f, layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    e_kv = cfg.num_kv_heads * cfg.head_dim
    matmul_params = layers * (2 * e * e + 2 * e * e_kv + 3 * e * f) \
        + cfg.vocab_size * e
    pairs = band_pairs(seq, cfg.sliding_window or seq)
    return (6 * matmul_params * batch * seq
            + 12 * layers * batch * cfg.num_heads * pairs * cfg.head_dim)


def check_mistral_train_launches(launches, phase: str, want) -> None:
    """The windowed path's bar on a training run: every kernel of ``want``
    launched, and no unwindowed or non-RMS kernel."""
    idle = [k for k in want if launches[k] == 0]
    stray = {k: launches[k] for k in UNWINDOWED if launches[k]}
    if idle or stray:
        raise AssertionError(f"{phase}: no launch of {idle}; unwindowed "
                             f"kernels launched {stray}")


def grad_bars(phase: str, card_grads, cpu_grads) -> dict:
    """Every gradient of the card against the CPU's, each tensor at atol =
    min(1e-4, 1e-3 max|g|) and rtol 1e-3, so that the bar stays below the
    tensor's own entries when they are small (a mean over few tokens at
    full width). Returns {name: [max |g| on the CPU, max |card - CPU|]}."""
    missing = [n for n, g in card_grads.items() if g is None]
    if missing:
        raise AssertionError(f"{phase}: no gradient on the card for "
                             f"{missing}")
    out = {}
    for n, g in card_grads.items():
        want = cpu_grads[n]
        gmax = want.abs().max().item()
        out[n] = [gmax, compare(f"{phase} grad {n}", g.cpu(), want,
                                "float32", (min(1e-4, 1e-3 * gmax), 1e-3))]
    return out


def mistral_train_fp32():
    """Card against CPU: Mistral-7B at full width, depth, window and length
    cut (``MISTRAL_TRAIN_FP32``), fp32, the same seeded weights on both
    sides, at ``train_fp32``'s learning rate: the loss and every gradient,
    a FusedAdam step on each side; with every norm ``memory_efficient``,
    the loss and every gradient; with the default norms, the loss and every
    gradient again, a second step, and the loss.
    The losses are held as the fp64 cross-entropy of each side's fp32
    logits: two steps memorize the batch (per-token losses down to ~3e-5),
    where the fp32 ``log_softmax`` of the loss itself rounds differently on
    the CPU and the card (``losses_card``/``losses_cpu``, reported).
    Returns the card's launches of the memory_efficient run (those of the
    default runs are in the phase's line)."""
    import torch

    from apex_tpu_torch.models import (LlamaModel, llama_loss,
                                       mistral_7b_config)
    from apex_tpu_torch.normalization import FusedRMSNorm
    from apex_tpu_torch.ops import _build

    c, lr = MISTRAL_TRAIN_FP32, TRAIN_LR
    cfg = mistral_7b_config(num_layers=c["layers"], sliding_window=c["window"],
                            dtype=torch.float32, param_dtype=torch.float32)
    cpu = LlamaModel(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(SEED))
    card = LlamaModel(cfg, device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(SEED))
    card.load_state_dict(cpu.state_dict())
    sides = {side: (model, *train_batch(cfg, c["batch"], c["seq"], dev))
             for side, model, dev in (("card", card, DEV), ("cpu", cpu,
                                                            "cpu"))}
    logits = {}
    for side, (model, _, _) in sides.items():
        model.register_forward_hook(
            lambda m, i, o, side=side: logits.__setitem__(side, o.detach()))

    def ce64(side):
        """The fp64 cross-entropy of the side's last logits."""
        labels = sides[side][2].long()
        logp = torch.log_softmax(logits[side].double(), dim=-1)
        return -logp.gather(-1, labels[..., None])[..., 0].mean().item()

    def forward(backward: bool = True):
        """Loss (fp32, the program's) and fp64 cross-entropy on both sides
        and, with ``backward``, their gradients; the launch counts after
        the card's side, which runs first. Fails if the fp64
        cross-entropies differ by more than 1e-4 relative."""
        losses, ces, grads = {}, {}, {}
        for side, (model, ids, labels) in sides.items():
            with torch.set_grad_enabled(backward):
                loss = llama_loss(model, ids, labels)
            if backward:
                loss.backward()
                grads[side] = {n: p.grad for n, p in model.named_parameters()}
            losses[side], ces[side] = loss.item(), ce64(side)
            if side == "card":
                torch.cuda.synchronize()
                card_launches = dict(_build.launches)
        if abs(ces["card"] - ces["cpu"]) > 1e-4 * abs(ces["cpu"]):
            raise AssertionError(f"mistral_train_fp32: losses differ: "
                                 f"{ces} (fp64 of the logits), {losses}")
        return losses, ces, grads, card_launches

    def set_memory_efficient(on: bool):
        for model, _, _ in sides.values():
            for m in model.modules():
                if isinstance(m, FusedRMSNorm):
                    m.memory_efficient = on

    torch.cuda.synchronize()
    _build.reset_launches()
    losses, ces, grads, _ = forward()
    bars = grad_bars("mistral_train_fp32", grads["card"], grads["cpu"])
    losses, ces = ({side: [x[side]] for side in sides} for x in (losses, ces))
    opts = {side: make_optimizer(model, lr)  # keeps the grads
            for side, (model, _, _) in sides.items()}
    for opt in opts.values():
        opt.step()
        opt.zero_grad()
    launches = dict(_build.launches)

    # the same parameters with the norms memory_efficient: x-hat from the
    # saved y, the norm weights one Adam step away from 1
    set_memory_efficient(True)
    torch.cuda.synchronize()
    _build.reset_launches()
    me_losses, me_ces, grads, me_launches = forward()
    me_bars = grad_bars("mistral_train_fp32 memory_efficient",
                        grads["card"], grads["cpu"])
    norms = 2 * cfg.num_layers + 1
    if (me_launches["layer_norm_bwd_from_y"] != norms
            or me_launches["rms_norm_bwd"]):
        raise AssertionError(f"mistral_train_fp32: memory_efficient "
                             f"launches {me_launches}, want "
                             f"layer_norm_bwd_from_y {norms}, rms_norm_bwd "
                             f"0")
    check_mistral_train_launches(
        me_launches, "mistral_train_fp32 memory_efficient",
        ("rms_norm_fwd", "layer_norm_bwd_from_y", "flash_fwd_window",
         "flash_bwd_dq_window", "flash_bwd_dkdv_window"))
    set_memory_efficient(False)
    for opt in opts.values():
        opt.zero_grad()

    torch.cuda.synchronize()
    _build.reset_launches()
    loss1, ce1, grads, _ = forward()
    bars_1 = grad_bars("mistral_train_fp32 step 1", grads["card"],
                       grads["cpu"])
    for opt in opts.values():
        opt.step()
    loss2, ce2, _, _ = forward(backward=False)
    for side in sides:
        losses[side] += [loss1[side], loss2[side]]
        ces[side] += [ce1[side], ce2[side]]
    torch.cuda.synchronize()
    launches = {k: n + _build.launches[k] for k, n in launches.items()}
    check_mistral_train_launches(launches, "mistral_train_fp32",
                                 MISTRAL_TRAIN_KERNELS)
    if launches["layer_norm_bwd_from_y"]:
        raise AssertionError("mistral_train_fp32: the memory_efficient "
                             "backward launched on the default path")

    def summary(b):
        return dict(min_max_abs_grad=min(g for g, _ in b.values()),
                    max_abs_err=max(e for _, e in b.values()))

    emit("mistral_train_fp32", batch=c["batch"], seq=c["seq"],
         layers=cfg.num_layers, window=cfg.sliding_window,
         hidden=cfg.hidden_size, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, lr=lr,
         parameters=sum(p.numel() for p in card.parameters()),
         ce64_card=ces["card"], ce64_cpu=ces["cpu"],
         losses_card=losses["card"], losses_cpu=losses["cpu"],
         grad_bar="atol = min(1e-4, 1e-3 max|g|) per tensor, rtol 1e-3",
         grads=bars, grads_summary=summary(bars),
         grads_step1_summary=summary(bars_1),
         params_with_grad=len(bars), launches=launches,
         memory_efficient_ce64=me_ces, memory_efficient_losses=me_losses,
         memory_efficient_grads_summary=summary(me_bars),
         memory_efficient_launches=me_launches)
    del sides, opts, card, cpu, logits
    torch.cuda.empty_cache()
    return me_launches


def mistral_train_bf16(smi):
    """Mistral-7B at full width, ``MISTRAL_TRAIN_LAYERS`` deep, window 4096,
    B x S = 1 x 8192, bf16 compute over fp32 parameters,
    ``FusedAdam(lr=1e-4, weight_decay=0.01)`` with the norms excluded: warm
    steps, then timed steps, with exact launches per step. Returns the step
    and the timed steps' launches."""
    import torch

    from apex_tpu_torch.models import (LlamaModel, llama_loss,
                                       mistral_7b_config)
    from apex_tpu_torch.ops import _build

    live = phase_memory_start()
    cfg = mistral_7b_config(num_layers=MISTRAL_TRAIN_LAYERS)
    model = LlamaModel(cfg, device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(SEED))
    opt = make_optimizer(model)
    b, s = MISTRAL_TRAIN_BATCH, MISTRAL_TRAIN_SEQ
    ids, labels = train_batch(cfg, b, s, DEV)

    def step():
        opt.zero_grad()
        loss = llama_loss(model, ids, labels)
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [step() for _ in range(MISTRAL_TRAIN_WARM)]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    losses += [step() for _ in range(MISTRAL_TRAIN_TIMED)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(_build.launches)
    with torch.no_grad():
        final = llama_loss(model, ids, labels).item()
    losses = [x.item() for x in losses]
    layers, norms = cfg.num_layers, 2 * cfg.num_layers + 1
    want = {"rms_norm_fwd": norms, "rms_norm_bwd": norms,
            "flash_fwd_window": layers, "flash_bwd_dq_window": layers,
            "flash_bwd_dkdv_window": layers, "adam": 1,
            **{k: 0 for k in UNWINDOWED}, "layer_norm_bwd_from_y": 0}
    per_step = {k: launches[k] / MISTRAL_TRAIN_TIMED for k in want}
    wrong = {k: n for k, n in per_step.items() if n != want[k]}
    if wrong:
        raise AssertionError(f"mistral_train_bf16: launches per step "
                             f"{wrong}, want {want}")
    if not all(map(math.isfinite, losses + [final])) or not final < losses[0]:
        raise AssertionError(f"mistral_train_bf16: loss not finite and "
                             f"falling: {losses} then {final}")
    step_s = elapsed / MISTRAL_TRAIN_TIMED
    flops = mistral_train_flops(cfg, b, s)
    emit("mistral_train_bf16", batch=b, seq=s, layers=layers,
         layers_published=32, window=cfg.sliding_window,
         hidden=cfg.hidden_size, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads,
         parameters=sum(p.numel() for p in model.parameters()),
         timed_steps=MISTRAL_TRAIN_TIMED, step_ms=step_s * 1e3,
         tokens_per_s=b * s / step_s, flops_per_step=flops,
         attention_flops_per_step=12 * layers * b * cfg.num_heads
         * band_pairs(s, cfg.sliding_window) * cfg.head_dim,
         flops_formula="6 * (L (2 e^2 + 2 e e_kv + 3 e f) + V e) * B * S "
                       "+ 12 L * B H pairs(S, w) * d, pairs = w (w + 1) / 2 "
                       "+ (S - w) w",
         mfu=flops / step_s / PEAK_FLOPS["bfloat16"],
         bound_ms=flops / PEAK_FLOPS["bfloat16"] * 1e3,
         peak_flops=PEAK_FLOPS["bfloat16"], losses=losses,
         loss_after=final, launches_per_step=per_step, launches=launches,
         peak_memory_gib=(torch.cuda.max_memory_allocated() - live)
         / 2 ** 30, earlier_phases_live_gib=live / 2 ** 30,
         nvidia_smi=smi, card_after=card_state())
    return step, launches


def profile_phase(phase: str, fn, cpu: bool = True) -> None:
    """One run of ``fn`` under the profiler: device busy and idle share and
    the top device items (``cpu=False``: the host's ops untraced)."""
    wall, acts = device_profile(fn, cpu=cpu)
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
              + check_lamb(gen, DEV) + check_dequant(gen, DEV)
              + check_paged_quant(gen, DEV) + check_rms_norm(gen, DEV)
              + check_flash_window(gen, DEV) + check_paged_window(gen, DEV)
              + check_norm_bwd_mistral(gen, DEV)
              + check_flash_bwd_window(gen, DEV))
    rows = [row for row, _ in checks]
    emit("kernels", tolerances=TOL, rms_atol=RMS_ATOL,
         card_before=card_before,
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
    engine_quant_fp32(model, prompts, new_tokens, outs)
    del model
    torch.cuda.empty_cache()

    model = build_model(torch.bfloat16)
    run_engine(model, prompts, new_tokens)                 # warm
    steps = {}
    timed = [run_engine(model, prompts, new_tokens, step_times=st)
             for st in (steps, None)]
    _, stats, elapsed, launches = timed[0]
    emit("engine_bf16", requests=N_REQUESTS, num_slots=NUM_SLOTS,
         page_size=PAGE_SIZE, layers=model.config.num_layers,
         tokens_per_s=stats["generated_tokens"] / elapsed, seconds=elapsed,
         host_ms_per_decode_step=steps["chunk_host_s"]
         / stats["decode_steps"] * 1e3,
         synced_ms_per_decode_step=steps["chunk_s"]
         / stats["decode_steps"] * 1e3,
         repeat_tokens_per_s=stats["generated_tokens"] / timed[1][2],
         lockstep_steps=lockstep_steps(new_tokens),
         lockstep_steps_fifo=lockstep_steps(new_tokens, fifo=True),
         launches=launches, nvidia_smi=smi, card_after=card_state(),
         **stats)
    quant_runs = engine_quant_bf16(model, prompts, new_tokens, smi)
    mistral_fp32()
    mistral_model, mistral_run, mistral_launches = mistral_bf16(smi)

    train_fp32()
    train_step, train_launches = train_bf16(smi)
    bert_fp32()
    bert_step, bert_launches = bert_bf16(smi)
    me_launches = mistral_train_fp32()
    mistral_train_step, mistral_train_launches = mistral_train_bf16(smi)

    # where the time goes, last, so that no profiler state touches the times
    # above: one more run of the same workload, then each kernel alone at
    # the shapes of phase 2
    profile_phase("engine_bf16_profile",
                  partial(run_engine, model, prompts, new_tokens), cpu=False)
    profile_quant(quant_runs)
    profile_phase("mistral_bf16_profile", mistral_run, cpu=False)
    del mistral_model, mistral_run
    torch.cuda.empty_cache()
    results = []
    for row, fn in checks:
        if row.get("path") in ("quant_serving", "mistral", "mistral_train"):
            continue                  # timed by queued_ms already
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
    profile_phase("mistral_train_bf16_profile", mistral_train_step)

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
    # the quantized kernels: the int8 (or int4) weight of the widest
    # block linear at the decode step's 8 rows, the int8 pool, bf16
    main_shape.update({"dequant_matmul": [NUM_SLOTS, *QUANT_SHAPES[2]],
                       "dequant_matmul_w4": [NUM_SLOTS, *QUANT_SHAPES[2]]})
    main_kind = {"dequant_matmul": "int8", "paged_attention_quant": "int8"}
    # the windowed kernels: a decode step's rows for RMSNorm, the prefill
    # of 4224 tokens for flash, the 8-slot pool for paged decode, bf16; the
    # quantized paged kernel keeps its GPT-2 serving row and gains its
    # windowed one
    main_shape.update({
        "rms_norm_fwd": [NUM_SLOTS, MISTRAL_HIDDEN],
        "flash_fwd_window": [1, MISTRAL_HEADS, FLASH_WINDOW_SEQS[0],
                             MISTRAL_HEAD_DIM],
        "paged_attention_quant": [NUM_SLOTS, 12, PAGE_SIZE, 64, 64]})
    # the Mistral training kernels at a training step's shapes, bf16: 8192
    # rows for the norms (the memory_efficient branch's RMSNorm row), 8192
    # tokens at window 4096 for the flash backward; the windowed forward
    # kernels also carry, under "mistral_train", their rows at these shapes
    train_shape = {"rms_norm_fwd": [MISTRAL_TRAIN_SEQ, MISTRAL_HIDDEN],
                   "flash_fwd_window": [1, MISTRAL_HEADS, MISTRAL_TRAIN_SEQ,
                                        MISTRAL_HEAD_DIM]}
    main_shape.update({
        "rms_norm_bwd": [NORM_BWD_ROWS[0], MISTRAL_HIDDEN],
        "layer_norm_bwd_from_y": [NORM_BWD_ROWS[0], MISTRAL_HIDDEN],
        "flash_bwd_dq_window": train_shape["flash_fwd_window"],
        "flash_bwd_dkdv_window": train_shape["flash_fwd_window"]})
    main_kind.update({"rms_norm_bwd": "rms", "layer_norm_bwd_from_y": "rms"})
    by_path = {"serving": launches, "gpt_train": train_launches,
               "bert_train": bert_launches, "mistral": mistral_launches,
               **{label: run[1] for label, run in quant_runs.items()},
               "mistral_train": mistral_train_launches,
               "mistral_train_memory_efficient": me_launches}
    quant_path = {"dequant_matmul": "w8_kv8", "dequant_matmul_w4": "w4_kv8",
                  "paged_attention_quant": "w8_kv8"}
    timing = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")
    summary = []
    for name, (src, replaces) in _build.KERNELS.items():
        path = ("serving" if name in SERVING_KERNELS else "gpt_train"
                if name in TRAIN_KERNELS else quant_path[name]
                if name in QUANT_KERNELS else "mistral"
                if name in MISTRAL_KERNELS else
                "mistral_train_memory_efficient"
                if name == "layer_norm_bwd_from_y" else "mistral_train"
                if name in MISTRAL_TRAIN_NEW else "bert_train")
        row = next(r for r in rows if r["name"] == name
                   and r["dtype"] == ("float32" if name in FP32_KERNELS
                                      else "bfloat16")
                   and (r.get("path") == "bert") == (path == "bert_train")
                   and r["shape"] == main_shape.get(name, r["shape"])
                   and r.get("kind") == main_kind.get(name, r.get("kind")))
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
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            **{k: row[k] for k in ("kind", "shape", "unquantized_ms",
                                   "library", "kv_heads", "window",
                                   "out_rms")
               if k in row and (path in (*quant_path.values(), "mistral")
                                or name in MISTRAL_TRAIN_NEW)})
        if name == "paged_attention_quant":
            win = next(r for r in rows if r["name"] == name
                       and r.get("path") == "mistral"
                       and r["dtype"] == "bfloat16" and r["kind"] == "int8")
            entry["mistral_window"] = dict(
                shape=win["shape"], kv_heads=win["kv_heads"],
                window=win["window"], dtype="bfloat16", kind="int8",
                unquantized_ms=win["unquantized_ms"],
                **{k: win[k] for k in timing})
        if name in train_shape:
            tr = next(r for r in rows if r["name"] == name
                      and r.get("path") == "mistral_train"
                      and r["dtype"] == "bfloat16"
                      and r["shape"] == train_shape[name])
            entry["mistral_train"] = dict(
                shape=tr["shape"], dtype="bfloat16", out_rms=tr["out_rms"],
                launches=mistral_train_launches[name],
                **{k: tr[k] for k in timing})
        if path != "bert_train" and name in BERT_KERNELS:
            bert = next(r for r in rows if r["name"] == name
                        and r.get("path") == "bert"
                        and r["dtype"] == "bfloat16"
                        and r["shape"] == bert_shape.get(name, r["shape"]))
            entry["bert_train"] = dict(
                shape=bert["shape"], dtype="bfloat16",
                launches=bert_launches[name], **{k: bert[k] for k in timing})
        summary.append(entry)
    emit("done", seconds=time.perf_counter() - START)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
