#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``apex_tpu_torch``'s paths at full width with seeded random
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
``loss.backward()``, ``FusedLAMB.step()``); Mistral-7B training steps
(``LlamaModel(mistral_7b_config(num_layers=4))``, ``llama_loss``,
``loss.backward()``, ``FusedAdam.step()``); and GPT-2-small's speculative
decode and chunked prefill (``PagedDecodeEngine(draft_model=...,
draft_len=3)``, ``PagedDecodeEngine(prefill_chunk=16)``,
``speculative_generate``), which run the paged kernel's s > 1 branches;
and t5-small, served (``T5Model(T5Config())``, ``t5_generate``) and trained
(``t5_loss``, ``loss.backward()``, ``FusedAdam.step()``), which run the
flash kernels' additive-bias branches; and ResNet-50 ImageNet training
under amp (``examples.imagenet.main_amp``: ``resnet50()``,
``build_training``, ``amp.initialize``, ``SyncBatchNorm``, the DDP facade,
``FusedSGD.step()``, or ``FusedNovoGrad``), which runs the SGD, NovoGrad
and stats kernels; Megatron's attention softmax
(``FusedScaleMaskSoftmax`` in its core attention at GPT-2-small's and
BERT-Large's widths) and one Stable Diffusion v1.5 UNet ResNet block
(``contrib.group_norm.GroupNorm(act="silu")`` with torch's convolutions),
which run the scaled-softmax and GroupNorm kernels; and Mistral-7B trained
on a long sequence with ring-attention context parallelism
(``parallel_state.initialize_model_parallel(1, 1,
context_parallel_size_=4)``, ``LlamaModel(mistral_7b_config(num_layers=2,
context_parallel=True))``, both layouts), the four ranks of the ring
emulated in one process (one card is one NCCL rank), which runs the flash
kernels' causal-offset and dropout-origin branches; and BASELINE's
config #3, the NMT Transformer over ``contrib.multihead_attn``
(``examples.nmt.main``: ``NMTTransformer`` at Transformer-big's widths,
``SelfMultiheadAttn``/``EncdecMultiheadAttn``, ``SoftmaxCrossEntropyLoss``,
``FusedAdam``, amp O1), and config #5, ASP 2:4 structured-sparse
BERT-Large (``contrib.sparsity.ASP.prune_trained_model`` with
``FusedAdam``). Phases, one JSON line each,
``t_s`` giving the seconds since the start:

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
   bf16 (every LayerNorm row by ``queued_ms``; the backward's dgamma/dbeta
   the same bits in a second call; every forward row, LayerNorm and
   RMSNorm, the same bits in a second call and row 0 alone the bits of row
   0 in the batch, and rows at a ragged width and as an unaligned view);
   the flash kernels at 8x16x512x64, non-causal, with per-row padding
   lengths (from the seed) as segment ids
   and dropout 0.1; the xentropy kernels at the gathered MLM head's 640 x
   30528 and the NSP head's 8 x 2, with smoothing 0 and 0.1 and padded
   rows; the stats and LAMB kernels over BERT-Large's flat buffers, with
   an injected inf and NaNs whose count must be exact, and a skipped step
   that must leave every buffer bit-identical (the stats kernel also over
   ResNet-50's; its rows by ``queued_ms`` beside ``torch._foreach_norm``).
   The quantized serving rows:
   the dequant-matmul kernels (int8 and fp8 per channel; int4 at group
   128) at GPT-2-small's four linear shapes, 8 and 128 rows, x in fp32 and
   bf16, timed over copies of the weight that together exceed the L2 cache
   (a decode step streams 48 weights), against cuBLAS on the dequantized
   weight, with their achieved TFLOP/s and TB/s (bf16 x runs the
   tensor-core kernels); a row alone must equal the same row in the batch,
   bit for bit; then the shapes of ROADMAP C2 (``QUANT_C2``: int4 at
   groups 2 and 8 at 768 -> 2304 and 1024 at 3072 -> 768, int8 and fp8 at
   ``in`` 36), rows marked ``c2``. Every paged row (by ``queued_ms``,
   with its achieved TB/s, the bound's bytes over its time, and the same
   bits in a second call): GPT-2-small's 8-slot pool (12 heads, d = 64,
   page 16, lengths 0..1024), fp32 and bf16, then each slot alone (batch
   1) and the batch at a wider table, which must give the batch's bits
   (rows ``use`` "alone"); the quantized paged kernel with int8 and fp8
   pools at the paged row's shape, beside the unquantized kernel's time
   there. The
   Mistral-7B rows, timed as the quantized ones: the RMS branch of the
   LayerNorm forward at width 4096 over a decode step's 8 rows and 4224
   prefill rows (library ``F.rms_norm``), and at t5-small's width 512, eps
   1e-6, over a decode step's 8 rows and a training batch's 128 x 512
   encoder rows; the windowed flash forward at 1
   x 32 x S x 128 over 8 kv heads, window 4096, S = 4224 and 6016 (library
   ``scaled_dot_product_attention`` with the band as a boolean mask); the
   windowed paged decode, unquantized and over int8 and fp8 pools, at 8
   slots, 32 heads over 8 kv heads, d = 128, page 16, lengths
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
   boolean mask), bound by operations over the band's visible pairs. The
   s > 1 rows (``check_paged_block``, by ``queued_ms``): the paged kernel's
   query blocks at GPT-2-small's pool (8 slots, 12 heads, d = 64, page 16,
   lengths 0..1024) at s = 4 and 16, fp32 and bf16, over the fp pool and
   over int8 and fp8 pools, and windowed at Mistral-7B's shapes at s = 16,
   each held within ``RMS_ATOL`` of its twin's RMS (the paged kernel's
   split pass and merge, ``KERNEL_SYMBOLS``); the rows before a short
   slot's start must be exactly 0. The T5 rows (``check_flash_bias``, by
   ``queued_ms``, fp32 and bf16, within ``RMS_ATOL`` of the twin's RMS):
   the bias branch of the flash forward at the encoder's 8 x 8 x 512 x 64
   (serving) and 128 x 8 x 512 x 64 and the decoder's causal 128 x 8 x 114
   x 64 (training), each with a (1, 8, S, S) table in q's dtype at scale
   1.0, and of dq and dk/dv at the two training shapes; T5's
   cross-attention without a bias at Sq = 1 and 114 against Sk = 512; the
   windowed bias branches at 1 x 8 x 1024 x 64, window 256; the library
   call ``scaled_dot_product_attention`` with the bias as a float mask and
   its backward. The NMT rows (``check_flash_nmt``, by ``queued_ms``,
   bf16 within ``RMS_ATOL`` of the twin's RMS): the three flash kernels at
   the NMT step's 32 x 16 x 128 x 64, dropout 0.1, with the decoder's fp32
   causal -1e9 table (1, 1, 128, 128) under the bf16 q and without a bias.
   The ResNet-50 rows (``check_resnet_optim``, by
   ``queued_ms``, fp32 within ``OPT_TOL`` and ``RMS_ATOL`` of the twin's
   RMS): SGD over ResNet-50's flat buffers (25,021 x 1024, 161 segments)
   at momentum 0.9 with decay 1e-4 at steps 1 and 2, momentum 0, Nesterov
   (library: fused ``torch.optim.SGD`` over the 161 views); the whole
   NovoGrad step at steps 1 and 2, ``init_zero`` both ways, grad scale 0.5
   and 1, the update kernel timed alone (no library: PyTorch has no
   NovoGrad); ``multi_tensor_scale`` over fp32 and bf16 buffers, bit-equal
   (library ``torch.mul(x.float(), s)``); a skipped SGD or NovoGrad step
   bit-identical. The softmax rows (``check_scaled_softmax``, by
   ``queued_ms``): each forward branch and the backward at GPT-2-small's
   causal [96, 1024, 1024] scores, BERT-Large's [8, 16, 512, 512] with a
   [8, 1, 1, 512] padding mask and without one, and [2, 4, 16, 8193], fp32
   and bf16, BERT's masked rows fp16 too (library ``torch.softmax`` on the
   pre-scaled, pre-masked scores; ``torch._softmax_backward_data``). The
   GroupNorm rows (``check_group_norm``, by ``queued_ms`` over copies of
   x and dy past the L2 cache, with the profiler's device ms of both
   launches of a call): forward and backward at Stable Diffusion v1.5's
   UNet norms, (8, C, S, S) for (C, S) in (320, 64), (640, 32), (1280,
   16), (1280, 8), channels_last, 32 groups, SiLU at eps 1e-5 and none at
   eps 1e-6, fp32 and bf16, a second call's bits and sample 0's alone
   equal to the batch's (library ``F.group_norm``; its backward's device
   ms by the profiler).
   ``sync_bn_sumsq``: the sum of squares of SyncBatchNorm's statistics at
   ResNet-50's 12 norm shapes in bf16 against fp64 (``vector_norm``
   squared, the direct fp32 sum, the port's), failing if the port's is
   further. ``megatron_softmax``: Megatron's core attention in bf16,
   forward and backward through ``FusedScaleMaskSoftmax`` (GPT-2-small's
   8 x 12 x 1024 causal; BERT-Large's 8 x 16 x 512 with and without the
   padding mask): each forward branch launched once and the backward three
   times, the fused path against the module's ``forward_torch_softmax``,
   ms fused and unfused. ``unet_group_norm``: one SD ResNet block at (8,
   320, 64, 64) bf16, forward and backward: 2 + 2 GroupNorm launches, the
   output and every gradient against the block on the plain fp32 norm, ms
   beside ``F.group_norm`` + ``F.silu``, the kernels' share of device time.
   The ring rows (``check_flash_ring``, by ``queued_ms``, fp32 and bf16,
   within ``TOL``, the atol cut to ``RMS_ATOL`` of the twin's RMS, an LSE
   cotangent in the backward): the ``_window_ring`` branches at
   Mistral-7B's widths on a ring chunk, 1 x 32 x 4096 x 128 over 8 kv
   heads, window 4096, at the offsets 4096 (a ring hop), 2048 and 6144
   and -1024 (the first rows see nothing), and on a zigzag half-chunk, 1 x
   32 x 2048 x 128, at the offsets 2048 and 4096 that ``ring_train_bf16``
   runs, library ``scaled_dot_product_attention`` with the offset band as
   a boolean mask and its backward; the other ``_ring`` branches with
   dropout 0.1 at a rank's global origins, causal (the diagonal step) and
   not (a hop), at the ``ring_attention`` phase's sequence-ordered chunk
   (1 x 32 x 1024 x 128 over 8 kv heads) and at GPT-2-small's 8 x 12 x
   1024 x 64, no library call. Right after the
   softmax and GroupNorm paths, the ring phases: ``ring_attention`` (the
   in-process ring of 4 ranks, 1 x 32 x 4096 x 128 over 8 kv heads, fp32,
   dropout 0.1; sequence order causal, not causal and window 1536, zigzag
   causal and window 1536: the output and every gradient against one
   unsharded call within 1e-4 (RMS + |x|), every ring branch launched,
   the launches kept by layout);
   ``ring_train_bf16`` (Mistral-7B, 2 layers, 1 x 16384 tokens, window
   4096, bf16 over fp32, FusedAdam, both layouts: step ms, tokens/s, MFU,
   peak memory, launches per step, the ``_window_ring`` ones above 0, a
   profiled step); ``ring_train_fp32`` (the bar: full width, 1 layer,
   window 96 below S_loc = 128, 1 x 512, fp32: each layout against the CPU
   through the same ring and against the plain model on the card, every
   gradient within 4 x the CPU's one-rounding floor, two FusedAdam steps);
   ``ring_gpt`` (GPT-2-small fp32 at 8 x 1024, zigzag, two steps against
   the plain model, no window and no dropout, so only the plain flash
   branches launch; the port's ``examples/long_context`` at its
   defaults).
   Then across ranks (BASELINE config #4; two processes on this card
   over gloo, started by ``parallel.run_ranks``, the backend and the
   host-staged collectives printed): ``tp_engine_fp32``/``_bf16``
   (GPT-2-small at full width over TP = 2 through
   ``TensorParallelPagedEngine``, 8 requests: fp32 tokens identical to
   tp = 1 in this process with equal decode steps and half the pool a
   rank, bf16 tokens/s with any first divergence a near tie),
   ``tp_train_fp32``/``_bf16`` (2 x 1024, FusedAdam: fp32 losses and the
   gathered gradients against tp = 1, bf16 step ms; a profiled run each
   for the collectives' host time) and ``ddp_syncbn`` (ResNet-50 with
   SyncBatchNorm and DDP, 2 ranks x 32 images against one rank on the 64,
   O0 and O1 bf16, a forced overflow on one rank skipped on both).
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
   ``spec_fp32``: the workload through two speculative engines,
   ``draft_len = 3``: the self-draft (mean acceptance above 1) and an
   unrelated 2-layer draft of GPT-2-small's width (seed 2), each
   token-identical to ``engine_fp32``'s outputs request for request (else
   the first diverging position and its fp64 logit margin are printed and
   the phase fails), its ``paged_attention_block`` launches its verify
   rounds x 12 layers, both pools drained, and none of the s > 1 branches
   launched by ``engine_fp32``; then lock-step ``speculative_generate``
   (k = 4, the unrelated draft) on two prompts against the same outputs.
   ``chunked_fp32``: the reference bench's chunked-prefill A/B
   (``tpu_decode_bench.py:814-826``: numpy seed 4, one 512-token prompt and
   24 of 24 tokens, 32 new tokens each) through monolithic and chunked
   admission (``prefill_chunk = 16``), token-identical, the chunk path
   engaged, and its ``paged_attention_block`` launches the pieces x 12.
4. ``engine_bf16``: the same workload in bf16, a warm run then two timed
   runs: generated tokens per second, and (first timed run) host and
   synchronized ms per decode step. ``engine_quant_bf16``: the same for
   ``w8_kv8`` (int8 weights, int8 pool) and ``w4_kv8`` (int4 group 128,
   int8 pool), with launches per kernel, block-linear weight bytes per
   decode step against bf16, a page's bytes against a bf16 page, and the
   slots a fixed pool budget admits.
   ``spec_bf16``: the self-draft engine over the workload in bf16, a warm
   and a timed run: tokens/s beside ``engine_bf16``'s, verify rounds, mean
   acceptance, host and synchronized ms per round, and the share of
   requests whose tokens match ``engine_bf16``'s (recorded, not a bar:
   bf16 near-ties). ``chunked_bf16``: the chunked-prefill A/B in bf16,
   monolithic, chunked and chunked over an int8 pool, each a warm and a
   timed run: tokens/s, the TTFT p50 and p95 of the 24 short requests
   (and of all), the share of matching requests, the s > 1 launches.
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
   Then the amp O2 and remat paths (A11) on the same workload, each
   freeing its model: ``bert_o2_bf16`` (the same weights, batch and seeds
   under ``amp.initialize(opt_level="O2")``: every non-norm parameter a
   bf16 copy of the fp32 master, every norm an fp32 master view, each
   copy ``master.to(bf16)`` bit for bit after every step, ``bert_bf16``'s
   launches per step, the losses within ``O2_DRIFT`` nats of
   ``bert_bf16``'s; step ms, tokens/s and MFU beside ``bert_bf16``'s, the
   two half-copy casts by ``queued_ms`` and the ``_to_copy`` casts a step
   dispatches beside ``bert_bf16``'s) and ``bert_remat_bf16`` (24 layers,
   dropout 0.1, one forward and backward with ``remat`` and one without:
   loss and every gradient bit-equal, the peak memory lower with remat,
   the flash and LayerNorm forwards once more a layer; forward-backward
   ms of both). After ``resnet_bf16``, ``resnet_o2_bf16`` (its workload
   under O2: conv and fc bf16, BatchNorm fp32, the copies checked after
   every step, losses within ``O2_DRIFT`` of ``resnet_bf16``'s, step ms,
   images/s, MFU beside; one O3 step with every parameter bf16), then
   ``dcgan_fp16`` (the DCGAN multi-loss example at O2 fp16, two dynamic
   scalers, against the CPU port: the scales and step counts at every
   step equal, one inf sample in step ``DCGAN_POISON``'s real batch skips
   only the discriminator's optimizer and halves only its scale, the
   losses within ``DCGAN_FLOOR_FACTOR`` times the CPU's own fp16 floor)
   and ``transforms`` (the four optax-style transforms at ResNet-50's 161
   tensors against the CPU's, with their launches).
9. ``mistral_train_fp32``: Mistral-7B at full width, 1 layer, window cut
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
   The ResNet-50 phases run after ``bert_bf16`` (their batch needs the
   room that the later phases' live models take): ``resnet_fp32`` (the
   bar): ResNet-50 at ImageNet width (1000 classes, 224 x 224), 8 images,
   amp O0, card against CPU from the same seeded weights, cuDNN's
   convolutions in their deterministic algorithms: two
   ``FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)`` steps, then two
   ``FusedNovoGrad`` steps, each step's losses within 1e-4 relative, every
   gradient within ``RESNET_FLOOR_FACTOR`` times the CPU's own rounding
   floor (in norm, per tensor), the running statistics, parameters and
   optimizer state after it within atol 1e-4 / rtol 1e-3 (the CPU stepping
   on the card's gradients), the kernels launched twice; then one O1 fp16
   step with a dynamic scaler and an ``inf`` planted in a gradient:
   parameters, momentum and the step count bit-identical, the scale
   halved, ``segment_stats`` and ``sgd`` launched once. ``resnet_bf16``:
   the example's path, ``resnet50()`` at 224 x 224, 256 images, amp O1
   bf16, FusedSGD: warm steps, then 10 timed steps: step ms, images/s,
   FLOPs per step (``resnet_train_flops``) and MFU, peak memory, launches
   per step asserted (``sgd`` 1, no stats pass: bf16 attaches no scaler).
   ``resnet_novograd_bf16``: the same with FusedNovoGrad, 3 steps:
   ``segment_stats`` and ``novograd`` 1 a step, a finite loss.
   The T5 phases run between the ResNet phases and ``mistral_train_fp32``
   (the Mistral step stays live for its profile, and T5's 128 x 512 batch
   fits before it): ``t5_fp32`` (the bar): t5-small at full width in fp32,
   ``t5_generate``
   of 64 tokens for 8 requests of 512 encoder tokens, token-identical to
   the greedy teacher-forced re-derivation on the card (else each
   diverging row's fp64 margin is printed and the phase fails), exact
   launches (the encoder's L ``flash_fwd_bias``), the bucket tables equal
   to the CPU's, the encoder output and first step's logits within
   ``T5_FLOOR_FACTOR`` times the CPU's own rounding floor of the port on
   the CPU. ``t5_bf16``:
   the same requests in bf16, 128 tokens: tokens/s, encode ms, host and
   synchronized ms per decode step, launches, peak memory.
   ``t5_train_fp32``: card against CPU at 2 x 512 inputs and 114 targets:
   the fp64 cross-entropies within 1e-4 relative, every gradient (plus 4 x
   the CPU's own rounding floor per tensor), both relative-bias tables'
   gradients exactly 0 on both sides, two FusedAdam steps, the CPU's on
   the card's gradients, the parameters after each within
   ``UPDATE_TOL``. ``t5_train_bf16``: the T5 paper's 128 x 512 inputs and
   114 targets, bf16 over fp32, FusedAdam(lr=1e-4, weight_decay=0.01): step ms,
   tokens/s, FLOPs (formula in the line) and MFU, launches per step
   asserted, a falling finite loss.
   The NMT and ASP phases run after ``bert_bf16`` and free their models:
   ``nmt_fp32`` (the bar): ``NMTTransformer`` at Transformer-big's widths
   (``NMT_BIG``) cut to 2 + 2 layers, 4 x 64 tokens, attention dropout 0.1
   (the counter-based keep masks, their seeds from a CPU generator, so
   both sides draw the same), card against CPU: the loss within 1e-4
   relative, every gradient within atol 1e-4 / rtol 1e-3, then three
   ``FusedAdam(lr=3e-4)`` steps and a loss after them, each within 1e-4
   relative, the launches of one forward and backward exact; then the
   example's ``run_training`` at its command line's defaults (30 steps, 32
   x 32) on the card: the loss falls, its first 3 losses within 1e-4
   relative of the CPU's. ``nmt_bf16``: Transformer-big uncut (6 + 6
   layers, vocab 37000), 32 x 128 source and target tokens, amp O1 bf16:
   3 warm steps, then 10 timed: step ms, target tokens/s, the step's bound
   from the widths (``nmt_bound``), peak memory, launches per step
   asserted, finite losses, the first batch's loss before the steps
   within 1e-2 relative of the same weights' fp32 loss; an fp32 witness
   (the same weights, amp off, the same batches and dropout seeds): the O1
   first-batch gradients within ``NMT_O1_GRAD_REL`` of its own (the
   largest relative 2-norm error over the parameters), a control with the
   bf16 flash calls' fp32 bias dropped beyond that bar, and every step's
   O1 loss within 1e-2 relative of the witness's (the first batch's loss
   after the steps reported for both: lr 3e-4 with no warm-up need not
   lower it in 13 steps); ``nmt_bf16_profile``: one profiled
   step, device ms by class. ``asp_bert_fp32``: ``bert_fp32``'s cut (4
   layers, 2 x 128), ``prune_trained_model`` with FusedAdam, card against
   CPU: the masks bit-equal and 2:4, the loss and every gradient at
   ``bert_fp32``'s bars, three masked steps and a loss after them within
   1e-4 relative, every pruned weight exactly 0 after every step on both
   sides. ``asp_bert_bf16``: BERT-Large uncut at ``bert_bf16``'s batch, 2
   warm and 10 timed masked steps: every mask 2:4, every pruned weight
   exactly 0 after every step, step ms and tokens/s, launches per step
   asserted (Adam 1, no stats or LAMB pass); then the hook's cost: steps
   with it and with the optimizer's own ``step`` in turns A, B, B, A, one
   profiled step of each (wall and device busy ms), and its two
   multiplies' time by ``queued_ms``.
10. ``engine_bf16_profile``, ``spec_bf16_round_profile`` (one
   speculative round, not a run, traced with the host's ops),
   ``engine_quant_bf16_profile``,
   ``mistral_bf16_profile``, ``kernel_device_ms``, ``train_bf16_profile``
   ``bert_bf16_profile``, ``mistral_train_bf16_profile``,
   ``t5_bf16_profile``, ``t5_train_bf16_profile`` and
   ``resnet_bf16_profile`` (with the SGD kernel's share of device time):
   one more bf16
   engine run (and a short run, the first 8 requests at 16 tokens, of each
   quantized configuration, with each kernel's device ms and launches, and
   of Mistral-7B), the host's ops untraced, under ``torch.profiler``
   (device busy and idle share, the top device kernels; the engine and
   Mistral-7B profiles also the paged kernel's device ms a call, its split
   pass and merge summed),
   each kernel's device time per call at the shapes of phase 2, the timed
   bf16 engine run once more, one profiled step of each training path,
   one ``t5_generate`` (host untraced), one T5 training step and one
   ResNet-50 step. Last, so that no profiler state can touch the times of phases
   2-9.

Then the per-kernel summary line (serving kernels with the launches of the
timed engine run, the quantized serving kernels with those of the timed
``w8_kv8`` or ``w4_kv8`` run, the windowed kernel branches with those of
the timed ``mistral_bf16`` run, GPT training kernels with those of its
timed run, the BERT kernels with those of the timed BERT run, the Mistral
training branches with those of its timed run (the ``memory_efficient``
branch with those of its run in ``mistral_train_fp32``), the s > 1 paged
branches with those of the timed ``spec_bf16`` run (the s = 16 row beside,
with the chunked run's) and of the timed int8-pool chunked run; the
windowed block has no engine path, as the reference refuses both modes
for windowed models, and reads 0; the flash bias branches with the T5
runs' launches, the windowed ones reading 0; the SGD and NovoGrad kernels
with the timed ResNet-50 runs' launches, ``multi_tensor_scale`` with 0:
it has no caller on a path, in the reference either; the scaled-softmax
and GroupNorm kernels with the ``megatron_softmax`` and
``unet_group_norm`` runs'; the windowed ring branches with those of the
timed ``ring_train_bf16`` steps of the sequence-ordered layout, read
against the row at that layout's shape and offset (both layouts per step
beside, the zigzag rows among the other rows), the others with the
``ring_attention`` phase's sequence-ordered runs, read against the row at
their chunk's shape;
every path's count beside it) and, last,
``{"ok": true, "device": ...}``.
Any failure raises, so the run exits non-zero without the last line. With
no CUDA device, or without the ``apex_tpu_torch`` package beside it, it
exits non-zero at once. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
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
# one bf16 ulp (2^-7 relative); fp16 (the scaled-softmax rows) by about one
# fp16 ulp (2^-10 relative).
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2),
       "float16": (1e-3, 1e-3)}
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

#: the NMT slice (BASELINE.md config #3, ``examples/nmt/main.py``):
#: Transformer-big (Vaswani et al. 2017, Table 3 "big"; ``NMTTransformer``'s
#: own fields): E 1024, 16 heads of 64, FFN 4096, 6 + 6 layers, the
#: shared en-de BPE vocabulary of about 37000, label smoothing and
#: attention dropout 0.1; 32 x 128 source and target tokens under amp O1
#: bf16; card against CPU in fp32 at 2 + 2 layers and 4 x 64 (the CPU
#: side's fp32 steps), three FusedAdam steps; then the example's own
#: ``run_training`` at its command line's defaults
NMT_BIG = dict(vocab_size=37000, embed_dim=1024, num_heads=16, ffn_dim=4096,
               num_layers=6, dropout=0.1)
NMT_BATCH, NMT_SEQ, NMT_WARM, NMT_TIMED = 32, 128, 3, 10
NMT_LS, NMT_LR = 0.1, 3e-4
NMT_FP32_LAYERS, NMT_FP32_BATCH, NMT_FP32_SEQ, NMT_FP32_STEPS = 2, 4, 64, 3
NMT_EXAMPLE = dict(steps=30, batch=32, seq=32)
#: the O1 step's loss against the same weights' fp32 loss, relative: the
#: bf16 GEMMs and flash kernels of 6 + 6 attention layers round to 2^-9
NMT_O1_REL = 1e-2
#: the O1 first-batch gradients against the fp32 witness's, the largest
#: relative 2-norm error over the parameters: 0.128 on the H100 (the last
#: decoder layer's cross-attention q weight, whose gradient at init is a
#: small difference of near-uniform attention terms), 0.93 with the bf16
#: flash calls' bias dropped; the bar lies between with room each side
NMT_O1_GRAD_REL = 0.3
#: ``asp_bert_bf16``'s A/B of steps with and without the ASP hook: rounds
#: of turns A, B, B, A, each turn this many steps
ASP_AB_ROUNDS, ASP_AB_STEPS = 2, 3
#: the kernels of an NMT training step
NMT_KERNELS = ("flash_fwd", "flash_fwd_bias", "flash_bwd_dq",
               "flash_bwd_dq_bias", "flash_bwd_dkdv", "flash_bwd_dkdv_bias",
               "layer_norm_fwd", "layer_norm_bwd", "xentropy_fwd",
               "xentropy_bwd", "adam")
#: device ms by class in ``nmt_bf16_profile``, by kernel name fragments:
#: cuBLAS's GEMMs split by their names' fp32 marks (the FFN and the tied
#: projection run in fp32 under O1, the attention projections in bf16,
#: cuBLAS's ``nvjet_*_h_*`` kernels)
NMT_FP32_GEMM = ("f32f32", "sgemm")
NMT_KERNEL_CLASSES = (
    ("flash", ("flash_",)), ("layer_norm", ("layer_norm_",)),
    ("xentropy", ("xentropy_",)), ("adam", ("adam_kernel",)),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "cublas")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reduction", ("reduce_kernel",)), ("index", ("index", "gather",
                                                 "scatter")))

# the quantized serving slice: the int4 group, GPT-2-small's block linears
# (in, out), the rows of a decode step and of a prefill; fp8 values carry
# 3 mantissa bits, so a quantized page value is within 1/16 of |x| plus
# half the smallest subnormal step (scale / 1024) of the value written
QUANT_GS = 128
#: the depth of engine_quant_fp32's int8 / int4 weight models
QUANT_FP32_LAYERS = 4
QUANT_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
QUANT_ROWS = (NUM_SLOTS, 128)
#: ROADMAP C2's shapes: (kind, group size, in, out), int4 groups below 16
#: and above 512 at GPT-2-small's widths, int8/e4m3 at an ``in`` that is no
#: multiple of 8
QUANT_C2 = (("int4", 2, 768, 2304), ("int4", 8, 768, 2304),
            ("int4", 1024, 3072, 768), ("int8", 0, 36, 768),
            ("fp8", 0, 36, 768))
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
#: a row wider than the norm backward holds in registers (it walks the row
#: in passes): a 2048-token sequence at width 8192, Llama-2-70B's hidden
#: size
NORM_BWD_WIDE = (2048, 8192)
FLASH_BWD_WINDOW_CASES = ((4224, MISTRAL_WINDOW), (6016, MISTRAL_WINDOW),
                          (MISTRAL_TRAIN_SEQ, MISTRAL_WINDOW), (1024, 256))
MISTRAL_TRAIN_FP32 = dict(layers=1, window=128, batch=1, seq=512)
MISTRAL_TRAIN_WARM, MISTRAL_TRAIN_TIMED = 2, 3

# the s > 1 query blocks: the verify of draft_len = 3 proposals (s = 4) and
# a chunk of one page (s = 16); the spec phases' unrelated draft (GPT-2-small
# width, 2 layers, its own seed); the reference bench's chunked-prefill A/B
# (tpu_decode_bench.py:814-826: one 512-token prompt and 3 x 8 prompts of
# 24 tokens, 32 new tokens each, numpy seed 4, prefill_chunk = page_size);
# the spec round the round profile catches
SPEC_DRAFT_LEN, BLOCK_S = 3, (4, 16)
SPEC_DRAFT_LAYERS, SPEC_DRAFT_SEED = 2, SEED + 1
CHUNK_SEED, CHUNK_LONG, CHUNK_SHORT, CHUNK_NEW = 4, 512, 24, 32
CHUNK_N_SHORT = 3 * NUM_SLOTS
PROFILE_ROUND = 10
# the untraced quantized and Mistral-7B engine profiles run the first
# NUM_SLOTS requests of their workload (Mistral's two long ones among
# them) with budgets capped at PROFILE_BUDGET tokens: a run of each
# workload under the profiler took 108-146 s
PROFILE_BUDGET = 16

#: the kernels of the serving path and of the two training paths
SERVING_KERNELS = ("layer_norm_fwd", "flash_fwd", "paged_attention")
#: the kernels of the speculative and chunked-prefill paths, and the s > 1
#: branches of the paged kernel
SPEC_KERNELS = SERVING_KERNELS + ("paged_attention_block",)
CHUNK_KERNELS = ("layer_norm_fwd", "paged_attention", "paged_attention_block")
CHUNK_KV8_KERNELS = ("layer_norm_fwd", "paged_attention_quant",
                     "paged_attention_quant_block")
BLOCK_KERNELS = ("paged_attention_block", "paged_attention_window_block",
                 "paged_attention_quant_block")
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
#: the T5 slice: t5-small at full width (T5Config(): vocab 32128, d_model
#: 512, d_ff 2048, 6 + 6 layers, 8 heads of 64, 32 buckets to distance 128);
#: serving 8 requests of 512 encoder tokens (numpy seed T5_SEED), 64 new
#: tokens each in fp32 (the bar) and 128 in bf16; training the T5 paper's
#: span-corruption batch, 128 x 512 inputs and 114 targets, in bf16 over
#: fp32, and card against CPU at 2 x 512 and 114 in fp32
T5_SEED, T5_BATCH, T5_ENC_SEQ, T5_NEW_FP32, T5_NEW_BF16 = 5, 8, 512, 64, 128
T5_TRAIN_BATCH, T5_TRAIN_ENC, T5_TRAIN_DEC = 128, 512, 114
T5_TRAIN_FP32_BATCH, T5_TRAIN_WARM, T5_TRAIN_TIMED = 2, 2, 5
T5_HEADS, T5_HEAD_DIM = 8, 64
# the windowed bias branch's one row, (S, window): no T5 path runs it
T5_WINDOW_CASE = (1024, 256)
# card against CPU in fp32, held to T5_FLOOR_FACTOR times the CPU's own
# floor: the change of the same outputs on the CPU when every parameter
# moves by relative noise of 2^-24 (one rounding; ``perturbed``). At
# t5-small's random init (LeCun q and k at scale 1.0: scores of std ~8;
# relu gates) six layers amplify rounding: on an H100 machine's CPU one
# rounding of every parameter moved the unit-RMS encoder output by 2.2e-4
# and a training gradient by 0.7% (median over tensors, relative Frobenius
# norm; 1.5% at worst), so most card gradients break the per-entry bar
# atol min(1e-4, 1e-3 max|g|), rtol 1e-3 that the other card-against-CPU
# phases hold (``t5_fp32``, ``t5_train_fp32`` report both)
T5_FLOOR_FACTOR = 4.0
#: the bias branches of the three flash kernels, and the kernels a T5
#: training step launches
BIAS_KERNELS = ("flash_fwd_bias", "flash_fwd_window_bias",
                "flash_bwd_dq_bias", "flash_bwd_dq_window_bias",
                "flash_bwd_dkdv_bias", "flash_bwd_dkdv_window_bias")
T5_TRAIN_KERNELS = ("rms_norm_fwd", "rms_norm_bwd", "flash_fwd",
                    "flash_fwd_bias", "flash_bwd_dq", "flash_bwd_dq_bias",
                    "flash_bwd_dkdv", "flash_bwd_dkdv_bias", "adam")

#: the ResNet-50 slice (the example ``examples/imagenet/main_amp.py``):
#: ImageNet width, 1000 classes at 224 x 224; the timed path at 256 images
#: a card, amp O1 bf16, FusedSGD(lr 0.1, momentum 0.9, decay 1e-4); the
#: card-against-CPU bar at 8 images in fp32 (O0), two steps of FusedSGD
#: and of FusedNovoGrad; the short NovoGrad run's steps
RESNET_IMAGE, RESNET_CLASSES, RESNET_LR = 224, 1000, 0.1
RESNET_BATCH, RESNET_WARM, RESNET_TIMED = 256, 3, 10
RESNET_FP32_BATCH, RESNET_NVG_STEPS = 8, 3
# amp O2/O3 (A11): the losses' largest drift from the O1 run's at the same
# weights, batch and seeds, in nats (the reference's L1 check,
# tests/test_examples.py:143)
O2_DRIFT = 0.25
# BERT remat: its depth (the whole model) and the timed forward-backwards
BERT_REMAT_LAYERS, BERT_REMAT_TIMED = 24, 3
# the DCGAN example (reference batch 32, 20 steps), the step whose real
# batch holds an inf sample, and the CPU floor's relative perturbation of
# the fp32 masters (one fp16 rounding is 2^-11 relative) and its factor
DCGAN_STEPS, DCGAN_BATCH, DCGAN_POISON = 20, 32, 10
DCGAN_PERTURB, DCGAN_FLOOR_FACTOR = 2.0 ** -11, 4.0
# ResNet-50 at its random init amplifies rounding: on a CPU, one rounding
# of every parameter (``perturbed``) moved the gradients by 2.4% median
# and 3.1% at worst (relative Frobenius norm per tensor; full width, 8
# images of 112 x 112), far past the per-entry bar atol 1e-4 / rtol 1e-3 on
# gradients of ~1e-3. So ``resnet_fp32`` holds each gradient in norm to
# RESNET_FLOOR_FACTOR times the CPU's own floor at the phase's shapes, as
# the T5 phases do, and the losses, running statistics, parameters and
# optimizer state to the fixed bars
RESNET_FLOOR_FACTOR = 4.0
# the optimizer kernel rows: kernel and twin compute the same fp32 formula,
# a fused multiply-add apart at most (one fp32 ulp, 6e-8 relative)
OPT_TOL = (1e-6, 1e-6)

#: the Megatron attention softmax (``FusedScaleMaskSoftmax``) at the widths
#: of two models the port trains, head dim 64: GPT-2-small's training
#: scores (8 x 12 heads x 1024 tokens, causal) and BERT-Large's (8 x 16
#: heads x 512 tokens, a [8, 1, 1, 512] padding mask from sequence lengths,
#: one of them a single token); Megatron's query-key layer scaling at each
#: model's last layer (scores / (sqrt(d) L), softmax scale L); a row longer
#: than 8192 (the kernels have no cap)
SOFTMAX_GPT = (TRAIN_BATCH, 12, TRAIN_SEQ)           # (b, np, s)
SOFTMAX_BERT = (BERT_BATCH, BERT_HEADS, BERT_SEQ)
SOFTMAX_LONG = (2, 4, 16, 8193)                       # (b, np, sq, sk)
SOFTMAX_HEAD_DIM = 64
SOFTMAX_LAYERS = {"gpt": 12, "bert": 24}
#: Stable Diffusion v1.5's UNet GroupNorm shapes at batch 8 (32 groups;
#: (channels, side) of its four resolutions): the ResNet blocks' norms, SiLU
#: fused, eps 1e-5; the attention blocks' norm, no activation, eps 1e-6
UNET_BATCH, UNET_GROUPS = 8, 32
UNET_SHAPES = ((320, 64), (640, 32), (1280, 16), (1280, 8))
UNET_NORMS = (("silu", 1e-5), (None, 1e-6))
#: the new kernels, by the path that launches them
SOFTMAX_KERNELS = ("scaled_softmax_fwd", "scaled_softmax_fwd_masked",
                   "scaled_softmax_fwd_causal", "scaled_softmax_bwd")
GROUP_NORM_KERNELS = ("group_norm_fwd", "group_norm_bwd")
#: a relative Frobenius bar for the paths' fused-against-unfused bf16
#: outputs and gradients: both sides round fp32 values once to bf16 (2^-9
#: relative); the fused softmax backward starts from the bf16 y it saved,
#: the unfused one from autograd's fp32 y
PATH_REL_BAR = 1e-2

#: the ring-attention slice: context parallelism over RING_CP ranks of an
#: in-process ring on the one card (one GPU is one NCCL rank). The ring
#: branches' kernel rows at Mistral-7B's widths on a chunk of RING_CHUNK
#: tokens (a 16384-token sequence over 4 ranks), window 4096, at the
#: offsets RING_OFFSETS (a ring hop's 4096, 2048, 6144 and a negative
#: one), and on zigzag's half-chunk of RING_CHUNK / 2 at the offsets
#: RING_ZIGZAG_OFFSETS that its ring runs; with dropout RING_DROPOUT at a
#: rank's origins on RING_ATTN's chunk and at GPT-2-small's widths.
#: ``ring_attention``: one layer's attention at RING_ATTN through
#: the ring against one unsharded call, fp32 within RING_ATTN_TOL (merge
#: order only). ``ring_train_bf16``: Mistral-7B, RING_TRAIN_LAYERS deep
#: (32 need 116 GB), 1 x RING_TRAIN_SEQ tokens, window 4096.
#: ``ring_train_fp32``: full width, 1 layer, window 96 below S_loc = 128
#: (S_h = 64), 1 x 512, card against CPU and against the plain model, each
#: gradient within RING_FLOOR_FACTOR times the CPU's one-rounding floor
RING_CP, RING_CHUNK, RING_DROPOUT = 4, 4096, 0.1
RING_OFFSETS = (4096, 2048, 6144, -1024)
RING_ZIGZAG_OFFSETS = (2048, 4096)
RING_ATTN = dict(batch=1, heads=MISTRAL_HEADS, kv_heads=MISTRAL_KV_HEADS,
                 seq=4096, d=MISTRAL_HEAD_DIM, window=1536)
RING_ATTN_TOL = 1e-4
RING_TRAIN_LAYERS, RING_TRAIN_SEQ = 2, 16384
RING_TRAIN_WARM, RING_TRAIN_TIMED = 2, 3
RING_TRAIN_FP32 = dict(layers=1, window=96, batch=1, seq=512)
RING_FLOOR_FACTOR = 4.0
#: the flash kernels' ring branches (a diagonal other than Sk - Sq, or
#: dropout at a non-zero origin)
RING_KERNELS = ("flash_fwd_ring", "flash_fwd_window_ring",
                "flash_bwd_dq_ring", "flash_bwd_dq_window_ring",
                "flash_bwd_dkdv_ring", "flash_bwd_dkdv_window_ring")

#: kernels whose buffers are fp32 on the path (the summary's dtype); the
#: unwindowed ring branches' path is the fp32 ``ring_attention`` phase
FP32_KERNELS = ("adam", "xentropy_fwd", "xentropy_bwd", "segment_stats",
                "lamb_phase1", "lamb_phase2", "sgd", "novograd",
                "multi_tensor_scale", "flash_fwd_ring", "flash_bwd_dq_ring",
                "flash_bwd_dkdv_ring")

#: the paged kernel's launches a call: its split pass (either route,
#: ``paged_split_simt_kernel`` or ``paged_split_mma_kernel``) and its merge;
#: and the one kernel of a tree whose paged call was one launch
#: (``paged_decode_kernel``, ``paged_decode_quant_kernel``), so that an A/B
#: against such a tree reads both sides
PAGED_SYMBOLS = ("paged_split_", "paged_merge_kernel", "paged_decode_")
#: the GroupNorm ops' launches a call: the forward's statistics and apply
#: passes, the backward's sums and dx passes; and each op's one kernel of
#: a tree whose call was one launch, so that an A/B against such a tree
#: reads both sides
GROUP_NORM_FWD_SYMBOLS = ("group_norm_fwd_stats_kernel",
                          "group_norm_fwd_apply_kernel",
                          "group_norm_fwd_kernel")
GROUP_NORM_BWD_SYMBOLS = ("group_norm_bwd_sums_kernel",
                          "group_norm_bwd_dx_kernel",
                          "group_norm_bwd_kernel")

#: kernel name -> the CUDA symbol the profiler reports its launches under
#: (for ``layer_norm_bwd`` its one kernel, which also sums dgamma/dbeta;
#: for the softmax forward the warp and the block path,
#: ``scaled_softmax_fwd_``), or a tuple of the symbols of an op that is
#: several launches (``segment_stats``: its row pass and its segment sums;
#: ``lamb_phase1``: its row pass and the norms' segment sums; the six paged
#: names: ``PAGED_SYMBOLS``; the GroupNorm ops: ``GROUP_NORM_*_SYMBOLS``)
KERNEL_SYMBOLS = {"layer_norm_fwd": "layer_norm_fwd_kernel",
                  "flash_fwd": "flash_fwd_kernel",
                  "paged_attention": PAGED_SYMBOLS,
                  "layer_norm_bwd": "layer_norm_bwd_kernel",
                  "flash_bwd_dq": "flash_bwd_dq_kernel",
                  "flash_bwd_dkdv": "flash_bwd_dkdv_kernel",
                  "adam": "adam_kernel",
                  "xentropy_fwd": "xentropy_fwd_kernel",
                  "xentropy_bwd": "xentropy_bwd_kernel",
                  "segment_stats": ("stats_rows_kernel",
                                    "stats_segments_kernel"),
                  "lamb_phase1": ("lamb_phase1_kernel",
                                  "segment_reduce_kernel"),
                  "lamb_phase2": "lamb_phase2_kernel",
                  "dequant_matmul": "dequant_matmul_kernel",
                  "dequant_matmul_w4": "dequant_matmul_w4_kernel",
                  "paged_attention_quant": PAGED_SYMBOLS,
                  "rms_norm_fwd": "layer_norm_fwd_kernel",
                  "flash_fwd_window": "flash_fwd_kernel",
                  "paged_attention_window": PAGED_SYMBOLS,
                  "rms_norm_bwd": "layer_norm_bwd_kernel",
                  "layer_norm_bwd_from_y": "layer_norm_bwd_kernel",
                  "flash_bwd_dq_window": "flash_bwd_dq_kernel",
                  "flash_bwd_dkdv_window": "flash_bwd_dkdv_kernel",
                  "paged_attention_block": PAGED_SYMBOLS,
                  "paged_attention_window_block": PAGED_SYMBOLS,
                  "paged_attention_quant_block": PAGED_SYMBOLS,
                  "flash_fwd_bias": "flash_fwd_kernel",
                  "flash_fwd_window_bias": "flash_fwd_kernel",
                  "flash_bwd_dq_bias": "flash_bwd_dq_kernel",
                  "flash_bwd_dq_window_bias": "flash_bwd_dq_kernel",
                  "flash_bwd_dkdv_bias": "flash_bwd_dkdv_kernel",
                  "flash_bwd_dkdv_window_bias": "flash_bwd_dkdv_kernel",
                  "sgd": "sgd_kernel", "novograd": "novograd_kernel",
                  "multi_tensor_scale": "scale_",
                  "scaled_softmax_fwd": "scaled_softmax_fwd_",
                  "scaled_softmax_fwd_masked": "scaled_softmax_fwd_",
                  "scaled_softmax_fwd_causal": "scaled_softmax_fwd_",
                  "scaled_softmax_bwd": "scaled_softmax_bwd_kernel",
                  "group_norm_fwd": GROUP_NORM_FWD_SYMBOLS,
                  "group_norm_bwd": GROUP_NORM_BWD_SYMBOLS,
                  "flash_fwd_ring": "flash_fwd_kernel",
                  "flash_fwd_window_ring": "flash_fwd_kernel",
                  "flash_bwd_dq_ring": "flash_bwd_dq_kernel",
                  "flash_bwd_dq_window_ring": "flash_bwd_dq_kernel",
                  "flash_bwd_dkdv_ring": "flash_bwd_dkdv_kernel",
                  "flash_bwd_dkdv_window_ring": "flash_bwd_dkdv_kernel"}
#: every flash branch and both dequant kernels in bf16 run a tensor-core
#: kernel (fp32 keeps the ``flash_*_kernel`` and ``dequant_matmul*_kernel``
#: symbols above)
BF16_SYMBOLS = {name: symbol.replace("_kernel", "_mma_kernel")
                for name, symbol in KERNEL_SYMBOLS.items()
                if name.startswith(("flash_", "dequant_"))}


def kernel_symbol(name: str, dtype: str):
    """The CUDA symbol the profiler reports kernel ``name``'s launches at
    ``dtype`` under (a tuple of symbols for an op of several launches)."""
    if dtype == "bfloat16" and name in BF16_SYMBOLS:
        return BF16_SYMBOLS[name]
    return KERNEL_SYMBOLS[name]


def ptxas_registers() -> dict:
    """Registers per thread of each built kernel."""
    return {name: regs for name, (regs, _) in ptxas_report().items()}


def ptxas_spill_bytes() -> dict:
    """Spill stores plus spill loads, in bytes, of each built kernel."""
    return {name: spill for name, (_, spill) in ptxas_report().items()}


def ptxas_report() -> dict:
    """``{kernel: (registers per thread, spill bytes)}`` of each built
    kernel (``<bf16>`` marks the bf16 instantiation, ``<d64>``/``<d128>``
    the head-dim instances of the tensor-core flash kernels), from the
    ptxas reports the build keeps beside each library."""
    import re

    from apex_tpu_torch.ops import _build

    names = ("layer_norm_fwd_kernel", "layer_norm_bwd_kernel",
             "flash_fwd_kernel",
             "flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
             "flash_bwd_dkdv_mma_kernel",
             "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel",
             "paged_decode_kernel", "adam_kernel", "xentropy_fwd_kernel",
             "xentropy_bwd_kernel", "stats_rows_kernel",
             "stats_segments_kernel", "segment_reduce_kernel",
             "lamb_phase1_kernel",
             "lamb_phase2_kernel", "dequant_matmul_kernel",
             "dequant_matmul_w4_kernel", "dequant_matmul_mma_kernel",
             "dequant_matmul_w4_mma_kernel", "paged_decode_quant_kernel",
             "paged_split_simt_kernel", "paged_split_mma_kernel",
             "paged_merge_kernel",
             "sgd_kernel", "novograd_kernel", "scale_f32_kernel",
             "scale_bf16_kernel", "scaled_softmax_fwd_warp_kernel",
             "scaled_softmax_fwd_long_kernel",
             "scaled_softmax_bwd_kernel", *GROUP_NORM_FWD_SYMBOLS,
             *GROUP_NORM_BWD_SYMBOLS)
    regs = {}
    for log in sorted(_build.BUILD.glob("*.log")):
        entry, spill = None, 0
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry, spill = m.group(1), 0
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                name = next((n for n in names if n in entry), entry)
                bf16 = ("<bf16>" if "nv_bfloat16" in entry else "<f16>"
                        if "6__half" in entry else "")
                # the SiLU and element-load (<ragged>) instantiations of
                # the GroupNorm kernels: <T, kSilu, kRagged>, the
                # statistics pass <T, kRagged>, a one-launch tree's
                # kernels <T, kSilu>
                gn = re.search(r"kernelI(?:f|13__nv_bfloat16|6__half)"
                               r"((?:Lb[01]E)+)E", entry)
                if name.startswith("group_norm") and gn:
                    flags = re.findall(r"Lb([01])E", gn.group(1))
                    if name == "group_norm_fwd_stats_kernel":
                        flags.insert(0, "0")
                    bf16 += ("<silu>" if flags[0] == "1" else "") + (
                        "<ragged>" if flags[1:] == ["1"] else "")
                # the RMS instantiations of the LayerNorm forward, its
                # slots a thread, element loads (<ragged>), passes over a
                # wide row and w and b read with x (<hoist>); the RMS and
                # from_y instantiations of its backward
                rms = ""
                fwd = re.search(r"Lb([01])ELi(\d+)ELb([01])ELb([01])E"
                                r"Lb([01])EE", entry)
                if name == "layer_norm_fwd_kernel" and fwd:
                    rms = (("<rms>" if fwd.group(1) == "1" else "")
                           + f"<nv{fwd.group(2)}>"
                           + ("" if fwd.group(3) == "1" else "<ragged>")
                           + ("<wide>" if fwd.group(4) == "1" else "")
                           + ("<hoist>" if fwd.group(5) == "1" else ""))
                flags = re.search(r"Lb([01])ELb([01])E", entry)
                if name == "layer_norm_bwd_kernel" and flags:
                    rms = ("<rms>" if flags.group(1) == "1" else "") + (
                        "<from_y>" if flags.group(2) == "1" else "")
                # the slots a thread holds (norm backward, and <wide>: a
                # row walked in passes) or the units a lane holds (softmax
                # warp path)
                nv = re.search(r"Li(\d+)E(Lb([01])E)?EE", entry)
                if name in ("layer_norm_bwd_kernel",
                            "scaled_softmax_fwd_warp_kernel") and nv:
                    rms += f"<nv{nv.group(1)}>" + (
                        "<wide>" if nv.group(3) == "1" else "")
                # the e4m3 instantiations of the quantized kernels
                fp8 = "<e4m3>" if ("fp8_e4m3" in entry or (
                    name in ("dequant_matmul_kernel",
                             "dequant_matmul_mma_kernel")
                    and "Li1E" in entry)) else ""
                # the dequant kernels' instances for ragged rows and the
                # int4 groups below 16 (ROADMAP C2)
                if name.startswith("dequant_matmul") and "Lb1EE" in entry:
                    fp8 += "<ragged>"
                # the paged split pass's instances: int8 pages, the head
                # dim bucket and the rows a warp may carry
                pk = re.search(r"simt_kernelI(?:f|13__nv_bfloat16)(a)?.*"
                               r"Li(\d+)ELi(\d+)EE", entry)
                if name == "paged_split_simt_kernel" and pk:
                    rms = (("<i8>" if pk.group(1) else "")
                           + f"<d{pk.group(2)}><rt{pk.group(3)}>")
                # the head-dim instances of the tensor-core flash kernels
                # (and of the paged split pass)
                dim = re.search(r"mma_kernelILi(\d+)E", entry)
                dim = f"<d{dim.group(1)}>" if dim else ""
                regs[name + bf16 + fp8 + rms + dim] = (int(m.group(1)),
                                                        spill)
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


def queued_ms(fn, iters: int = 50, sleep_cycles: int = 800_000) -> float:
    """``time_ms`` with the calls queued behind a sleep on the card, so that
    the events time the card's work and not the host's launch rate: calls
    of tens of µs are launch-bound in ``time_ms``. The sleep
    (``sleep_cycles`` a call: ~0.4 ms of host time per call at the H100's
    1.98 GHz by default) ends before the start event, so it is not timed;
    a call that holds the host longer needs more."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles * iters)
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


def kernel_device_ms(fn, symbol, reps: int = 20):
    """``(device ms per call, launches seen, {symbol: device ms per
    launch})`` of the kernels whose names hold ``symbol`` (or, for an op of
    several launches, one of a tuple of symbols, each launched once a
    call) over ``reps`` calls of ``fn``, from the profiler: each symbol's
    time is divided by the launches the profiler reports of it, not by
    ``reps``, so launches it drops do not count as time, and the call's
    time is the sum over its symbols ((None, 0, {}) when it sees none).
    Late in a long process the profiler at times reports no device
    activity for a whole run; such a run is profiled again, up to three
    runs in all."""
    symbols = (symbol,) if isinstance(symbol, str) else symbol
    for _ in range(3):
        _, acts = device_profile(fn, reps)
        split, seen = {}, 0
        for sym in symbols:
            hits = [(t, c) for k, (t, c) in acts.items() if sym in k]
            n = sum(c for _, c in hits)
            seen += n
            if n:
                split[sym] = sum(t for t, _ in hits) / n
        if seen:
            break
    return (sum(split.values()) if split else None), seen, split


def library_device_ms(fn, reps: int = 20):
    """``(device ms per call, launches seen)`` of a library call ``fn``
    (every kernel it launches) over ``reps`` calls, from the profiler. The
    call launches the same kernels each time, so a run in which the
    profiler dropped none reports each kernel a multiple of ``reps`` times;
    a run that does not (launches dropped, or none seen) is profiled again,
    up to three runs in all, and the time is None when no run was whole,
    never a sum divided by calls that were not all seen."""
    for _ in range(3):
        _, acts = device_profile(fn, reps)
        seen = sum(c for _, c in acts.values())
        if acts and all(c % reps == 0 for _, c in acts.values()):
            return sum(t for t, _ in acts.values()) / reps, seen
    return None, seen


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def achieved_tflops(flops: float, ms: float) -> float:
    """TFLOP/s of ``flops`` operations done in ``ms``."""
    return flops / ms / 1e9


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


def same_bits(name: str, first, second) -> None:
    """AssertionError unless two calls' outputs (None where absent) are
    the same bits: the kernels sum in orders fixed by the shape."""
    import torch

    for a, b in zip(first, second):
        if (a is None) != (b is None) or (
                a is not None and not torch.equal(a, b)):
            raise AssertionError(f"{name}: a second call gives other bits")


def bits_digest(*tensors) -> str:
    """A digest of the tensors' bits (sha-256 over each one's int32 words
    summed on the card, then its first and last 4096 words), for
    comparing two trees' outputs on the same inputs."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        w = t.contiguous().view(-1).view(torch.int32)
        h.update(str(w.long().sum().item()).encode())
        h.update(w[:4096].cpu().numpy().tobytes())
        h.update(w[-4096:].cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
    and the gathered MLM head's norm (bf16, 640 rows); last a ragged width
    (1000 columns: 125 bf16 slots over a warp's 32 lanes, some lanes 3 and
    some 4) and GPT-2's prefill rows as a view one element into its buffer
    (no 16-byte aligned row: read and written element by element)."""
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
    odd = [(1024, cols, dtype, 1e-5, dict(use=use))
           for cols, use in ((1000, "ragged width"), (768, "unaligned view"))
           for dtype in (torch.float32, torch.bfloat16)]
    return gpt + bert + odd


#: uses of ``layer_norm_cases``' last rows, which draw their data from a
#: generator of their own (the later checks' draws stay as they were) and
#: have no backward row
ODD_NORM_ROWS = ("ragged width", "unaligned view")


def norm_fwd_bits(name: str, fwd, x, *args) -> None:
    """AssertionError unless the norm forward ``fwd(x, *args)`` gives the
    same bits in a second call and row 0 alone the bits of row 0 in the
    batch: the tile plan depends on the width alone."""
    first = fwd(x, *args)
    same_bits(name, first, fwd(x, *args))
    same_bits(f"{name} row 0 alone", [t[:1] for t in first],
              fwd(x[:1], *args))


def unaligned(x):
    """``x`` as a view one element into a buffer of its dtype: the same
    values, no row on a 16-byte boundary."""
    flat = x.new_empty(x.numel() + 1)
    flat[1:] = x.flatten()
    return flat[1:].view(x.shape)


def norm_fwd_timings(x, fwd, plain, library, *args, copy=None) -> dict:
    """``ms``, ``plain_ms`` and ``library_ms`` of a norm forward row by
    ``queued_ms``, each over copies of ``x`` (made by ``copy``, default
    ``clone``) whose reads and written outputs together exceed the L2
    cache, outputs kept until their copy comes round again: x is read and
    y written through device memory, as ``bound_ms``'s rate assumes (over
    one x, rows up to 50 MB stay in L2 and beat that rate). ``library``
    takes x alone. Rows too small to fill L2 in 256 copies stay in it; a
    launch's latency, far above their bound, is their time. Returns the
    row's fields and the rotating kernel call, for the profiles."""
    nbytes = 2 * x.numel() * x.element_size()
    copy = copy or (lambda t: t.clone())
    xs = [copy(x) for _ in range(copies_for(nbytes))]
    kernel = rotating(fwd, [(xc, *args) for xc in xs])
    return dict(ms=queued_ms(kernel),
                plain_ms=queued_ms(rotating(plain,
                                            [(xc, *args) for xc in xs])),
                library_ms=None if library is None else queued_ms(
                    rotating(library, [(xc,) for xc in xs])),
                x_copies=len(xs)), kernel


def check_layer_norm(gen, dev):
    """The LayerNorm forward against its twin at ``layer_norm_cases``,
    each row also as ``norm_fwd_bits``; kernel, twin and ``F.layer_norm``
    (the library) timed by ``norm_fwd_timings``."""
    import torch
    import torch.nn.functional as F

    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

    out = []
    odd_gen = torch.Generator().manual_seed(SEED)
    for rows, cols, dtype, eps, extra in layer_norm_cases():
        g = odd_gen if extra.get("use") in ODD_NORM_ROWS else gen
        x = (torch.randn(rows, cols, generator=g) * 2 + 0.5).to(dev, dtype)
        if extra.get("use") == "unaligned view":
            x = unaligned(x)
        w = (torch.rand(cols, generator=g) + 0.5).to(dev)
        b = torch.randn(cols, generator=g).to(dev)
        y, mean, rstd = ln.layer_norm_fwd(x, w, b, eps)
        torch.cuda.synchronize()
        ry, rmean, rstd_ref = ln.layer_norm_fwd_reference(x, w, b, eps)
        dn = str(dtype).split(".")[1]
        err = compare("layer_norm_fwd", y, ry, dn)
        compare("layer_norm_fwd mean", mean, rmean, "float32")
        compare("layer_norm_fwd rstd", rstd, rstd_ref, "float32")
        norm_fwd_bits("layer_norm_fwd", ln.layer_norm_fwd, x, w, b, eps)
        elt = x.element_size()
        nbytes = 2 * rows * cols * elt + 2 * cols * 4 + 2 * rows * 4
        bms, by = bound_ms(nbytes, 8 * rows * cols, dn)
        lw, lb = w.to(dtype), b.to(dtype)
        times, kernel = norm_fwd_timings(
            x, ln.layer_norm_fwd, ln.layer_norm_fwd_reference,
            lambda xc: F.layer_norm(xc, (cols,), lw, lb, eps), w, b, eps,
            copy=unaligned if extra.get("use") == "unaligned view" else None)
        out.append((dict(
            name="layer_norm_fwd", dtype=dn, shape=[rows, cols], eps=eps,
            **extra, max_abs_err=err, **times, bound_ms=bms, bound_by=by),
            kernel))
    return out


def check_flash(gen, dev):
    """The causal forward at GPT-2-small's width (12 heads, d 64): a
    prefill of 16, 128 and 1024 tokens and the training batch, fp32 and
    bf16. Timed by ``queued_ms``: the short rows take microseconds on the
    card, less than a launch takes on the host."""
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
            ms = queued_ms(kernel)
            out.append((dict(
                name="flash_fwd", dtype=dn, shape=[b, h, s, d],
                max_abs_err=err, ms=ms,
                tflops=achieved_tflops(4 * pairs * d, ms),
                plain_ms=queued_ms(partial(fa.flash_attention_reference,
                                           q, k, v, scale=scale)),
                library_ms=queued_ms(partial(
                    F.scaled_dot_product_attention, q, k, v,
                    is_causal=True)),
                bound_ms=bms, bound_by=by), kernel))
    return out


def paged_times(name: str, kernel, plain, first, nbytes: float) -> dict:
    """A paged row's times by ``queued_ms`` (the kernel is ~0.01 ms: by
    ``time_ms`` it would read the host's launch rate): the kernel's, its
    twin's, and its achieved TB/s, the bound's bytes over its time; the
    kernel's output ``first`` must come back bit for bit in a second
    call."""
    same_bits(name, (first,), (kernel(),))
    ms = queued_ms(kernel)
    return dict(ms=ms, plain_ms=queued_ms(plain), tb_s=nbytes / ms / 1e9)


def check_paged(gen, dev):
    """GPT-2-small's paged decode step: 8 slots, 12 heads, d = 64, page 16,
    lengths 0..1024, fp32 and bf16, by ``queued_ms``; a zero-length slot
    outputs exactly 0. Then each slot alone (batch 1, its own table row)
    and the batch at a table twice as wide must give the batch's bits: a
    slot's splits depend on its own length alone. The rows ``use`` "alone"
    time the longest slot alone."""
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
    pools = []
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
            max_abs_err=err, **paged_times(
                "paged_attention", kernel, partial(
                    pa.paged_attention_reference, q, kp, vp, bt, ln), o,
                nbytes),
            library_ms=None, bound_ms=bms, bound_by=by), kernel))
        pools.append((dtype, q, kp, vp, o))
    wide = torch.cat([bt, torch.zeros_like(bt)], 1)
    for dtype, q, kp, vp, o in pools:
        same_bits("paged_attention at a wider table", (o,),
                  (pa.paged_attention(q, kp, vp, wide, ln),))
        for i in range(slots):
            alone = pa.paged_attention(q[i:i + 1], kp, vp, bt[i:i + 1],
                                       ln[i:i + 1])
            if not torch.equal(alone[0], o[i]):
                raise AssertionError(f"paged_attention: slot {i} alone gives "
                                     f"other bits than in the batch")
        i = slots - 1
        args = (q[i:i + 1], kp, vp, bt[i:i + 1], ln[i:i + 1])
        dn = str(dtype).split(".")[1]
        n, elt = int(lengths[i]), q.element_size()
        nbytes = 2 * n * h * d * elt + 2 * h * d * elt + maxp * 4 + 4
        bms, by = bound_ms(nbytes, 4 * n * h * d, dn)
        kernel = partial(pa.paged_attention, *args)
        out.append((dict(
            name="paged_attention", use="alone", dtype=dn,
            shape=[1, h, ps, d, maxp], lengths=[n],
            max_abs_err=compare("paged_attention alone", o[i:i + 1],
                                pa.paged_attention_reference(*args), dn),
            **paged_times("paged_attention alone", kernel, partial(
                pa.paged_attention_reference, *args), o[i:i + 1], nbytes),
            library_ms=None, bound_ms=bms, bound_by=by), kernel))
    return out


def check_layer_norm_bwd(gen, dev):
    """The LayerNorm backward (saved x, affine) against its twin at GPT-2's
    training rows and BERT-Large's, then at ``NORM_BWD_WIDE``, a row the
    kernel walks in passes (fp32 and bf16, eps 1e-5, its data from a
    generator of its own, so the later checks' draws stay as they were).
    Kernel, twin and library (the backward of ``F.layer_norm``) timed by
    ``queued_ms``; each row's TB/s is its bound's bytes over its time."""
    import torch
    import torch.nn.functional as F

    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

    out = []
    # GPT-2's training rows, then BERT-Large's (the rows of the forward's
    # cases but its prefill and decode rows, which take no backward)
    cases = [c + (gen,) for c in layer_norm_cases()
             if c[4].get("use") not in ODD_NORM_ROWS
             and (c[0] == TRAIN_BATCH * TRAIN_SEQ or c[4])]
    wide_gen = torch.Generator().manual_seed(SEED)
    cases += [(*NORM_BWD_WIDE, dtype, 1e-5, dict(use="wide row"), wide_gen)
              for dtype in (torch.float32, torch.bfloat16)]
    for rows, cols, dtype, eps, extra, g in cases:
        x = (torch.randn(rows, cols, generator=g) * 2 + 0.5).to(dev, dtype)
        dy = torch.randn(rows, cols, generator=g).to(dev, dtype)
        w = (torch.rand(cols, generator=g) + 0.5).to(dev)
        b = torch.randn(cols, generator=g).to(dev)
        _, mean, rstd = ln.layer_norm_fwd_reference(x, w, b, eps)
        dx, dw, db = ln.layer_norm_bwd(dy, x, mean, rstd, w)
        torch.cuda.synchronize()
        rdx, rdw, rdb = ln.layer_norm_bwd_reference(dy, x, mean, rstd, w)
        dn = str(dtype).split(".")[1]
        err = max(compare("layer_norm_bwd dx", dx, rdx, dn),
                  compare("layer_norm_bwd dgamma", dw, rdw, dn, SUM_TOL),
                  compare("layer_norm_bwd dbeta", db, rdb, dn, SUM_TOL))
        same_bits("layer_norm_bwd", (dw, db),
                  ln.layer_norm_bwd(dy, x, mean, rstd, w)[1:])
        elt = x.element_size()
        # read dy, x, mean, rstd, w; write dx, dgamma, dbeta
        nbytes = 3 * rows * cols * elt + 2 * rows * 4 + 3 * cols * 4
        bms, by = bound_ms(nbytes, 13 * rows * cols, dn)
        kernel = partial(ln.layer_norm_bwd, dy, x, mean, rstd, w)
        xl = x.detach().requires_grad_()
        wl, bl = (t.to(dtype).requires_grad_() for t in (w, b))
        y = F.layer_norm(xl, (cols,), wl, bl, eps)
        ms = queued_ms(kernel)
        out.append((dict(
            name="layer_norm_bwd", dtype=dn, shape=[rows, cols], eps=eps,
            **extra, max_abs_err=err, ms=ms, tb_s=nbytes / ms / 1e9,
            plain_ms=queued_ms(partial(ln.layer_norm_bwd_reference, dy, x,
                                       mean, rstd, w)),
            library_ms=queued_ms(partial(torch.autograd.grad, y,
                                         (xl, wl, bl), dy,
                                         retain_graph=True)),
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
        library_ms = queued_ms(partial(torch.autograd.grad, ol, (ql, kl, vl),
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
            ms = queued_ms(kernel)
            out.append((dict(
                name=name, dtype=dn, shape=[b, h, s, d], max_abs_err=err,
                out_absmax=absmax[name], ms=ms,
                tflops=achieved_tflops(flops, ms),
                plain_ms=queued_ms(partial(plain, *args, scale=scale)),
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
            ms = time_ms(kernel)
            out.append((dict(
                name=name, **common, max_abs_err=err, ms=ms,
                tflops=achieved_tflops(flops, ms),
                plain_ms=time_ms(partial(plain, *call, **kw)),
                library_ms=lib, library=lib_name, bound_ms=bms,
                bound_by=by), kernel))
    return out


def check_xentropy(gen, dev):
    """Forward and backward at the gathered MLM head (640 x 30528; fp32 on
    the path, where the logits are cast before the loss) and the NSP head
    (8 x 2, padding_idx -1), smoothing 0 and 0.1, every seventh MLM row
    padded; and at the NMT step's logits (``nmt_bf16``: 32 x 128 targets x
    37000, fp32, smoothing 0.1, no padded row). Kernel, twin and library
    call are timed by ``queued_ms`` over copies of the logits that
    together exceed the L2 cache (``copies_for``; BERT's bf16 logits, 39
    MB, fit in it), outputs held until their copy comes round again
    (``rotating``)."""
    import torch
    import torch.nn.functional as F

    xe = importlib.import_module("apex_tpu_torch.ops.xentropy")

    out = []
    mlm_rows, vocab = BERT_BATCH * BERT_MLM_K, 30528
    cases = [(dtype, rows, width, smoothing, pad, "bert")
             for dtype in (torch.float32, torch.bfloat16)
             for rows, width, smoothing, pad in (
                 (mlm_rows, vocab, 0.0, 0), (mlm_rows, vocab, 0.1, 0),
                 (BERT_BATCH, 2, 0.0, -1))]
    cases.append((torch.float32, NMT_BATCH * NMT_SEQ, NMT_BIG["vocab_size"],
                  NMT_LS, 0, "nmt"))
    for dtype, rows, width, smoothing, pad, path in cases:
        x = (torch.randn(rows, width, generator=gen) * 3).to(dev, dtype)
        low = 2 if path == "nmt" else 0      # the copy task draws no 0
        labels = torch.randint(low, width, (rows,), generator=gen,
                               dtype=torch.int32)
        if pad == 0 and path == "bert":
            labels[::7] = 0
        labels = labels.to(dev)
        dy = torch.randn(rows, generator=gen).to(dev)
        loss, lse = xe.xentropy_fwd(x, labels, smoothing, pad)
        dx = xe.xentropy_bwd(x, labels, lse, dy, smoothing, pad)
        torch.cuda.synchronize()
        rloss, rlse = xe.xentropy_fwd_reference(x, labels, smoothing, pad)
        rdx = xe.xentropy_bwd_reference(x, labels, rlse, dy, smoothing, pad)
        dn = str(dtype).split(".")[1]
        err_fwd = max(compare("xentropy_fwd loss", loss, rloss, "float32"),
                      compare("xentropy_fwd lse", lse, rlse, "float32"))
        err_bwd = compare("xentropy_bwd dx", dx, rdx, dn, XENT_DX_TOL[dn])
        if pad == 0 and path == "bert" and ((loss[::7] != 0).any()
                                            or (dx[::7] != 0).any()):
            raise AssertionError("xentropy: a padded row must give loss "
                                 "0 and dx 0")
        del loss, dx, rloss, rlse, rdx
        n, elt = rows * width, x.element_size()
        lib_kw = dict(reduction="none", ignore_index=pad,
                      label_smoothing=smoothing)
        xs = [x] + [x.clone() for _ in range(copies_for(2 * n * elt) - 1)]
        graphs = []
        for xc in xs:
            xl = xc.detach().requires_grad_()
            graphs.append((F.cross_entropy(xl, labels.long(), **lib_kw),
                           xl))
        common = dict(dtype=dn, shape=[rows, width], smoothing=smoothing,
                      padding_idx=pad, path=path, x_copies=len(xs))
        for name, err, fn, plain, args, nbytes, lib, lib_args, lib_name in (
                ("xentropy_fwd", err_fwd, xe.xentropy_fwd,
                 xe.xentropy_fwd_reference,
                 [(xc, labels, smoothing, pad) for xc in xs],
                 n * elt + 3 * rows * 4,
                 lambda xc: F.cross_entropy(xc, labels.long(), **lib_kw),
                 [(xc,) for xc in xs],
                 "F.cross_entropy(reduction='none', ignore_index, "
                 "label_smoothing)"),
                ("xentropy_bwd", err_bwd, xe.xentropy_bwd,
                 xe.xentropy_bwd_reference,
                 [(xc, labels, lse, dy, smoothing, pad) for xc in xs],
                 2 * n * elt + 3 * rows * 4,
                 lambda ll, xl: torch.autograd.grad(ll, xl, dy,
                                                    retain_graph=True),
                 graphs, "backward of the same F.cross_entropy")):
            bms, by = bound_ms(nbytes, 4 * n, "float32")
            kernel = rotating(fn, args)
            ms = queued_ms(kernel)
            out.append((dict(
                name=name, **common, max_abs_err=err, ms=ms,
                plain_ms=queued_ms(rotating(plain, args)),
                library_ms=queued_ms(rotating(lib, lib_args)),
                library=lib_name, bound_ms=bms, bound_by=by,
                bound_share=bms / ms),
                None if path == "nmt" else kernel))
        del graphs
    return out


def bert_no_decay(name: str) -> bool:
    """bench.py's exclusion: biases and norms take no weight decay."""
    return "bias" in name or "norm" in name.lower()


def segment_stats_row(g, spec, seg, path: str):
    """The stats kernel over the flat gradient buffer ``g`` of ``spec``
    against its twin, with an inf and two NaNs injected: the non-finite
    counts exact, the sums within ``SEGMENT_SUM_TOL``, the same bits in a
    second call. Kernel, twin and ``torch._foreach_norm`` over the
    per-parameter views (the library) timed by ``queued_ms``."""
    import torch

    from apex_tpu_torch.ops import flat_buffer

    oa = importlib.import_module("apex_tpu_torch.ops.optim_kernels")
    rows, segs, lane = spec.total_rows, spec.num_tensors, flat_buffer.LANE
    n = rows * lane
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
    same_bits("segment_stats", [torch.nan_to_num(stats)],
              [torch.nan_to_num(oa.segment_stats(g, seg, segs))])
    views = list(flat_buffer.unflatten(g, spec).values())
    bms, by = bound_ms(n * 4 + rows * 4 + 3 * segs * 4, 3 * n, "float32")
    kernel = partial(oa.segment_stats, g, seg, segs)
    # the library's views hold the host longer than queued_ms's default
    # sleep covers (behind it BERT's 302 read 0.52-0.95 ms a call, the
    # profiler ~0.5), so its calls queue behind ~2 ms each; the profiles
    # (kernel_device_ms, kernel_ab.py --device-ms) time its device work too
    kernel.library = partial(torch._foreach_norm, views)
    return (dict(
        name="segment_stats", dtype="float32", shape=[rows, lane],
        segments=segs, params=sum(spec.sizes), path=path,
        nonfinite_injected=3, max_abs_err=err, sums_max_rel_err=rel,
        sums_tolerance=SEGMENT_SUM_TOL, ms=queued_ms(kernel),
        plain_ms=queued_ms(partial(oa.segment_stats_reference, g, seg,
                                   segs)),
        library_ms=queued_ms(kernel.library, sleep_cycles=4_000_000),
        library="torch._foreach_norm over the per-parameter views",
        bound_ms=bms, bound_by=by), kernel)


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

    out = [segment_stats_row(randn(), spec, seg, "bert")]

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
             dict(norms_max_rel_err=rel1, norms_tolerance=SEGMENT_SUM_TOL,
                  bits=bits_digest(st, u)),
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


def rotating(fn, arg_sets):
    """``cycling`` that also holds each call's output until its argument
    set comes round again: the outputs, too, rotate over as many buffers,
    so that a call's writes do not land on lines the previous call left
    in the L2 cache."""
    turn = itertools.cycle(range(len(arg_sets)))
    held = [None] * len(arg_sets)

    def call():
        i = next(turn)
        held[i] = None                # its buffer is this call's to reuse
        held[i] = fn(*arg_sets[i])
        return held[i]
    return call


def copies_for(nbytes: int) -> int:
    """Copies of a tensor that together exceed the L2 cache by half, so that
    a timed loop over them reads each from device memory."""
    return max(1, min(256, math.ceil(1.5 * L2_BYTES / nbytes)))


def check_dequant(gen, dev):
    """The dequant-matmul kernels at GPT-2-small's block-linear shapes:
    int8 and fp8 per channel (``dequant_matmul``), int4 at group 128
    (``dequant_matmul_w4``), at a decode step's 8 rows and a 128-token
    prefill, x in fp32 and bf16 (``check_dequant_c2``: the same at ROADMAP
    C2's shapes). Kernel, twin and library are
    each timed by ``queued_ms`` over copies of their weight that exceed
    the L2 cache; the library is ``F.linear`` on the dequantized weight in
    x's dtype (cuBLAS on the full-width weight). Each row carries the
    kernel's achieved TFLOP/s and TB/s (the bytes of ``bound_ms`` over its
    time)."""
    out = []
    for kind in ("int8", "fp8", "int4"):
        for n_in, n_out in QUANT_SHAPES:
            out += dequant_rows(gen, dev, kind,
                                QUANT_GS if kind == "int4" else 0, n_in,
                                n_out, False)
    return out


def check_dequant_c2(gen, dev):
    """``check_dequant``'s rows at ROADMAP C2's shapes (``QUANT_C2``), rows
    marked ``c2``: shapes a tree from before C2's repair refuses, so that
    an A/B against such a tree leaves this check out."""
    out = []
    for kind, gs, n_in, n_out in QUANT_C2:
        out += dequant_rows(gen, dev, kind, gs, n_in, n_out, True)
    return out


def dequant_rows(gen, dev, kind, gs, n_in, n_out, c2):
    """``check_dequant``'s rows of one weight: fp32 and bf16 x at each of
    ``QUANT_ROWS``."""
    import torch
    import torch.nn.functional as F

    quant = importlib.import_module("apex_tpu_torch.ops.quant")

    quantize = {"int8": quant.quantize_weight,
                "fp8": quant.quantize_weight_fp8,
                "int4": partial(quant.quantize_weight_int4,
                                group_size=gs)}[kind]
    name = DEQUANT_KERNEL[kind]
    w = torch.randn(n_out, n_in, generator=gen) * n_in ** -0.5
    qw, sc = (t.to(dev) for t in quantize(w))
    wbytes = qw.numel() * qw.element_size() + sc.numel() * 4
    qsets = [(qw.clone(), sc.clone()) for _ in range(copies_for(wbytes))]
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        full = quant.dequantize_weight(qw, sc).to(dtype)
        fsets = [(full.clone(),) for _ in range(
            copies_for(full.numel() * full.element_size()))]
        dn = str(dtype).split(".")[1]
        elt = full.element_size()
        for m in QUANT_ROWS:
            x = torch.randn(m, n_in, generator=gen).to(dev, dtype)
            fields = dict(name=name, kind=kind, dtype=dn,
                          shape=[m, n_in, n_out],
                          **({"group_size": gs} if kind == "int4" else {}),
                          **({"c2": True} if c2 else {}),
                          path="quant_serving")
            y = quant.fused_dequant_matmul(x, qw, sc)
            torch.cuda.synchronize()
            err = compare(name, y, quant.fused_dequant_matmul_reference(
                x, qw, sc), dn)
            # the kernel's rows do not depend on the batch (the twin's CPU
            # matmul makes no such promise)
            if x.is_cuda and not torch.equal(
                    quant.fused_dequant_matmul(x[3:4], qw, sc), y[3:4]):
                raise AssertionError(f"{name}: a row alone differs from "
                                     f"the same row in a batch")
            nbytes = m * n_in * elt + wbytes + m * n_out * elt
            flops = 2 * m * n_in * n_out
            bms, by = bound_ms(nbytes, flops, dn)
            kernel = cycling(partial(quant.fused_dequant_matmul, x), qsets)
            ms = queued_ms(kernel)
            out.append((dict(
                fields, max_abs_err=err, ms=ms,
                tflops=achieved_tflops(flops, ms), tb_s=nbytes / ms / 1e9,
                plain_ms=queued_ms(cycling(partial(
                    quant.fused_dequant_matmul_reference, x), qsets)),
                library_ms=queued_ms(cycling(partial(F.linear, x), fsets)),
                library="F.linear on the dequantized weight in x's dtype "
                        "(cuBLAS)",
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
                path="quant_serving", max_abs_err=err, **paged_times(
                    "paged_attention_quant", kernel, partial(
                        pa.paged_attention_reference, q, kp, vp, bt, ln,
                        **kw), o, nbytes),
                unquantized_ms=queued_ms(partial(pa.paged_attention, q, kpf,
                                               vpf, bt, ln)),
                library_ms=None, bound_ms=bms, bound_by=by), kernel))
    return out


def check_rms_norm(gen, dev):
    """The RMS branch of the LayerNorm forward kernel at Mistral-7B's width,
    eps 1e-5: a decode step's rows, a long prefill's and a training step's
    (``path`` "mistral_train"); then at t5-small's width 512, eps 1e-6: a
    decode step's ``T5_BATCH`` rows and a training batch's encoder rows
    (``path`` "t5", from a generator of their own, so the later checks'
    draws stay as they were). Each row also as ``norm_fwd_bits``. Kernel,
    twin and ``F.rms_norm`` (the library) are timed by
    ``norm_fwd_timings``: ``queued_ms`` over copies past the L2 cache."""
    import torch
    import torch.nn.functional as F

    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

    out = []
    mistral = [(rows, MISTRAL_HIDDEN, 1e-5, "mistral" if rows in RMS_ROWS
                else "mistral_train")
               for rows in (*RMS_ROWS, MISTRAL_TRAIN_SEQ)]
    t5 = [(rows, T5_HEADS * T5_HEAD_DIM, 1e-6, "t5")
          for rows in (T5_BATCH, T5_TRAIN_BATCH * T5_TRAIN_ENC)]
    t5_gen = torch.Generator().manual_seed(SEED)
    cases = [(dtype, *case, g) for cases, g in ((mistral, gen), (t5, t5_gen))
             for dtype in (torch.float32, torch.bfloat16) for case in cases]
    for dtype, rows, cols, eps, path, g in cases:
        x = (torch.randn(rows, cols, generator=g) * 2 + 0.5).to(dev, dtype)
        w = (torch.rand(cols, generator=g) + 0.5).to(dev)
        y, mean, rstd = ln.rms_norm_fwd(x, w, eps)
        torch.cuda.synchronize()
        ry, _, rstd_ref = ln.rms_norm_fwd_reference(x, w, eps)
        dn = str(dtype).split(".")[1]
        err = compare("rms_norm_fwd", y, ry, dn, rms_atol=True)
        compare("rms_norm_fwd rstd", rstd, rstd_ref, "float32")
        if (mean != 0).any():
            raise AssertionError("rms_norm_fwd: mean must be exactly 0")
        norm_fwd_bits("rms_norm_fwd", ln.rms_norm_fwd, x, w, eps)
        nbytes = 2 * rows * cols * x.element_size() + cols * 4 \
            + 2 * rows * 4
        bms, by = bound_ms(nbytes, 4 * rows * cols, dn)
        lib, lw = getattr(F, "rms_norm", None), w.to(dtype)
        times, kernel = norm_fwd_timings(
            x, ln.rms_norm_fwd, ln.rms_norm_fwd_reference,
            None if lib is None else (
                lambda xc: lib(xc, (cols,), lw, eps)), w, eps)
        out.append((dict(
            name="rms_norm_fwd", dtype=dn, shape=[rows, cols], eps=eps,
            path=path, max_abs_err=err, out_rms=rms_of(ry), **times,
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
            flops = 4 * h * band_pairs(s, w) * d
            bms, by = bound_ms(nbytes, flops, dn)
            kernel = partial(fa.flash_attention_with_lse, q, k, v,
                             causal=True, window=w)
            ms = queued_ms(kernel, BIG_ITERS)
            pos = torch.arange(s, device=dev)
            band = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - w)
            ke, ve = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
            out.append((dict(
                name="flash_fwd_window", dtype=dn, shape=[1, h, s, d],
                kv_heads=hkv, window=w,
                path="mistral" if s in FLASH_WINDOW_SEQS else "mistral_train",
                max_abs_err=err, out_rms=o_rms, ms=ms,
                tflops=achieved_tflops(flops, ms),
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
            **paged_times(name, kernel, partial(
                pa.paged_attention_reference, q, kp, vp, bt, ln, **kw), o,
                nbytes),
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


def check_paged_block(gen, dev):
    """The s > 1 query blocks of the paged kernel against the twin, all by
    ``queued_ms``: GPT-2-small's decode pool (8 slots, 12 heads, d = 64,
    page 16, lengths up to 1024) at s = 4 (a ``draft_len = 3`` verify) and
    s = 16 (a chunk), fp32 and bf16, over the fp pool and over int8 and fp8
    pools; the windowed branch at Mistral-7B's shapes (32 heads over 8 kv
    heads, d = 128, window 4096, lengths up to 6100, the entries below each
    slot's earliest query's band nulled) at s = 16: 64 rows per kv head,
    four row groups. Every row's atol is cut to ``RMS_ATOL`` of the twin's
    RMS, so a missed page shows in bf16 too. A slot shorter than s must
    output exactly 0 on its leading rows. Bound: the bytes of the positions
    the blocks read, q, out, the tables (and a quantized pool's scales);
    FLOPs 4 h d over every (query, visible position) pair."""
    import torch

    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    quant = importlib.import_module("apex_tpu_torch.ops.quant")

    out = []
    slots, ps = NUM_SLOTS, PAGE_SIZE

    def row(name, q, kp, vp, bt, lengths, page_elt, window=None,
            scales=None, **extra):
        b, h, s, d = q.shape
        kv, maxp = kp.shape[1], bt.shape[1]
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = {} if window is None else dict(window=window)
        if scales is not None:
            kw.update(k_scales=scales[0], v_scales=scales[1])
        o = pa.paged_attention(q, kp, vp, bt, ln, **kw)
        torch.cuda.synchronize()
        dn = str(q.dtype).split(".")[1]
        want = pa.paged_attention_reference(q, kp, vp, bt, ln, **kw)
        err = compare(name, o, want, dn, rms_atol=True)
        for i, n in enumerate(lengths):
            if n < s and (o[i, :, :s - n] != 0).any():
                raise AssertionError(f"{name}: the rows before slot {i}'s "
                                     f"start must output exactly 0")
        w = window or 1 << 40
        pairs = sum(max(0, min(n - s + i + 1, w)) for n in lengths
                    for i in range(s))
        floors = [max(n - s - w + 1, 0) for n in lengths]
        read = sum(n - f for n, f in zip(lengths, floors))
        pages = sum(-(-n // ps) - f // ps for n, f in zip(lengths, floors))
        nbytes = (2 * read * kv * d * page_elt + 2 * q.numel()
                  * q.element_size() + bt.numel() * 4 + b * 4)
        if scales is not None:
            nbytes += 2 * pages * kv * 4
        bms, by = bound_ms(nbytes, 4 * h * d * pairs, dn)
        kernel = partial(pa.paged_attention, q, kp, vp, bt, ln, **kw)
        return (dict(
            name=name, dtype=dn, shape=[b, h, s, ps, d, maxp], s=s,
            kv_heads=kv, window=window, lengths=list(lengths),
            path="spec_chunked", max_abs_err=err, out_rms=rms_of(want),
            **paged_times(name, kernel, partial(
                pa.paged_attention_reference, q, kp, vp, bt, ln, **kw), o,
                nbytes),
            library_ms=None, library="none: no single PyTorch call",
            bound_ms=bms, bound_by=by, **extra), kernel)

    # GPT-2-small's decode pool
    h, d, maxp = 12, 64, 64
    lengths = [0, 1, 16, 17, 100, 255, 1000, maxp * ps]
    num_pages = 1 + slots * maxp
    perm = torch.randperm(num_pages - 1, generator=gen) + 1
    bt = torch.zeros(slots, maxp, dtype=torch.int32)
    for i, n in enumerate(lengths):
        bt[i, :-(-n // ps)] = perm[i * maxp:i * maxp - (-n // ps)]
    bt = bt.to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        kp, vp = (torch.randn(num_pages, h, ps, d, generator=gen)
                  .to(dev, dtype) for _ in range(2))
        for s in BLOCK_S:
            q = torch.randn(slots, h, s, d, generator=gen).to(dev, dtype)
            out.append(row("paged_attention_block", q, kp, vp, bt, lengths,
                           kp.element_size()))
    for kv_name in ("int8", "fp8"):
        qdt, qmax = quant.resolve_kv_dtype(kv_name)
        pools = [quant.kv_quantize(
            torch.randn(num_pages, h, ps, d, generator=gen).to(dev) * 2, qdt,
            qmax, axes=(2, 3)) for _ in range(2)]
        (kp, ks), (vp, vs) = ((p, sc[:, :, 0, 0].contiguous())
                              for p, sc in pools)
        for dtype in (torch.float32, torch.bfloat16):
            for s in BLOCK_S:
                q = torch.randn(slots, h, s, d, generator=gen).to(dev, dtype)
                out.append(row("paged_attention_quant_block", q, kp, vp, bt,
                               lengths, 1, scales=(ks, vs), kind=kv_name))
    # Mistral-7B's windowed pool: the entries below each slot's earliest
    # query's floor, lengths - s - window + 1, nulled
    s, w = BLOCK_S[1], MISTRAL_WINDOW
    lengths = list(PAGED_WINDOW_LENGTHS)
    bt, maxp, num_pages = windowed_tables(gen, dev, lengths, ps, w + s - 1)
    for dtype in (torch.float32, torch.bfloat16):
        kp, vp = (torch.randn(num_pages, MISTRAL_KV_HEADS, ps,
                              MISTRAL_HEAD_DIM, generator=gen).to(dev, dtype)
                  for _ in range(2))
        q = torch.randn(slots, MISTRAL_HEADS, s, MISTRAL_HEAD_DIM,
                        generator=gen).to(dev, dtype)
        out.append(row("paged_attention_window_block", q, kp, vp, bt,
                       lengths, kp.element_size(), window=w))
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
        same_bits(name, got[1:], kernel()[1:])
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
        ms = queued_ms(kernel)
        out.append((dict(
            name=name, dtype=dn, shape=[rows, cols], kind=kind, eps=eps,
            path="mistral_train", max_abs_err=err, out_rms=rms_of(want[0]),
            ms=ms, tb_s=nbytes / ms / 1e9,
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
                ms = queued_ms(kernel, BIG_ITERS)
                out.append((dict(
                    name=name, dtype=dn, shape=[1, h, s, d], kv_heads=hkv,
                    window=w, path="mistral_train", max_abs_err=err,
                    out_absmax=absmax[name], out_rms=out_rms[name],
                    visible_pairs=pairs, ms=ms,
                    tflops=achieved_tflops(flops, ms),
                    plain_ms=queued_ms(partial(plain, *args, **kw),
                                       BIG_ITERS),
                    library_ms=library_ms,
                    library="backward of scaled_dot_product_attention, "
                            "boolean band mask, K/V expanded to 32 heads: "
                            "dq, dk and dv together",
                    bound_ms=bms, bound_by=by), kernel))
    return out


def bias_rows_cases():
    """``(path, use, batch, Sq, Sk, causal, window, with bias)`` of the T5
    rows: the encoder's self-attention at serving's 8 x 512 and training's
    128 x 512, the decoder's at training's 128 x 114 (causal), the
    cross-attention (no bias) at decode's Sq = 1 and training's 114, both
    against Sk = 512, and the windowed branch (no T5 path runs it) at 1 x
    1024, window 256. Serving (``path`` "t5") runs the forward only; the
    other rows hold the backward kernels too."""
    b, bt, se, sd = T5_BATCH, T5_TRAIN_BATCH, T5_ENC_SEQ, T5_TRAIN_DEC
    return [("t5", "encoder self-attention", b, se, se, False, None, True),
            ("t5_train", "encoder self-attention", bt, se, se, False, None,
             True),
            ("t5_train", "decoder self-attention", bt, sd, sd, True, None,
             True),
            ("t5", "decode cross-attention", b, 1, se, False, None, False),
            ("t5_train", "cross-attention", bt, sd, se, False, None, False),
            ("window_bias", "windowed, no T5 path", 1, T5_WINDOW_CASE[0],
             T5_WINDOW_CASE[0], True, T5_WINDOW_CASE[1], True)]


def visible_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """Visible (query, key) pairs of one head at the default diagonal."""
    if window is not None:
        return band_pairs(sk, window) if sq == sk else sq * min(sk, window)
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(sk, r + off + 1) for r in range(sq))


def check_flash_bias(gen, dev):
    """The bias branch of the three flash kernels at T5's shapes
    (``bias_rows_cases``), fp32 and bf16, each held against its twin at
    ``RMS_ATOL`` of the twin's RMS: the bias a ``(1, 8, Sq, Sk)`` table
    serving the whole batch, in q's dtype, as T5 passes it; q drawn at std
    d^-0.5 and every call at ``scale=1.0`` (T5 folds 1/sqrt(d) into its
    init). The rows without a bias hold T5's cross-attention shapes, which
    no earlier row ran. Timed by ``queued_ms``; the bound counts the
    bias's own bytes once (the one table serves every batch entry; at
    4 MiB it stays in the L2 cache) and one add per visible pair; the
    library call is ``scaled_dot_product_attention`` with the bias as a
    float ``attn_mask`` (a causal -inf triangle, or the band, folded into
    it; no mask where there is neither bias nor hidden pair, so that the
    library may take its flash backend) and, for the backward rows, its
    backward (dq, dk and dv together)."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

    out = []
    h, d = T5_HEADS, T5_HEAD_DIM
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for path, use, b, sq, sk, causal, window, with_bias in \
                bias_rows_cases():
            masking = fa.Masking(causal=causal, window=window)
            q = (torch.randn(b, h, sq, d, generator=gen) * d ** -0.5).to(
                dev, dtype)
            k, v, do = (torch.randn(b, h, n, d, generator=gen).to(dev, dtype)
                        for n in (sk, sk, sq))
            bias = (torch.randn(1, h, sq, sk, generator=gen).to(dev, dtype)
                    if with_bias else None)
            kw = dict(scale=1.0, masking=masking, bias=bias)
            o, lse = fa.flash_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
            fwd_name, dq_name, dkdv_name = (
                fa.launch_name(n, masking, bias, sq, sk) for n in
                ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"))
            errs = {fwd_name: compare(fwd_name, o, ro, dn, rms_atol=True)}
            compare(f"{fwd_name} lse", lse, rlse, "float32")
            out_rms = {fwd_name: [rms_of(ro)]}
            delta = fa.flash_bwd_delta(ro, do)
            args = (q, k, v, do, rlse, delta)
            del ro, o, lse
            if path != "t5":
                dq = fa.flash_bwd_dq(*args, **kw)
                dk, dv = fa.flash_bwd_dkdv(*args, **kw)
                torch.cuda.synchronize()
                rdq = fa.flash_bwd_dq_reference(*args, **kw)
                rdk, rdv = fa.flash_bwd_dkdv_reference(*args, **kw)
                errs[dq_name] = compare(dq_name, dq, rdq, dn, rms_atol=True)
                errs[dkdv_name] = max(
                    compare(f"{dkdv_name} dk", dk, rdk, dn, rms_atol=True),
                    compare(f"{dkdv_name} dv", dv, rdv, dn, rms_atol=True))
                out_rms.update({dq_name: [rms_of(rdq)],
                                dkdv_name: [rms_of(rdk), rms_of(rdv)]})
                del dq, dk, dv, rdq, rdk, rdv
            # the library call: the bias as a float mask, the causal
            # triangle or the band folded in as -inf
            rows = torch.arange(sq, device=dev)[:, None] + (sk - sq)
            cols = torch.arange(sk, device=dev)[None, :]
            hidden = torch.zeros(sq, sk, dtype=torch.bool, device=dev)
            if causal:
                hidden = cols > rows
            if window is not None:
                hidden = hidden | (cols <= rows - window)
            lib_mask = bias
            if hidden.any():
                lib_mask = (torch.zeros(1, h, sq, sk, dtype=dtype,
                                        device=dev) if bias is None
                            else bias).masked_fill(hidden, float("-inf"))
            lib_fwd = partial(F.scaled_dot_product_attention, q, k, v,
                              attn_mask=lib_mask, scale=1.0)
            iters = BIG_ITERS if b * sq * sk > 2 ** 24 else 50
            library = {fwd_name: queued_ms(lib_fwd, iters)}
            if path != "t5":
                ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
                ol = F.scaled_dot_product_attention(ql, kl, vl,
                                                    attn_mask=lib_mask,
                                                    scale=1.0)
                library[dq_name] = library[dkdv_name] = queued_ms(partial(
                    torch.autograd.grad, ol, (ql, kl, vl), do,
                    retain_graph=True), iters)
                del ol, ql, kl, vl
            elt = q.element_size()
            pairs = b * h * visible_pairs(sq, sk, causal, window)
            bias_bytes = (0 if bias is None
                          else bias.numel() * bias.element_size())
            q_bytes, kv_bytes = b * h * sq * d * elt, b * h * sk * d * elt
            row_stats = b * h * sq * 4                 # lse or delta, fp32
            shape_fields = dict(shape=[b, h, sq, d], sk=sk, causal=causal,
                                window=window, path=path, use=use,
                                bias_shape=None if bias is None
                                else list(bias.shape),
                                visible_pairs=pairs)
            for name, fn, plain, nbytes, flops in (
                    (fwd_name, fa.flash_fwd, fa.flash_attention_reference,
                     2 * q_bytes + 2 * kv_bytes + row_stats + bias_bytes,
                     4 * pairs * d + pairs),
                    (dq_name, fa.flash_bwd_dq, fa.flash_bwd_dq_reference,
                     3 * q_bytes + 2 * kv_bytes + 2 * row_stats
                     + bias_bytes, 6 * pairs * d + pairs),
                    (dkdv_name, fa.flash_bwd_dkdv,
                     fa.flash_bwd_dkdv_reference,
                     2 * q_bytes + 4 * kv_bytes + 2 * row_stats
                     + bias_bytes, 8 * pairs * d + pairs)):
                if name not in errs:
                    continue
                call = (q, k, v) if name == fwd_name else args
                bms, by = bound_ms(nbytes, flops, dn)
                kernel = partial(fn, *call, **kw)
                ms = queued_ms(kernel, iters)
                out.append((dict(
                    name=name, dtype=dn, **shape_fields,
                    max_abs_err=errs[name], out_rms=out_rms[name], ms=ms,
                    tflops=achieved_tflops(flops, ms),
                    plain_ms=queued_ms(partial(plain, *call, **kw), iters),
                    library_ms=library[name],
                    library="scaled_dot_product_attention, "
                            + ("no attn_mask" if lib_mask is None else
                               "the bias as a float attn_mask with the "
                               "hidden pairs -inf")
                            + ("" if name == fwd_name else
                               "; its backward: dq, dk and dv together"),
                    bound_ms=bms, bound_by=by), kernel))
    return out


#: head dims above 128 (ROADMAP C3): the wide kernels at every branch of
#: the d <= 128 ones, small shapes (correctness, ``queued_ms`` over
#: ``HEAD_DIM_ITERS`` calls), then one timed row a kernel, d and dtype at a
#: d-256 model's attention (16 heads; causal prefill of
#: ``HEAD_DIM_SEQ``; decode over an 8-slot pool of 16 heads on 8 kv heads)
HEAD_DIMS = (160, 192, 256)
HEAD_DIM_SEQ = 2048
HEAD_DIM_ITERS = 10
#: (b, h, hkv, sq, sk, Masking keywords, bias kind, segments)
HEAD_DIM_FLASH = {
    "causal": (2, 4, 2, 77, 77, dict(causal=True), None, False),
    "noncausal": (2, 4, 4, 40, 97, dict(causal=False), None, False),
    "window": (1, 4, 2, 100, 100, dict(causal=True, window=20), None, False),
    "bias": (2, 4, 2, 77, 77, dict(causal=True), "table", False),
    "fp32_bias": (2, 4, 4, 64, 64, dict(causal=False, dropout_rate=0.1),
                  "padding", False),
    "segments_dropout": (2, 4, 2, 64, 64, dict(causal=False,
                                               dropout_rate=0.1), None,
                         True),
    "dropout": (2, 4, 2, 70, 70, dict(causal=True, dropout_rate=0.1), None,
                False),
    "ring": (1, 4, 2, 64, 64, dict(causal=True, causal_offset=40,
                                   dropout_rate=0.1, dropout_row0=64), None,
             False),
}
HEAD_DIM_PAGED = ("fp", "window", "int8", "fp8", "int8_window")


def head_dim_flash_rows(gen, dev, d, dtype, branch, shape=None):
    """Rows of the three flash kernels at head dim ``d`` on one branch
    (``HEAD_DIM_FLASH``; ``shape`` ``(b, h, sq)`` overrides the causal
    branch's for the timed row): each held against its twin, timed by
    ``queued_ms`` beside its twin, its bound and, for the timed causal
    forward, ``scaled_dot_product_attention``'s time (None on the small
    rows)."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    b, h, hkv, sq, sk, kw, bias_kind, segs = HEAD_DIM_FLASH[branch]
    if shape is not None:
        b, h, sq = shape
        hkv, sk = h, sq
    q, do = (torch.randn(b, h, sq, d, generator=gen).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, sk, d, generator=gen).to(dev, dtype)
            for _ in range(2))
    if segs:
        seg = (torch.arange(sq)[None, :]
               < torch.tensor([sq, sq - 9])[:, None]).int().to(dev)
        kw = dict(kw, segment_ids=seg, kv_segment_ids=seg)
    masking = fa.Masking(dropout_seed=7, **kw)
    bias = None
    if bias_kind == "table":
        bias = torch.randn(1, h, sq, sk, generator=gen).to(dev, dtype)
    elif bias_kind == "padding":
        keep = torch.arange(sk)[None, :] < torch.randint(
            sk // 2, sk + 1, (b,), generator=gen)[:, None]
        bias = torch.where(keep, 0.0, -1e9)[:, None, None, :].to(
            dev, torch.float32)
    kwargs = dict(scale=d ** -0.5, masking=masking, bias=bias)
    dn = str(dtype).split(".")[1]
    iters = 20 if shape is not None else HEAD_DIM_ITERS
    o, lse = fa.flash_fwd(q, k, v, **kwargs)
    ro, rlse = fa.flash_attention_reference(q, k, v, **kwargs)
    err = compare(f"flash_fwd d={d} {branch}", o, ro, dn)
    compare(f"flash_fwd lse d={d} {branch}", lse, rlse, "float32")
    delta = fa.flash_bwd_delta(ro, do)
    args = (q, k, v, do, rlse, delta)
    dq = fa.flash_bwd_dq(*args, **kwargs)
    dk, dv = fa.flash_bwd_dkdv(*args, **kwargs)
    err_dq = compare(f"flash_bwd_dq d={d} {branch}", dq,
                     fa.flash_bwd_dq_reference(*args, **kwargs), dn)
    rdk, rdv = fa.flash_bwd_dkdv_reference(*args, **kwargs)
    err_dkdv = max(compare(f"flash_bwd_dkdv dk d={d} {branch}", dk, rdk, dn),
                   compare(f"flash_bwd_dkdv dv d={d} {branch}", dv, rdv, dn))
    same_bits(f"flash_fwd d={d} {branch}", (o,),
              (fa.flash_fwd(q, k, v, **kwargs)[0],))
    pairs = int(masking.visible(sq, sk, dev).expand(b, 1, sq, sk).sum()) * h
    elt = q.element_size()
    q_tile, kv_tile = b * h * sq * d * elt, b * hkv * sk * d * elt
    bias_bytes = 0 if bias is None else bias.numel() * bias.element_size()
    library_ms = None
    if shape is not None:                 # the timed causal row, no GQA
        library_ms = queued_ms(partial(
            F.scaled_dot_product_attention, q, k, v, is_causal=True),
            iters=iters)
    rows = []
    for name, kernel_fn, plain_fn, e, n_bytes, flops in (
            ("flash_fwd", fa.flash_fwd, fa.flash_attention_reference, err,
             2 * q_tile + 2 * kv_tile + b * h * sq * 4, 4 * pairs * d),
            ("flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_reference,
             err_dq, 3 * q_tile + 2 * kv_tile + 2 * b * h * sq * 4,
             6 * pairs * d),
            ("flash_bwd_dkdv", fa.flash_bwd_dkdv,
             fa.flash_bwd_dkdv_reference, err_dkdv,
             2 * q_tile + 4 * kv_tile + 2 * b * h * sq * 4, 8 * pairs * d)):
        call = (q, k, v) if name == "flash_fwd" else args
        kernel = partial(kernel_fn, *call, **kwargs)
        bms, by = bound_ms(n_bytes + bias_bytes, flops, dn)
        ms = queued_ms(kernel, iters=iters)
        rows.append((dict(
            name=fa.launch_name(name, masking, bias, sq, sk), dtype=dn,
            path="head_dim", kind="head_dim", branch=branch, d=d,
            shape=[b, h, sq, d], sk=sk, kv_heads=hkv,
            causal_offset=masking.offset(sq, sk),
            visible_pairs=pairs, max_abs_err=e, ms=ms,
            tflops=achieved_tflops(flops, ms),
            plain_ms=queued_ms(partial(plain_fn, *call, **kwargs),
                               iters=iters),
            library_ms=library_ms if name == "flash_fwd" else None,
            library=("F.scaled_dot_product_attention(is_causal=True)"
                     if name == "flash_fwd" and library_ms is not None
                     else None),
            bound_ms=bms, bound_by=by), kernel))
    return rows


def head_dim_paged_row(gen, dev, d, dtype, branch, s, rep, slots=6,
                       kv=2, maxp=48, lengths=None, timed=False):
    """One paged row at head dim ``d``: a shuffled pool of page 16 with
    page 0 poisoned (1e4), entries below a window's band nulled, lengths on
    page edges; the twin at ``TOL``, leading rows of short slots exactly 0,
    the same bits in a second call."""
    import torch

    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    quant = importlib.import_module("apex_tpu_torch.ops.quant")
    ps = PAGE_SIZE
    window = 300 if "window" in branch else None
    kv_dtype = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
                "int8_window": torch.int8}.get(branch)
    if lengths is None:
        lengths = [0, 1, s, 129, 400, maxp * ps][:slots]
    slots = len(lengths)
    num_pages = 1 + slots * maxp
    perm = torch.randperm(num_pages - 1, generator=gen) + 1
    bt = torch.zeros(slots, maxp, dtype=torch.int32)
    for i, n in enumerate(lengths):
        bt[i, :-(-n // ps)] = perm[i * maxp:i * maxp - (-n // ps)]
        if window is not None:
            bt[i, :max(n - s - window + 1, 0) // ps] = 0
    pages = [torch.randn(num_pages, kv, ps, d, generator=gen) * 2
             for _ in range(2)]
    for pg in pages:
        pg[0] = 1e4
    kw = {} if window is None else dict(window=window)
    if kv_dtype is None:
        kp, vp = (pg.to(dev, dtype) for pg in pages)
    else:
        qmax = 127.0 if kv_dtype == torch.int8 else 448.0
        (kp, ksc), (vp, vsc) = (quant.kv_quantize(pg, kv_dtype, qmax,
                                                  axes=(2, 3))
                                for pg in pages)
        kp, vp = kp.to(dev), vp.to(dev)
        kw.update(k_scales=ksc[:, :, 0, 0].to(dev),
                  v_scales=vsc[:, :, 0, 0].to(dev))
    q = torch.randn(slots, rep * kv, s, d, generator=gen).to(dev, dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    args = (q, kp, vp, bt.to(dev), ln)
    o = pa.paged_attention(*args, **kw)
    dn = str(dtype).split(".")[1]
    name = ("paged_attention_quant" if kv_dtype is not None
            else "paged_attention_window" if window else "paged_attention")
    name += "_block" if s > 1 else ""
    err = compare(f"{name} d={d}", o, pa.paged_attention_reference(*args,
                                                                   **kw), dn)
    for i, n in enumerate(lengths):
        if n < s and (o[i, :, :s - n] != 0).any():
            raise AssertionError(f"{name} d={d}: rows before slot {i}'s "
                                 f"start must be exactly 0")
    n_pos = sum(min(n, maxp * ps) if window is None
                else min(n, s + window - 1) for n in lengths)
    elt = kp.element_size()
    nbytes = (2 * n_pos * kv * d * elt + 2 * q.numel() * q.element_size()
              + slots * maxp * 4)
    bms, by = bound_ms(nbytes, 4 * n_pos * rep * kv * s * d, dn)
    kernel = partial(pa.paged_attention, *args, **kw)
    iters = 50 if timed else HEAD_DIM_ITERS
    same_bits(f"{name} d={d}", (o,), (kernel(),))
    ms = queued_ms(kernel, iters=iters)
    return (dict(name=name, dtype=dn, path="head_dim", kind="head_dim",
                 branch=branch, d=d, s=s, kv_heads=kv,
                 shape=[slots, rep * kv, ps, d, maxp], lengths=lengths,
                 window=window, max_abs_err=err, ms=ms,
                 tb_s=nbytes / ms / 1e9,
                 plain_ms=queued_ms(partial(pa.paged_attention_reference,
                                            *args, **kw), iters=iters),
                 library_ms=None, bound_ms=bms, bound_by=by), kernel)


def check_head_dim(gen, dev):
    """ROADMAP C3 on the card: the flash forward, dq and dk/dv kernels and
    the paged kernel at head dims 160, 192 and 256, fp32 and bf16, on
    every branch the d <= 128 instances take (flash: causal, non-causal,
    window, a bias table in q's dtype, an fp32 bias under bf16 q, segment
    ids with dropout, dropout, ring attention's offset and dropout origin;
    paged: s = 1 and s = 4, fp, window, int8 and fp8 pools, int8 under a
    window), each against its twin; then the timed rows: the causal
    prefill at 1 x 16 x ``HEAD_DIM_SEQ`` and an 8-slot decode step (16
    heads over 8 kv heads, lengths up to 2048)."""
    import torch

    out = []
    for d in HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for branch in HEAD_DIM_FLASH:
                out += head_dim_flash_rows(gen, dev, d, dtype, branch)
            for branch in HEAD_DIM_PAGED:
                for s, rep in ((1, 2), (4, 2)):
                    out.append(head_dim_paged_row(gen, dev, d, dtype, branch,
                                                  s, rep))
            timed = head_dim_flash_rows(gen, dev, d, dtype, "causal",
                                        shape=(1, 16, HEAD_DIM_SEQ))
            for row, _ in timed:
                row["use"] = "timed"
            out += timed
            row = head_dim_paged_row(
                gen, dev, d, dtype, "fp", 1, 2, kv=8, maxp=128,
                lengths=[1, 17, 100, 256, 511, 1024, 1500, 2048], timed=True)
            row[0]["use"] = "timed"
            out.append(row)
    return out


def check_flash_nmt(gen, dev):
    """The three flash kernels at the NMT step's shape under amp O1
    (``nmt_bf16``: 32 x 16 heads x 128 x 64, bf16 q/k/v, ``scale``
    d^-0.5, not causal, dropout 0.1), each against its twin at
    ``RMS_ATOL`` of the twin's RMS: the decoder's self-attention with the
    causal mask as the fp32 -1e9 table ``(1, 1, 128, 128)`` that
    ``masks_to_bias`` builds (the bf16 kernels' fp32-bias branch), and the
    encoder's self and the cross attention without a bias. Timed by
    ``queued_ms``; the bound counts the fp32 table once and one add per
    pair; the library call is ``scaled_dot_product_attention`` with the
    same dropout rate (its own keep mask) and the table rounded to bf16 as
    its ``attn_mask`` (the library takes no fp32 mask under a bf16 q)."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

    out = []
    b, s = NMT_BATCH, NMT_SEQ
    h = NMT_BIG["num_heads"]
    d = NMT_BIG["embed_dim"] // h
    rate = NMT_BIG["dropout"]
    masking = fa.Masking(causal=False, dropout_rate=rate, dropout_seed=SEED)
    pos = torch.arange(s, device=dev)
    table = torch.where(pos[:, None] >= pos[None, :], 0.0, -1e9).to(
        torch.float32)[None, None]
    dn, elt = "bfloat16", 2
    for use, bias in (("decoder self-attention", table),
                      ("encoder self and cross attention", None)):
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen).to(
            dev, torch.bfloat16) for _ in range(4))
        kw = dict(scale=d ** -0.5, masking=masking, bias=bias)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        names = [fa.launch_name(n, masking, bias, s, s) for n in
                 ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")]
        fwd_name, dq_name, dkdv_name = names
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
        errs = {fwd_name: compare(f"{fwd_name} (nmt)", o, ro, dn,
                                  rms_atol=True)}
        compare(f"{fwd_name} (nmt) lse", lse, rlse, "float32")
        out_rms = {fwd_name: [rms_of(ro)]}
        args = (q, k, v, do, rlse, fa.flash_bwd_delta(ro, do))
        del o, lse, ro
        dq = fa.flash_bwd_dq(*args, **kw)
        dk, dv = fa.flash_bwd_dkdv(*args, **kw)
        torch.cuda.synchronize()
        rdq = fa.flash_bwd_dq_reference(*args, **kw)
        rdk, rdv = fa.flash_bwd_dkdv_reference(*args, **kw)
        errs[dq_name] = compare(f"{dq_name} (nmt)", dq, rdq, dn,
                                rms_atol=True)
        errs[dkdv_name] = max(
            compare(f"{dkdv_name} (nmt) dk", dk, rdk, dn, rms_atol=True),
            compare(f"{dkdv_name} (nmt) dv", dv, rdv, dn, rms_atol=True))
        out_rms.update({dq_name: [rms_of(rdq)],
                        dkdv_name: [rms_of(rdk), rms_of(rdv)]})
        del dq, dk, dv, rdq, rdk, rdv
        lib_mask = None if bias is None else bias.to(torch.bfloat16)
        library = {fwd_name: queued_ms(partial(
            F.scaled_dot_product_attention, q, k, v, attn_mask=lib_mask,
            dropout_p=rate))}
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=lib_mask,
                                            dropout_p=rate)
        library[dq_name] = library[dkdv_name] = queued_ms(partial(
            torch.autograd.grad, ol, (ql, kl, vl), do, retain_graph=True))
        del ol, ql, kl, vl
        pairs = b * h * s * s
        bias_bytes = 0 if bias is None else bias.numel() * 4
        tile, row_stats = b * h * s * d * elt, b * h * s * 4
        for name, fn, plain, nbytes, flops in (
                (fwd_name, fa.flash_fwd, fa.flash_attention_reference,
                 4 * tile + row_stats + bias_bytes, 4 * pairs * d + pairs),
                (dq_name, fa.flash_bwd_dq, fa.flash_bwd_dq_reference,
                 5 * tile + 2 * row_stats + bias_bytes,
                 6 * pairs * d + pairs),
                (dkdv_name, fa.flash_bwd_dkdv, fa.flash_bwd_dkdv_reference,
                 6 * tile + 2 * row_stats + bias_bytes,
                 8 * pairs * d + pairs)):
            call = (q, k, v) if name == fwd_name else args
            bms, by = bound_ms(nbytes, flops, dn)
            kernel = partial(fn, *call, **kw)
            ms = queued_ms(kernel)
            out.append((dict(
                name=name, dtype=dn, shape=[b, h, s, d], sk=s, causal=False,
                path="nmt", use=use, dropout=rate,
                bias_shape=None if bias is None else list(bias.shape),
                bias_dtype=None if bias is None else "float32",
                max_abs_err=errs[name], out_rms=out_rms[name], ms=ms,
                tflops=achieved_tflops(flops, ms),
                plain_ms=queued_ms(partial(plain, *call, **kw)),
                library_ms=library[name],
                library="scaled_dot_product_attention(dropout_p"
                        + (")" if bias is None else
                           ", the table in bf16 as attn_mask)")
                        + ("" if name == fwd_name else
                           "; its backward: dq, dk and dv together"),
                bound_ms=bms, bound_by=by), kernel))
    return out


def resnet_spec():
    """``(named parameters on the meta device, FlatSpec)`` of ResNet-50 at
    ImageNet width: 161 tensors, 25,557,032 parameters, 25,021 rows."""
    from apex_tpu_torch.examples.imagenet import main_amp as rn
    from apex_tpu_torch.ops import flat_buffer

    named = list(rn.resnet50(device="meta").named_parameters())
    return named, flat_buffer.build_spec(named)


def opt_compare(name: str, got, want) -> float:
    """``compare`` at ``OPT_TOL`` with the atol cut to ``RMS_ATOL`` of the
    twin's RMS."""
    return compare(name, got, want, "float32", OPT_TOL, rms_atol=True)


def check_resnet_optim(gen, dev):
    """The SGD, NovoGrad, scale and stats kernels over ResNet-50's flat
    buffers (25,021 x 1024 fp32, 161 segments), each against its twin: SGD at
    momentum 0.9 with decay 1e-4 at step 1 and 2, momentum 0, Nesterov;
    NovoGrad at step 1 and 2, ``init_zero`` both ways, grad scale 0.5 and
    1; scale over fp32 and bf16 x; the stats as ``segment_stats_row``. A
    skipped step must leave every buffer
    bit-identical. One row per kernel (two for scale: fp32, bf16), timed
    by ``queued_ms`` at the timed path's case: SGD momentum 0.9, decay
    1e-4, step 2; NovoGrad's update kernel alone at step 2."""
    import torch

    from apex_tpu_torch.ops import flat_buffer

    oa = importlib.import_module("apex_tpu_torch.ops.optim_kernels")
    named, spec = resnet_spec()
    rows, segs, lane = spec.total_rows, spec.num_tensors, flat_buffer.LANE
    n = rows * lane
    seg = spec.segment_rows().to(dev)
    dgen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(scale=1.0):
        return torch.randn(rows, lane, generator=dgen, device=dev) * scale

    g, p, m = randn(0.01), randn(0.05), randn(0.01)
    out = []

    # SGD: the kernel (in place on copies) against the twin, per case
    cases = [dict(momentum=0.9, weight_decay=1e-4, step=1),
             dict(momentum=0.9, weight_decay=1e-4, step=2),
             dict(momentum=0.0, weight_decay=1e-4, step=2),
             dict(momentum=0.9, nesterov=True, weight_decay=1e-4, step=2)]
    errs = []
    for case in cases:
        kw = dict(lr=RESNET_LR, **dict(case, step=torch.tensor(
            case["step"], device=dev)))
        p1, m1 = oa.sgd_update(g, p.clone(), m.clone(), **kw)
        torch.cuda.synchronize()
        rp, rm = oa.sgd_update_reference(g, p, m, **kw)
        label = f"sgd {case}"
        errs.append(max(opt_compare(f"{label} p", p1, rp),
                        opt_compare(f"{label} m", m1, rm),
                        compare(f"{label} p - p0", p1 - p, rp - p,
                                "float32", UPDATE_TOL)))
        if case["momentum"] == 0.0 and not torch.equal(m1, m):
            raise AssertionError("sgd: momentum 0 changed the buffer")
    kw = dict(lr=RESNET_LR, momentum=0.9, weight_decay=1e-4,
              step=torch.tensor(2, device=dev))
    pk, mk = p.clone(), m.clone()
    oa.sgd_update(g, pk, mk, **dict(kw, noop=torch.tensor(1.0, device=dev)))
    torch.cuda.synchronize()
    if not (torch.equal(pk, p) and torch.equal(mk, m)):
        raise AssertionError("sgd: a skipped step changed a buffer")
    bufs = [t.clone() for t in (p, m)]
    kernel = partial(oa.sgd_update, g, *bufs, **kw)
    lp = flat_buffer.unflatten(p.clone(), spec)
    lg = flat_buffer.unflatten(g, spec)
    for nm, t in lp.items():
        t.grad = lg[nm]
    lib = torch.optim.SGD(list(lp.values()), lr=RESNET_LR, momentum=0.9,
                          weight_decay=1e-4, fused=True)
    # read g, p, m; write p, m: 20 bytes and ~9 operations an element
    bms, by = bound_ms(20 * n, 9 * n, "float32")
    out.append((dict(
        name="sgd", dtype="float32", shape=[rows, lane], segments=segs,
        params=sum(spec.sizes), path="resnet", cases=cases,
        max_abs_err=max(errs), skip_bit_identical=True,
        ms=queued_ms(kernel),
        plain_ms=queued_ms(partial(oa.sgd_update_reference, g, p, m, **kw)),
        library_ms=queued_ms(lib.step),
        library="torch.optim.SGD(momentum=0.9, weight_decay=1e-4, "
                "fused=True).step() over the 161 views",
        bound_ms=bms, bound_by=by), kernel))
    del lib, lp, lg, bufs

    # NovoGrad: the whole step (stats kernel, second moment, update
    # kernel) against the whole twin, per case; then the update alone
    v = torch.rand(segs, generator=dgen, device=dev) * 0.1
    nvg = dict(beta1=0.95, beta2=0.98, eps=1e-8, weight_decay=1e-4,
               lr=RESNET_LR)
    cases = [dict(step=1, init_zero=False, grad_scale=1.0),
             dict(step=1, init_zero=True, grad_scale=0.5),
             dict(step=2, init_zero=False, grad_scale=0.5),
             dict(step=2, init_zero=True, grad_scale=1.0)]
    errs = []
    for case in cases:
        kw = dict(nvg, **dict(case, step=torch.tensor(case["step"],
                                                      device=dev)))
        p1, m1, v1 = oa.novograd_update(g, p.clone(), m.clone(), v.clone(),
                                        seg, segs, **kw)
        torch.cuda.synchronize()
        rp, rm, rv = oa.novograd_update_reference(g, p, m, v, seg, segs,
                                                  **kw)
        label = f"novograd {case}"
        errs.append(max(opt_compare(f"{label} p", p1, rp),
                        opt_compare(f"{label} m", m1, rm),
                        opt_compare(f"{label} v", v1, rv),
                        compare(f"{label} p - p0", p1 - p, rp - p,
                                "float32", UPDATE_TOL)))
    kw = dict(nvg, step=torch.tensor(2, device=dev), grad_scale=1.0)
    pk, mk, vk = p.clone(), m.clone(), v.clone()
    oa.novograd_update(g, pk, mk, vk, seg, segs,
                       **dict(kw, noop=torch.tensor(1.0, device=dev)))
    torch.cuda.synchronize()
    if not (torch.equal(pk, p) and torch.equal(mk, m) and torch.equal(vk, v)):
        raise AssertionError("novograd: a skipped step changed a buffer")
    stats = oa.segment_stats(g, seg, segs)
    _, vden = oa.novograd_second_moment(stats[0], v, beta2=0.98, eps=1e-8,
                                        step=2)
    hp = oa.novograd_hyperparams(beta1=0.95, eps=1e-8, weight_decay=1e-4,
                                 lr=RESNET_LR, device=dev)
    bufs = [t.clone() for t in (p, m)]
    kernel = partial(oa.novograd_apply, hp, g, *bufs, vden, seg)
    bms, by = bound_ms(20 * n + 4 * rows + 4 * segs, 8 * n, "float32")
    out.append((dict(
        name="novograd", dtype="float32", shape=[rows, lane], segments=segs,
        params=sum(spec.sizes), path="resnet", cases=cases,
        max_abs_err=max(errs), skip_bit_identical=True,
        ms=queued_ms(kernel),
        plain_ms=queued_ms(partial(oa.novograd_apply_reference, hp, g, p, m,
                                   vden, seg)),
        whole_step_ms=queued_ms(partial(oa.novograd_update, g, *bufs,
                                        v.clone(), seg, segs, **kw)),
        library_ms=None, library="none: PyTorch has no NovoGrad",
        bound_ms=bms, bound_by=by), kernel))
    del bufs

    # scale: y = f32(x) * s, one rounding on both sides: bit-equal
    s = torch.tensor(2.0 ** -16, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        x = g.to(dtype)
        y = oa.multi_tensor_scale(x, s)
        torch.cuda.synchronize()
        want = oa.multi_tensor_scale_reference(x, s)
        err = opt_compare(f"multi_tensor_scale {dtype}", y, want)
        if not torch.equal(y, want):
            raise AssertionError(f"multi_tensor_scale {dtype}: not "
                                 f"bit-equal to its twin")
        kernel = partial(oa.multi_tensor_scale, x, s)
        bms, by = bound_ms(n * (x.element_size() + 4), n, "float32")
        out.append((dict(
            name="multi_tensor_scale", dtype=str(dtype).split(".")[-1],
            shape=[rows, lane], path="resnet", max_abs_err=err,
            ms=queued_ms(kernel),
            plain_ms=queued_ms(partial(oa.multi_tensor_scale_reference, x,
                                       s)),
            library_ms=queued_ms(partial(lambda a, b: torch.mul(a.float(),
                                                                b), x, s)),
            library="torch.mul(x.float(), s)",
            bound_ms=bms, bound_by=by), kernel))
    # the stats pass of FusedNovoGrad and of the amp overflow check
    out.append(segment_stats_row(randn(0.01), spec, seg, "resnet"))
    return out


def padding_mask(gen, b: int, s: int, dev):
    """A ``[b, 1, 1, s]`` padding mask (True = padded) from sequence lengths
    uniform in 1..s (``gen``), the first a single token."""
    import torch

    lengths = torch.randint(1, s + 1, (b,), generator=gen)
    lengths[0] = 1
    return (torch.arange(s)[None, :] >= lengths[:, None])[:, None, None].to(
        dev)


def softmax_cases(gen, dev):
    """``(label, x shape, mask, causal, layers)`` of the softmax rows:
    GPT-2-small's causal scores, BERT-Large's with the padding mask and
    without one, and a row longer than 8192 with a padding mask."""
    b, h, s = SOFTMAX_GPT
    bb, bh, bs = SOFTMAX_BERT
    lb, lh, lq, lk = SOFTMAX_LONG
    return [("gpt", (b * h, 1, s, s), None, True, SOFTMAX_LAYERS["gpt"]),
            ("bert", (bb, bh, bs, bs), padding_mask(gen, bb, bs, dev), False,
             SOFTMAX_LAYERS["bert"]),
            ("bert", (bb, bh, bs, bs), None, False, SOFTMAX_LAYERS["bert"]),
            ("long", SOFTMAX_LONG, padding_mask(gen, lb, lk, dev), False, 1)]


def kept_scores(shape, mask, causal: bool) -> int:
    """The scores of ``[b, np, sq, sk]`` that are not fill (masked, or
    right of the diagonal under ``causal``): the x values the forward
    needs, in this run's mask."""
    import torch

    b, np_, sq, sk = shape
    keep = torch.ones(sq, sk, dtype=torch.bool, device=mask.device
                      if mask is not None else None)
    if causal:
        keep = keep.tril()
    if mask is None:
        return b * np_ * int(keep.sum())
    m = ~mask.expand(mask.shape[0], 1, sq, sk) & keep
    per_block = m.flatten(1).sum(1).cpu()
    return np_ * int(per_block[torch.arange(b) % mask.shape[0]].sum())


def check_scaled_softmax(gen, dev):
    """The scaled-softmax kernels against their twins: each forward branch
    and the backward at GPT-2-small's causal [96, 1024, 1024], BERT-Large's
    [8, 16, 512, 512] with its padding mask (and without one), and [2, 4,
    16, 8193] (no cap), fp32 and bf16, BERT's masked rows fp16 too; the
    scores' spread 2 after Megatron's layer scaling ``scale = L``. Timed
    by ``queued_ms``; library: ``torch.softmax`` on the pre-scaled,
    pre-masked scores in x's dtype and ``torch._softmax_backward_data``.
    The forward's bound reads only the scores that are not fill
    (``kept_scores``) and writes every output; each row's TB/s is its
    bound's bytes over its time. Rows carry no timing closure
    (``queued_ms`` has timed them)."""
    import torch

    ss = importlib.import_module("apex_tpu_torch.ops.scaled_softmax")
    dgen = torch.Generator(device=dev).manual_seed(SEED)
    out = []
    for label, shape, mask, causal, scale in softmax_cases(gen, dev):
        kind = "causal" if causal else "padding" if mask is not None \
            else "none"
        dtypes = [torch.float32, torch.bfloat16] + (
            [torch.float16] if label == "bert" and mask is not None else [])
        row_shape = [shape[0], *shape[2:]] if causal else list(shape)
        name = ss._branch(mask, causal)
        n = math.prod(shape)
        kept = kept_scores(shape, mask, causal)
        mask_bytes = mask.numel() if mask is not None else 0
        for dtype in dtypes:
            dt = str(dtype).split(".")[-1]
            x = (torch.randn(shape, generator=dgen, device=dev)
                 * (2.0 / scale)).to(dtype)
            dy = torch.randn(shape, generator=dgen, device=dev).to(dtype)
            y = ss.scaled_softmax_fwd(x, mask, scale, causal)
            dx = ss.scaled_softmax_bwd(y, dy, scale)
            torch.cuda.synchronize()
            same_bits(f"{name} {label} {dt}", (y,),
                      (ss.scaled_softmax_fwd(x, mask, scale, causal),))
            want = ss.scaled_softmax_fwd_reference(x, mask, scale, causal)
            err = compare(f"{name} {label} {dt}", y, want, dt)
            berr = compare(f"scaled_softmax_bwd {label} {dt}", dx,
                           ss.scaled_softmax_bwd_reference(y, dy, scale), dt)
            del want
            pre = x.float() * scale
            if mask is not None:
                pre = pre.masked_fill(mask, ss.MASK_FILL)
            if causal:
                pre = pre.masked_fill(torch.ones(shape[2:], dtype=torch.bool,
                                                 device=dev).triu(1),
                                      ss.MASK_FILL)
            pre = pre.to(dtype)
            esize = x.element_size()
            common = dict(dtype=dt, shape=row_shape, kind=kind, scale=scale,
                          path="megatron_softmax")
            nbytes = (kept + n) * esize + mask_bytes
            bms, by = bound_ms(nbytes, 8 * n, "float32")
            ms = queued_ms(partial(ss.scaled_softmax_fwd, x, mask, scale,
                                   causal), 20)
            out.append((dict(
                name=name, **common, max_abs_err=err, ms=ms,
                tb_s=nbytes / ms / 1e9,
                plain_ms=queued_ms(partial(ss.scaled_softmax_fwd_reference,
                                           x, mask, scale, causal), 5),
                library_ms=queued_ms(partial(torch.softmax, pre, -1), 20),
                library="torch.softmax(scores pre-scaled and pre-masked in "
                        "x's dtype, -1)",
                bound_ms=bms, bound_by=by), None))
            nbytes = 3 * n * esize
            bms, by = bound_ms(nbytes, 5 * n, "float32")
            ms = queued_ms(partial(ss.scaled_softmax_bwd, y, dy, scale), 20)
            out.append((dict(
                name="scaled_softmax_bwd", **common, max_abs_err=berr,
                ms=ms, tb_s=nbytes / ms / 1e9,
                plain_ms=queued_ms(partial(ss.scaled_softmax_bwd_reference,
                                           y, dy, scale), 5),
                library_ms=queued_ms(partial(
                    torch._softmax_backward_data, dy, y, -1, dtype), 20),
                library="torch._softmax_backward_data(dy, y, -1)",
                bound_ms=bms, bound_by=by), None))
            del x, dy, y, dx, pre
    return out


def unet_norm_input(dgen, c: int, side: int, dtype, dev):
    """An NCHW ``(UNET_BATCH, c, side, side)`` activation in channels_last
    memory, mean 0.3."""
    import torch

    x = torch.randn(UNET_BATCH, side, side, c, generator=dgen, device=dev)
    return (x + 0.3).to(dtype).permute(0, 3, 1, 2)


def check_group_norm(gen, dev):
    """The GroupNorm kernels against their twins at Stable Diffusion v1.5's
    UNet norm shapes (``UNET_SHAPES``, batch 8, 32 groups, channels_last),
    each with SiLU at eps 1e-5 and without at eps 1e-6, fp32 and bf16,
    weight and bias near 1 and 0: y, mean, rstd; dx, dw, db (dw and db at
    ``SUM_TOL``: fp32 sums over 8 h w rows in other orders); a second call
    gives the same bits, and sample 0 alone the bits of sample 0 in the
    batch (y, mean, rstd, dx). Kernel, twin and library are timed by
    ``queued_ms`` over copies of x (and dy) whose reads and written outputs
    together exceed the L2 cache (``copies_for``, ``rotating``: over one x
    a row up to 50 MB would be read from L2), and each row carries the
    kernels' device ms by the profiler (``kernel_device_ms`` over the op's
    symbols: both launches of a call). Library: ``F.group_norm`` on the
    same NCHW tensor (its weight and bias in x's dtype), and for the
    backward the device ms of ``torch.autograd.grad`` over its graph, one
    graph a copy (``library_device_ms``: its ``queued_ms`` reads the host).
    The rows keep no closure: their copies are freed here."""
    import torch
    import torch.nn.functional as F

    gn = importlib.import_module("apex_tpu_torch.ops.group_norm")
    dgen = torch.Generator(device=dev).manual_seed(SEED)
    out = []
    for c, side in UNET_SHAPES:
        w = torch.randn(c, generator=dgen, device=dev) * 0.1 + 1
        b = torch.randn(c, generator=dgen, device=dev) * 0.1
        for act, eps in UNET_NORMS:
            for dtype in (torch.float32, torch.bfloat16):
                dt = str(dtype).split(".")[-1]
                x = unet_norm_input(dgen, c, side, dtype, dev)
                dy = unet_norm_input(dgen, c, side, dtype, dev)
                xh, dyh = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
                args = (w, b, UNET_GROUPS)
                y, mean, rstd = gn.group_norm_fwd(xh, *args, eps, act)
                bargs = (w, b, mean, rstd, UNET_GROUPS, act)
                dx, dw, db = gn.group_norm_bwd(xh, dyh, *bargs)
                torch.cuda.synchronize()
                label = f"group_norm {c}x{side} {act} {dt}"
                ry, rmean, rrstd = gn.group_norm_fwd_reference(xh, *args,
                                                               eps, act)
                err = max(compare(f"{label} y", y, ry, dt),
                          compare(f"{label} mean", mean, rmean, "float32"),
                          compare(f"{label} rstd", rstd, rrstd, "float32"))
                rdx, rdw, rdb = gn.group_norm_bwd_reference(xh, dyh, *bargs)
                berr = compare(f"{label} dx", dx, rdx, dt)
                sums_err = max(compare(f"{label} dw", dw, rdw, "float32",
                                       SUM_TOL),
                               compare(f"{label} db", db, rdb, "float32",
                                       SUM_TOL))
                del ry, rdx
                same_bits(label, (y, mean, rstd, dx, dw, db),
                          (*gn.group_norm_fwd(xh, *args, eps, act),
                           *gn.group_norm_bwd(xh, dyh, *bargs)))
                alone = gn.group_norm_fwd(xh[:1], *args, eps, act)
                same_bits(f"{label} sample 0 alone",
                          (y[:1], mean[:1], rstd[:1], dx[:1]),
                          (*alone, gn.group_norm_bwd(
                              xh[:1], dyh[:1], w, b, *alone[1:],
                              UNET_GROUPS, act)[0]))
                del alone
                n, esize = x.numel(), x.element_size()
                common = dict(dtype=dt, shape=list(xh.shape),
                              kind=act or "none", eps=eps,
                              groups=UNET_GROUPS, path="unet_group_norm")
                wl, bl = w.to(dtype), b.to(dtype)
                bms, by = bound_ms(2 * n * esize + 8 * c, 12 * n, "float32")
                xs = [xh.clone() for _ in range(copies_for(2 * n * esize))]
                fwd_sets = [(xc, *args, eps, act) for xc in xs]
                kernel = rotating(gn.group_norm_fwd, fwd_sets)
                library = rotating(
                    lambda xc: F.group_norm(xc.permute(0, 3, 1, 2),
                                            UNET_GROUPS, wl, bl, eps),
                    [(xc,) for xc in xs])
                dev_ms, seen, split = kernel_device_ms(
                    kernel, kernel_symbol("group_norm_fwd", dt))
                lib_dev, lib_seen = library_device_ms(library)
                out.append((dict(
                    name="group_norm_fwd", **common, max_abs_err=err,
                    ms=queued_ms(kernel),
                    plain_ms=queued_ms(rotating(gn.group_norm_fwd_reference,
                                                fwd_sets), 10),
                    library_ms=queued_ms(library),
                    library="F.group_norm(x NCHW channels_last, 32, w, b, "
                            "eps), w and b in x's dtype",
                    device_ms=dev_ms, device_ms_by_symbol=split,
                    launches_seen=seen, library_device_ms=lib_dev,
                    library_launches_seen=lib_seen, x_copies=len(xs),
                    bound_ms=bms, bound_by=by), None))
                del xs, fwd_sets, kernel, library
                bms, by = bound_ms(3 * n * esize + 16 * c
                                   + 8 * UNET_BATCH * UNET_GROUPS,
                                   20 * n, "float32")
                pairs = [(xh.clone(), dyh.clone())
                         for _ in range(copies_for(3 * n * esize))]
                bwd_sets = [(xc, dc, *bargs) for xc, dc in pairs]
                kernel = rotating(gn.group_norm_bwd, bwd_sets)
                wg = wl.detach().requires_grad_()
                bg = bl.detach().requires_grad_()
                graphs = []
                for xc, dc in pairs:
                    xl = xc.permute(0, 3, 1, 2).detach().requires_grad_()
                    graphs.append((F.group_norm(xl, UNET_GROUPS, wg, bg, eps),
                                   xl, dc.permute(0, 3, 1, 2)))
                library = rotating(
                    lambda yl, xl, dc: torch.autograd.grad(
                        yl, (xl, wg, bg), dc, retain_graph=True), graphs)
                dev_ms, seen, split = kernel_device_ms(
                    kernel, kernel_symbol("group_norm_bwd", dt))
                lib_dev, lib_seen = library_device_ms(library)
                out.append((dict(
                    name="group_norm_bwd", **common, max_abs_err=berr,
                    sums_max_abs_err=sums_err,
                    ms=queued_ms(kernel),
                    plain_ms=queued_ms(rotating(gn.group_norm_bwd_reference,
                                                bwd_sets), 10),
                    library_ms=lib_dev,
                    library="the backward of F.group_norm (dx, dw, db): "
                            "device ms by the profiler",
                    device_ms=dev_ms, device_ms_by_symbol=split,
                    launches_seen=seen, library_device_ms=lib_dev,
                    library_launches_seen=lib_seen, x_copies=len(pairs),
                    bound_ms=bms, bound_by=by), None))
                del pairs, bwd_sets, kernel, library, graphs
                del x, dy, xh, dyh, y, dx
    return out


def sync_bn_sumsq(gen, dev) -> None:
    """ROADMAP C1: the per-channel sum of squares of SyncBatchNorm's
    statistics at each of ResNet-50's 12 norm input shapes (53 norms, 256
    images at 224), bf16 channels_last, mean 0.3 and std 0.5, against the
    fp64 sum: the largest and median relative error over the channels of
    ``vector_norm(x, 2, dtype=float32)^2`` (the port's form before C1), of
    the reference's direct fp32 sum of ``x32 * x32``
    (``apex_tpu/parallel/sync_batchnorm.py:44``), of an fp64-accumulated
    ``vector_norm`` squared, and of the port's ``channel_sums``, with the ms
    of each, and whether the port's equals the direct sum bit for bit.
    Fails if the port's is further from fp64 than the direct sum."""
    import collections

    import torch

    from apex_tpu_torch.examples.imagenet import main_amp as rn
    from apex_tpu_torch.parallel import SyncBatchNorm
    from apex_tpu_torch.parallel.sync_batchnorm import channel_sums

    model = rn.resnet50(device="meta")
    shapes = collections.Counter()
    for mod in model.modules():
        if isinstance(mod, SyncBatchNorm):
            mod.register_forward_pre_hook(
                lambda m, inp: shapes.update([tuple(inp[0].shape)]))
    model(torch.empty(RESNET_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE,
                      device="meta"))
    dgen = torch.Generator(device=dev).manual_seed(SEED)
    dims = [0, 2, 3]

    def vector_norm(x):
        return torch.linalg.vector_norm(x, 2, dim=dims,
                                        dtype=torch.float32).square()

    def direct(x):
        x32 = x.float()
        return (x32 * x32).sum(dims)

    def fp64(x):
        return torch.linalg.vector_norm(x, 2, dim=dims,
                                        dtype=torch.float64).square().float()

    forms = (("vector_norm", vector_norm), ("direct", direct),
             ("fp64", fp64), ("port", lambda t: channel_sums(t)[1]))
    rows, worst = [], {}
    for shape, count in shapes.items():
        x = (torch.randn(shape, generator=dgen, device=dev) * 0.5 + 0.3).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        want = x.double().square().sum(dims)
        row = dict(shape=list(shape), norms=count,
                   port_equals_direct=torch.equal(channel_sums(x)[1],
                                                  direct(x)))
        for label, fn in forms:
            rel = ((fn(x).double() - want).abs() / want)
            row[label] = dict(max_rel_err=rel.max().item(),
                              median_rel_err=rel.median().item(),
                              ms=time_ms(partial(fn, x), 10))
            worst[label] = max(worst.get(label, 0.0), row[label][
                "max_rel_err"])
        rows.append(row)
        del x, want
    emit("sync_bn_sumsq", dtype="bfloat16", mean=0.3, std=0.5, rows=rows,
         worst_max_rel_err=worst,
         ms_total_53_norms={k: sum(r[k]["ms"] * r["norms"] for r in rows)
                            for k, _ in forms})
    if worst["port"] > worst["direct"]:
        raise AssertionError(f"sync_bn_sumsq: the port's sum of squares is "
                             f"further from fp64 ({worst['port']:.3e}) than "
                             f"the direct fp32 sum ({worst['direct']:.3e})")


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
    """Wrap ``engine``'s admission and decode chunk (its speculative round
    chunk, for a speculative engine) to add their seconds to ``into``:
    ``admit_s`` (an admission ends in a read of its first token),
    ``chunk_host_s`` (the host issuing a chunk's steps, up to its return)
    and ``chunk_s`` (the same chunk through a synchronize, which the
    engine's own read of the chunk's tokens would wait for next)."""
    import torch

    name = "_spec_chunk" if engine.draft_len else "_decode_chunk"
    admit, chunk = engine._admit, getattr(engine, name)
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

    engine._admit = timed_admit
    setattr(engine, name, timed_chunk)


def drive_engine(model, prompts, new_tokens, kernels=SERVING_KERNELS,
                 kv_dtype=None, step_times=None, num_slots=NUM_SLOTS,
                 **engine_kw):
    """One engine run over the workload, the launch counts set to 0 just
    before it and read just after; it fails if a kernel of ``kernels`` was
    not launched or a pool (the draft pool too) leaked. ``engine_kw`` sizes
    the pool or sets the engine's mode; ``step_times``, a dict, receives
    ``time_engine_steps``' sums. With a prefix cache the pages the tree
    still caches are not a leak: the free stack must hold every usable
    page but those. Returns ``(engine, outputs, stats, seconds,
    launches)``."""
    import torch

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.serving import PagedDecodeEngine, Request

    engine = PagedDecodeEngine(model, num_slots=num_slots,
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
    for pool in (engine.cache, engine.draft_cache):
        if pool is None:
            continue
        free = pool["free_top"]
        usable = pool["layers"][0]["k_pages"].shape[0] - 1
        if pool is engine.cache and engine.prefix is not None:
            usable -= len(engine.prefix)
        if free != usable:
            raise AssertionError(f"pool leaked: {free} free of {usable} "
                                 f"pages")
    return engine, outs, stats, elapsed, launches


def build_model(dtype, layers=None, device=None):
    """GPT-2-small at full width (``layers`` deep when given), seeded
    random weights drawn on the CPU, on ``device`` (the card by
    default)."""
    import torch

    from apex_tpu_torch.models import GPTModel, gpt2_small_config

    depth = {} if layers is None else dict(num_layers=layers)
    return GPTModel(gpt2_small_config(dtype=dtype, **depth),
                    device=device or DEV,
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
    lock-step ``generate`` of the same quantized model, at full width and
    ``QUANT_FP32_LAYERS`` deep (the bar is the engine against lock-step
    decode of one model, which depth does not change); (c), (d): int8 and
    fp8 pools over the fp model, first tokens equal to ``engine_fp32``'s,
    and the pool's error bound after one admission."""
    import numpy as np
    import torch

    from apex_tpu_torch.models import generate

    results = {}
    shallow = build_model(torch.float32, layers=QUANT_FP32_LAYERS)
    for label, kind in (("w8", "int8"), ("w4", "int4")):
        qmodel = build_quant_model(shallow, kind)
        outs, stats, elapsed, launches = drive_engine(
            qmodel, prompts, new_tokens, kernels=quant_kernels(kind))[1:]
        for i, (p, n, o) in enumerate(zip(prompts, new_tokens, outs)):
            ref = generate(qmodel, torch.from_numpy(p)[None].to(DEV), n)
            ref = ref[0, p.shape[0]:].cpu().numpy()
            if o.shape != ref.shape or (o != ref).any():
                raise AssertionError(f"{label}: request {i}: engine tokens "
                                     f"differ from lock-step generate")
        results[label] = dict(weights=kind, pool="fp32",
                              layers=QUANT_FP32_LAYERS,
                              requests=len(outs), token_identical=True,
                              launches=launches, seconds=elapsed, **stats)
        del qmodel
    del shallow
    for label, kv_dtype in (("kv8", "int8"), ("kv_fp8", "fp8")):
        bound = pool_error(model, prompts[0], new_tokens[0], kv_dtype)
        outs, stats, elapsed, launches = drive_engine(
            model, prompts, new_tokens, kernels=quant_kernels(None, kv_dtype),
            kv_dtype=kv_dtype)[1:]
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
        run = partial(drive_engine, qmodel, prompts, new_tokens,
                      kernels=quant_kernels(kind, "int8"), kv_dtype="int8")
        run()                                                # warm
        timed = [run()[1:] for _ in range(2)]
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


def short_run(run):
    """``run`` (a ``partial`` of ``drive_engine``) over its first
    ``NUM_SLOTS`` requests, budgets capped at ``PROFILE_BUDGET`` tokens: the
    run the engine profiles trace."""
    prompts, new_tokens = run.args[1:3]
    return partial(run.func, run.args[0], prompts[:NUM_SLOTS],
                   [min(n, PROFILE_BUDGET) for n in new_tokens[:NUM_SLOTS]],
                   *run.args[3:], **run.keywords)


def profile_quant(runs) -> None:
    """One profiled short run (``short_run``) of each quantized bf16
    configuration: device busy and idle share, each quantized kernel's
    device ms and calls seen (``op_device_ms``: the paged kernel's split
    pass and merge together), beside the timed full run's launches."""
    out = {}
    for label, (run, launches, _) in runs.items():
        wall, acts = device_profile(short_run(run), cpu=False)
        busy = sum(t for t, _ in acts.values())
        kernels = {}
        for name in QUANT_KERNELS:
            symbols = kernel_symbol(name, "bfloat16")
            op = op_device_ms(acts, (symbols,) if isinstance(symbols, str)
                              else symbols)
            kernels[name] = dict(device_ms=op["ms"],
                                 launches_seen=op["calls"],
                                 timed_run_launches=launches[name])
        top = sorted(acts.items(), key=lambda kv: -kv[1][0])[:10]
        out[label] = dict(wall_s=wall, device_busy_s=busy / 1e3,
                          device_idle_share=1.0 - busy / 1e3 / wall,
                          kernels=kernels,
                          top_device=[dict(name=k[:120], ms=t, count=c)
                                      for k, (t, c) in top])
    emit("engine_quant_bf16_profile", requests=NUM_SLOTS,
         budget_cap=PROFILE_BUDGET, runs=out)


# --- the speculative-decode and chunked-prefill phases ----------------------


def block_launches(launches) -> dict:
    return {k: launches[k] for k in BLOCK_KERNELS}


def fp64_divergence(model, prompt, got, want,
                    with_logits: bool = False) -> dict:
    """Where ``got`` first leaves ``want`` (the reference tokens), with the
    fp64 logits there: the final norm's fp32 output at the last position
    of a no-cache forward of the prompt and the reference tokens before,
    times the tied embedding in fp64; the two tokens' logits and the fp64
    top-2 margin (``with_logits``: the fp64 logits too)."""
    import numpy as np
    import torch

    n = min(len(got), len(want))
    step = next((i for i in range(n) if got[i] != want[i]), n)
    ids = torch.from_numpy(np.concatenate([prompt, want[:step]]))[None]
    hidden = {}
    hook = model.final_norm.register_forward_hook(
        lambda _m, _a, o: hidden.update(x=o))
    try:
        with torch.no_grad():
            model(ids.to(DEV))
    finally:
        hook.remove()
    logits = (hidden["x"][0, -1].double()
              @ model.word_embeddings.weight.double().T)
    top = logits.topk(2).values
    out = dict(step=int(step), lengths=[len(got), len(want)],
               fp64_top2_margin=(top[0] - top[1]).item())
    if with_logits:
        out["logits"] = logits.cpu()
    for label, toks in (("got", got), ("want", want)):
        if step < len(toks):
            out[f"{label}_token"] = int(toks[step])
            out[f"{label}_fp64_logit"] = logits[int(toks[step])].item()
    return out


def diverged_requests(model, prompts, outs, want) -> dict:
    return {i: fp64_divergence(model, p, o, r)
            for i, (p, o, r) in enumerate(zip(prompts, outs, want))
            if o.shape != r.shape or (o != r).any()}


def build_draft(dtype):
    """The unrelated draft: GPT-2-small's width, ``SPEC_DRAFT_LAYERS``
    layers, weights from its own seed."""
    import torch

    from apex_tpu_torch.models import GPTModel, gpt2_small_config

    return GPTModel(gpt2_small_config(dtype=dtype,
                                      num_layers=SPEC_DRAFT_LAYERS),
                    device=DEV, generator=torch.Generator().manual_seed(
                        SPEC_DRAFT_SEED)).eval()


def chunked_workload(vocab: int):
    """The reference bench's chunked-prefill A/B at full size
    (tpu_decode_bench.py:814-826): one long prompt, then the short ones."""
    import numpy as np

    rng = np.random.default_rng(CHUNK_SEED)
    prompts = [rng.integers(0, vocab, CHUNK_LONG).astype(np.int32)]
    prompts += [rng.integers(0, vocab, CHUNK_SHORT).astype(np.int32)
                for _ in range(CHUNK_N_SHORT)]
    return prompts, [CHUNK_NEW] * len(prompts)


def spec_fp32(model, prompts, new_tokens, fp_outs, fp_launches):
    """Two speculative engines over ``engine_fp32``'s workload, each
    token-identical to its outputs request for request: the self-draft at
    ``draft_len = 3`` (as the reference bench; mean acceptance must exceed
    1) and the unrelated 2-layer draft (rejections and rollbacks). Each
    run's ``paged_attention_block`` launches must be its verify rounds x
    layers, and ``engine_fp32`` must have launched no s > 1 branch. Then
    lock-step ``speculative_generate`` (k = 4, the unrelated draft) on two
    prompts against the same outputs."""
    import torch

    from apex_tpu_torch.models import speculative_generate

    if any(block_launches(fp_launches).values()):
        raise AssertionError(f"engine_fp32 launched an s > 1 branch: "
                             f"{block_launches(fp_launches)}")
    draft = build_draft(torch.float32)
    layers = model.config.num_layers
    runs, diverged = {}, {}
    for label, dm in (("self_draft", model), ("unrelated_draft", draft)):
        _, outs, stats, elapsed, launches = drive_engine(
            model, prompts, new_tokens, kernels=SPEC_KERNELS, draft_model=dm,
            draft_len=SPEC_DRAFT_LEN)
        diverged[label] = diverged_requests(model, prompts, outs, fp_outs)
        rounds = stats["decode_steps"]               # one verify a round
        if launches["paged_attention_block"] != rounds * layers:
            raise AssertionError(
                f"spec_fp32 {label}: {launches['paged_attention_block']} "
                f"s > 1 launches for {rounds} verify rounds x {layers}")
        runs[label] = dict(draft_layers=dm.config.num_layers,
                           token_identical=not diverged[label],
                           diverged=diverged[label], verify_rounds=rounds,
                           launches=launches, seconds=elapsed, **stats)
    if runs["self_draft"]["mean_acceptance_len"] <= 1.0:
        raise AssertionError("spec_fp32: the self-draft's mean acceptance "
                             "is not above 1")
    lockstep = {}
    for i in range(2):
        p = torch.from_numpy(prompts[i])[None].to(DEV)
        got = speculative_generate(model, draft, p, new_tokens[i], k=4)
        got = got[0, prompts[i].shape[0]:].cpu().numpy()
        lockstep[i] = bool((got == fp_outs[i]).all())
        if not lockstep[i]:
            diverged[f"speculative_generate_{i}"] = fp64_divergence(
                model, prompts[i], got, fp_outs[i])
    emit("spec_fp32", requests=len(prompts), num_slots=NUM_SLOTS,
         page_size=PAGE_SIZE, layers=layers, draft_len=SPEC_DRAFT_LEN,
         runs=runs, speculative_generate_identical=lockstep,
         engine_fp32_block_launches=block_launches(fp_launches))
    if any(diverged.values()):
        raise AssertionError(f"spec_fp32: tokens differ from engine_fp32's: "
                             f"{diverged}")


def chunked_fp32(model):
    """The chunked-prefill A/B workload through monolithic and chunked
    admission (``prefill_chunk = page_size``), fp32: token-identical request
    for request; the chunk path engaged (a chunked admission, more pieces
    than admissions) and its ``paged_attention_block`` launches are the
    pieces x layers."""
    prompts, new_tokens = chunked_workload(model.config.vocab_size)
    _, mono, mono_stats, mono_s, _ = drive_engine(model, prompts, new_tokens)
    _, outs, stats, elapsed, launches = drive_engine(
        model, prompts, new_tokens, kernels=CHUNK_KERNELS,
        prefill_chunk=PAGE_SIZE)
    diverged = diverged_requests(model, prompts, outs, mono)
    emit("chunked_fp32", requests=len(prompts), num_slots=NUM_SLOTS,
         page_size=PAGE_SIZE, prefill_chunk=PAGE_SIZE,
         layers=model.config.num_layers, long_prompt=CHUNK_LONG,
         short_prompt=CHUNK_SHORT, token_identical=not diverged,
         diverged=diverged, launches=launches, seconds=elapsed,
         monolithic_seconds=mono_s,
         monolithic_decode_steps=mono_stats["decode_steps"], **stats)
    if diverged:
        raise AssertionError(f"chunked_fp32: chunked tokens differ from "
                             f"monolithic admission's: {diverged}")
    if not stats["prefill_chunks"] > stats["chunked_prefills"] >= 1:
        raise AssertionError(f"chunked_fp32: the chunk path did not engage "
                             f"({stats['chunked_prefills']} chunked "
                             f"admissions, {stats['prefill_chunks']} pieces)")
    want = stats["prefill_chunks"] * model.config.num_layers
    if launches["paged_attention_block"] != want:
        raise AssertionError(f"chunked_fp32: {launches} s > 1 launches for "
                             f"{stats['prefill_chunks']} pieces")


def same_share(outs, want) -> float:
    return sum(bool((o.shape == r.shape) and (o == r).all())
               for o, r in zip(outs, want)) / len(want)


def spec_bf16(model, prompts, new_tokens, bf16_run, smi):
    """The self-draft speculative engine (``draft_len = 3``) over the bf16
    workload, a warm run then a timed one: tokens/s beside ``engine_bf16``'s,
    verify rounds, acceptance, host and synchronized ms per round, and the
    share of requests whose tokens match ``engine_bf16``'s (recorded, not a
    bar: bf16 near-ties). Returns the timed run's launches."""
    outs_ref, stats_ref, elapsed_ref = bf16_run
    kw = dict(kernels=SPEC_KERNELS, draft_model=model,
              draft_len=SPEC_DRAFT_LEN)
    drive_engine(model, prompts, new_tokens, **kw)               # warm
    steps = {}
    _, outs, stats, elapsed, launches = drive_engine(
        model, prompts, new_tokens, step_times=steps, **kw)
    rounds = stats["decode_steps"]
    emit("spec_bf16", requests=len(prompts), num_slots=NUM_SLOTS,
         page_size=PAGE_SIZE, draft_len=SPEC_DRAFT_LEN, self_draft=True,
         tokens_per_s=stats["generated_tokens"] / elapsed, seconds=elapsed,
         engine_bf16_tokens_per_s=stats_ref["generated_tokens"] / elapsed_ref,
         engine_bf16_decode_steps=stats_ref["decode_steps"],
         host_ms_per_round=steps["chunk_host_s"] / rounds * 1e3,
         synced_ms_per_round=steps["chunk_s"] / rounds * 1e3,
         same_tokens_as_engine_bf16=same_share(outs, outs_ref),
         launches=launches, nvidia_smi=smi, card_after=card_state(),
         **stats)
    return launches


def chunked_bf16(model, smi):
    """The chunked-prefill A/B in bf16: monolithic and chunked admission,
    each a warm run then a timed one (tokens/s, decode steps, the TTFT p50
    and p95 of the 24 short requests and of all), the share of requests
    whose tokens match, and the same chunked run over an int8 pool (its
    pieces through ``paged_attention_quant_block``). Returns the timed
    chunked runs' launches, fp and int8 pool."""
    import numpy as np

    prompts, new_tokens = chunked_workload(model.config.vocab_size)
    layers = model.config.num_layers
    runs, outs, launches = {}, {}, {}
    for label, kw in (("monolithic", {}),
                      ("chunked", dict(kernels=CHUNK_KERNELS,
                                       prefill_chunk=PAGE_SIZE)),
                      ("chunked_kv8", dict(kernels=CHUNK_KV8_KERNELS,
                                           prefill_chunk=PAGE_SIZE,
                                           kv_dtype="int8"))):
        drive_engine(model, prompts, new_tokens, **kw)           # warm
        engine, outs[label], stats, elapsed, launches[label] = drive_engine(
            model, prompts, new_tokens, **kw)
        short = engine.ttft_ms[1:]
        runs[label] = dict(
            tokens_per_s=stats["generated_tokens"] / elapsed,
            seconds=elapsed,
            short_ttft_ms_p50=float(np.percentile(short, 50)),
            short_ttft_ms_p95=float(np.percentile(short, 95)),
            long_ttft_ms=engine.ttft_ms[0],
            block_launches=block_launches(launches[label]), **stats)
        if "prefill_chunk" in kw:
            name = ("paged_attention_quant_block" if "kv_dtype" in kw
                    else "paged_attention_block")
            if launches[label][name] != stats["prefill_chunks"] * layers:
                raise AssertionError(f"chunked_bf16 {label}: "
                                     f"{launches[label][name]} {name} "
                                     f"launches for "
                                     f"{stats['prefill_chunks']} pieces")
    emit("chunked_bf16", requests=len(prompts), num_slots=NUM_SLOTS,
         page_size=PAGE_SIZE, prefill_chunk=PAGE_SIZE, long_prompt=CHUNK_LONG,
         short_prompt=CHUNK_SHORT, runs=runs,
         same_tokens_chunked_vs_monolithic=same_share(outs["chunked"],
                                                      outs["monolithic"]),
         same_tokens_kv8_vs_monolithic=same_share(outs["chunked_kv8"],
                                                  outs["monolithic"]),
         nvidia_smi=smi, card_after=card_state())
    return launches["chunked"], launches["chunked_kv8"]


def profile_spec_round(model, prompts, new_tokens) -> None:
    """One speculative round, not a whole run, under the profiler: the
    self-draft engine over the first 8 requests, round ``PROFILE_ROUND``
    (every slot busy) traced with the host's ops; its wall ms, device busy
    and idle share and the top device items."""
    from apex_tpu_torch.serving import PagedDecodeEngine, Request

    engine = PagedDecodeEngine(model, num_slots=NUM_SLOTS,
                               page_size=PAGE_SIZE, draft_model=model,
                               draft_len=SPEC_DRAFT_LEN)
    spec_round, calls, traced = engine._spec_chunk, [0], {}

    def one_round(*args):
        calls[0] += 1
        if calls[0] != PROFILE_ROUND:
            return spec_round(*args)
        result = []
        traced["wall"], traced["acts"] = device_profile(
            lambda: result.append(spec_round(*args)))
        return result[0]

    engine._spec_chunk = one_round
    engine.run([Request(p, n) for p, n in zip(prompts[:NUM_SLOTS],
                                              new_tokens[:NUM_SLOTS])])
    wall, acts = traced["wall"], traced["acts"]
    busy = sum(t for t, _ in acts.values())
    top = sorted(acts.items(), key=lambda kv: -kv[1][0])[:15]
    emit("spec_bf16_round_profile", round=PROFILE_ROUND,
         draft_len=SPEC_DRAFT_LEN, wall_ms=wall * 1e3, device_busy_ms=busy,
         device_idle_share=1.0 - busy / 1e3 / wall,
         top_device=[dict(name=k[:120], ms=t, count=c)
                     for k, (t, c) in top])


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
    RMS branch of the norm launched (``drive_engine`` has held the pool)."""
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
    outs, stats, elapsed, launches = drive_engine(
        model, prompts, new_tokens, kernels=MISTRAL_KERNELS,
        **MISTRAL_POOL)[1:]
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
    run = partial(drive_engine, model, prompts, new_tokens,
                  kernels=MISTRAL_KERNELS, **MISTRAL_POOL)
    drive_engine(model, prompts[:NUM_SLOTS],
               [min(n, 16) for n in new_tokens[:NUM_SLOTS]],
               kernels=MISTRAL_KERNELS, **MISTRAL_POOL)          # warm
    steps = {}
    outs, stats, elapsed, launches = run(step_times=steps)[1:]
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
    per_step = check_bert_launches("bert_bf16", launches, layers)
    if not all(map(math.isfinite, losses + [final])) or not final < losses[0]:
        raise AssertionError(f"bert_bf16: loss not finite and falling: "
                             f"{losses} then {final}")
    step_s = elapsed / BERT_TIMED
    rates = bert_rates(cfg, step_s, mlm_k)
    casts = cast_ops(step)
    emit("bert_bf16", batch=BERT_BATCH, seq=BERT_SEQ, layers=layers,
         hidden=cfg.hidden_size, heads=cfg.num_heads, vocab=cfg.vocab_size,
         mlm_k=mlm_k, params=sum(p.numel() for p in model.parameters()),
         segments=opt.spec.num_tensors, timed_steps=BERT_TIMED,
         **rates, peak_flops=PEAK_FLOPS["bfloat16"], losses=losses,
         loss_after=final, launches_per_step=per_step, launches=launches,
         cast_ops_per_step=casts,
         peak_memory_gib=(torch.cuda.max_memory_allocated() - live)
         / 2 ** 30, earlier_phases_live_gib=live / 2 ** 30,
         nvidia_smi=smi, card_after=card_state())
    return step, launches, dict(losses=losses, casts=casts, **rates)


def bert_train_launches(layers: int, remat: bool = False) -> dict:
    """The kernels one BERT training step launches (a LAMB step included);
    under ``remat`` each layer's forward runs again in the backward: its
    flash forward and its two LayerNorm forwards once more."""
    again = layers if remat else 0
    return {"flash_fwd": layers + again, "flash_bwd_dq": layers,
            "flash_bwd_dkdv": layers,
            "layer_norm_fwd": 2 * layers + 2 + 2 * again,
            "layer_norm_bwd": 2 * layers + 2, "xentropy_fwd": 2,
            "xentropy_bwd": 2, "segment_stats": 1, "lamb_phase1": 1,
            "lamb_phase2": 1}


def check_bert_launches(phase: str, launches, layers: int, steps: int =
                        BERT_TIMED, remat: bool = False,
                        optimizer: bool = True) -> dict:
    """``launches`` over ``steps`` steps must be ``bert_train_launches``
    a step (without ``optimizer``: no stats or LAMB launch); returns the
    launches per step."""
    want = bert_train_launches(layers, remat)
    if not optimizer:
        want.update(segment_stats=0, lamb_phase1=0, lamb_phase2=0)
    per_step = {k: launches[k] / steps for k in want}
    wrong = {k: n for k, n in per_step.items() if n != want[k]}
    if wrong:
        raise AssertionError(f"{phase}: launches per step {wrong}, want "
                             f"{want}")
    return per_step


def bert_rates(cfg, step_s: float, mlm_k: int) -> dict:
    """Step ms, tokens/s and MFU of a ``BERT_BATCH`` x ``BERT_SEQ`` step
    (bench.py's FLOPs, ``bert_flops_per_token``)."""
    tokens = BERT_BATCH * BERT_SEQ
    per_token = bert_flops_per_token(cfg, BERT_SEQ, mlm_k)
    flops = per_token * tokens
    return dict(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                flops_per_token=per_token, flops_per_step=flops,
                flops_formula="bench.py model_flops_per_token: 3 (L (8 e^2 "
                              "+ 4 S e + 4 e i) + (2 e^2 + 2 e V) K / S) per "
                              "token",
                mfu=flops / step_s / PEAK_FLOPS["bfloat16"])


def cast_ops(step) -> dict:
    """The dtype casts one call of ``step`` dispatches (``aten._to_copy``
    between floating dtypes, forward and backward): count and bytes read
    and written. One untimed step under a dispatch mode that counts; the
    casts the optimizer's O2 half copies make (``torch.where``,
    ``copy_``) are not ``_to_copy`` and are timed by their phase."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n, nbytes = 0, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func is torch.ops.aten._to_copy.default
                    and isinstance(out, torch.Tensor)
                    and out.is_floating_point()
                    and args[0].is_floating_point()
                    and out.dtype != args[0].dtype):
                self.n += 1
                self.nbytes += (out.numel() * out.element_size()
                                + args[0].numel() * args[0].element_size())
            return out

    with Count() as c:
        step()
    torch.cuda.synchronize()
    return dict(count=c.n, gb=c.nbytes / 1e9)


def half_copy_mismatches(opt):
    """0-d int64 on the card: the entries of every half copy of ``opt``
    that differ from ``master.to(dtype)`` (rows of the copy's own tensors
    only); no host read."""
    import torch

    bad = torch.zeros((), dtype=torch.int64, device=opt.master.device)
    for dt, h in opt.half.items():
        bad += ((h.params != opt.master.to(dt)) & h.rows).sum()
    return bad


def half_cast_times(opt) -> dict:
    """The two casts an O2 step adds, each by ``queued_ms`` over the bf16
    copy's whole buffer, beside its bound: the half gradients' rows into
    the fp32 gradients (``torch.where``: bf16 and fp32 read, fp32 written)
    and the master into the half copy (fp32 read, bf16 written)."""
    import torch

    h = opt.half[torch.bfloat16]
    n = opt.master.numel()
    return dict(
        grads_where_ms=queued_ms(lambda: torch.where(
            h.rows, h.grads, opt.grads, out=opt.grads), iters=10),
        grads_where_bound_ms=bound_ms(n * (2 + 4 + 4), 0, "float32")[0],
        params_copy_ms=queued_ms(lambda: h.params.copy_(opt.master),
                                 iters=10),
        params_copy_bound_ms=bound_ms(n * (4 + 2), 0, "float32")[0])


def check_o2_dtypes(phase: str, model, opt, level: str = "O2") -> dict:
    """Under O2 every floating parameter whose name is not a norm's is bf16
    and every norm's fp32, a view of the optimizer's master (O3: every
    parameter bf16); returns the counts."""
    import torch

    from apex_tpu_torch import amp

    master = opt.master
    lo = master.data_ptr()
    hi = lo + master.numel() * master.element_size()
    counts = {"bfloat16": 0, "float32": 0}
    for name, p in model.named_parameters():
        norm = level == "O2" and amp.is_norm_param_name(name)
        want = torch.float32 if norm else torch.bfloat16
        in_master = lo <= p.data_ptr() < hi
        if p.dtype != want or in_master != norm:
            raise AssertionError(f"{phase}: {name} is {p.dtype} (master "
                                 f"view: {in_master}), want {want}")
        counts[str(want).split(".")[-1]] += 1
    return counts


def timed_steps(step, warm: int, timed: int, check=None):
    """``warm`` then ``timed`` calls of ``step``, each followed by
    ``check()`` (a 0-d device count of mismatches, summed on the card);
    returns ``(losses, seconds of the timed calls, mismatches)``."""
    import torch

    from apex_tpu_torch.ops import _build

    bad = []
    losses = []
    for i in range(warm + timed):
        if i == warm:
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
        losses.append(step())
        if check is not None:
            bad.append(check())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return ([x.item() for x in losses], elapsed,
            int(sum(b.item() for b in bad)) if bad else 0)


def bert_o2_bf16(smi, ref: dict):
    """``bert_bf16``'s workload (the same seeded weights, batch and dropout
    seeds) under amp O2 with FusedLAMB: every non-norm parameter a bf16
    copy of the fp32 master, every norm fp32 (a master view); after every
    step each half copy equals ``master.to(bf16)`` bit for bit; the
    launches per step ``bert_bf16``'s; the losses finite, falling, and
    within ``O2_DRIFT`` nats of ``ref``'s (``bert_bf16``'s) at every step.
    Step ms, tokens/s, MFU beside ``bert_bf16``'s; the two half-copy casts
    timed alone (``queued_ms``) with their bound; the dtype casts a step
    dispatches beside ``bert_bf16``'s. Returns the timed steps'
    launches."""
    import torch

    from apex_tpu_torch import amp
    from apex_tpu_torch.models import (BertForPreTraining, bert_large_config,
                                       bert_pretrain_loss_fn)
    from apex_tpu_torch.ops import _build

    phase = "bert_o2_bf16"
    live = phase_memory_start()
    cfg = bert_large_config()
    model = BertForPreTraining(cfg, device=DEV,
                               generator=torch.Generator().manual_seed(SEED))
    opt = make_lamb(model, BERT_LR)
    with amp.scope():
        amp.initialize(model, opt, opt_level="O2")
        state = amp.active_state()
    dtypes = check_o2_dtypes(phase, model, opt)
    batch = bert_batch(cfg, BERT_BATCH, BERT_SEQ, DEV)
    mlm_k = batch["mlm_positions"].shape[1]
    seeds = iter(range(10 ** 9))     # the step index is the dropout seed

    def step():
        with amp.scope(state):
            opt.zero_grad()
            loss = bert_pretrain_loss_fn(model, batch, next(seeds))
            loss.backward()
            opt.step()
        return loss.detach()

    losses, elapsed, bad = timed_steps(step, BERT_WARM, BERT_TIMED,
                                       partial(half_copy_mismatches, opt))
    launches = dict(_build.launches)
    per_step = check_bert_launches(phase, launches, cfg.num_layers)
    with torch.no_grad(), amp.scope(state):
        final = bert_pretrain_loss_fn(model, batch, 0).item()
    if bad:
        raise AssertionError(f"{phase}: {bad} half-copy entries differ from "
                             f"master.to(bf16)")
    drift = max(abs(a - b) for a, b in zip(losses, ref["losses"]))
    if (not all(map(math.isfinite, losses + [final]))
            or not final < losses[0] or drift > O2_DRIFT):
        raise AssertionError(f"{phase}: losses {losses} then {final}, "
                             f"drift {drift} from bert_bf16's "
                             f"{ref['losses']} (bar {O2_DRIFT})")
    half_casts = half_cast_times(opt)
    casts = cast_ops(step)
    rates = bert_rates(cfg, elapsed / BERT_TIMED, mlm_k)
    emit(phase, batch=BERT_BATCH, seq=BERT_SEQ, layers=cfg.num_layers,
         params_by_dtype=dtypes, timed_steps=BERT_TIMED, **rates,
         bert_bf16={k: ref[k] for k in ("step_ms", "tokens_per_s", "mfu")},
         losses=losses, losses_bert_bf16=ref["losses"], loss_after=final,
         max_loss_drift=drift, drift_bar=O2_DRIFT,
         half_copy_mismatches=bad, launches_per_step=per_step,
         launches=launches,
         half_casts=half_casts, cast_ops_per_step=casts, cast_ops_per_step_bert_bf16=ref["casts"],
         peak_memory_gib=(torch.cuda.max_memory_allocated() - live)
         / 2 ** 30, nvidia_smi=smi, card_after=card_state())
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def bert_remat_bf16(smi) -> dict:
    """BERT-Large at full width (``BERT_REMAT_LAYERS`` deep), bf16 compute,
    hidden and attention dropout 0.1, ``bench.py``'s 8 x 512 batch: one
    forward and backward with ``remat`` off and one with it on, the same
    weights, batch and dropout seed. The loss and every gradient must be
    bit-equal (the recompute replays each layer's dropout generator;
    attention dropout is counter-based); the peak memory above the weights
    and gradients lower with remat; then ``BERT_REMAT_TIMED`` timed
    forward-backward steps each (no optimizer). Returns the launches of
    remat's timed steps."""
    import torch

    from apex_tpu_torch.models import (BertForPreTraining, bert_large_config,
                                       bert_pretrain_loss_fn)
    from apex_tpu_torch.ops import _build

    phase = "bert_remat_bf16"
    cfg = bert_large_config(num_layers=BERT_REMAT_LAYERS)
    model = BertForPreTraining(cfg, device=DEV,
                               generator=torch.Generator().manual_seed(SEED))
    batch = bert_batch(cfg, BERT_BATCH, BERT_SEQ, DEV)
    for p in model.parameters():        # in the base of both peaks
        p.grad = torch.zeros_like(p)
    runs = {}
    for remat in (False, True):
        set_config(model, dataclasses.replace(cfg, remat=remat))
        model.zero_grad(set_to_none=False)
        base = phase_memory_start()
        _build.reset_launches()
        loss = bert_pretrain_loss_fn(model, batch, SEED)
        loss.backward()
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        peak = torch.cuda.max_memory_allocated() - base
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}

        def step():
            model.zero_grad(set_to_none=False)
            loss = bert_pretrain_loss_fn(model, batch, SEED + 1)
            loss.backward()
            return loss.detach()

        _, elapsed, _ = timed_steps(step, 0, BERT_REMAT_TIMED)
        runs[remat] = dict(loss=loss.item(), grads=grads, peak=peak,
                           step_ms=elapsed / BERT_REMAT_TIMED * 1e3,
                           launches=launches,
                           launches_timed=dict(_build.launches))
    off, on = runs[False], runs[True]
    for remat, run in runs.items():
        check_bert_launches(phase, run["launches"], cfg.num_layers, 1,
                            remat=remat, optimizer=False)
    unequal = [n for n, g in off["grads"].items()
               if not torch.equal(g, on["grads"][n])]
    if off["loss"] != on["loss"] or unequal:
        raise AssertionError(f"{phase}: remat loss {on['loss']} against "
                             f"{off['loss']}; {len(unequal)} gradients not "
                             f"bit-equal, e.g. {unequal[:3]}")
    if not on["peak"] < off["peak"]:
        raise AssertionError(f"{phase}: peak memory with remat "
                             f"{on['peak']} not below {off['peak']}")
    emit(phase, batch=BERT_BATCH, seq=BERT_SEQ, layers=cfg.num_layers,
         layers_cut_from=24, hidden=cfg.hidden_size,
         hidden_dropout=cfg.hidden_dropout,
         attention_dropout=cfg.attention_dropout, loss=on["loss"],
         loss_bit_equal=True, grads_bit_equal=len(off["grads"]),
         peak_gib=off["peak"] / 2 ** 30, peak_gib_remat=on["peak"] / 2 ** 30,
         fwd_bwd_ms=off["step_ms"], fwd_bwd_ms_remat=on["step_ms"],
         timed_steps=BERT_REMAT_TIMED,
         launches_per_step=off["launches"],
         launches_per_step_remat=on["launches"], nvidia_smi=smi)
    timed = on["launches_timed"]
    del model, runs, off, on
    gc.collect()
    torch.cuda.empty_cache()
    return timed


# --- BASELINE configs #3 and #5: the NMT Transformer, ASP 2:4 BERT --------


def nmt_launches(layers: int, optimizer: bool = True) -> dict:
    """Launches of one NMT forward and backward (and ``optimizer``: its
    FusedAdam step): the encoder's self and the decoder's cross attention
    without a bias, the decoder's causal mask as an additive bias; per
    encoder layer 2 norms, per decoder layer 3, and the two final norms."""
    return {"flash_fwd": 2 * layers, "flash_fwd_bias": layers,
            "flash_bwd_dq": 2 * layers, "flash_bwd_dq_bias": layers,
            "flash_bwd_dkdv": 2 * layers, "flash_bwd_dkdv_bias": layers,
            "layer_norm_fwd": 5 * layers + 2,
            "layer_norm_bwd": 5 * layers + 2, "xentropy_fwd": 1,
            "xentropy_bwd": 1, "adam": int(optimizer)}


def nmt_bound(cfg: dict, batch: int, seq: int) -> dict:
    """The least time of one NMT training step from the widths, forward
    and backward at 3x the forward's products: the fp32 GEMMs (the FFN's
    two on every token of each side, the tied projection on the targets)
    over the fp32 peak, the bf16 ones (the attention projections: 4 e^2
    per token of each self attention, q and out on the targets and k, v on
    the sources of the cross attention) and the flash cores (4 B H S^2 d
    forward, 3.5x that with the backward's recompute, 3 L calls) over the
    bf16 peak."""
    e, f, v, layers = (cfg["embed_dim"], cfg["ffn_dim"], cfg["vocab_size"],
                       cfg["num_layers"])
    tokens = batch * seq
    fp32 = 3 * (4 * e * f * layers * 2 * tokens + 2 * e * v * tokens)
    proj = 3 * 2 * 12 * e * e * layers * tokens
    cores = 3 * layers * 14 * batch * cfg["num_heads"] * seq * seq * (
        e // cfg["num_heads"])
    ms = (fp32 / PEAK_FLOPS["float32"]
          + (proj + cores) / PEAK_FLOPS["bfloat16"]) * 1e3
    return dict(bound_ms=ms, fp32_gemm_flops=fp32, bf16_gemm_flops=proj,
                flash_flops=cores,
                bound_formula="3 (4 e f 2 L B S + 2 e V B S) / 67e12 + (3 "
                              "24 e^2 L B S + 3 L 14 B H S^2 d) / 989e12")


def nmt_model(cfg: dict, dev):
    from apex_tpu_torch.examples.nmt import main as nmt

    import torch

    return nmt.NMTTransformer(**cfg, device=dev, dropout_seed=SEED,
                              generator=torch.Generator().manual_seed(SEED))


def nmt_side(cfg: dict, dev) -> dict:
    """One side of ``nmt_fp32``: the loss and gradients of the first
    batch, then three FusedAdam steps (the first on those gradients) and
    the loss after them, dropout off."""
    import numpy as np
    import torch

    from apex_tpu_torch.examples.nmt import main as nmt
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import FusedAdam

    model = nmt_model(cfg, dev)
    rng = np.random.default_rng(SEED)
    batches = [nmt.synthetic_copy_batch(rng, NMT_FP32_BATCH, NMT_FP32_SEQ,
                                        cfg["vocab_size"], dev)
               for _ in range(NMT_FP32_STEPS + 1)]
    if dev != "cpu":
        torch.cuda.synchronize()
    _build.reset_launches()
    loss = nmt.nmt_loss(model, *batches[0], label_smoothing=NMT_LS)
    loss.backward()
    launches = dict(_build.launches)
    grads = {n: p.grad.detach().cpu().clone()
             for n, p in model.named_parameters()}
    losses = [loss.item()]
    opt = FusedAdam(model.named_parameters(), lr=NMT_LR)  # keeps the grads
    opt.step()
    for batch in batches[1:NMT_FP32_STEPS]:
        losses.append(nmt.train_step(model, opt, batch, NMT_LS).item())
    with torch.no_grad():
        losses.append(nmt.nmt_loss(model, *batches[NMT_FP32_STEPS],
                                   label_smoothing=NMT_LS,
                                   train=False).item())
    return dict(losses=losses, grads=grads, launches=launches,
                adam=_build.launches["adam"])


def nmt_fp32() -> None:
    """Card against CPU at Transformer-big's widths, 2 + 2 layers, with
    attention dropout; then the example's ``run_training`` on the card
    against its first steps on the CPU."""
    from apex_tpu_torch.examples.nmt import main as nmt

    cfg = dict(NMT_BIG, num_layers=NMT_FP32_LAYERS)
    card = nmt_side(cfg, DEV)
    cpu = nmt_side(cfg, "cpu")
    check_launches("nmt_fp32", card["launches"],
                   nmt_launches(NMT_FP32_LAYERS, optimizer=False))
    if card["adam"] != NMT_FP32_STEPS:
        raise AssertionError(f"nmt_fp32: {card['adam']} adam launches, want "
                             f"{NMT_FP32_STEPS}")
    grad_err = 0.0
    for n, g in card["grads"].items():
        grad_err = max(grad_err, compare(f"nmt_fp32 grad {n}", g,
                                         cpu["grads"][n], "float32",
                                         (1e-4, 1e-3)))
    for i, (a, b) in enumerate(zip(card["losses"], cpu["losses"])):
        if abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"nmt_fp32: loss {i} differs: card {a} "
                                 f"vs CPU {b}")
    quiet = lambda *a: None                              # noqa: E731
    example = nmt.run_training(**NMT_EXAMPLE, device=DEV, verbose=quiet,
                               seed=SEED)
    first = nmt.run_training(**dict(NMT_EXAMPLE, steps=3), device="cpu",
                             verbose=quiet, seed=SEED)
    for i, (a, b) in enumerate(zip(example, first)):
        if abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"nmt_fp32: run_training loss {i} differs: "
                                 f"card {a} vs CPU {b}")
    if not all(map(math.isfinite, example)) or not example[-1] < example[0]:
        raise AssertionError(f"nmt_fp32: run_training's loss not finite "
                             f"and falling: {example}")
    emit("nmt_fp32", batch=NMT_FP32_BATCH, seq=NMT_FP32_SEQ,
         layers=NMT_FP32_LAYERS, layers_cut_from=NMT_BIG["num_layers"],
         depth_cut="the CPU side's fp32 forward, backward and Adam steps",
         embed_dim=cfg["embed_dim"], heads=cfg["num_heads"],
         ffn_dim=cfg["ffn_dim"], vocab=cfg["vocab_size"],
         attention_dropout=cfg["dropout"], label_smoothing=NMT_LS,
         adam_lr=NMT_LR, losses_card=card["losses"],
         losses_cpu=cpu["losses"], max_grad_abs_err=grad_err,
         params_with_grad=len(card["grads"]), launches=card["launches"],
         run_training=dict(NMT_EXAMPLE, losses=example,
                           cpu_first_losses=first))


def nmt_grads(model, opt, batch, amp_state) -> dict:
    """The gradients of one loss on ``batch`` under ``amp_state``, by
    parameter name, without a step: the model's dropout generator is put
    back, so the steps after draw the seeds they would have drawn."""
    import torch

    from apex_tpu_torch import amp
    from apex_tpu_torch.examples.nmt import main as nmt

    seeds = model.dropout_generator.get_state()
    with amp.scope(amp_state):
        opt.zero_grad()
        nmt.nmt_loss(model, *batch, label_smoothing=NMT_LS).backward()
    model.dropout_generator.set_state(seeds)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    opt.zero_grad()
    torch.cuda.synchronize()
    return grads


def nmt_grad_rel(got: dict, want: dict) -> dict:
    """``|got - want| / |want|`` (2-norms) of each parameter's gradient."""
    return {n: ((got[n] - w).norm() / w.norm()).item()
            for n, w in want.items()}


@contextlib.contextmanager
def nmt_bias_dropped():
    """The multihead_attn core's flash calls with a bf16 q lose their
    bias: a bf16 path that ignores the fp32 mask, for the control."""
    import torch

    core = importlib.import_module(
        "apex_tpu_torch.contrib.multihead_attn._core")
    real = core.flash_attention

    def dropped(q, k, v, bias=None, **kw):
        return real(q, k, v, bias=None if q.dtype == torch.bfloat16
                    else bias, **kw)

    core.flash_attention = dropped
    try:
        yield
    finally:
        core.flash_attention = real


def nmt_bf16(smi):
    """Transformer-big uncut under amp O1 bf16: the first batch's
    gradients against an fp32 witness's (and a control's), warm steps,
    timed steps with exact launches per step, the step against its bound,
    the witness's losses on the same batches, then one profiled step by
    class. Returns the timed steps' launches."""
    import numpy as np
    import torch

    from apex_tpu_torch import amp
    from apex_tpu_torch.examples.nmt import main as nmt
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import FusedAdam

    live = phase_memory_start()
    model = nmt_model(NMT_BIG, DEV)
    opt = FusedAdam(model.named_parameters(), lr=NMT_LR)
    with amp.scope():
        amp.initialize(model, opt, opt_level="O1",
                       half_dtype=torch.bfloat16)
        state = amp.active_state()
    rng = np.random.default_rng(SEED)
    data = [nmt.synthetic_copy_batch(rng, NMT_BATCH, NMT_SEQ,
                                     NMT_BIG["vocab_size"], DEV)
            for _ in range(NMT_WARM + NMT_TIMED)]
    batches = itertools.cycle(data)

    def step():
        with amp.scope(state):
            return nmt.train_step(model, opt, next(batches), NMT_LS)

    def eval_loss(amp_state=state):
        """The first batch's loss, dropout off, under ``amp_state``."""
        with amp.scope(amp_state), torch.no_grad():
            return nmt.nmt_loss(model, *data[0], label_smoothing=NMT_LS,
                                train=False).item()

    # the O1 forward against the same weights in fp32 (amp off): the
    # attention modules' bf16 GEMMs and flash kernels round to 2^-9
    first, first_fp32 = eval_loss(), eval_loss((None, ()))
    if not abs(first - first_fp32) <= NMT_O1_REL * abs(first_fp32):
        raise AssertionError(f"nmt_bf16: the O1 loss {first} is not within "
                             f"{NMT_O1_REL} of the fp32 loss {first_fp32}")
    # the fp32 witness: the same weights, amp off, its own optimizer; the
    # first batch's gradients of both, and of the O1 model with the bf16
    # flash calls' bias dropped (the control the bar must reject)
    witness = nmt_model(NMT_BIG, DEV)
    wopt = FusedAdam(witness.named_parameters(), lr=NMT_LR)
    want = nmt_grads(witness, wopt, data[0], (None, ()))
    grad_rel = nmt_grad_rel(nmt_grads(model, opt, data[0], state), want)
    with nmt_bias_dropped():
        control_rel = nmt_grad_rel(nmt_grads(model, opt, data[0], state),
                                   want)
    worst, control = max(grad_rel.values()), max(control_rel.values())
    if not worst <= NMT_O1_GRAD_REL < control:
        raise AssertionError(
            f"nmt_bf16: the O1 gradients' largest relative error against "
            f"fp32 is {worst:.3e} ({max(grad_rel, key=grad_rel.get)}), the "
            f"control's (bf16 bias dropped) {control:.3e}; the bar "
            f"{NMT_O1_GRAD_REL} must lie between them")
    losses = [step() for _ in range(NMT_WARM)]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    losses += [step() for _ in range(NMT_TIMED)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(_build.launches)
    check_launches("nmt_bf16", launches,
                   nmt_launches(NMT_BIG["num_layers"]), per=NMT_TIMED)
    losses = [x.item() for x in losses]
    final = eval_loss()
    if not all(map(math.isfinite, losses + [final])):
        raise AssertionError(f"nmt_bf16: loss not finite: {losses}, then "
                             f"{final}")
    # the witness takes the same steps on the same batches (its dropout
    # seeds drawn in the same order); O1's losses held to its own
    witness_losses = [nmt.train_step(witness, wopt, b, NMT_LS).item()
                      for b in data]
    with torch.no_grad():
        witness_final = nmt.nmt_loss(witness, *data[0],
                                     label_smoothing=NMT_LS,
                                     train=False).item()
    del witness, wopt, want
    for i, (a, b) in enumerate(zip(losses, witness_losses)):
        if not abs(a - b) <= NMT_O1_REL * abs(b):
            raise AssertionError(f"nmt_bf16: step {i}'s O1 loss {a} is not "
                                 f"within {NMT_O1_REL} of fp32's {b}")
    step_s = elapsed / NMT_TIMED
    bound = nmt_bound(NMT_BIG, NMT_BATCH, NMT_SEQ)
    emit("nmt_bf16", batch=NMT_BATCH, src_tokens=NMT_SEQ,
         tgt_tokens=NMT_SEQ, **NMT_BIG, label_smoothing=NMT_LS,
         parameters=sum(p.numel() for p in model.parameters()),
         timed_steps=NMT_TIMED, step_ms=step_s * 1e3,
         tokens_per_s=NMT_BATCH * NMT_SEQ / step_s, **bound,
         bound_share=bound["bound_ms"] / (step_s * 1e3),
         first_batch_loss_before=first,
         first_batch_loss_before_fp32=first_fp32,
         first_batch_loss_after=final,
         first_batch_loss_after_fp32=witness_final,
         grad_rel_max=worst, grad_rel_bar=NMT_O1_GRAD_REL,
         grad_rel_by_tensor=grad_rel, control_grad_rel_max=control,
         control="the bf16 flash calls' fp32 bias dropped",
         losses=losses, losses_fp32=witness_losses, launches_per_step={k: launches[k] / NMT_TIMED
                            for k in NMT_KERNELS}, launches=launches,
         peak_memory_gib=(torch.cuda.max_memory_allocated() - live)
         / 2 ** 30, earlier_phases_live_gib=live / 2 ** 30,
         nvidia_smi=smi, card_after=card_state())
    wall, acts = device_profile(step)
    busy = sum(t for t, _ in acts.values())
    by_class = {}
    for k, (t, _) in acts.items():
        low = k.lower()
        cls = next((c for c, frags in NMT_KERNEL_CLASSES
                    if any(f in low for f in frags)), "other")
        if cls == "gemm":
            cls = ("gemm_fp32" if any(f in low for f in NMT_FP32_GEMM)
                   else "gemm_half")
        by_class[cls] = by_class.get(cls, 0.0) + t
    top = sorted(acts.items(), key=lambda kv: -kv[1][0])[:20]
    emit("nmt_bf16_profile", wall_s=wall, device_busy_s=busy / 1e3,
         device_idle_share=1.0 - busy / 1e3 / wall if wall else None,
         device_ms_by_class=by_class,
         top_device=[dict(name=k[:120], ms=t, count=c)
                     for k, (t, c) in top])
    del model, opt, step, batches, data
    gc.collect()        # the later phases need this phase's room at once
    torch.cuda.empty_cache()
    return launches


def pruned_flat(opt, masks):
    """1 where a weight is pruned and 0 elsewhere, fp32, in ``opt``'s flat
    layout: built here from the masks, apart from ASP's own."""
    import torch

    from apex_tpu_torch.ops import flat_buffer

    flat = torch.zeros_like(opt.master)
    views = flat_buffer.unflatten(flat, opt.spec)
    for name, mask in masks.items():
        views[name].copy_(~mask)
    return flat


def asp_check_masks(phase: str, masks) -> None:
    """Every mask 2:4 along the last dimension."""
    bad = [n for n, m in masks.items()
           if not bool((m.reshape(-1, 4).sum(-1) == 2).all())]
    if bad or not masks:
        raise AssertionError(f"{phase}: masks not 2:4: {bad or 'none'}")


def asp_optimizer(model, lr: float):
    from apex_tpu_torch.optimizers import FusedAdam

    return FusedAdam(model.named_parameters(), lr=lr, weight_decay=BERT_WD,
                     exclude_from_weight_decay=bert_no_decay)


def asp_side(cfg, dev) -> dict:
    """One side of ``asp_bert_fp32``: ``prune_trained_model`` on the
    seeded model, the loss and gradients of step 0, then three masked
    FusedAdam steps (the pruned weights' largest |value| after each) and a
    loss after them."""
    import torch

    from apex_tpu_torch.contrib.sparsity import ASP
    from apex_tpu_torch.models import BertForPreTraining, bert_pretrain_loss_fn
    from apex_tpu_torch.ops import _build

    model = BertForPreTraining(cfg, device=dev,
                               generator=torch.Generator().manual_seed(SEED))
    batch = bert_batch(cfg, BERT_FP32_BATCH, BERT_FP32_SEQ, dev,
                       pad_tail=BERT_FP32_SEQ // 4)
    opt = asp_optimizer(model, BERT_FP32_LR)
    ASP.prune_trained_model(model, opt)
    masks = ASP.masks()
    pruned = pruned_flat(opt, masks)
    _build.reset_launches()
    losses, left = [], []
    grads = None
    for i in range(3):
        opt.zero_grad()
        loss = bert_pretrain_loss_fn(model, batch, SEED + i)
        loss.backward()
        if grads is None:
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in model.named_parameters()}
        opt.step()
        losses.append(loss.item())
        left.append((opt.master * pruned).abs().max().item())
    launches = dict(_build.launches)
    with torch.no_grad():
        losses.append(bert_pretrain_loss_fn(model, batch, SEED + 3).item())
    out = dict(losses=losses, grads=grads, left=left,
               masks={n: m.cpu() for n, m in masks.items()},
               launches=launches)
    ASP.reset()
    return out


def asp_bert_fp32() -> None:
    """ASP on ``bert_fp32``'s cut, card against CPU: masks bit-equal,
    ``bert_fp32``'s bars over three masked FusedAdam steps, every pruned
    weight exactly 0 after every step on both sides."""
    import torch

    from apex_tpu_torch.models import bert_large_config

    cfg = bert_large_config(num_layers=BERT_FP32_LAYERS, dtype=torch.float32,
                            hidden_dropout=0.0,
                            attention_dropout=BERT_DROPOUT)
    card = asp_side(cfg, DEV)
    cpu = asp_side(cfg, "cpu")
    asp_check_masks("asp_bert_fp32", card["masks"])
    if card["masks"].keys() != cpu["masks"].keys() or any(
            not torch.equal(m, cpu["masks"][n])
            for n, m in card["masks"].items()):
        raise AssertionError("asp_bert_fp32: masks differ between card and "
                             "CPU")
    if any(card["left"]) or any(cpu["left"]):
        raise AssertionError(f"asp_bert_fp32: pruned weights not 0 after a "
                             f"step: card {card['left']}, CPU {cpu['left']}")
    grad_err = 0.0
    for n, g in card["grads"].items():
        grad_err = max(grad_err, compare(f"asp_bert_fp32 grad {n}", g,
                                         cpu["grads"][n], "float32",
                                         (1e-4, 1e-3)))
    for i, (a, b) in enumerate(zip(card["losses"], cpu["losses"])):
        if abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"asp_bert_fp32: loss {i} differs: card {a} "
                                 f"vs CPU {b}")
    want = {"flash_fwd": 3 * cfg.num_layers, "adam": 3, "lamb_phase1": 0,
            "segment_stats": 0}
    check_launches("asp_bert_fp32", card["launches"], want)
    emit("asp_bert_fp32", batch=BERT_FP32_BATCH, seq=BERT_FP32_SEQ,
         layers=cfg.num_layers, layers_cut_from=24, adam_lr=BERT_FP32_LR,
         pruned_tensors=len(card["masks"]),
         pruned_weights=sum(int((~m).sum()) for m in card["masks"].values()),
         masks_bit_equal=True, losses_card=card["losses"],
         losses_cpu=cpu["losses"], max_grad_abs_err=grad_err,
         pruned_max_abs_after_steps=card["left"], launches=card["launches"])


def asp_bert_bf16(smi):
    """BERT-Large uncut at ``bert_bf16``'s batch, ``prune_trained_model``
    with FusedAdam: warm and timed masked steps (every pruned weight 0
    after each), exact launches per step; then the hook's cost: steps
    with and without it (the optimizer's own ``step``) in turns A, B, B, A,
    ``ASP_AB_ROUNDS`` times, one profiled step of each, and the hook's two
    multiplies by ``queued_ms``. Returns the timed masked steps'
    launches."""
    import torch

    from apex_tpu_torch.contrib.sparsity import ASP
    from apex_tpu_torch.models import (BertForPreTraining, bert_large_config,
                                       bert_pretrain_loss_fn)
    from apex_tpu_torch.ops import _build

    live = phase_memory_start()
    cfg = bert_large_config()
    model = BertForPreTraining(cfg, device=DEV,
                               generator=torch.Generator().manual_seed(SEED))
    opt = asp_optimizer(model, BERT_LR)
    own_step = opt.step
    batch = bert_batch(cfg, BERT_BATCH, BERT_SEQ, DEV)
    ASP.prune_trained_model(model, opt)
    hooked_step = opt.step
    masks = ASP.masks()
    asp_check_masks("asp_bert_bf16", masks)
    pruned = pruned_flat(opt, masks)
    seeds = iter(range(10 ** 9))

    def step(update=hooked_step):
        opt.zero_grad()
        loss = bert_pretrain_loss_fn(model, batch, next(seeds))
        loss.backward()
        update()
        return loss.detach(), (opt.master * pruned).abs().amax()

    def timed(n, update=hooked_step):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = [step(update) for _ in range(n)]
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / n, dict(_build.launches)

    warm = [step() for _ in range(BERT_WARM)]
    run, step_s, launches = timed(BERT_TIMED)
    left = [float(x) for _, x in warm + run]
    if any(left):
        raise AssertionError(f"asp_bert_bf16: pruned weights not 0 after a "
                             f"step: {left}")
    layers = cfg.num_layers
    check_launches("asp_bert_bf16", launches, {
        "flash_fwd": layers, "flash_bwd_dq": layers,
        "flash_bwd_dkdv": layers, "layer_norm_fwd": 2 * layers + 2,
        "layer_norm_bwd": 2 * layers + 2, "xentropy_fwd": 2,
        "xentropy_bwd": 2, "adam": 1, "segment_stats": 0, "lamb_phase1": 0,
        "lamb_phase2": 0}, per=BERT_TIMED)
    losses = [float(x) for x, _ in warm + run]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"asp_bert_bf16: loss not finite and falling: "
                             f"{losses}")
    keep = 1.0 - pruned
    hook_ms = queued_ms(lambda: (opt.grads.mul_(keep), opt.master.mul_(keep)),
                        iters=20)
    turns = {"hook": [], "own": []}
    for _ in range(ASP_AB_ROUNDS):
        for name in ("hook", "own", "own", "hook"):
            turns[name].append(timed(ASP_AB_STEPS, hooked_step if name ==
                                     "hook" else own_step)[1] * 1e3)
    profiles = {}
    for name, update in (("hook", hooked_step), ("own", own_step)):
        wall, acts = device_profile(partial(step, update))
        profiles[name] = dict(wall_ms=wall * 1e3, device_busy_ms=sum(
            t for t, _ in acts.values()))
    ASP.reset()
    tokens = BERT_BATCH * BERT_SEQ
    emit("asp_bert_bf16", batch=BERT_BATCH, seq=BERT_SEQ, layers=layers,
         pruned_tensors=len(masks),
         pruned_weights=sum(int((~m).sum()) for m in masks.values()),
         params=sum(p.numel() for p in model.parameters()),
         timed_steps=BERT_TIMED, step_ms=step_s * 1e3,
         tokens_per_s=tokens / step_s, ab_step_ms=turns,
         hook_cost_ms=(sum(turns["hook"]) - sum(turns["own"]))
         / len(turns["hook"]), hook_multiplies_ms=hook_ms,
         hook_bytes=3 * 2 * opt.master.numel() * 4, profiled_step=profiles,
         losses=losses, pruned_max_abs_after_steps=left,
         launches_per_step={k: launches[k] / BERT_TIMED
                            for k in BERT_KERNELS + ("adam",)},
         launches=launches,
         peak_memory_gib=(torch.cuda.max_memory_allocated() - live)
         / 2 ** 30, earlier_phases_live_gib=live / 2 ** 30,
         nvidia_smi=smi, card_after=card_state())
    del model, opt, step, masks, pruned, keep, own_step, hooked_step
    gc.collect()        # the later phases need this phase's room at once
    torch.cuda.empty_cache()
    return launches


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


# --- the T5 slice: t5-small served and trained -----------------------------


def build_t5(dtype, device=None):
    """t5-small (the JAX package's own ``T5Config()``) at full width, its
    parameters in fp32 and its compute in ``dtype``, seeded random weights
    drawn on ``device`` (the card by default)."""
    import torch

    from apex_tpu_torch.models import T5Config, T5Model

    device = device or DEV
    gen = torch.Generator(device=device).manual_seed(SEED)
    return T5Model(T5Config(dtype=dtype, param_dtype=torch.float32),
                   device=device, generator=gen)


def t5_requests(vocab: int):
    """``T5_BATCH`` encoder inputs of ``T5_ENC_SEQ`` tokens, uniform over
    the vocabulary (numpy seed ``T5_SEED``)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(T5_SEED)
    return torch.from_numpy(rng.integers(0, vocab, (T5_BATCH, T5_ENC_SEQ))
                            .astype(np.int32))


def t5_generate_launches(cfg, new_tokens: int) -> dict:
    """Exact launches of one ``t5_generate``: the encoder's L biased
    self-attentions and 2L + 1 norms; each of the ``new_tokens`` decode
    calls (the start token's, then the steps) L cross-attentions and 3L +
    1 norms (the decoder's self-attention is the dense cached path)."""
    layers = cfg.num_layers
    want = {k: 0 for k in KERNEL_SYMBOLS}
    want.update(flash_fwd_bias=layers, flash_fwd=layers * new_tokens,
                rms_norm_fwd=2 * layers + 1 + (3 * layers + 1) * new_tokens)
    return want


def t5_train_launches(cfg) -> dict:
    """Exact launches of one T5 training step: every norm forward and
    backward, the encoder's and decoder's biased self-attentions and the
    cross-attentions, forward, dq and dk/dv, and one Adam."""
    layers = cfg.num_layers
    norms = 5 * layers + 2
    want = {k: 0 for k in KERNEL_SYMBOLS}
    want.update(rms_norm_fwd=norms, rms_norm_bwd=norms,
                flash_fwd_bias=2 * layers, flash_bwd_dq_bias=2 * layers,
                flash_bwd_dkdv_bias=2 * layers, flash_fwd=layers,
                flash_bwd_dq=layers, flash_bwd_dkdv=layers, adam=1)
    return want


def check_launches(phase: str, launches, want, per: float = 1.0) -> None:
    got = {k: launches[k] / per for k in want}
    wrong = {k: n for k, n in got.items() if n != want[k]}
    if wrong:
        raise AssertionError(f"{phase}: launches {wrong}, want "
                             f"{ {k: want[k] for k in wrong} }")


def t5_divergence(model, enc, got, want) -> dict:
    """Where ``got`` first leaves ``want`` (one row's tokens), with the
    fp64 logits there: the decoder's final-norm fp32 output at that
    position of a teacher-forced forward of the start token and ``want``
    before it, times the head in fp64; the two tokens' logits and the fp64
    top-2 margin."""
    import numpy as np
    import torch

    cfg = model.config
    n = min(len(got), len(want))
    step = next((i for i in range(n) if got[i] != want[i]), n)
    ids = np.concatenate([[cfg.decoder_start_token_id], want[:step]])
    hidden = {}
    hook = model.dec_final_norm.register_forward_hook(
        lambda _m, _a, o: hidden.update(x=o))
    try:
        with torch.no_grad():
            model.decode(torch.from_numpy(ids.astype(np.int32))[None].to(DEV),
                         enc[None])
    finally:
        hook.remove()
    x = hidden["x"][0, -1].double()
    head = model.shared.weight if model.lm_head is None \
        else model.lm_head.weight
    if model.lm_head is None:
        x = x * cfg.d_model ** -0.5
    logits = x @ head.double().T
    top = logits.topk(2).values
    out = dict(step=int(step), fp64_top2_margin=(top[0] - top[1]).item())
    for label, toks in (("got", got), ("want", want)):
        if step < len(toks):
            out[f"{label}_token"] = int(toks[step])
            out[f"{label}_fp64_logit"] = logits[int(toks[step])].item()
    return out


def t5_fp32():
    """The serving bar: t5-small at full width in fp32 on the card,
    ``t5_generate`` of ``T5_NEW_FP32`` tokens for ``T5_BATCH`` requests of
    ``T5_ENC_SEQ`` tokens, token-identical to the greedy teacher-forced
    re-derivation on the card (the contract of
    ``tests/test_t5_model.py:119-136``: one fixed-shape teacher-forced
    decode per position, its argmax written into the next); else each
    diverging row's fp64 margin is printed and the phase fails. The launches
    are exact; the bucket tables the card computes equal the CPU's exactly;
    the encoder output and the first step's logits agree with the port on
    the CPU within ``T5_FLOOR_FACTOR`` times the CPU's floor (the largest
    change one rounding of every parameter makes there)."""
    import numpy as np
    import torch

    from apex_tpu_torch.models import t5_generate
    from apex_tpu_torch.models.generation import init_cache
    from apex_tpu_torch.ops import _build

    model = build_t5(torch.float32)
    cfg, n_new = model.config, T5_NEW_FP32
    enc_ids = t5_requests(cfg.vocab_size)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    toks = t5_generate(model, enc_ids.to(DEV), n_new)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.launches)
    check_launches("t5_fp32", launches, t5_generate_launches(cfg, n_new))
    toks = toks.cpu().numpy()

    with torch.no_grad():
        enc = model.encode(enc_ids.to(DEV))
        dec = torch.full((T5_BATCH, n_new + 1), cfg.decoder_start_token_id,
                         dtype=torch.int32, device=DEV)
        for t in range(1, n_new + 1):
            dec[:, t] = model.decode(dec, enc)[:, t - 1].float().argmax(-1)
    want = dec[:, 1:].cpu().numpy()
    diverged = {i: t5_divergence(model, enc[i], toks[i], want[i])
                for i in range(T5_BATCH) if (toks[i] != want[i]).any()}
    if diverged:
        emit("t5_fp32_divergence", rows=diverged)
        raise AssertionError(f"t5_fp32: t5_generate differs from the "
                             f"teacher-forced re-derivation in rows "
                             f"{sorted(diverged)}")

    # the card against the port on the CPU: the bucket tables, exactly;
    # the encoder output and the first step's logits
    cpu = build_t5(torch.float32, device="cpu")
    cpu.load_state_dict(model.state_dict())
    buckets = {}
    for name, n in (("enc_rel_bias", T5_ENC_SEQ), ("dec_rel_bias",
                                                   n_new + 1)):
        pos = torch.arange(n)
        card_b = getattr(model, name).buckets(pos.to(DEV), pos.to(DEV))
        cpu_b = getattr(cpu, name).buckets(pos, pos)
        if not torch.equal(card_b.cpu(), cpu_b):
            bad = int((card_b.cpu() != cpu_b).sum())
            raise AssertionError(f"t5_fp32: {name} buckets differ from the "
                                 f"CPU's at {bad} pairs")
        buckets[name] = dict(pairs=n * n, distinct=int(cpu_b.unique().numel()))
    start = torch.full((T5_BATCH, 1), cfg.decoder_start_token_id,
                       dtype=torch.int32)

    def encode_first(m, dev):
        """The encoder output and the start token's logits, on ``dev``."""
        with torch.no_grad():
            e = m.encode(enc_ids.to(dev))
            first, _ = m.decode(start.to(dev), e,
                                init_cache(cfg, T5_BATCH, 2, device=dev))
        return e.cpu(), first.cpu()

    enc_cpu, first_cpu = encode_first(cpu, "cpu")
    enc_card, first_card = encode_first(model, DEV)
    with perturbed(cpu, SEED):
        enc_floor, first_floor = encode_first(cpu, "cpu")
    bars = {}
    for label, got, want, floor in (
            ("encoder output", enc_card, enc_cpu, enc_floor),
            ("first-step logits", first_card, first_cpu, first_floor)):
        err = (got - want).abs().max().item()
        floor = (floor - want).abs().max().item()
        bars[label] = dict(max_abs_err=err, cpu_floor=floor,
                           ratio=err / floor if floor else None)
        if not torch.isfinite(got).all() or err > T5_FLOOR_FACTOR * floor:
            raise AssertionError(f"t5_fp32: the card's {label} differ from "
                                 f"the CPU's by {err:.3e}, over "
                                 f"{T5_FLOOR_FACTOR} x the CPU's floor "
                                 f"{floor:.3e}")
    if not (first_card.argmax(-1) == first_cpu.argmax(-1)).all():
        raise AssertionError("t5_fp32: first tokens differ from the CPU's")
    emit("t5_fp32", requests=T5_BATCH, encoder_tokens=T5_ENC_SEQ,
         new_tokens=n_new, layers=cfg.num_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size,
         parameters=sum(p.numel() for p in model.parameters()),
         token_identical=True, seconds=seconds, launches=launches,
         buckets_equal_cpu=buckets, card_vs_cpu=bars,
         floor_factor=T5_FLOOR_FACTOR, first_logits_rms=rms_of(first_cpu),
         distinct_tokens=int(np.unique(toks).size))
    del model, cpu, enc
    torch.cuda.empty_cache()


def t5_bf16(smi):
    """The serving speed run: t5-small in bf16 over fp32 parameters,
    ``t5_generate`` of ``T5_NEW_BF16`` tokens for the same requests: a warm
    call, the encoder alone timed, then one timed call with exact launches:
    generated tokens/s, host and synchronized ms per decode step, peak
    memory. Returns the timed call."""
    import torch

    from apex_tpu_torch.models import t5_generate
    from apex_tpu_torch.ops import _build

    live = phase_memory_start()
    model = build_t5(torch.bfloat16)
    cfg, n_new = model.config, T5_NEW_BF16
    enc_ids = t5_requests(cfg.vocab_size).to(DEV)
    t5_generate(model, enc_ids, 8)                                   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        model.encode(enc_ids)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    _build.reset_launches()
    t0 = time.perf_counter()
    toks = t5_generate(model, enc_ids, n_new)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(_build.launches)
    check_launches("t5_bf16", launches, t5_generate_launches(cfg, n_new))
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError("t5_bf16: tokens outside the vocabulary")
    emit("t5_bf16", requests=T5_BATCH, encoder_tokens=T5_ENC_SEQ,
         new_tokens=n_new, layers=cfg.num_layers,
         tokens_per_s=T5_BATCH * n_new / elapsed, seconds=elapsed,
         encode_ms=encode_s * 1e3,
         host_ms_per_decode_step=host_s / n_new * 1e3,
         synced_ms_per_decode_step=elapsed / n_new * 1e3,
         launches=launches,
         peak_memory_gib=(torch.cuda.max_memory_allocated() - live)
         / 2 ** 30, earlier_phases_live_gib=live / 2 ** 30,
         nvidia_smi=smi, card_after=card_state())
    return partial(t5_generate, model, enc_ids, n_new), launches


def t5_batch(cfg, batch: int, dev):
    """Span-corruption-shaped ids (numpy seed ``T5_SEED``):
    ``T5_TRAIN_ENC`` input and ``T5_TRAIN_DEC`` target tokens a row, the
    labels the targets shifted left."""
    import numpy as np
    import torch

    rng = np.random.default_rng(T5_SEED + 1)
    enc = rng.integers(0, cfg.vocab_size, (batch, T5_TRAIN_ENC))
    dec = rng.integers(0, cfg.vocab_size, (batch, T5_TRAIN_DEC))
    enc, dec = (torch.from_numpy(a.astype(np.int32)).to(dev)
                for a in (enc, dec))
    return enc, dec, torch.roll(dec, -1, dims=1)


def t5_train_flops(cfg, batch: int, s_enc: int, s_dec: int) -> float:
    """FLOPs of one T5 training step: 6 x the matmul parameters each token
    passes (encoder layer 4 e i + f e w, decoder layer 6 e i + f e w on its
    own tokens and 2 e i, the cross K/V, on the encoder's; the tied head V e;
    w = 2 for relu, 3 for gated-gelu; i = H d), plus attention, 12 d per
    visible pair (4 d forward, 8 d backward) over the encoder's S_enc^2,
    the decoder's causal S_dec (S_dec + 1) / 2 and the cross S_dec S_enc
    pairs of each head."""
    e, f, layers = cfg.d_model, cfg.d_ff, cfg.num_layers
    i = cfg.num_heads * cfg.head_dim
    w = 3 if cfg.ff_act == "gated-gelu" else 2
    enc_layer, dec_layer = 4 * e * i + w * e * f, 6 * e * i + w * e * f
    linear = (s_enc * layers * (enc_layer + 2 * e * i)
              + s_dec * (layers * dec_layer + cfg.vocab_size * e))
    pairs = s_enc * s_enc + s_dec * (s_dec + 1) // 2 + s_dec * s_enc
    return float(6 * batch * linear + 12 * batch * cfg.num_heads
                 * cfg.head_dim * layers * pairs)


def perturbed(model, seed: int):
    """Context: every parameter of ``model`` multiplied in place by 1 +
    2^-24 noise (one rounding), restored bit for bit after (in place, so
    an optimizer's views stay)."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def ctx():
        gen = torch.Generator().manual_seed(seed)
        saved = [p.detach().clone() for p in model.parameters()]
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 2.0 ** -24 * torch.randn(p.shape, generator=gen))
        try:
            yield
        finally:
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
    return ctx()


def floor_grad_bars(phase: str, card_grads, cpu_grads, floor_grads,
                    factor: float = T5_FLOOR_FACTOR) -> dict:
    """Every gradient of the card against the CPU's, in norm: |card - CPU|
    within the larger of 1e-3 |CPU| (the per-entry bar's rtol) and
    ``factor`` times the CPU's own floor |CPU' - CPU|, CPU' the
    CPU's gradient with every parameter moved by one rounding
    (``floor_grads``), Frobenius norms per tensor; a tensor whose CPU
    gradient is 0 must be 0 on the card. Per-entry errors are reported:
    the per-entry bar cannot hold here (``T5_FLOOR_FACTOR``'s note).
    Returns {name: [|CPU|, |card - CPU|, |CPU' - CPU|, max |card - CPU|,
    max |g|]}."""
    import torch

    missing = [n for n, g in card_grads.items() if g is None]
    if missing:
        raise AssertionError(f"{phase}: no gradient on the card for "
                             f"{missing}")
    out, over = {}, []
    for n, g in card_grads.items():
        want, got = cpu_grads[n], g.cpu()
        norm = want.norm().item()
        err = (got - want).norm().item()
        floor = (floor_grads[n] - want).norm().item()
        bar = max(1e-3 * norm, factor * floor)
        if not torch.isfinite(got).all() or err > bar:
            over.append((err / max(bar, 1e-30), n, err, norm, floor))
        out[n] = [norm, err, floor, (got - want).abs().max().item(),
                  want.abs().max().item()]
    if over:
        ratio, n, err, norm, floor = max(over, key=lambda o: o[0])
        raise AssertionError(
            f"{phase}: {len(over)} of {len(out)} gradients over their bar; "
            f"the worst, {n}: |card - CPU| {err:.3e} over max(1e-3 |CPU| "
            f"= {1e-3 * norm:.3e}, {factor} x the CPU floor {floor:.3e}), "
            f"{ratio:.3g}x the bar")
    return out


def t5_train_fp32():
    """Card against CPU: t5-small at full width, fp32, B = 2, 512 input and
    114 target tokens, the same seeded weights on both sides: the loss and
    every gradient (``floor_grad_bars``: in norm, within the larger of 1e-3
    and ``T5_FLOOR_FACTOR`` times the CPU's own floor per tensor),
    both relative-bias tables' gradients exactly 0 on both sides, a
    FusedAdam step on each side on the card's gradients (``step_both``:
    the parameters after it within ``UPDATE_TOL``), the loss and gradients
    again, a second step, and the loss. The losses are held as the fp64
    cross-entropy of each side's fp32 logits within 1e-4 relative; the
    launches of the card's first forward and backward are exact."""
    import torch

    from apex_tpu_torch.models import t5_loss
    from apex_tpu_torch.ops import _build

    card = build_t5(torch.float32)
    cpu = build_t5(torch.float32, device="cpu")
    cpu.load_state_dict(card.state_dict())
    cfg = card.config
    sides = {side: (model, *t5_batch(cfg, T5_TRAIN_FP32_BATCH, dev))
             for side, model, dev in (("card", card, DEV), ("cpu", cpu,
                                                            "cpu"))}
    logits = {}
    for side, (model, *_rest) in sides.items():
        model.register_forward_hook(
            lambda m, i, o, side=side: logits.__setitem__(side, o.detach()))
    tables = ("enc_rel_bias.rel_attn_bias", "dec_rel_bias.rel_attn_bias")

    def cpu_floor_grads():
        """The CPU's gradients with every parameter moved by one rounding
        (``perturbed``); the gradients zeroed in place after (FusedAdam's
        views stay)."""
        model, enc, dec, labels = sides["cpu"]
        params = list(model.parameters())
        for p in params:
            if p.grad is not None:
                p.grad.zero_()
        with perturbed(model, SEED):
            t5_loss(model, enc, dec, labels).backward()
        out = {n: p.grad.detach().clone()
               for n, p in model.named_parameters()}
        for p in params:
            p.grad.zero_()
        return out

    def forward(backward: bool = True):
        losses, ces, grads, card_launches = {}, {}, {}, None
        for side, (model, enc, dec, labels) in sides.items():
            if side == "card":
                torch.cuda.synchronize()
                _build.reset_launches()
            with torch.set_grad_enabled(backward):
                loss = t5_loss(model, enc, dec, labels)
            if backward:
                loss.backward()
                grads[side] = {n: p.grad for n, p in model.named_parameters()}
            logp = torch.log_softmax(logits[side].double(), dim=-1)
            ces[side] = -logp.gather(-1, labels.long()[..., None])[
                ..., 0].mean().item()
            losses[side] = loss.item()
            if side == "card":
                torch.cuda.synchronize()
                card_launches = dict(_build.launches)
        if abs(ces["card"] - ces["cpu"]) > 1e-4 * abs(ces["cpu"]):
            raise AssertionError(f"t5_train_fp32: losses differ: {ces} "
                                 f"(fp64 of the logits), {losses}")
        if backward:
            for side in sides:
                for name in tables:
                    if grads[side][name] is None or grads[side][name].any():
                        raise AssertionError(
                            f"t5_train_fp32: {side} gradient of {name} is "
                            f"not exactly 0")
        return losses, ces, grads, card_launches

    floor = cpu_floor_grads()
    losses, ces, grads, launches = forward()
    want = t5_train_launches(cfg)
    want["adam"] = 0
    check_launches("t5_train_fp32", launches, want)
    bars = floor_grad_bars("t5_train_fp32", grads["card"], grads["cpu"],
                           floor)
    opts = {side: make_optimizer(model)
            for side, (model, *_rest) in sides.items()}

    def step_both() -> float:
        """A FusedAdam step on each side, the CPU's on the card's gradients
        (copied into its FusedAdam views): every parameter after it within
        ``UPDATE_TOL`` of the card's. Then the card's parameters are copied
        into the CPU's views, so that the next comparison starts from equal
        weights: at this init one rounding of the weights moves the
        gradients by the CPU floor, and a step on each side's own gradients
        (relu gates that flip) moves them by far more. Returns the largest
        |card - CPU| after the step."""
        card_p = dict(sides["card"][0].named_parameters())
        cpu_p = dict(sides["cpu"][0].named_parameters())
        with torch.no_grad():
            for n, p in cpu_p.items():
                p.grad.copy_(card_p[n].grad.cpu())
        for opt in opts.values():
            opt.step()
        worst = 0.0
        with torch.no_grad():
            for n, p in cpu_p.items():
                got = card_p[n].detach().cpu()
                diff = (got - p).abs()
                if (diff > UPDATE_TOL[0] + UPDATE_TOL[1] * p.abs()).any():
                    raise AssertionError(
                        f"t5_train_fp32: {n} after the step differs from "
                        f"the CPU's by {diff.max().item():.3e}")
                worst = max(worst, diff.max().item())
                p.copy_(got)
        return worst

    step_errs = [step_both()]
    for opt in opts.values():
        opt.zero_grad()
    floor = cpu_floor_grads()
    loss1, ce1, grads, _ = forward()
    bars_1 = floor_grad_bars("t5_train_fp32 step 1", grads["card"],
                             grads["cpu"], floor)
    step_errs.append(step_both())
    loss2, ce2, _, _ = forward(backward=False)

    def summary(b):
        """Per tensor, the card's error and the CPU floor relative to the
        gradient's norm (median and worst), the largest error over its
        floor, and the tensors whose largest entry error is within the
        per-entry bar min(1e-4, 1e-3 max|g|) + 1e-3 max|g|."""
        live = {n: v for n, v in b.items() if v[0] > 0}
        rel = sorted(e / g for g, e, _, _, _ in live.values())
        floors = sorted(f / g for g, _, f, _, _ in live.values())
        return dict(tensors=len(b), zero_tensors=len(b) - len(live),
                    rel_err_median=rel[len(rel) // 2], rel_err_max=rel[-1],
                    rel_floor_median=floors[len(floors) // 2],
                    rel_floor_max=floors[-1],
                    max_err_over_floor=max(e / f for _, e, f, _, _
                                           in live.values() if f > 0),
                    within_entry_bar=sum(
                        m <= min(1e-4, 1e-3 * gm) + 1e-3 * gm
                        for _, _, _, m, gm in b.values()))

    emit("t5_train_fp32", batch=T5_TRAIN_FP32_BATCH,
         encoder_tokens=T5_TRAIN_ENC, decoder_tokens=T5_TRAIN_DEC,
         layers=cfg.num_layers, lr=TRAIN_LR,
         parameters=sum(p.numel() for p in card.parameters()),
         ce64_card=[ces["card"], ce1["card"], ce2["card"]],
         ce64_cpu=[ces["cpu"], ce1["cpu"], ce2["cpu"]],
         losses_card=[losses["card"], loss1["card"], loss2["card"]],
         losses_cpu=[losses["cpu"], loss1["cpu"], loss2["cpu"]],
         grad_bar="|card - CPU| <= max(1e-3 |CPU|, "
                  f"{T5_FLOOR_FACTOR} |CPU' - CPU|) per tensor, Frobenius; "
                  "CPU' = every parameter moved by one rounding",
         grads_summary=summary(bars), grads_step1_summary=summary(bars_1),
         rel_bias_grads_zero=list(tables), params_with_grad=len(bars),
         params_after_step_max_abs_err=step_errs, update_tol=UPDATE_TOL,
         launches=launches)
    del sides, opts, card, cpu, logits
    torch.cuda.empty_cache()


def t5_train_bf16(smi):
    """t5-small at full width, B = ``T5_TRAIN_BATCH`` x 512 inputs and 114
    targets, bf16 compute over fp32 parameters, ``FusedAdam(lr=1e-4,
    weight_decay=0.01)`` with norms and biases excluded: warm steps, then
    timed steps with exact launches per step. Returns the step and the
    timed steps' launches."""
    import torch

    from apex_tpu_torch.models import t5_loss
    from apex_tpu_torch.ops import _build

    live = phase_memory_start()
    model = build_t5(torch.bfloat16)
    cfg = model.config
    opt = make_optimizer(model)
    b = T5_TRAIN_BATCH
    enc, dec, labels = t5_batch(cfg, b, DEV)

    def step():
        opt.zero_grad()
        loss = t5_loss(model, enc, dec, labels)
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [step() for _ in range(T5_TRAIN_WARM)]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    losses += [step() for _ in range(T5_TRAIN_TIMED)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(_build.launches)
    check_launches("t5_train_bf16", launches, t5_train_launches(cfg),
                   per=T5_TRAIN_TIMED)
    with torch.no_grad():
        final = t5_loss(model, enc, dec, labels).item()
    losses = [x.item() for x in losses]
    if not all(map(math.isfinite, losses + [final])) or not final < losses[0]:
        raise AssertionError(f"t5_train_bf16: loss not finite and falling: "
                             f"{losses} then {final}")
    step_s = elapsed / T5_TRAIN_TIMED
    flops = t5_train_flops(cfg, b, T5_TRAIN_ENC, T5_TRAIN_DEC)
    emit("t5_train_bf16", batch=b, encoder_tokens=T5_TRAIN_ENC,
         decoder_tokens=T5_TRAIN_DEC, layers=cfg.num_layers,
         parameters=sum(p.numel() for p in model.parameters()),
         timed_steps=T5_TRAIN_TIMED, step_ms=step_s * 1e3,
         tokens_per_s=b * (T5_TRAIN_ENC + T5_TRAIN_DEC) / step_s,
         target_tokens_per_s=b * T5_TRAIN_DEC / step_s,
         flops_per_step=flops,
         flops_formula="6 B (S_enc L (4 e i + w e f + 2 e i) + S_dec (L "
                       "(6 e i + w e f) + V e)) + 12 B H d L (S_enc^2 + "
                       "S_dec (S_dec + 1) / 2 + S_dec S_enc), i = H d, "
                       "w = 2 (relu)",
         mfu=flops / step_s / PEAK_FLOPS["bfloat16"],
         bound_ms=flops / PEAK_FLOPS["bfloat16"] * 1e3,
         peak_flops=PEAK_FLOPS["bfloat16"], losses=losses, loss_after=final,
         launches_per_step={k: launches[k] / T5_TRAIN_TIMED
                            for k in T5_TRAIN_KERNELS}, launches=launches,
         peak_memory_gib=(torch.cuda.max_memory_allocated() - live)
         / 2 ** 30, earlier_phases_live_gib=live / 2 ** 30,
         nvidia_smi=smi, card_after=card_state())
    return step, launches


# --- the ResNet-50 slice: ImageNet training under amp ----------------------


def resnet_batch(batch: int, dev):
    """The example's synthetic ImageNet batch (numpy seed 0), NCHW."""
    import numpy as np

    from apex_tpu_torch.examples.imagenet import main_amp as rn

    return rn.synthetic_batch(np.random.default_rng(0), batch, RESNET_IMAGE,
                              RESNET_CLASSES, device=dev)


def resnet_side(dev, optimizer: str, opt_level: str = "O0",
                half_dtype=None):
    """``(model, opt, ddp, step)``: ResNet-50 at ImageNet width from the
    seeded init on ``dev``, through the example's ``build_training``
    (``step(x, y)`` its training step), under a fresh amp state of its
    own: ``step`` sets that state for its duration (``amp.scope``), so
    the other phases' models compute in their configs' dtypes."""
    import torch

    from apex_tpu_torch import amp
    from apex_tpu_torch.examples.imagenet import main_amp as rn

    model = rn.resnet50(num_classes=RESNET_CLASSES, device=dev, seed=SEED)
    with amp.scope():
        opt, ddp, train_step = rn.build_training(
            model, opt_level=opt_level, lr=RESNET_LR, optimizer=optimizer,
            half_dtype=half_dtype or torch.bfloat16)
        state = amp.active_state()

    def step(x, y):
        with amp.scope(state):
            return train_step(x, y)
    return model, opt, ddp, state, step


def resnet_grads(model, opt, ddp, x, y):
    """One forward and backward, amp O0 (off): ``(loss, {name:
    gradient})``, the gradients as views of the optimizer's flat
    buffer."""
    from apex_tpu_torch.examples.imagenet import main_amp as rn
    from apex_tpu_torch.ops import flat_buffer

    opt.zero_grad()
    loss = rn.nll_loss(ddp(x), y)
    loss.backward()
    return loss.item(), flat_buffer.unflatten(opt.grads, opt.spec)


def resnet_card_vs_cpu(optimizer: str) -> dict:
    """Two steps of ``optimizer`` under O0 on the card and on the CPU from
    the same seeded weights and batch: each step's losses (1e-4 relative),
    gradients (``floor_grad_bars`` with ``RESNET_FLOOR_FACTOR``: the CPU's
    own floor measured at each step with every parameter moved by one
    rounding, its running statistics put back after), running statistics
    and, after the step, parameters and optimizer state (atol 1e-4, rtol
    1e-3, per entry). The CPU steps on the card's gradients, so that the
    steps compare the optimizers and not the two gradients. cuDNN runs its
    deterministic algorithms here (restored after): its default backward
    convolutions give other gradient bits in every run, and after the
    first step's lr 0.1 the most sensitive tensors (stage3_block2's norms
    and conv3) move from run to run by up to the CPU's floor, and whether
    the bar held depended on the draw. Returns the phase's numbers, with the
    card's launches of its steps."""
    import torch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _resnet_card_vs_cpu(optimizer)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _resnet_card_vs_cpu(optimizer: str) -> dict:
    """``resnet_card_vs_cpu``'s steps, under the cuDNN setting it chose."""
    import torch

    from apex_tpu_torch.ops import _build

    sides = {"card": resnet_side(DEV, optimizer),
             "cpu": resnet_side("cpu", optimizer)}
    batch = {"card": resnet_batch(RESNET_FP32_BATCH, DEV),
             "cpu": resnet_batch(RESNET_FP32_BATCH, "cpu")}
    out = dict(losses_card=[], losses_cpu=[], grads=[], launches={})
    step_kernels = (("sgd",) if optimizer == "sgd"
                    else ("segment_stats", "novograd"))
    for step in range(2):
        losses, grads = {}, {}
        for side, (model, opt, ddp, _, _) in sides.items():
            losses[side], grads[side] = resnet_grads(model, opt, ddp,
                                                     *batch[side])
        model, opt, ddp = sides["cpu"][:3]
        saved = {k: v.clone() for k, v in model.named_buffers()}
        with perturbed(model, SEED + step):
            _, floor = resnet_grads(model, opt, ddp, *batch["cpu"])
            floor = {k: v.clone() for k, v in floor.items()}
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(saved[k])
        _, grads["cpu"] = resnet_grads(model, opt, ddp, *batch["cpu"])
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(saved[k])
        if abs(losses["card"] - losses["cpu"]) > 1e-4 * abs(losses["cpu"]):
            raise AssertionError(f"resnet_fp32 {optimizer} step {step}: "
                                 f"loss card {losses['card']} vs CPU "
                                 f"{losses['cpu']}")
        out["losses_card"].append(losses["card"])
        out["losses_cpu"].append(losses["cpu"])
        bars = floor_grad_bars(f"resnet_fp32 {optimizer} step {step}",
                               grads["card"], grads["cpu"], floor,
                               factor=RESNET_FLOOR_FACTOR)
        out["grads"].append(dict(
            max_rel_err=max(v[1] / max(v[0], 1e-30) for v in bars.values()),
            max_rel_floor=max(v[2] / max(v[0], 1e-30)
                              for v in bars.values()),
            median_rel_floor=sorted(v[2] / max(v[0], 1e-30)
                                    for v in bars.values())[len(bars) // 2],
            max_ratio_to_floor=max(v[1] / max(v[2], 1e-30)
                                   for v in bars.values()),
            max_abs_err=max(v[3] for v in bars.values())))
        stats_err = max(
            compare(f"resnet_fp32 {optimizer} {k}", v.cpu(),
                    dict(sides["cpu"][0].named_buffers())[k], "float32",
                    (1e-4, 1e-3))
            for k, v in sides["card"][0].named_buffers())
        # the CPU steps on the card's gradients
        sides["cpu"][1].grads.copy_(sides["card"][1].grads.cpu())
        card_opt = sides["card"][1]
        torch.cuda.synchronize()
        before = dict(_build.launches)
        card_opt.step()
        torch.cuda.synchronize()
        for k in step_kernels:
            out["launches"][k] = out["launches"].get(k, 0) + (
                _build.launches[k] - before[k])
        sides["cpu"][1].step()
        params_err = max(
            compare(f"resnet_fp32 {optimizer} step {step} {k}",
                    card_opt.state[k].cpu() if k != "master"
                    else card_opt.master.cpu(),
                    sides["cpu"][1].state[k] if k != "master"
                    else sides["cpu"][1].master, "float32", (1e-4, 1e-3))
            for k in ("master", *card_opt.state))
        out["grads"][-1].update(running_stats_max_abs_err=stats_err,
                                params_and_state_max_abs_err=params_err)
    for k in step_kernels:
        if out["launches"].get(k) != 2:
            raise AssertionError(f"resnet_fp32 {optimizer}: {k} launched "
                                 f"{out['launches'].get(k)} times in two "
                                 f"steps, not 2")
    return out


def resnet_fp32() -> None:
    """Card against CPU: ResNet-50 at ImageNet width (1000 classes, 224 x
    224), B = ``RESNET_FP32_BATCH``, amp O0, two ``FusedSGD(lr=0.1,
    momentum=0.9, weight_decay=1e-4)`` steps, then the same two steps with
    ``FusedNovoGrad`` (``resnet_card_vs_cpu``); then one O1 fp16 step on
    the card with a dynamic scaler and an ``inf`` planted in one gradient:
    parameters, momentum and the step count bit-identical, the scale
    halved, ``segment_stats`` and ``sgd`` launched once each."""
    import torch

    from apex_tpu_torch import amp
    from apex_tpu_torch.examples.imagenet import main_amp as rn
    from apex_tpu_torch.ops import _build

    sgd = resnet_card_vs_cpu("sgd")
    nvg = resnet_card_vs_cpu("novograd")
    model, opt, ddp, state, step = resnet_side(DEV, "sgd", "O1",
                                               torch.float16)
    x, y = resnet_batch(RESNET_FP32_BATCH, DEV)
    step(x, y)              # a clean step first: the momentum is not zero
    with amp.scope(state):
        opt.zero_grad()
        loss = rn.nll_loss(ddp(x), y)
        loss.backward()
        model.fc.weight.grad[3, 5] = float("inf")
        master = opt.master.clone()
        momentum = opt.state["momentum_buffer"].clone()
        count = opt.step_count.item()
        scale = opt._amp_scaler.state.scale.item()
        torch.cuda.synchronize()
        _build.reset_launches()
        opt.step()
        torch.cuda.synchronize()
    launches = {k: v for k, v in _build.launches.items() if v}
    new_scale = opt._amp_scaler.state.scale.item()
    if not (torch.equal(opt.master, master)
            and torch.equal(opt.state["momentum_buffer"], momentum)
            and opt.step_count.item() == count):
        raise AssertionError("resnet_fp32: the O1 fp16 step with an inf "
                             "gradient changed the parameters, the momentum "
                             "or the step count")
    if new_scale != scale / 2:
        raise AssertionError(f"resnet_fp32: scale {scale} -> {new_scale}, "
                             f"not halved")
    if launches != {"segment_stats": 1, "sgd": 1}:
        raise AssertionError(f"resnet_fp32: the skipped step launched "
                             f"{launches}, not segment_stats 1 and sgd 1")
    emit("resnet_fp32", batch=RESNET_FP32_BATCH, image=RESNET_IMAGE,
         classes=RESNET_CLASSES, opt_level="O0", lr=RESNET_LR,
         floor_factor=RESNET_FLOOR_FACTOR, cudnn_deterministic=True,
         sgd=sgd, novograd=nvg,
         skip_step=dict(opt_level="O1", half_dtype="float16",
                        loss=loss.item(), scale_before=scale,
                        scale_after=new_scale, step_count=count,
                        bit_identical=True, launches=launches))


def resnet_train_launches(optimizer: str) -> dict:
    """The kernels one O1 bf16 training step launches: SGD once, or the
    stats pass and NovoGrad once each (no scaler: bf16's static scale 1
    attaches none, so FusedSGD runs no stats pass)."""
    if optimizer == "sgd":
        return {"sgd": 1, "segment_stats": 0, "novograd": 0}
    return {"segment_stats": 1, "novograd": 1, "sgd": 0}


def resnet_bf16(smi, optimizer: str = "sgd"):
    """The example's path at ImageNet width: ``resnet50()``, 224 x 224,
    B = ``RESNET_BATCH``, amp O1 bf16, ``FusedSGD(lr=0.1, momentum=0.9,
    weight_decay=1e-4)`` through ``build_training``: warm steps, then timed
    steps with exact launches per step (``optimizer="novograd"``: the
    short NovoGrad run, ``RESNET_NVG_STEPS`` steps). Returns the step and
    the timed steps' launches."""
    import torch

    from apex_tpu_torch.examples.imagenet import main_amp as rn
    from apex_tpu_torch.ops import _build

    phase = "resnet_bf16" if optimizer == "sgd" else "resnet_novograd_bf16"
    live = phase_memory_start()
    model, opt, ddp, _, train_step = resnet_side(DEV, optimizer, "O1",
                                                 torch.bfloat16)
    x, y = resnet_batch(RESNET_BATCH, DEV)
    step = partial(train_step, x, y)
    warm, timed = ((RESNET_WARM, RESNET_TIMED) if optimizer == "sgd"
                   else (1, RESNET_NVG_STEPS))
    losses = [step() for _ in range(warm)]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    losses += [step() for _ in range(timed)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(_build.launches)
    check_launches(phase, launches, resnet_train_launches(optimizer),
                   per=timed)
    losses = [v.item() for v in losses]
    # lr 0.1 with momentum on one memorized batch need not fall every
    # step: the bar is a finite loss that has fallen below its first value
    if not all(map(math.isfinite, losses)) or not min(losses) < losses[0]:
        raise AssertionError(f"{phase}: loss not finite, or never below "
                             f"its first value: {losses}")
    step_s = elapsed / timed
    flops = rn.resnet_train_flops(model, RESNET_BATCH, RESNET_IMAGE)
    fields = dict(
        batch=RESNET_BATCH, image=RESNET_IMAGE, classes=RESNET_CLASSES,
        opt_level="O1", half_dtype="bfloat16", optimizer=optimizer,
        parameters=sum(p.numel() for p in model.parameters()),
        tensors=len(list(model.parameters())), timed_steps=timed,
        step_ms=step_s * 1e3, images_per_s=RESNET_BATCH / step_s,
        flops_per_step=flops,
        flops_formula="3 x 2 x (multiply-adds of every conv and fc, from "
                      "their shapes) x B",
        mfu=flops / step_s / PEAK_FLOPS["bfloat16"],
        bound_ms=flops / PEAK_FLOPS["bfloat16"] * 1e3,
        peak_flops=PEAK_FLOPS["bfloat16"], losses=losses,
        launches_per_step={k: launches[k] / timed
                           for k in ("sgd", "novograd", "segment_stats")},
        launches=launches,
        peak_memory_gib=(torch.cuda.max_memory_allocated() - live) / 2 ** 30,
        earlier_phases_live_gib=live / 2 ** 30)
    emit(phase, **fields, nvidia_smi=smi, card_after=card_state())
    return step, launches, dict(losses=losses, step_ms=step_s * 1e3,
                                images_per_s=RESNET_BATCH / step_s,
                                mfu=fields["mfu"])


def resnet_o2_bf16(smi, ref: dict) -> dict:
    """``resnet_bf16``'s workload (the same seeded weights and batch,
    FusedSGD, ``RESNET_WARM`` + ``RESNET_TIMED`` steps) under amp O2 bf16
    through the example's ``build_training``: every conv and fc parameter a
    bf16 copy of the fp32 master, every BatchNorm parameter fp32 (a master
    view); after every step each half copy equals ``master.to(bf16)`` bit
    for bit; one SGD launch a step and no stats pass; the losses finite
    and within ``O2_DRIFT`` nats of ``ref``'s (``resnet_bf16``'s) at every
    step. Step ms, images/s and MFU beside ``resnet_bf16``'s. Then one O3
    step (every parameter bf16, the norms too, beside the fp32 master) on a
    fresh model, its loss within ``O2_DRIFT`` of ``ref``'s first. Returns
    the O2 timed steps' launches."""
    import torch

    from apex_tpu_torch.examples.imagenet import main_amp as rn
    from apex_tpu_torch.ops import _build

    phase = "resnet_o2_bf16"
    live = phase_memory_start()
    model, opt, _, _, train_step = resnet_side(DEV, "sgd", "O2",
                                               torch.bfloat16)
    dtypes = check_o2_dtypes(phase, model, opt)
    x, y = resnet_batch(RESNET_BATCH, DEV)
    step = partial(train_step, x, y)
    losses, elapsed, bad = timed_steps(step, RESNET_WARM, RESNET_TIMED,
                                       partial(half_copy_mismatches, opt))
    launches = dict(_build.launches)
    check_launches(phase, launches, resnet_train_launches("sgd"),
                   per=RESNET_TIMED)
    if bad:
        raise AssertionError(f"{phase}: {bad} half-copy entries differ from "
                             f"master.to(bf16)")
    drift = max(abs(a - b) for a, b in zip(losses, ref["losses"]))
    if not all(map(math.isfinite, losses)) or drift > O2_DRIFT:
        raise AssertionError(f"{phase}: losses {losses}, drift {drift} from "
                             f"resnet_bf16's {ref['losses']} (bar "
                             f"{O2_DRIFT})")
    step_s = elapsed / RESNET_TIMED
    flops = rn.resnet_train_flops(model, RESNET_BATCH, RESNET_IMAGE)
    peak = (torch.cuda.max_memory_allocated() - live) / 2 ** 30
    half_casts = half_cast_times(opt)
    del model, opt, train_step, step
    gc.collect()
    torch.cuda.empty_cache()
    model, opt, _, _, train_step = resnet_side(DEV, "sgd", "O3",
                                               torch.bfloat16)
    o3_dtypes = check_o2_dtypes(phase + " O3", model, opt, level="O3")
    _build.reset_launches()
    o3_loss = train_step(x, y).item()
    o3_bad = half_copy_mismatches(opt).item()
    o3_launches = dict(_build.launches)
    check_launches(phase + " O3", o3_launches, resnet_train_launches("sgd"))
    if (not math.isfinite(o3_loss) or o3_bad
            or abs(o3_loss - ref["losses"][0]) > O2_DRIFT):
        raise AssertionError(f"{phase}: the O3 step's loss {o3_loss} (O1's "
                             f"{ref['losses'][0]}), {o3_bad} half-copy "
                             f"entries off")
    emit(phase, batch=RESNET_BATCH, image=RESNET_IMAGE, opt_level="O2",
         half_dtype="bfloat16", params_by_dtype=dtypes,
         timed_steps=RESNET_TIMED, step_ms=step_s * 1e3,
         images_per_s=RESNET_BATCH / step_s,
         mfu=flops / step_s / PEAK_FLOPS["bfloat16"],
         resnet_bf16={k: ref[k] for k in ("step_ms", "images_per_s", "mfu")},
         losses=losses, losses_resnet_bf16=ref["losses"],
         max_loss_drift=drift, drift_bar=O2_DRIFT, half_copy_mismatches=bad,
         launches_per_step={k: launches[k] / RESNET_TIMED
                            for k in ("sgd", "novograd", "segment_stats")},
         launches=launches, peak_memory_gib=peak, half_casts=half_casts,
         o3=dict(params_by_dtype=o3_dtypes, loss=o3_loss,
                 half_copy_mismatches=o3_bad,
                 launches={k: o3_launches[k] for k in
                           ("sgd", "novograd", "segment_stats")}),
         nvidia_smi=smi, card_after=card_state())
    del model, opt, train_step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --- the DCGAN multi-loss example and the optimizer transforms -------------


def dcgan_side(dev, poison_step: int, perturb: float = 0.0) -> dict:
    """The DCGAN example at O2 fp16 (two dynamic scalers) on ``dev``:
    ``DCGAN_STEPS`` steps of ``build_training``'s step on the reference's
    batches, the real batch of step ``poison_step`` holding one inf sample.
    ``perturb``: both optimizers' masters first multiplied by ``1 +
    perturb * N(0, 1)`` (seeded), the half copies refreshed. Returns per
    step the two losses, the scales after it, and the two step counts."""
    import torch

    from apex_tpu_torch import amp
    from apex_tpu_torch.examples.dcgan import main_amp as dc
    from apex_tpu_torch.ops import _build

    g = dc.Generator(device=dev, seed=SEED)
    d = dc.Discriminator(device=dev, seed=SEED + 1)
    with amp.scope():
        g_opt, d_opt, step = dc.build_training(
            g, d, opt_level="O2", half_dtype=torch.float16)
        state = amp.active_state()
    if perturb:
        gen = torch.Generator().manual_seed(SEED + 7)
        with torch.no_grad():
            for opt in (g_opt, d_opt):
                opt.master.mul_(1 + perturb * torch.randn(
                    opt.master.shape, generator=gen).to(dev))
                opt.sync_half_params()
    batches = dc.synthetic_batches(SEED, DCGAN_STEPS, DCGAN_BATCH, 32, dev)
    z, real = batches[poison_step]
    real = real.clone()
    real[5, 0] = float("inf")
    batches[poison_step] = (z, real)
    out = {k: [] for k in ("d_loss", "g_loss", "scale_g", "scale_d",
                           "count_g", "count_d", "mismatches")}
    _build.reset_launches()
    with amp.scope(state):
        for z, real in batches:
            dl, gl = step(z, real)
            out["d_loss"].append(dl.item())
            out["g_loss"].append(gl.item())
            for key, sc in zip(("scale_g", "scale_d"), state[1]):
                out[key].append(sc.state.scale.item())
            out["count_g"].append(int(g_opt.step_count))
            out["count_d"].append(int(d_opt.step_count))
            out["mismatches"].append(int(half_copy_mismatches(g_opt))
                                     + int(half_copy_mismatches(d_opt)))
    out["launches"] = dict(_build.launches)
    out["dtypes"] = sorted({str(p.dtype) for m in (g, d)
                            for p in m.parameters()})
    return out


def dcgan_fp16(smi) -> dict:
    """The DCGAN multi-loss example (``examples.dcgan.main_amp``, BASELINE's
    amp pattern: two FusedAdams, ``num_losses=2``, ``scale_loss(...,
    loss_id=)``) at O2 fp16, where both scalers are dynamic, on the card and
    on the CPU port from the same seeds, one inf sample in the real batch
    of step ``DCGAN_POISON``: every parameter fp16; after every step each
    half copy equals its master in fp16; the per-loss scales and both step
    counts equal the CPU's at every step; at the poisoned step only the
    discriminator's optimizer skips and only its scale (loss 1) halves;
    the losses within ``DCGAN_FLOOR_FACTOR`` times the CPU's own fp16
    floor (the CPU again with both masters moved by ``DCGAN_PERTURB``
    relative noise, about one fp16 rounding), relative, at every step but
    the poisoned one's non-finite D loss. Returns the card's launches."""
    phase = "dcgan_fp16"
    card = dcgan_side(DEV, DCGAN_POISON)
    cpu = dcgan_side("cpu", DCGAN_POISON)
    floor = dcgan_side("cpu", DCGAN_POISON, perturb=DCGAN_PERTURB)
    for key in ("scale_g", "scale_d", "count_g", "count_d"):
        if card[key] != cpu[key]:
            raise AssertionError(f"{phase}: {key} {card[key]} on the card, "
                                 f"{cpu[key]} on the CPU")
    i = DCGAN_POISON                  # >= 1: step i - 1 is clean

    def moved(k):
        return card[k][i], card[k][i - 1]
    pattern = dict(
        d_skipped=moved("count_d")[0] == moved("count_d")[1],
        g_stepped=moved("count_g")[0] == moved("count_g")[1] + 1,
        d_scale_halved=moved("scale_d")[0] * 2 == moved("scale_d")[1],
        g_scale_kept=moved("scale_g")[0] == moved("scale_g")[1],
        d_loss_nonfinite=not math.isfinite(card["d_loss"][i]))
    if not all(pattern.values()) or any(card["mismatches"]) \
            or card["dtypes"] != ["torch.float16"]:
        raise AssertionError(f"{phase}: the forced overflow {pattern}, "
                             f"half-copy mismatches {card['mismatches']}, "
                             f"dtypes {card['dtypes']}")
    rel = {}
    for key in ("d_loss", "g_loss"):
        pairs = [(a, b, c) for j, (a, b, c) in enumerate(
            zip(card[key], cpu[key], floor[key]))
            if not (key == "d_loss" and j == i)]
        err = max(abs(a - b) / abs(b) for a, b, _ in pairs)
        fl = max(abs(c - b) / abs(b) for _, b, c in pairs)
        rel[key] = dict(card_vs_cpu=err, cpu_floor=fl,
                        bar=DCGAN_FLOOR_FACTOR * fl)
        if not err <= DCGAN_FLOOR_FACTOR * fl:
            raise AssertionError(f"{phase}: {key} off the CPU's by {err:.3e} "
                                 f"relative, over {DCGAN_FLOOR_FACTOR} x the "
                                 f"CPU's floor {fl:.3e}")
    launches = card["launches"]
    per_step = {k: launches[k] / DCGAN_STEPS
                for k in ("adam", "segment_stats")}
    if per_step != {"adam": 2, "segment_stats": 2}:
        raise AssertionError(f"{phase}: launches per step {per_step}, want "
                             f"adam 2, segment_stats 2")
    emit(phase, steps=DCGAN_STEPS, batch=DCGAN_BATCH, opt_level="O2",
         half_dtype="float16", poisoned_step=i, forced_overflow=pattern,
         scales_g=card["scale_g"], scales_d=card["scale_d"],
         counts_g=card["count_g"], counts_d=card["count_d"],
         pattern_equal_cpu=True, d_losses=card["d_loss"],
         g_losses=card["g_loss"], loss_rel_err=rel,
         floor_perturb=DCGAN_PERTURB, launches_per_step=per_step,
         launches=launches, nvidia_smi=smi)
    return launches


def transforms_phase(smi) -> dict:
    """The optax-style transforms (``optimizers.transforms``) once each at
    ResNet-50's 161 tensors (25,557,032 parameters), on the card against
    the same update on the CPU (the twins): the updated parameters
    (parameters + deltas) and the state within ``OPT_TOL`` (atol cut to
    ``RMS_ATOL`` of the twin's RMS), and each transform's kernel
    launches. Returns the launches of the four."""
    import torch

    from apex_tpu_torch.optimizers import transforms as tx
    from apex_tpu_torch.ops import _build

    named, _ = resnet_spec()
    gen = torch.Generator().manual_seed(SEED)
    params = {n: torch.randn(p.shape, generator=gen) for n, p in named}
    grads = {n: torch.randn(p.shape, generator=gen) * 1e-2
             for n, p in named}
    cases = {"fused_adam": (tx.fused_adam(1e-3, weight_decay=1e-2),
                            {"adam": 1}),
             "fused_lamb": (tx.fused_lamb(1e-3),
                            {"segment_stats": 1, "lamb_phase1": 1,
                             "lamb_phase2": 1}),
             "fused_sgd": (tx.fused_sgd(0.1, momentum=0.9,
                                        weight_decay=1e-4), {"sgd": 1}),
             "fused_novograd": (tx.fused_novograd(1e-2, weight_decay=1e-3),
                                {"segment_stats": 1, "novograd": 1})}
    rows, total = {}, {}
    for name, (t, want) in cases.items():
        sides = {}
        for side, dev in (("card", DEV), ("cpu", "cpu")):
            p = {k: v.to(dev) for k, v in params.items()}
            g = {k: v.to(dev) for k, v in grads.items()}
            state = t.init(p)
            _build.reset_launches()
            sides[side] = t.update(g, state, p)
            if side == "card":
                torch.cuda.synchronize()
                launches = dict(_build.launches)
                ms = time_ms(partial(t.update, g, state, p), iters=3)
        wrong = {k: launches[k] for k in want if launches[k] != want[k]}
        if wrong:
            raise AssertionError(f"transforms: {name} launches {wrong}, "
                                 f"want {want}")
        (d_card, s_card), (d_cpu, s_cpu) = sides["card"], sides["cpu"]
        # the updated parameters: a delta alone carries the rounding of
        # the parameter it moves, far above its own RMS
        err = max(opt_compare(f"transforms {name} params {k}",
                              params[k] + d.cpu(), params[k] + d_cpu[k])
                  for k, d in d_card.items())
        for f in ("m", "v"):
            err = max(err, opt_compare(f"transforms {name} {f}",
                                       getattr(s_card, f).cpu(),
                                       getattr(s_cpu, f)))
        if not int(s_card.count) == int(s_cpu.count) == 1:
            raise AssertionError(f"transforms: {name} count")
        rows[name] = dict(max_abs_err=err, update_ms=ms, launches=want)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    emit("transforms", tensors=len(named),
         params=sum(p.numel() for _, p in named), results=rows,
         nvidia_smi=smi)
    return total


# --- the Megatron softmax and UNet GroupNorm paths ---------------------------


def rel_err(got, want) -> float:
    """``||got - want|| / ||want||`` (Frobenius, fp32)."""
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def megatron_attention(q, k, v, softmax, mask, layer: int, b: int):
    """Megatron's core attention (``CoreAttention.forward``) over ``[b np,
    s, d]`` q, k and v: scores ``baddbmm(q, k^T) / (sqrt(d) layer)``,
    ``softmax(scores as [b, np, sq, sk], mask)``, then ``bmm`` with v.
    Returns the context and the probabilities."""
    import torch

    bnp, sq, d = q.shape
    sk = k.shape[1]
    scores = torch.baddbmm(
        torch.empty(bnp, sq, sk, dtype=q.dtype, device=q.device), q,
        k.transpose(1, 2), beta=0.0, alpha=1.0 / (math.sqrt(d) * layer))
    probs = softmax(scores.view(b, bnp // b, sq, sk), mask)
    return torch.bmm(probs.view(bnp, sq, sk), v), probs


def megatron_softmax(smi) -> dict:
    """The Megatron attention softmax path in bf16, forward and backward
    through ``FusedScaleMaskSoftmax(input_in_bf16=True, scale=L,
    softmax_in_fp32=True)`` inside Megatron's core attention: GPT-2-small's
    8 x 12 x 1024 causal scores, BERT-Large's 8 x 16 x 512 with a padding
    mask from sequence lengths and without a mask (each branch of the
    forward kernel once, the backward three times: asserted). The fused
    probabilities against the module's own ``forward_torch_softmax`` on the
    card (Megatron's test) within ``TOL`` (atol cut to ``RMS_ATOL`` of their
    RMS), the context and dq, dk, dv within ``PATH_REL_BAR``; ms per forward
    and backward, fused and unfused. Returns the launches of the fused
    run."""
    import torch

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.transformer.enums import AttnMaskType
    from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

    live = phase_memory_start()
    gen = torch.Generator().manual_seed(SEED + 11)
    dgen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    b, h, s = SOFTMAX_GPT
    bb, bh, bs = SOFTMAX_BERT
    mask = padding_mask(gen, bb, bs, DEV)
    cases = [("gpt_causal", b, h, s, AttnMaskType.causal, None, "gpt"),
             ("bert_padding", bb, bh, bs, AttnMaskType.padding, mask, "bert"),
             ("bert_no_mask", bb, bh, bs, AttnMaskType.padding, None, "bert")]
    runs = []
    for label, nb, nh, ns, mask_type, m, model in cases:
        qkv = [torch.randn(nb * nh, ns, SOFTMAX_HEAD_DIM, generator=dgen,
                           device=DEV).to(torch.bfloat16).requires_grad_()
               for _ in range(3)]
        dctx = torch.randn(nb * nh, ns, SOFTMAX_HEAD_DIM, generator=dgen,
                           device=DEV).to(torch.bfloat16)
        layer = SOFTMAX_LAYERS[model]
        fused = FusedScaleMaskSoftmax(input_in_bf16=True,
                                      attn_mask_type=mask_type,
                                      scale=float(layer),
                                      softmax_in_fp32=True)
        runs.append((label, nb, nh, ns, qkv, dctx, fused, m, layer))

    def step(run, unfused: bool = False):
        _, nb, _, _, qkv, dctx, fused, m, layer = run
        softmax = fused.forward_torch_softmax if unfused else fused
        ctx, probs = megatron_attention(*qkv, softmax, m, layer, nb)
        return ctx, probs, torch.autograd.grad(ctx, qkv, dctx)

    torch.cuda.synchronize()
    _build.reset_launches()
    outs = [step(run) for run in runs]
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    check_launches("megatron_softmax", launches, {
        "scaled_softmax_fwd_causal": 1, "scaled_softmax_fwd_masked": 1,
        "scaled_softmax_fwd": 1, "scaled_softmax_bwd": 3})
    results = []
    for run, (ctx, probs, grads) in zip(runs, outs):
        label, nb, nh, ns = run[:4]
        uctx, uprobs, ugrads = step(run, unfused=True)
        probs_err = compare(f"megatron_softmax {label} probs", probs, uprobs,
                            "bfloat16", rms_atol=True)
        rels = {"context": rel_err(ctx, uctx),
                **{f"d{n}": rel_err(g, u)
                   for n, g, u in zip("qkv", grads, ugrads)}}
        over = {k: v for k, v in rels.items() if not v <= PATH_REL_BAR}
        if over:
            raise AssertionError(f"megatron_softmax {label}: fused against "
                                 f"unfused over {PATH_REL_BAR}: {over}")
        results.append(dict(
            case=label, scores=[nb, nh, ns, ns], scale=run[8],
            padded_tokens=int(run[7].sum()) if run[7] is not None else 0,
            probs_max_abs_err=probs_err, rel_err=rels,
            fused_ms=time_ms(partial(step, run), 5),
            unfused_ms=time_ms(partial(step, run, True), 5)))
        del ctx, probs, grads, uctx, uprobs, ugrads
    emit("megatron_softmax", dtype="bfloat16", head_dim=SOFTMAX_HEAD_DIM,
         rel_bar=PATH_REL_BAR, launches={k: launches[k]
                                         for k in SOFTMAX_KERNELS},
         results=results,
         peak_memory_gib=(torch.cuda.max_memory_allocated() - live) / 2 ** 30,
         nvidia_smi=smi)
    return launches


def unet_group_norm(smi) -> dict:
    """One Stable Diffusion v1.5 UNet ResNet block at its first
    resolution, (8, 320, 64, 64) bf16 channels_last: GroupNorm + SiLU ->
    conv 3x3 -> GroupNorm + SiLU -> conv 3x3 -> the residual add (the time
    embedding and dropout left out), through ``contrib.group_norm.GroupNorm
    (32, 320, act="silu")`` with torch's convolutions, forward and backward:
    two launches of each GroupNorm kernel (asserted); the output and every
    gradient within ``PATH_REL_BAR`` of the same block with the plain fp32
    ``F.group_norm`` + ``F.silu`` rounded to bf16; ms per forward and
    backward, beside the same block on ``F.group_norm`` + ``F.silu`` in
    bf16 (the library) and on the plain fp32 norm; the GroupNorm kernels'
    share of the device time of one profiled step. Returns the launches."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    from apex_tpu_torch.contrib.group_norm import GroupNorm
    from apex_tpu_torch.ops import _build

    live = phase_memory_start()
    c, side = UNET_SHAPES[0]
    act, eps = UNET_NORMS[0]
    dgen = torch.Generator(device=DEV).manual_seed(SEED + 12)
    norms, convs = [], []
    for _ in range(2):
        norm = GroupNorm(UNET_GROUPS, c, eps=eps, act=act, device=DEV)
        conv = nn.Conv2d(c, c, 3, padding=1, device=DEV,
                         dtype=torch.bfloat16).to(
            memory_format=torch.channels_last)
        with torch.no_grad():
            norm.weight.copy_(torch.randn(c, generator=dgen, device=DEV)
                              * 0.1 + 1)
            norm.bias.copy_(torch.randn(c, generator=dgen, device=DEV) * 0.1)
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=dgen,
                                          device=DEV) / math.sqrt(9 * c))
            conv.bias.copy_(torch.randn(c, generator=dgen, device=DEV) * 0.1)
        norms.append(norm)
        convs.append(conv)
    x = unet_norm_input(dgen, c, side, torch.bfloat16, DEV).requires_grad_()
    dy = unet_norm_input(dgen, c, side, torch.bfloat16, DEV)
    params = [x] + [p for m in norms + convs for p in m.parameters()]

    def port(i, t):
        return norms[i](t)

    def plain(i, t):
        return F.silu(F.group_norm(t.float(), UNET_GROUPS, norms[i].weight,
                                   norms[i].bias, eps)).to(t.dtype)

    def library(i, t):
        return F.silu(F.group_norm(t, UNET_GROUPS,
                                   norms[i].weight.to(t.dtype),
                                   norms[i].bias.to(t.dtype), eps))

    def step(norm):
        hid = convs[0](norm(0, x))
        out = x + convs[1](norm(1, hid))
        return out, torch.autograd.grad(out, params, dy)

    step(port)
    torch.cuda.synchronize()
    _build.reset_launches()
    out, grads = step(port)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    check_launches("unet_group_norm", launches,
                   {"group_norm_fwd": 2, "group_norm_bwd": 2})
    ref_out, ref_grads = step(plain)
    names = ["x"] + [f"{kind}{i}.{p}" for kind, mods in (("norm", norms),
                                                         ("conv", convs))
                     for i, m in enumerate(mods)
                     for p, _ in m.named_parameters()]
    rels = {"out": rel_err(out, ref_out),
            **{f"d{n}": rel_err(g, r)
               for n, g, r in zip(names, grads, ref_grads)}}
    over = {k: v for k, v in rels.items() if not v <= PATH_REL_BAR}
    if over:
        raise AssertionError(f"unet_group_norm: over {PATH_REL_BAR} against "
                             f"the plain fp32 norm: {over}")
    del out, grads, ref_out, ref_grads
    ms = {label: time_ms(partial(step, fn), 10)
          for label, fn in (("port", port), ("library", library),
                            ("plain", plain))}
    wall, acts = device_profile(partial(step, port))
    busy = sum(t for t, _ in acts.values())
    gn_ms = {k: sum(t for a, (t, _) in acts.items()
                    if any(sym in a for sym in KERNEL_SYMBOLS[k]))
             for k in GROUP_NORM_KERNELS}
    emit("unet_group_norm", shape=[UNET_BATCH, c, side, side],
         dtype="bfloat16", groups=UNET_GROUPS, act=act, eps=eps,
         rel_bar=PATH_REL_BAR, rel_err=rels,
         launches={k: launches[k] for k in GROUP_NORM_KERNELS},
         ms_per_fwd_bwd=ms["port"], library_ms_per_fwd_bwd=ms["library"],
         plain_ms_per_fwd_bwd=ms["plain"],
         library="F.group_norm + F.silu in bf16 (weights cast to bf16)",
         group_norm_device_ms=gn_ms, device_busy_ms=busy,
         group_norm_share_of_device=sum(gn_ms.values()) / busy if busy
         else None, device_idle_share=1.0 - busy / 1e3 / wall,
         peak_memory_gib=(torch.cuda.max_memory_allocated() - live) / 2 ** 30,
         nvidia_smi=smi)
    return launches


#: device activity classes of a ResNet-50 step, by kernel-name fragment
#: (first match wins): the SGD kernel, the batch-norm apply and backward
#: ops, cuDNN's convolutions, reductions (the norms' fp32 sums, the mean
#: pool, the loss), pooling, other elementwise ops (casts, ReLU, the
#: residual adds)
RESNET_KERNEL_CLASSES = (
    ("sgd", ("sgd_kernel",)), ("batch_norm", ("batch_norm",)),
    ("convolution", ("conv", "xmma", "cutlass", "cudnn", "implicit", "gemm",
                     "fprop", "dgrad", "wgrad")),
    ("reduction", ("reduce_kernel",)), ("pool", ("pool",)),
    ("elementwise", ("elementwise",)))


def profile_resnet(step) -> None:
    """One profiled ResNet-50 training step: device busy and idle share,
    the SGD kernel's share of device time, device ms by class
    (``RESNET_KERNEL_CLASSES``), the top device items."""
    wall, acts = device_profile(step)
    busy = sum(t for t, _ in acts.values())
    by_class = {}
    for k, (t, _) in acts.items():
        cls = next((c for c, frags in RESNET_KERNEL_CLASSES
                    if any(f in k for f in frags)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + t
    sgd_ms = by_class.get("sgd", 0.0)
    top = sorted(acts.items(), key=lambda kv: -kv[1][0])[:15]
    emit("resnet_bf16_profile", wall_s=wall, device_busy_s=busy / 1e3,
         device_idle_share=1.0 - busy / 1e3 / wall, sgd_kernel_ms=sgd_ms,
         sgd_share_of_device=sgd_ms / busy if busy else None,
         device_ms_by_class=by_class,
         top_device=[dict(name=k[:120], ms=t, count=c)
                     for k, (t, c) in top])


def op_device_ms(acts, symbols) -> dict:
    """An op's device ms a call in a profile (``device_profile``'s
    activities), its launches being one kernel of each of ``symbols`` a
    call: the time of every kernel whose name holds one of them, over the
    most launches seen of any one."""
    counts = [sum(c for k, (_, c) in acts.items() if sym in k)
              for sym in symbols]
    total = sum(t for k, (t, _) in acts.items()
                if any(sym in k for sym in symbols))
    calls = max(counts)
    return dict(ms_per_call=total / calls if calls else None, calls=calls,
                ms=total)


def profile_phase(phase: str, fn, cpu: bool = True, ops=None,
                  **fields) -> None:
    """One run of ``fn`` under the profiler: device busy and idle share and
    the top device items (``cpu=False``: the host's ops untraced); with
    ``ops`` ({name: symbols}), each op's device ms a call
    (``op_device_ms``)."""
    wall, acts = device_profile(fn, cpu=cpu)
    busy = sum(t for t, _ in acts.values())
    top = sorted(acts.items(), key=lambda kv: -kv[1][0])[:15]
    if ops:
        fields["op_device_ms"] = {name: op_device_ms(acts, symbols)
                                  for name, symbols in ops.items()}
    emit(phase, **fields, wall_s=wall, device_busy_s=busy / 1e3,
         device_idle_share=1.0 - busy / 1e3 / wall,
         top_device=[dict(name=k[:120], ms=t, count=c)
                     for k, (t, c) in top])


# --- the ring-attention slice: context parallelism on one card -------------


def offset_pairs(sq: int, sk: int, causal: bool, window, offset) -> int:
    """Visible (query, key) pairs of one head under ``causal`` and a
    ``window`` on the diagonal ``offset`` (row r sees keys <= r + offset,
    and >= r + offset - (window - 1))."""
    import numpy as np

    rows = np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk - 1, rows + offset) if causal else np.full(sq, sk - 1)
    lo = (np.maximum(0, rows + offset - (window - 1)) if window is not None
          else np.zeros(sq, dtype=np.int64))
    return int(np.maximum(0, hi - lo + 1).sum())


def ring_row_cases():
    """``(kind, batch, heads, kv heads, S, d, causal, window, offset, rate,
    row0, col0)`` of the ring branches' kernel rows. Mistral-7B's widths,
    window 4096: on a sequence-ordered ring step's chunk of 4096 tokens at
    the offset of its hop (4096, what ``ring_train_bf16``'s ring layout
    runs), at 2048 and 6144 and at a negative one (the first 1024 rows see
    nothing); on zigzag's half-chunk of 2048 tokens at the offsets its
    windowed ring runs there (2048, 4096). Dropout 0.1 at the last rank's
    global origins, the diagonal step (causal) and its first hop (not
    causal): on the ``ring_attention`` phase's sequence-ordered chunk (1 x
    32 x 1024 x 128 over 8 kv heads) and at GPT-2-small's widths."""
    m = (1, MISTRAL_HEADS, MISTRAL_KV_HEADS, RING_CHUNK, MISTRAL_HEAD_DIM)
    z = (1, MISTRAL_HEADS, MISTRAL_KV_HEADS, RING_CHUNK // 2,
         MISTRAL_HEAD_DIM)
    s_loc = RING_ATTN["seq"] // RING_CP
    a = (RING_ATTN["batch"], RING_ATTN["heads"], RING_ATTN["kv_heads"],
         s_loc, RING_ATTN["d"])
    g = (TRAIN_BATCH, 12, 12, TRAIN_SEQ, 64)
    last = RING_CP - 1
    return ([(f"offset {off}", *m, True, MISTRAL_WINDOW, off, 0.0, 0, 0)
             for off in RING_OFFSETS]
            + [(f"zigzag offset {off}", *z, True, MISTRAL_WINDOW, off, 0.0,
                0, 0) for off in RING_ZIGZAG_OFFSETS]
            + [(f"{kind} causal", *shape, True, None, None, RING_DROPOUT,
                last * n, last * n)
               for kind, shape, n in (("attn", a, s_loc),
                                      ("gpt", g, TRAIN_SEQ))]
            + [(f"{kind} noncausal", *shape, False, None, None,
                RING_DROPOUT, last * n, (last - 1) * n)
               for kind, shape, n in (("attn", a, s_loc),
                                      ("gpt", g, TRAIN_SEQ))])


def check_flash_ring(gen, dev):
    """The ring branches of the three flash kernels (``ring_row_cases``),
    fp32 and bf16, each held against its twin within ``TOL`` (the atol cut
    to ``RMS_ATOL`` of the twin's RMS), with an LSE cotangent in the
    backward. Timed by ``queued_ms`` over ``BIG_ITERS`` calls; the bound
    counts the visible pairs of the offset band; the library call is
    ``scaled_dot_product_attention`` with the offset band as a boolean
    ``attn_mask`` and K/V expanded, and its backward (dq, dk and dv
    together); the dropout rows are timed against
    ``scaled_dot_product_attention`` with ``dropout_p`` and K/V expanded,
    and its backward (a yardstick only: its dropout draws other bits)."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

    out = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for (kind, b, h, hkv, s, d, causal, window, off, rate, row0,
             col0) in ring_row_cases():
            masking = fa.Masking(causal=causal, window=window,
                                 causal_offset=off, dropout_rate=rate,
                                 dropout_seed=SEED, dropout_row0=row0,
                                 dropout_col0=col0)
            scale = d ** -0.5
            q, do = (torch.randn(b, h, s, d, generator=gen).to(dev, dtype)
                     for _ in range(2))
            k, v = (torch.randn(b, hkv, s, d, generator=gen).to(dev, dtype)
                    for _ in range(2))
            dlse = torch.randn(b, h, s, generator=gen).to(dev)
            kw = dict(scale=scale, masking=masking)
            names = [fa.launch_name(n, masking, None, s, s) for n in
                     ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")]
            o, lse = fa.flash_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
            errs = {names[0]: compare(names[0], o, ro, dn, rms_atol=True)}
            compare(f"{names[0]} lse", lse, rlse, "float32")
            out_rms = {names[0]: [rms_of(ro)]}
            delta = fa.flash_bwd_delta(ro, do, dlse)
            args = (q, k, v, do, rlse, delta)
            del o, lse, ro
            dq = fa.flash_bwd_dq(*args, **kw)
            dk, dv = fa.flash_bwd_dkdv(*args, **kw)
            torch.cuda.synchronize()
            rdq = fa.flash_bwd_dq_reference(*args, **kw)
            rdk, rdv = fa.flash_bwd_dkdv_reference(*args, **kw)
            errs[names[1]] = compare(names[1], dq, rdq, dn, rms_atol=True)
            errs[names[2]] = max(
                compare(f"{names[2]} dk", dk, rdk, dn, rms_atol=True),
                compare(f"{names[2]} dv", dv, rdv, dn, rms_atol=True))
            out_rms.update({names[1]: [rms_of(rdq)],
                            names[2]: [rms_of(rdk), rms_of(rdv)]})
            del dq, dk, dv, rdq, rdk, rdv
            library = dict.fromkeys(names)
            if rate == 0.0:
                rows = torch.arange(s, device=dev)[:, None]
                cols = torch.arange(s, device=dev)[None, :]
                band = (cols <= rows + off) & (cols > rows + off - window)
                ke, ve = (t.repeat_interleave(h // hkv, dim=1)
                          for t in (k, v))
                library[names[0]] = queued_ms(partial(
                    F.scaled_dot_product_attention, q, ke, ve,
                    attn_mask=band), BIG_ITERS)
                ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
                ol = F.scaled_dot_product_attention(
                    ql, kl.repeat_interleave(h // hkv, dim=1),
                    vl.repeat_interleave(h // hkv, dim=1), attn_mask=band)
                library[names[1]] = library[names[2]] = queued_ms(partial(
                    torch.autograd.grad, ol, (ql, kl, vl), do,
                    retain_graph=True), BIG_ITERS)
                del ol, ql, kl, vl, ke, ve, band
            else:
                # a yardstick only: the library's dropout draws other bits
                ke, ve = (t.repeat_interleave(h // hkv, dim=1)
                          for t in (k, v))
                library[names[0]] = queued_ms(partial(
                    F.scaled_dot_product_attention, q, ke, ve,
                    is_causal=causal, dropout_p=rate), BIG_ITERS)
                ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
                ol = F.scaled_dot_product_attention(
                    ql, kl.repeat_interleave(h // hkv, dim=1),
                    vl.repeat_interleave(h // hkv, dim=1), is_causal=causal,
                    dropout_p=rate)
                library[names[1]] = library[names[2]] = queued_ms(partial(
                    torch.autograd.grad, ol, (ql, kl, vl), do,
                    retain_graph=True), BIG_ITERS)
                del ol, ql, kl, vl, ke, ve
            lib_name = ("scaled_dot_product_attention, the offset band as "
                        "a boolean attn_mask, K/V expanded" if rate == 0.0
                        else "scaled_dot_product_attention(is_causal, "
                        "dropout_p), K/V expanded, a yardstick only: its "
                        "dropout draws other bits")
            elt = q.element_size()
            pairs = b * h * offset_pairs(s, s, causal, window,
                                         0 if off is None else off)
            q_bytes, kv_bytes = b * h * s * d * elt, b * hkv * s * d * elt
            row_stats = b * h * s * 4
            for name, fn, plain, call, nbytes, flops in (
                    (names[0], fa.flash_fwd, fa.flash_attention_reference,
                     (q, k, v), 2 * q_bytes + 2 * kv_bytes + row_stats,
                     4 * pairs * d),
                    (names[1], fa.flash_bwd_dq, fa.flash_bwd_dq_reference,
                     args, 3 * q_bytes + 2 * kv_bytes + 2 * row_stats,
                     6 * pairs * d),
                    (names[2], fa.flash_bwd_dkdv,
                     fa.flash_bwd_dkdv_reference, args,
                     2 * q_bytes + 4 * kv_bytes + 2 * row_stats,
                     8 * pairs * d)):
                bms, by = bound_ms(nbytes, flops, dn)
                kernel = partial(fn, *call, **kw)
                ms = queued_ms(kernel, BIG_ITERS)
                out.append((dict(
                    name=name, dtype=dn, kind=kind, shape=[b, h, s, d],
                    kv_heads=hkv, causal=causal, window=window,
                    causal_offset=off, dropout=rate, dropout_origin=[row0,
                                                                     col0],
                    path="ring", max_abs_err=errs[name],
                    out_rms=out_rms[name], visible_pairs=pairs, ms=ms,
                    tflops=achieved_tflops(flops, ms),
                    plain_ms=queued_ms(partial(plain, *call, **kw),
                                       BIG_ITERS),
                    library_ms=library[name],
                    library=None if library[name] is None else
                    lib_name + ("" if name == names[0] else
                       "; its backward: dq, dk and dv together"),
                    bound_ms=bms, bound_by=by), kernel))
    return out


def ring_attention_phase(smi) -> dict:
    """``ring_attention`` and ``ring_attention_zigzag`` through the
    in-process ring of ``RING_CP`` ranks on the card (``RING_ATTN``: GQA,
    dropout 0.1), causal, not causal and windowed, each held against ONE
    unsharded ``flash_attention_with_lse`` call on the card with the same
    seed: the output and (dq, dk, dv) within ``RING_ATTN_TOL`` times (the
    tensor's RMS + |entry|). fp32: the two sum the same products in other
    orders (dk and dv over the four query heads and every chunk's rows,
    added by autograd in the ring) and merge the ring's partials, so an
    entry errs by a few ulps of the terms it sums, whatever its own size;
    a keep mask that differed by one pair would move an output entry by ~p
    v / 0.9 ~ 7e-4, some 300 times the output's bar. Every ring branch must
    launch. Returns the ring calls' launches by layout (``ring`` and
    ``zigzag``): the layouts cut the sequence into chunks of different
    lengths."""
    import torch

    from apex_tpu_torch.ops import (flash_attention_with_lse, from_zigzag,
                                    ring_attention, ring_attention_zigzag,
                                    to_zigzag)
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops.ring_attention import LocalRing

    c, cp = RING_ATTN, RING_CP
    gen = torch.Generator().manual_seed(SEED)
    q, do = (torch.randn(c["batch"], c["heads"], c["seq"], c["d"],
                         generator=gen).to(DEV) for _ in range(2))
    k, v = (torch.randn(c["batch"], c["kv_heads"], c["seq"], c["d"],
                        generator=gen).to(DEV) for _ in range(2))
    ring = LocalRing(cp)
    launches = {layout: dict.fromkeys(dict(_build.launches), 0)
                for layout in ("ring", "zigzag")}
    results = []
    for layout, causal, window in (("ring", True, None),
                                   ("ring", False, None),
                                   ("ring", True, c["window"]),
                                   ("zigzag", True, None),
                                   ("zigzag", True, c["window"])):
        kw = dict(window=window, dropout_rate=RING_DROPOUT,
                  dropout_seed=SEED)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def unsharded():
            o = flash_attention_with_lse(*leaves, causal=causal, **kw)[0]
            return (o.detach(), *torch.autograd.grad(o, leaves, do))

        def sharded():
            if layout == "ring":
                o = ring_attention(*leaves, ring=ring, causal=causal, **kw)
                return (o.detach(), *torch.autograd.grad(o, leaves, do))
            zq, zk, zv = (to_zigzag(t, cp) for t in leaves)
            o = ring_attention_zigzag(zq, zk, zv, ring=ring, **kw)
            grads = torch.autograd.grad(o, leaves, to_zigzag(do, cp))
            return (from_zigzag(o.detach(), cp), *grads)

        want = unsharded()
        torch.cuda.synchronize()
        _build.reset_launches()
        got = sharded()
        torch.cuda.synchronize()
        case = dict(_build.launches)
        for name, n in case.items():
            launches[layout][name] += n
        errs = {name: compare(f"ring_attention {layout} {name}", g, w,
                              "float32", (RING_ATTN_TOL * rms_of(w),
                                          RING_ATTN_TOL))
                for name, g, w in zip(("o", "dq", "dk", "dv"), got, want)}
        results.append(dict(
            layout=layout, causal=causal, window=window, max_abs_err=errs,
            out_rms=rms_of(want[0]),
            ms=time_ms(sharded, 3), unsharded_ms=time_ms(unsharded, 3),
            launches={n: x for n, x in case.items() if x}))
        del want, got
    idle = [n for n in RING_KERNELS
            if not any(by[n] for by in launches.values())]
    if idle:
        raise AssertionError(f"ring_attention: no launch of {idle}")
    emit("ring_attention", cp=cp, shape=[c["batch"], c["heads"], c["seq"],
                                         c["d"]],
         kv_heads=c["kv_heads"], dropout=RING_DROPOUT, dtype="float32",
         tolerance=f"{RING_ATTN_TOL} (rms + |want|) per entry",
         ms="forward and backward",
         cases=results, launches={
             layout: {n: x for n, x in by.items() if x}
             for layout, by in launches.items()}, nvidia_smi=smi)
    return launches


def set_config(model, cfg) -> None:
    """Give ``model`` and its blocks ``cfg`` (a layout's context-parallel
    fields; the parameters do not depend on them)."""
    for m in model.modules():
        if hasattr(m, "config"):
            m.config = cfg


def ring_train_bf16(smi) -> dict:
    """Mistral-7B at full width, ``RING_TRAIN_LAYERS`` deep (32 need 116
    GB), trained on 1 x ``RING_TRAIN_SEQ`` tokens (four windows of 4096)
    over the in-process ring of ``RING_CP`` ranks, both layouts, bf16 over
    fp32 parameters, ``FusedAdam(lr=1e-4, weight_decay=0.01)``: warm steps,
    then timed steps. Step ms, tokens/s, MFU (PERF.md's formula at S =
    16384), peak memory, the launches per step of every flash name (the
    ``_window_ring`` branches > 0, the unwindowed and bias ones 0), then
    one profiled step (device time by kernel). Returns the timed ring
    layout's launches (the zigzag's under ``zigzag``)."""
    import torch

    from apex_tpu_torch.models import (LlamaModel, llama_loss,
                                       mistral_7b_config)
    from apex_tpu_torch.ops import _build, to_zigzag
    from apex_tpu_torch.transformer import parallel_state

    b, s, cp = 1, RING_TRAIN_SEQ, RING_CP
    out = {}
    parallel_state.initialize_model_parallel(1, 1, context_parallel_size_=cp)
    try:
        for layout in ("ring", "zigzag"):
            live = phase_memory_start()
            cfg = mistral_7b_config(
                num_layers=RING_TRAIN_LAYERS, context_parallel=True,
                context_parallel_zigzag=layout == "zigzag")
            model = LlamaModel(cfg, device=DEV, generator=torch.Generator(
                device=DEV).manual_seed(SEED))
            opt = make_optimizer(model)
            ids, labels = train_batch(cfg, b, s, DEV)
            if layout == "zigzag":
                ids, labels = (to_zigzag(t, cp, axis=1) for t in (ids, labels))

            def step():
                opt.zero_grad()
                loss = llama_loss(model, ids, labels)
                loss.backward()
                opt.step()
                return loss.detach()

            losses = [step() for _ in range(RING_TRAIN_WARM)]
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            losses += [step() for _ in range(RING_TRAIN_TIMED)]
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            launches = dict(_build.launches)
            peak = (torch.cuda.max_memory_allocated() - live) / 2 ** 30
            with torch.no_grad():
                final = llama_loss(model, ids, labels).item()
            losses = [x.item() for x in losses]
            per_step = {k: n / RING_TRAIN_TIMED for k, n in launches.items()
                        if n}
            stray = [k for k in per_step if k.startswith("flash")
                     and ("window" not in k or "bias" in k)]
            idle = [k for k in RING_KERNELS if "window" in k
                    and not launches[k]]
            if stray or idle or any(n != int(n) for n in per_step.values()):
                raise AssertionError(f"ring_train_bf16 {layout}: launches "
                                     f"per step {per_step}; no launch of "
                                     f"{idle}")
            if not all(map(math.isfinite, losses + [final])) \
                    or not final < losses[0]:
                raise AssertionError(f"ring_train_bf16 {layout}: loss not "
                                     f"finite and falling: {losses} then "
                                     f"{final}")
            step_s = elapsed / RING_TRAIN_TIMED
            flops = mistral_train_flops(cfg, b, s)
            emit("ring_train_bf16", layout=layout, cp=cp, batch=b, seq=s,
                 layers=cfg.num_layers, layers_published=32,
                 window=cfg.sliding_window, hidden=cfg.hidden_size,
                 heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                 parameters=sum(p.numel() for p in model.parameters()),
                 timed_steps=RING_TRAIN_TIMED, step_ms=step_s * 1e3,
                 tokens_per_s=b * s / step_s, flops_per_step=flops,
                 flops_formula="6 * (L (2 e^2 + 2 e e_kv + 3 e f) + V e) * "
                               "B * S + 12 L * B H pairs(S, w) * d",
                 mfu=flops / step_s / PEAK_FLOPS["bfloat16"],
                 bound_ms=flops / PEAK_FLOPS["bfloat16"] * 1e3,
                 losses=losses, loss_after=final,
                 launches_per_step=per_step, peak_memory_gib=peak,
                 earlier_phases_live_gib=live / 2 ** 30, nvidia_smi=smi,
                 card_after=card_state())
            profile_phase("ring_train_bf16_profile", step, layout=layout)
            out[layout] = launches
            del model, opt, step
            torch.cuda.empty_cache()
    finally:
        parallel_state.destroy_model_parallel()
    return out


def ring_train_fp32() -> None:
    """The bar: Mistral-7B at full width, depth, window and length cut
    (``RING_TRAIN_FP32``: window below S_loc, so every ring step carries an
    offset), fp32, over the in-process ring of ``RING_CP`` ranks, both
    layouts, two ``FusedAdam`` steps. Each layout's card step against the
    CPU's (the twins through the same ring) and against the same weights
    without context parallelism on the card: the fp64 cross-entropy of the
    logits within 1e-4 relative, every gradient within ``RING_FLOOR_FACTOR``
    times the CPU's own one-rounding floor (``perturbed``; measured in this
    run on the ring layout's CPU step) or 1e-3 of its norm; after the first
    step, the CP and plain card models again; after the second, their
    losses."""
    import torch

    from apex_tpu_torch.models import (LlamaModel, lm_token_loss,
                                       mistral_7b_config)
    from apex_tpu_torch.ops import _build, to_zigzag
    from apex_tpu_torch.transformer import parallel_state

    c, cp = RING_TRAIN_FP32, RING_CP
    base = mistral_7b_config(num_layers=c["layers"],
                             sliding_window=c["window"], dtype=torch.float32,
                             param_dtype=torch.float32)

    def layout_cfg(layout):
        return dataclasses.replace(base, context_parallel=True,
                                   context_parallel_zigzag=layout == "zigzag")

    def loss_grads(model, ids, labels, backward=True):
        """(fp32 loss, fp64 cross-entropy of the logits, gradients)."""
        for p in model.parameters():
            p.grad = None
        with torch.set_grad_enabled(backward):
            logits = model(ids)
            loss = lm_token_loss(logits, labels)
        logp = torch.log_softmax(logits.detach().double(), dim=-1)
        ce = -logp.gather(-1, labels.long()[..., None])[..., 0].mean().item()
        if not backward:
            return loss.item(), ce, None
        loss.backward()
        return loss.item(), ce, {n: p.grad.detach().cpu().clone()
                                 for n, p in model.named_parameters()}

    def close(phase, a, b):
        if abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"{phase}: cross-entropies {a} and {b} "
                                 f"differ by more than 1e-4 relative")

    parallel_state.initialize_model_parallel(1, 1, context_parallel_size_=cp)
    try:
        cpu = LlamaModel(layout_cfg("ring"), device="cpu",
                         generator=torch.Generator().manual_seed(SEED))
        state = cpu.state_dict()
        ids0, labels0 = train_batch(base, c["batch"], c["seq"], "cpu")
        cpu_ring = loss_grads(cpu, ids0, labels0)
        with perturbed(cpu, SEED + 1):
            floor = loss_grads(cpu, ids0, labels0)[2]

        def floor_at(want):
            """``want`` moved by the CPU's own one-rounding change, so that
            ``floor_grad_bars`` reads |CPU' - CPU| whatever it compares."""
            return {n: want[n] + (floor[n] - cpu_ring[2][n]) for n in want}

        lines = {}
        for layout in ("ring", "zigzag"):
            cfg = layout_cfg(layout)
            ids, labels = ids0, labels0
            if layout == "zigzag":
                ids, labels = (to_zigzag(t, cp, axis=1) for t in (ids, labels))
                set_config(cpu, cfg)
                cpu_side = loss_grads(cpu, ids, labels)
            else:
                cpu_side = cpu_ring
            card = LlamaModel(cfg, device=DEV, generator=torch.Generator(
                device=DEV).manual_seed(SEED))
            plain = LlamaModel(base, device=DEV, generator=torch.Generator(
                device=DEV).manual_seed(SEED))
            for m in (card, plain):
                m.load_state_dict(state)
            opts = [make_optimizer(m, TRAIN_LR) for m in (card, plain)]
            ids, labels = ids.to(DEV), labels.to(DEV)
            plain_ids, plain_labels = ids0.to(DEV), labels0.to(DEV)
            phase = f"ring_train_fp32 {layout}"
            torch.cuda.synchronize()
            _build.reset_launches()
            got = loss_grads(card, ids, labels)
            torch.cuda.synchronize()
            launches = dict(_build.launches)
            want = loss_grads(plain, plain_ids, plain_labels)
            close(f"{phase} card against CPU", got[1], cpu_side[1])
            close(f"{phase} CP against plain", got[1], want[1])
            vs_cpu = floor_grad_bars(f"{phase} card against CPU", got[2],
                                     cpu_side[2], floor_at(cpu_side[2]),
                                     RING_FLOOR_FACTOR)
            vs_plain = floor_grad_bars(f"{phase} CP against plain", got[2],
                                       want[2], floor_at(want[2]),
                                       RING_FLOOR_FACTOR)
            for opt in opts:            # each on its own model's .grad
                opt.step()
            got1 = loss_grads(card, ids, labels)
            want1 = loss_grads(plain, plain_ids, plain_labels)
            close(f"{phase} step 1", got1[1], want1[1])
            step1 = floor_grad_bars(f"{phase} step 1", got1[2], want1[2],
                                    floor_at(want1[2]), RING_FLOOR_FACTOR)
            for opt in opts:
                opt.step()
            got2 = loss_grads(card, ids, labels, backward=False)
            want2 = loss_grads(plain, plain_ids, plain_labels, backward=False)
            close(f"{phase} step 2", got2[1], want2[1])
            idle = [k for k in RING_KERNELS if "window" in k
                    and not launches[k]]
            if idle:
                raise AssertionError(f"{phase}: no launch of {idle}")

            def worst(bars):
                return max(e / max(1e-3 * n, RING_FLOOR_FACTOR * f, 1e-30)
                           for n, e, f, _, _ in bars.values())

            lines[layout] = dict(
                ce64_card=[got[1], got1[1], got2[1]],
                ce64_plain=[want[1], want1[1], want2[1]],
                ce64_cpu=cpu_side[1], losses_card=[got[0], got1[0], got2[0]],
                worst_share_of_bar_vs_cpu=worst(vs_cpu),
                worst_share_of_bar_vs_plain=worst(vs_plain),
                worst_share_of_bar_step1=worst(step1),
                median_floor_rel=sorted(
                    f / n for n, _, f, _, _ in vs_cpu.values() if n)[
                        len(vs_cpu) // 2],
                launches={k: n for k, n in launches.items() if n})
            del card, plain, opts
            torch.cuda.empty_cache()
    finally:
        parallel_state.destroy_model_parallel()
    emit("ring_train_fp32", cp=cp, batch=c["batch"], seq=c["seq"],
         layers=c["layers"], window=c["window"], s_loc=c["seq"] // cp,
         s_half=c["seq"] // (2 * cp), lr=TRAIN_LR,
         grad_bar=f"|card - want| <= max(1e-3 |want|, {RING_FLOOR_FACTOR} "
                  f"x |CPU' - CPU|) per tensor, Frobenius",
         params_with_grad=len(floor), layouts=lines)
    del cpu, state
    torch.cuda.empty_cache()


def ring_gpt(smi) -> dict:
    """GPT-2-small (its widths, fp32) at 8 x 1024 tokens (its
    ``max_position_embeddings``), zigzag over the in-process ring of
    ``RING_CP`` ranks, two FusedAdam steps, held against the same weights
    without context parallelism on the card: the losses within 1e-4
    relative, every gradient per entry (``grad_bars``) at both steps; then
    the port's example ``run_training`` at its defaults on the card, whose
    loss must fall. With no window and no dropout the ring gives no offset
    that moves a diagonal, so its steps launch the plain flash branches
    and no ``_ring`` or windowed one. Returns the CP steps' launches."""
    import torch

    from apex_tpu_torch.examples.long_context.train_ring_attention import (
        run_training)
    from apex_tpu_torch.models import GPTModel, gpt2_small_config, gpt_loss
    from apex_tpu_torch.ops import _build, to_zigzag
    from apex_tpu_torch.transformer import parallel_state

    cp = RING_CP
    base = gpt2_small_config(dtype=torch.float32)
    cfg = dataclasses.replace(base, context_parallel=True,
                              context_parallel_zigzag=True)
    ids, labels = train_batch(base, TRAIN_BATCH, TRAIN_SEQ, DEV)
    zids, zlabels = (to_zigzag(t, cp, axis=1) for t in (ids, labels))
    models = {"cp": GPTModel(cfg, device=DEV), "plain": GPTModel(base,
                                                                 device=DEV)}
    models["plain"].load_state_dict(models["cp"].state_dict())
    opts = {k: make_optimizer(m) for k, m in models.items()}
    batches = {"cp": (zids, zlabels), "plain": (ids, labels)}
    launches = dict.fromkeys(dict(_build.launches), 0)
    losses = {k: [] for k in models}
    bars = []
    parallel_state.initialize_model_parallel(1, 1, context_parallel_size_=cp)
    try:
        for _ in range(2):
            grads = {}
            for k, m in models.items():
                opts[k].zero_grad()
                torch.cuda.synchronize()
                _build.reset_launches()
                loss = gpt_loss(m, *batches[k])
                loss.backward()
                torch.cuda.synchronize()
                if k == "cp":
                    for n, x in dict(_build.launches).items():
                        launches[n] += x
                losses[k].append(loss.item())
                grads[k] = {n: p.grad.detach().clone()
                            for n, p in m.named_parameters()}
            if abs(losses["cp"][-1] - losses["plain"][-1]) \
                    > 1e-4 * abs(losses["plain"][-1]):
                raise AssertionError(f"ring_gpt: losses {losses}")
            b = grad_bars("ring_gpt", grads["cp"],
                          {n: g.cpu() for n, g in grads["plain"].items()})
            bars.append(max(e for _, e in b.values()))
            for opt in opts.values():
                opt.step()
    finally:
        parallel_state.destroy_model_parallel()
    plain = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")
    idle = [k for k in plain if not launches[k]]
    stray = [k for k, n in launches.items()
             if n and k.startswith("flash") and k not in plain]
    if idle or stray:
        raise AssertionError(f"ring_gpt: no launch of {idle}; windowed or "
                             f"ring launches {stray}")
    del models, opts
    torch.cuda.empty_cache()
    example = run_training(device=DEV, verbose=lambda *_: None)
    if not all(map(math.isfinite, example)) or not example[-1] < example[0]:
        raise AssertionError(f"ring_gpt: the example's loss did not fall: "
                             f"{example}")
    emit("ring_gpt", cp=cp, layout="zigzag", batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, dtype="float32", losses=losses,
         grads_max_abs_err=bars,
         grad_bar="atol = min(1e-4, 1e-3 max|g|) per tensor, rtol 1e-3",
         launches={n: x for n, x in launches.items() if x},
         example_losses=example, nvidia_smi=smi)
    return launches


# --- the host side of serving (ROADMAP A6) -----------------------------------

#: sampled decode: the knobs, the seed, and the (num_slots, sync_every)
#: runs whose tokens must equal the timed run's
SAMPLE_KW = dict(temperature=0.8, top_k=50, top_p=0.95, rng=SEED)
SAMPLE_INVARIANCE = ((3, 1), (NUM_SLOTS, 4))
#: the shared-prefix trace: system prompts of 3-6 pages, requests adding
#: private tails of 8-64 tokens, PREFIX_NEW new tokens each
PREFIX_SYSTEM_PAGES = (3, 4, 5, 6)
PREFIX_REQUESTS, PREFIX_NEW = 24, 32
PREFIX_CPU_REQUESTS = 12      # the CPU side's share of the trace (S18)
#: forced preemption: PREEMPT_LOW low-priority requests fill the slots,
#: PREEMPT_HIGH high-priority ones with a TTFT deadline arrive after
#: PREEMPT_WARM pump iterations
PREEMPT_LOW, PREEMPT_HIGH, PREEMPT_WARM = NUM_SLOTS, 4, 6
PREEMPT_NEW_LOW, PREEMPT_NEW_HIGH, PREEMPT_DEADLINE_MS = 64, 24, 50.0
#: beam search: GPT-2-small (2 prompts of 24 tokens) and t5-small (2
#: encoder inputs of 64 tokens), 4 beams, BEAM_NEW tokens, fp32
BEAM_WIDTH, BEAM_NEW, BEAM_PROMPT, BEAM_ENC = 4, 16, 24, 64
BEAM_SCORE_RTOL = 1e-4
#: the bf16 bar of two runs that compute a token by other kernels (a
#: shared prefix's tail against the cold prefill, a resumed request's
#: re-prefilled tail against its decode steps): at a request's first
#: differing token, the reference run's two candidates' fp64 logits (their
#: perturbed scores when sampled) within this many bf16 ulps of the larger
#: logit; fp32 holds the same runs to token identity
NEAR_TIE_BF16_ULPS = 2


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at ``|x|`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def near_tie_check(phase: str, model, prompts, got, want, streams=None
                   ) -> dict:
    """Requests whose tokens ``got`` leave ``want``'s (the reference run),
    each held to a bf16 near tie at its first differing token
    (``NEAR_TIE_BF16_ULPS`` bf16 ulps of the larger of the two tokens'
    logits, ``bar``): the fp64 logits there from a no-cache forward of the
    prompt and ``want``'s tokens before (``fp64_divergence``), greedy
    within ``bar`` of each other. Sampled (``streams``: each request's
    noise stream) the choice is ``SAMPLE_KW``'s filter, then the argmax of
    logit / T plus the Gumbel noise of the token's index, so a near tie is
    either the two perturbed scores within ``bar / T``, or one of the two
    tokens at the filter's edge: its logit / T within ``bar / T`` of the
    top-k cut, or the fp64 mass before it within ``bar / T`` of ``top_p``.
    Returns the divergences by request."""
    import torch

    from apex_tpu_torch.models.generation import sample_noise

    out = {}
    for i, (p, o, r) in enumerate(zip(prompts, got, want)):
        if o.shape == r.shape and (o == r).all():
            continue
        dv = fp64_divergence(model, p, o, r, with_logits=True)
        if "got_token" not in dv or "want_token" not in dv:
            raise AssertionError(f"{phase}: request {i}: one run's tokens "
                                 f"end where the other's go on ({dv})")
        a, b = dv["want_fp64_logit"], dv["got_fp64_logit"]
        bar = NEAR_TIE_BF16_ULPS * bf16_ulp(max(abs(a), abs(b)))
        if streams is None:
            dv.update(margin=abs(a - b), bar=bar, kind="argmax")
            near = abs(a - b) <= bar
        else:
            t, k, top_p = (SAMPLE_KW[n] for n in ("temperature", "top_k",
                                                  "top_p"))
            x = dv.pop("logits") / t
            bar /= t
            g = sample_noise(SAMPLE_KW["rng"], torch.tensor(
                [streams[i]], dtype=torch.int64), dv["step"],
                x.shape[0])[0].double()
            wt, gt = dv["want_token"], dv["got_token"]
            margin = abs((x[wt] + g[wt]) - (x[gt] + g[gt])).item()
            top = torch.sort(x, descending=True)
            kth = top.values[k - 1].item()
            edge_k = min(abs(x[wt].item() - kth), abs(x[gt].item() - kth))
            kept = top.values[:k]
            prob = torch.softmax(kept, dim=0)
            before = torch.cumsum(prob, dim=0) - prob
            rank = {int(tok): n for n, tok in enumerate(top.indices[:k])}
            edge_p = min((abs(before[rank[tok]].item() - top_p)
                          for tok in (wt, gt) if tok in rank),
                         default=float("inf"))
            dv.update(margin=margin, top_k_edge=edge_k, top_p_edge=edge_p,
                      bar=bar)
            near = min(margin, edge_k, edge_p) <= bar
        dv.pop("logits", None)
        if not near:
            raise AssertionError(f"{phase}: request {i} leaves the "
                                 f"reference past the bf16 near-tie bar "
                                 f"({dv})")
        out[i] = dv
    return out


def prefix_workload(vocab: int):
    """``PREFIX_REQUESTS`` prompts, request ``i`` system prompt ``i % 4``
    (``PREFIX_SYSTEM_PAGES`` pages) plus a private tail of 8-64 tokens
    (numpy seed ``SEED``)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 21)
    systems = [rng.integers(0, vocab, n * PAGE_SIZE).astype(np.int32)
               for n in PREFIX_SYSTEM_PAGES]
    return [np.concatenate([systems[i % len(systems)], rng.integers(
        0, vocab, int(rng.integers(8, 65))).astype(np.int32)])
        for i in range(PREFIX_REQUESTS)]


def engine_sampled_bf16(model, prompts, new_tokens, smi) -> dict:
    """Sampled decode (``SAMPLE_KW``) on ``engine_bf16``'s requests: a warm
    run, a timed one at ``NUM_SLOTS`` slots (tokens/s, host ms a decode
    step), then the runs of ``SAMPLE_INVARIANCE``, whose tokens must equal
    the timed run's (the draws depend on the request and the seed alone).
    Returns the timed run's launches."""
    drive_engine(model, prompts, new_tokens, **SAMPLE_KW)      # warm
    steps = {}
    outs, stats, elapsed, launches = drive_engine(
        model, prompts, new_tokens, step_times=steps, **SAMPLE_KW)[1:]
    runs = {}
    for slots, sync in SAMPLE_INVARIANCE:
        got, st = drive_engine(model, prompts, new_tokens, num_slots=slots,
                               sync_every=sync, **SAMPLE_KW)[1:3]
        bad = [i for i, (a, b) in enumerate(zip(got, outs))
               if a.shape != b.shape or (a != b).any()]
        if bad:
            raise AssertionError(f"engine_sampled_bf16: num_slots {slots}, "
                                 f"sync_every {sync}: requests {bad} draw "
                                 f"other tokens than at {NUM_SLOTS} slots")
        runs[f"slots{slots}_sync{sync}"] = dict(
            decode_steps=st["decode_steps"], token_identical=True)
    emit("engine_sampled_bf16", requests=len(prompts), num_slots=NUM_SLOTS,
         layers=model.config.num_layers,
         sampling={k: v for k, v in SAMPLE_KW.items() if k != "rng"},
         seed=SAMPLE_KW["rng"],
         tokens_per_s=stats["generated_tokens"] / elapsed, seconds=elapsed,
         host_ms_per_decode_step=steps["chunk_host_s"]
         / stats["decode_steps"] * 1e3,
         synced_ms_per_decode_step=steps["chunk_s"]
         / stats["decode_steps"] * 1e3,
         invariance=runs, launches=launches, nvidia_smi=smi,
         decode_steps=stats["decode_steps"],
         generated_tokens=stats["generated_tokens"])
    return launches


def prefix_run(model, prompts, prefix_cache: bool):
    """One engine run of the shared-prefix trace; returns ``(engine,
    outputs, stats, seconds, launches)`` (``drive_engine``, whose pool
    check counts the tree's cached pages as held)."""
    return drive_engine(model, prompts, [PREFIX_NEW] * len(prompts),
                        prefix_cache=prefix_cache)


def check_prefix_stats(phase: str, engine, stats) -> dict:
    """The prefix cache's counters and the pool after the drain: hits and
    skipped prefill tokens above 0, no page referenced, and the free stack
    exactly ``num_pages - 1 - (pages the tree caches)``."""
    if not (stats["prefix_hits"] > 0 and stats["prefill_tokens_skipped"] > 0):
        raise AssertionError(f"{phase}: no prefix hits ({stats})")
    usable = engine.cache["layers"][0]["k_pages"].shape[0] - 1
    cached = len(engine.prefix)
    free = engine.cache["free_top"]
    if free != usable - cached or int(engine.cache["page_ref"].sum()) != 0:
        raise AssertionError(f"{phase}: {free} pages free of {usable}, "
                             f"{cached} cached")
    return dict(prefix_hits=stats["prefix_hits"],
                prefill_tokens_total=stats["prefill_tokens_total"],
                prefill_tokens_skipped=stats["prefill_tokens_skipped"],
                evicted_pages=stats["evicted_pages"],
                free_pages_after=free, usable_pages=usable,
                cached_pages_after=cached,
                free_check="free_top == usable - cached pages, "
                           "sum(page_ref) == 0")


def engine_prefix_fp32(model) -> dict:
    """The shared-prefix trace in fp32 on the card with the prefix cache
    off and on, then on the CPU port with it on over the same weights: the
    three runs' tokens equal; hits and skipped tokens above 0; the pool
    after the drain holds every usable page but the cached ones. Returns
    the card's prefix-on launches."""
    import torch

    prompts = prefix_workload(model.config.vocab_size)
    off = prefix_run(model, prompts, False)
    eng, outs, stats, elapsed, launches = prefix_run(model, prompts, True)
    # the CPU side serves the first PREFIX_CPU_REQUESTS (ROADMAP S18), the
    # card again the same ones
    few = prompts[:PREFIX_CPU_REQUESTS]
    few_outs, few_stats = prefix_run(model, few, True)[1:3]
    cpu = build_model(torch.float32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    from apex_tpu_torch.serving import PagedDecodeEngine, Request

    cpu_eng = PagedDecodeEngine(cpu, num_slots=NUM_SLOTS,
                                page_size=PAGE_SIZE, prefix_cache=True)
    cpu_outs, cpu_stats = cpu_eng.run([Request(p, PREFIX_NEW)
                                       for p in few])
    for label, got, other in (("prefix off", outs, off[1]),
                              ("the CPU port", few_outs, cpu_outs)):
        bad = [i for i, (a, b) in enumerate(zip(got, other))
               if a.shape != b.shape or (a != b).any()]
        if bad:
            raise AssertionError(f"engine_prefix_fp32: requests {bad}: "
                                 f"prefix-on tokens differ from {label}'s")
    line = check_prefix_stats("engine_prefix_fp32", eng, stats)
    for key in ("prefix_hits", "prefill_tokens_skipped", "evicted_pages"):
        if cpu_stats[key] != few_stats[key] or not cpu_stats["prefix_hits"]:
            raise AssertionError(
                f"engine_prefix_fp32: {key} {few_stats[key]} on the card, "
                f"{cpu_stats[key]} on the CPU ({len(few)} requests)")
    del cpu, cpu_eng
    emit("engine_prefix_fp32", requests=len(prompts),
         system_pages=list(PREFIX_SYSTEM_PAGES), new_tokens=PREFIX_NEW,
         layers=model.config.num_layers, token_identical_off=True,
         token_identical_cpu=True, cpu_requests=len(few),
         cpu_prefix_hits=cpu_stats["prefix_hits"], seconds=elapsed,
         seconds_prefix_off=off[3], launches=launches,
         decode_steps=stats["decode_steps"], **line)
    return launches


def engine_prefix_bf16(model, smi) -> dict:
    """The shared-prefix trace in bf16: prefix on gives the tokens of
    prefix off but at bf16 near ties (``near_tie_check``: the tail's GEMMs
    run at other row counts than the cold prefill's, so a near-tied argmax
    may flip, as the reference notes for bf16); counters and pool as in
    fp32; tokens/s and prefill tokens both ways (a warm run first).
    Returns the prefix-on launches."""
    prompts = prefix_workload(model.config.vocab_size)
    prefix_run(model, prompts, True)                          # warm
    off = prefix_run(model, prompts, False)
    eng, outs, stats, elapsed, launches = prefix_run(model, prompts, True)
    ties = near_tie_check("engine_prefix_bf16", model, prompts, outs,
                          off[1])
    line = check_prefix_stats("engine_prefix_bf16", eng, stats)
    emit("engine_prefix_bf16", requests=len(prompts),
         system_pages=list(PREFIX_SYSTEM_PAGES), new_tokens=PREFIX_NEW,
         layers=model.config.num_layers,
         token_identical_off=len(prompts) - len(ties),
         near_ties=ties, near_tie_ulps=NEAR_TIE_BF16_ULPS,
         tokens_per_s=stats["generated_tokens"] / elapsed,
         tokens_per_s_prefix_off=off[2]["generated_tokens"] / off[3],
         seconds=elapsed, seconds_prefix_off=off[3],
         prefill_tokens_computed=stats["prefill_tokens_computed"],
         prefill_tokens_computed_off=off[2]["prefill_tokens_computed"],
         ttft_ms_p50=stats["ttft_ms_p50"], ttft_ms_p95=stats["ttft_ms_p95"],
         launches=launches, nvidia_smi=smi, **line)
    return launches


def preempt_run(model, preempt: bool, sampled: bool):
    """``PREEMPT_LOW`` low-priority requests fill the slots; after
    ``PREEMPT_WARM`` pump iterations ``PREEMPT_HIGH`` priority-5 requests
    with a ``PREEMPT_DEADLINE_MS`` TTFT deadline arrive; the frontend
    (prefix cache on, so a victim's pages spill into the tree) drains.
    ``preempt``: ``PriorityDeadlinePolicy(preempt_on_priority=True)``, else
    ``preemption=False``. Returns ``(frontend, outputs, launches,
    prompts)``, the requests in id order."""
    import numpy as np
    import torch

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.serving import (PagedDecodeEngine,
                                        PriorityDeadlinePolicy, Request,
                                        ServingFrontend)

    rng = np.random.default_rng(SEED + 31)
    vocab = model.config.vocab_size
    low = [Request(rng.integers(0, vocab, int(rng.integers(32, 97))).astype(
        np.int32), PREEMPT_NEW_LOW) for _ in range(PREEMPT_LOW)]
    high = [Request(rng.integers(0, vocab, int(rng.integers(16, 65))).astype(
        np.int32), PREEMPT_NEW_HIGH, priority=5,
        deadline_ms=PREEMPT_DEADLINE_MS) for _ in range(PREEMPT_HIGH)]
    engine = PagedDecodeEngine(model, num_slots=NUM_SLOTS,
                               page_size=PAGE_SIZE, prefix_cache=True,
                               **(SAMPLE_KW if sampled else {}))
    policy = (PriorityDeadlinePolicy(preempt_on_priority=True) if preempt
              else PriorityDeadlinePolicy(preemption=False))
    fe = ServingFrontend(engine, policy=policy)
    torch.cuda.synchronize()
    _build.reset_launches()
    handles = [fe.submit(r, request_id=i) for i, r in enumerate(low)]
    for _ in range(PREEMPT_WARM):
        fe.pump()
    handles += [fe.submit(r, request_id=PREEMPT_LOW + i)
                for i, r in enumerate(high)]
    fe.drain()
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    missing = [k for k in SERVING_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"frontend_preempt_bf16: no launch of {missing}")
    return (fe, [h.result(timeout=0) for h in handles], launches,
            [r.prompt for r in low + high])


def frontend_preempt_bf16(model, smi) -> dict:
    """Forced preemption through ``ServingFrontend``, greedy and sampled:
    each run with preemption on gives the tokens of the same schedule with
    it off but at bf16 near ties (``near_tie_check``: a resume re-prefills
    its last page's tokens, which the undisturbed run computed in decode
    steps at other row counts and through the paged kernel); preemptions
    > 0 and resumes == preemptions; TTFT p50/p95 of both, and the
    high-priority requests' alone. Returns the greedy preempting run's
    launches."""
    lines, launches_out = {}, None
    for sampled in (False, True):
        off = preempt_run(model, False, sampled)
        fe, outs, launches, prompts = preempt_run(model, True, sampled)
        mode = "sampled" if sampled else "greedy"
        ties = near_tie_check(f"frontend_preempt_bf16 {mode}", model,
                              prompts, outs, off[1],
                              streams=(list(range(len(prompts)))
                                       if sampled else None))
        st, st_off = fe.stats(), off[0].stats()
        if not (st["preemptions"] > 0
                and st["resumes"] == st["preemptions"]):
            raise AssertionError(f"frontend_preempt_bf16 {mode}: "
                                 f"{st['preemptions']} preemptions, "
                                 f"{st['resumes']} resumes")
        lives = fe.tracer.lifecycles()
        hi_ttft = sorted(lives[i]["ttft_ms"] for i in range(
            PREEMPT_LOW, PREEMPT_LOW + PREEMPT_HIGH))
        hi_off = sorted(off[0].tracer.lifecycles()[i]["ttft_ms"] for i in
                        range(PREEMPT_LOW, PREEMPT_LOW + PREEMPT_HIGH))
        lines[mode] = dict(
            token_identical=len(prompts) - len(ties), near_ties=ties,
            preemptions=st["preemptions"],
            resumes=st["resumes"], deadline_misses=st["deadline_misses"],
            deadline_misses_off=st_off["deadline_misses"],
            ttft_ms_p50=st["ttft_ms_p50"], ttft_ms_p95=st["ttft_ms_p95"],
            ttft_ms_p50_off=st_off["ttft_ms_p50"],
            ttft_ms_p95_off=st_off["ttft_ms_p95"],
            high_priority_ttft_ms=hi_ttft,
            high_priority_ttft_ms_off=hi_off,
            prefill_tokens_skipped=st["prefill_tokens_skipped"],
            decode_steps=st["decode_steps"],
            decode_steps_off=st_off["decode_steps"])
        if not sampled:
            launches_out = launches
    emit("frontend_preempt_bf16", low=PREEMPT_LOW, high=PREEMPT_HIGH,
         new_tokens=[PREEMPT_NEW_LOW, PREEMPT_NEW_HIGH],
         deadline_ms=PREEMPT_DEADLINE_MS, num_slots=NUM_SLOTS,
         layers=model.config.num_layers, runs=lines, nvidia_smi=smi,
         launches=launches_out)
    return launches_out


def beam_fp32(model) -> dict:
    """Beam search in fp32, card against the CPU port on the same weights:
    ``generate_beam`` on GPT-2-small and ``t5_beam_search`` on t5-small,
    ``BEAM_WIDTH`` beams, ``BEAM_NEW`` tokens, an EOS and length penalty 1;
    the sequences equal, the scores within ``BEAM_SCORE_RTOL`` relative.
    Returns the card's launches of the GPT run."""
    import numpy as np
    import torch

    from apex_tpu_torch.models import generate_beam, t5_beam_search
    from apex_tpu_torch.ops import _build

    rng = np.random.default_rng(SEED + 41)
    cpu = build_model(torch.float32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    prompts = torch.from_numpy(rng.integers(
        0, model.config.vocab_size, (2, BEAM_PROMPT)).astype(np.int32))
    kw = dict(num_beams=BEAM_WIDTH, eos_token_id=int(prompts[0, -1]),
              length_penalty=1.0)
    torch.cuda.synchronize()
    _build.reset_launches()
    seqs, scores = generate_beam(model, prompts.to(DEV), BEAM_NEW, **kw)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    if not (launches["flash_fwd"] and launches["layer_norm_fwd"]):
        raise AssertionError(f"beam_fp32: the kernels of the path did not "
                             f"launch ({launches})")
    c_seqs, c_scores = generate_beam(cpu, prompts, BEAM_NEW, **kw)
    lines = {}

    def hold(label, got, want):
        (s, sc), (cs, csc) = got, want
        if not torch.equal(s.cpu(), cs):
            raise AssertionError(f"beam_fp32 {label}: the card's beams "
                                 f"differ from the CPU port's")
        rel = ((sc.cpu() - csc).abs() / csc.abs()).max().item()
        if rel > BEAM_SCORE_RTOL:
            raise AssertionError(f"beam_fp32 {label}: scores differ by "
                                 f"{rel:.3e} relative")
        lines[label] = dict(sequences_equal=True, score_max_rel_err=rel,
                            best_scores=sc[:, 0].tolist())

    hold("gpt2_small", (seqs, scores), (c_seqs, c_scores))
    del cpu
    t5 = build_t5(torch.float32).eval()
    t5_cpu = build_t5(torch.float32, device="cpu").eval()
    t5_cpu.load_state_dict({k: v.cpu() for k, v in t5.state_dict().items()})
    enc = torch.from_numpy(rng.integers(
        0, t5.config.vocab_size, (2, BEAM_ENC)).astype(np.int32))
    t5_kw = dict(num_beams=BEAM_WIDTH, eos_token_id=1, length_penalty=1.0)
    hold("t5_small", t5_beam_search(t5, enc.to(DEV), BEAM_NEW, **t5_kw),
         t5_beam_search(t5_cpu, enc, BEAM_NEW, **t5_kw))
    del t5, t5_cpu
    torch.cuda.empty_cache()
    emit("beam_fp32", beams=BEAM_WIDTH, new_tokens=BEAM_NEW,
         gpt2_prompt=[2, BEAM_PROMPT], t5_encoder=[2, BEAM_ENC],
         score_rtol=BEAM_SCORE_RTOL, runs=lines, launches=launches)
    return launches


# --- tensor parallelism and data parallelism across ranks (A10) --------------

#: the tensor-parallel phases (BASELINE config #4): GPT-2-small at full
#: width split over TP ranks, every rank a process on the one card over
#: gloo (NCCL refuses two ranks on one device): 8 requests (prompts 32-128,
#: budgets 16-32, seed 1) and 2 x 1024-token training steps
TP = 2
TP_CONFIG, TP_CONFIG_KW, TP_VOCAB = "gpt2_small", {}, 50304
TP_REQUESTS, TP_REQUEST_SEED = 8, 1
TP_TRAIN_BATCH, TP_TRAIN_SEQ, TP_TRAIN_TIMED = 2, 1024, 3
#: the bf16 engine's profiled run serves the first this many requests (the
#: profiler's post-processing grows with the run: all 8 took ~24 s a rank
#: on an H100's host)
TP_PROFILE_REQUESTS = 4
#: tp = 2 against tp = 1 in fp32: loss (relative) and the gathered
#: gradients per entry (the JAX package's TP bar, tests/test_gpt_model.py)
TP_LOSS_RTOL = 1e-4
TP_GRAD_TOL = (5e-3, 1e-4)                 # (rtol, atol)
#: every spawned set of ranks must answer within this many seconds
RANKS_TIMEOUT = 600
#: ddp_syncbn: ResNet-50 O1 bf16 with SyncBatchNorm and DDP, 2 ranks x 32
#: images against one rank on the 64; its bar is the one-rank step's own
#: rounding floor (every parameter moved by one fp32 rounding, relative
#: noise 2^-24, as ``perturbed``) times the factor, as in resnet_fp32
DDP_RANKS, DDP_BATCH, DDP_ARCH = 2, 64, "resnet50"
DDP_FLOOR_EPS, DDP_FLOOR_FACTOR = 2.0 ** -24, RESNET_FLOOR_FACTOR


def print_transport(backend) -> None:
    """The collectives' backend and what is staged through the host, on
    lines of their own: the port stages nothing (``collectives``' table);
    gloo copies CUDA tensors through host memory itself."""
    how = ("gloo copies CUDA tensors itself" if backend == "gloo"
           else f"{backend} takes CUDA tensors directly")
    print(f"tp transport: torch.distributed backend {backend}", flush=True)
    print(f"tp transport: collectives staged through the host by the port: "
          f"none staged ({how})", flush=True)


def rank_launch_check(phase: str, ranks, kernels) -> None:
    """Every rank launched every kernel of ``kernels`` in its run."""
    for r in ranks:
        missing = [k for k in kernels if r["launches"][k] == 0]
        if missing:
            raise AssertionError(f"{phase}: rank {r['rank']} launched no "
                                 f"{missing} kernel")


def tp_phases(smi) -> dict:
    """``tp_engine_fp32``/``_bf16`` and ``tp_train_fp32``/``_bf16``:
    GPT-2-small at full width (12 layers, 12 heads, 6 a rank, vocab 50304,
    25152 a rank) over TP = 2 ranks, both processes on this card, started
    once for all four (``examples.tensor_parallel.gpt.jobs_rank``), against
    tp = 1 in this process from the same seed (the layers draw the tp = 1
    weights and keep their rank's block). fp32 serving: tokens identical
    to tp = 1, equal decode steps, each rank's pool half of tp = 1's; bf16
    serving: tokens/s, and any first divergence a bf16 near tie. fp32
    training: the two FusedAdam steps' losses within ``TP_LOSS_RTOL`` and
    the first step's gradients, gathered over the ranks
    (``bridge.unshard_gpt_params``), within ``TP_GRAD_TOL`` per entry; bf16
    training: losses and step ms. The bf16 runs end with a profiled run
    (``collective_profile``). Returns each path's rank-0 launches."""
    import numpy as np
    import torch

    from apex_tpu_torch.bridge import unshard_gpt_params
    from apex_tpu_torch.examples.tensor_parallel import gpt as tpg
    from apex_tpu_torch.parallel import run_ranks

    f32, b16 = torch.float32, torch.bfloat16
    reqs = tpg.demo_requests(TP_VOCAB, TP_REQUESTS, seed=TP_REQUEST_SEED)
    prompts = [r.prompt for r in reqs]
    engine_kw = dict(num_slots=NUM_SLOTS, page_size=PAGE_SIZE)
    serve = dict(config=TP_CONFIG, seed=SEED, requests=reqs,
                 engine_kw=engine_kw, device=DEV)
    train = dict(config=TP_CONFIG, seed=SEED, batch=TP_TRAIN_BATCH,
                 seq=TP_TRAIN_SEQ, lr=TRAIN_LR, device=DEV)
    c32, c16 = (dict(TP_CONFIG_KW, dtype=dt) for dt in (f32, b16))
    # tp = 1 in this process: the references
    t0 = time.perf_counter()
    ref32 = tpg.serve_rank(0, 1, cfg_kw=c32, **serve)
    ref16 = tpg.serve_rank(0, 1, cfg_kw=c16, runs=2, **serve)
    tref = tpg.train_rank(0, 1, cfg_kw=c32, steps=2, return_grads=True,
                          **train)
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    jobs = [("serve", dict(serve, cfg_kw=c32)),
            ("serve", dict(serve, cfg_kw=c16, runs=2,
                           profile=TP_PROFILE_REQUESTS)),
            ("train", dict(train, cfg_kw=c32, steps=2, return_grads=True)),
            ("train", dict(train, cfg_kw=c16, steps=1 + TP_TRAIN_TIMED,
                           timed_from=1, profile=True))]
    t0 = time.perf_counter()
    ranks = run_ranks(tpg.jobs_rank, TP, (jobs,), device=DEV,
                      timeout=RANKS_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    serve32, serve16, train32, train16 = ([r[i] for r in ranks]
                                          for i in range(4))
    backend = serve32[0]["backend"]
    print_transport(backend)
    common = dict(tp=TP, backend=backend,
                  ranks_on="cuda:0" if backend == "gloo" else "a card each")

    # tp_engine_fp32
    rank_launch_check("tp_engine_fp32", serve32, SERVING_KERNELS)
    for r in serve32:
        for i, (a, b) in enumerate(zip(r["outputs"], ref32["outputs"])):
            if a.shape != b.shape or (a != b).any():
                raise AssertionError(f"tp_engine_fp32: rank {r['rank']} "
                                     f"request {i} differs from tp = 1")
        if r["stats"]["decode_steps"] != ref32["stats"]["decode_steps"]:
            raise AssertionError(
                f"tp_engine_fp32: decode steps {r['stats']['decode_steps']}"
                f" against tp = 1's {ref32['stats']['decode_steps']}")
        if 2 * r["pool_bytes"] != ref32["pool_bytes"]:
            raise AssertionError(f"tp_engine_fp32: rank pool "
                                 f"{r['pool_bytes']} bytes, tp = 1 "
                                 f"{ref32['pool_bytes']}")
    emit("tp_engine_fp32", **common, requests=len(reqs),
         token_identical=True,
         decode_steps=serve32[0]["stats"]["decode_steps"],
         tp1_decode_steps=ref32["stats"]["decode_steps"],
         pool_bytes_per_rank=serve32[0]["pool_bytes"],
         tp1_pool_bytes=ref32["pool_bytes"],
         seconds=[r["seconds"][-1] for r in serve32],
         tp1_seconds=ref32["seconds"][-1],
         launches_rank0=serve32[0]["launches"])

    # tp_engine_bf16
    rank_launch_check("tp_engine_bf16", serve16, SERVING_KERNELS)
    for a, b in zip(serve16[0]["outputs"], serve16[1]["outputs"]):
        if a.shape != b.shape or (a != b).any():
            raise AssertionError("tp_engine_bf16: the ranks' tokens differ")
    diverged = {}
    got = serve16[0]["outputs"]
    if any(a.shape != b.shape or (a != b).any()
           for a, b in zip(got, ref16["outputs"])):
        model = tpg.build_model(TP_CONFIG, c16, SEED, DEV)
        diverged = near_tie_check("tp_engine_bf16", model.eval(), prompts,
                                  got, ref16["outputs"])
        del model
    tokens = serve16[0]["stats"]["generated_tokens"]
    emit("tp_engine_bf16", **common, requests=len(reqs),
         tokens_per_s=tokens / serve16[0]["seconds"][-1],
         tp1_tokens_per_s=ref16["stats"]["generated_tokens"]
         / ref16["seconds"][-1],
         generated_tokens=tokens,
         decode_steps=serve16[0]["stats"]["decode_steps"],
         tp1_decode_steps=ref16["stats"]["decode_steps"],
         same_tokens_as_tp1=len(reqs) - len(diverged),
         diverged=diverged, tokens=[o.tolist() for o in got],
         pool_bytes_per_rank=serve16[0]["pool_bytes"],
         tp1_pool_bytes=ref16["pool_bytes"],
         profile=[r["profile"] for r in serve16],
         launches_rank0=serve16[0]["launches"], nvidia_smi=smi,
         card_after=card_state())

    # tp_train_fp32
    rank_launch_check("tp_train_fp32", train32, TRAIN_KERNELS)
    for r in train32:
        for step, (a, b) in enumerate(zip(r["losses"], tref["losses"])):
            if abs(a - b) > TP_LOSS_RTOL * abs(b):
                raise AssertionError(f"tp_train_fp32: rank {r['rank']} "
                                     f"step {step} loss {a} against tp = 1 "
                                     f"{b}")
    gathered = unshard_gpt_params([r["grads"] for r in train32])
    rtol, atol = TP_GRAD_TOL
    worst, over = 0.0, []
    for name, want in tref["grads"].items():
        err = (gathered[name] - want).abs()
        ratio = (err / (atol + rtol * want.abs())).max().item()
        worst = max(worst, ratio)
        if ratio > 1.0:
            over.append((name, ratio))
    if over:
        raise AssertionError(f"tp_train_fp32: {len(over)} gradients past "
                             f"rtol {rtol}, atol {atol}: {over[:5]}")
    emit("tp_train_fp32", **common, batch=TP_TRAIN_BATCH, seq=TP_TRAIN_SEQ,
         losses=train32[0]["losses"], tp1_losses=tref["losses"],
         loss_rel_err=max(abs(a - b) / abs(b) for a, b in
                          zip(train32[0]["losses"], tref["losses"])),
         grads=len(gathered), grad_worst_ratio_to_bar=worst,
         grad_max_abs_err=max((gathered[n] - g).abs().max().item()
                              for n, g in tref["grads"].items()),
         step_ms=train32[0]["step_ms"], tp1_step_ms=tref["step_ms"])

    # tp_train_bf16
    rank_launch_check("tp_train_bf16", train16, TRAIN_KERNELS)
    timed = train16[0]["timed_steps"]
    step_ms = float(np.mean(train16[0]["step_ms"][-timed:]))
    emit("tp_train_bf16", **common, batch=TP_TRAIN_BATCH, seq=TP_TRAIN_SEQ,
         losses=[r["losses"] for r in train16],
         step_ms=[r["step_ms"] for r in train16], timed_steps=timed,
         mean_step_ms=step_ms,
         tokens_per_s=TP_TRAIN_BATCH * TP_TRAIN_SEQ / step_ms * 1e3,
         launches_per_step={k: train16[0]["launches"][k] / timed
                            for k in TRAIN_KERNELS},
         profile=[r["profile"] for r in train16],
         tp1_reference_s=ref_s, ranks_s=ranks_s,
         job_s=[[job["job_s"] for job in r] for r in ranks], nvidia_smi=smi,
         card_after=card_state())
    return {"tp_engine": serve16[0]["launches"],
            "tp_engine_fp32": serve32[0]["launches"],
            "tp_train": {k: v / timed
                         for k, v in train16[0]["launches"].items()},
            "tp_train_fp32": train32[0]["launches"]}


def ddp_check(level: str, one, floor, ranks) -> dict:
    """``ddp_syncbn``'s bars for one amp level: the ranks' gradients and
    statistics bit for bit equal; step 0's loss (the ranks' mean), averaged
    gradients and running statistics against one rank's within
    ``DDP_FLOOR_FACTOR`` times its own floor (``floor_grad_bars``, which
    also takes 1e-3 relative, per tensor in norm). Returns the numbers."""
    import torch

    phase = f"ddp_syncbn {level}"
    for r in ranks[1:]:
        for part in ("grads", "buffers"):
            for k, v in r[part].items():
                if not torch.equal(v, ranks[0][part][k]):
                    raise AssertionError(f"{phase}: the ranks' {part} {k} "
                                         f"differ")
    loss, want = ranks[0]["losses"][0], one["losses"][0]
    loss_bar = max(1e-4 * abs(want),
                   DDP_FLOOR_FACTOR * abs(floor["losses"][0] - want))
    if abs(loss - want) > loss_bar:
        raise AssertionError(f"{phase}: loss {loss} against one rank's "
                             f"{want} (bar {loss_bar})")
    bars = {part: floor_grad_bars(f"{phase} {part}", ranks[0][part],
                                  one[part], floor[part],
                                  factor=DDP_FLOOR_FACTOR)
            for part in ("grads", "buffers")}
    out = dict(loss=loss, one_rank_loss=want, floor_loss=floor["losses"][0],
               loss_bar=loss_bar)
    for part, b in bars.items():
        out[part] = dict(
            max_rel_err=max(v[1] / max(v[0], 1e-30) for v in b.values()),
            median_rel_floor=sorted(v[2] / max(v[0], 1e-30)
                                    for v in b.values())[len(b) // 2],
            max_ratio_to_bar=max(v[1] / max(1e-3 * v[0], DDP_FLOOR_FACTOR
                                            * v[2], 1e-30)
                                 for v in b.values()))
    return out


def ddp_syncbn(smi) -> dict:
    """ResNet-50 at ImageNet width with SyncBatchNorm and DDP
    (``examples.imagenet.main_amp.rank_steps``) over ``DDP_RANKS`` ranks of
    32 images on this card, against one rank in this process on the 64
    (cuDNN deterministic and TF32 off here for the phase; ``run_ranks``
    gives the ranks these flags), under O0 and under amp O1 bf16
    with a dynamic loss scale; both levels in one set of rank processes
    (``rank_runs``). Each level's step 0 is held by ``ddp_check`` to the
    one-rank step's own floor (that step again with every parameter moved
    by one fp32 rounding). At O0 that floor is a few percent of a gradient
    (``resnet_fp32``'s); at O1 one rounding moves ResNet-50's initial
    gradients by about their own size (the bf16 convolutions round every
    activation), so the O1 gradient bar is loose and O0's is the one that
    holds the reduction to account. O1's step 1: rank 1 writes an inf into
    a gradient before the all-reduce, and both ranks must skip (parameters
    bit for bit, the loss scale halved, the step count kept). Returns rank
    0's O1 launches."""
    import torch

    from apex_tpu_torch.examples.imagenet import main_amp as rn
    from apex_tpu_torch.parallel import run_ranks

    base = dict(batch_size=DDP_BATCH, image_size=RESNET_IMAGE,
                arch=DDP_ARCH, num_classes=RESNET_CLASSES, lr=RESNET_LR,
                seed=SEED, device=DEV)
    levels = {"O0": dict(base, opt_level="O0"),
              "O1": dict(base, opt_level="O1", half_dtype=torch.bfloat16,
                         loss_scale="dynamic")}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        refs = {lv: (rn.rank_steps(0, 1, steps=1, **kw),
                     rn.rank_steps(0, 1, steps=1,
                                   perturb=(SEED, DDP_FLOOR_EPS), **kw))
                for lv, kw in levels.items()}
        gc.collect()
        torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t0
        runs = [dict(levels["O0"], steps=1),
                dict(levels["O1"], steps=2, poison=(1, 1))]
        t0 = time.perf_counter()
        ranks = run_ranks(rn.rank_runs, DDP_RANKS, (runs,), device=DEV,
                          timeout=RANKS_TIMEOUT)
        ranks_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out = {lv: ddp_check(lv, *refs[lv], [r[i] for r in ranks])
           for i, lv in enumerate(levels)}
    o1 = [r[1] for r in ranks]
    skipped = [r["steps"][1] for r in o1]
    for r, s in zip(o1, skipped):
        if not (s["unchanged"] and s["step_count"] == 1
                and s["loss_scale"] == r["steps"][0]["loss_scale"] / 2):
            raise AssertionError(f"ddp_syncbn: rank 1's overflow did not "
                                 f"skip the step everywhere: {skipped}")
    emit("ddp_syncbn", ranks=DDP_RANKS, images_per_rank=DDP_BATCH // DDP_RANKS,
         image=RESNET_IMAGE, floor_eps=DDP_FLOOR_EPS,
         floor_factor=DDP_FLOOR_FACTOR, **out, o1_overflow_step=skipped,
         one_rank_s=ref_s, ranks_s=ranks_s,
         launches_rank0=o1[0]["launches"], nvidia_smi=smi,
         card_after=card_state())
    return o1[0]["launches"]


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
         build_s=build_s, registers=ptxas_registers(),
         spill_bytes=ptxas_spill_bytes())
    print(smi, flush=True)

    warm_card()
    card_before = card_state()
    gen = torch.Generator().manual_seed(SEED)
    checks = (check_layer_norm(gen, DEV) + check_flash(gen, DEV)
              + check_paged(gen, DEV) + check_layer_norm_bwd(gen, DEV)
              + check_flash_bwd(gen, DEV) + check_adam(gen, DEV)
              + check_flash_bert(gen, DEV) + check_xentropy(gen, DEV)
              + check_lamb(gen, DEV) + check_dequant(gen, DEV)
              + check_dequant_c2(gen, DEV)
              + check_paged_quant(gen, DEV) + check_rms_norm(gen, DEV)
              + check_flash_window(gen, DEV) + check_paged_window(gen, DEV)
              + check_norm_bwd_mistral(gen, DEV)
              + check_flash_bwd_window(gen, DEV)
              + check_paged_block(gen, DEV) + check_flash_bias(gen, DEV)
              + check_resnet_optim(gen, DEV) + check_scaled_softmax(gen, DEV)
              + check_group_norm(gen, DEV) + check_flash_ring(gen, DEV)
              + check_flash_nmt(gen, DEV) + check_head_dim(gen, DEV))
    rows = [row for row, _ in checks]
    emit("kernels", tolerances=TOL, rms_atol=RMS_ATOL,
         card_before=card_before,
         card_after=card_state(), results=rows)
    torch.cuda.empty_cache()
    # the softmax and GroupNorm paths, early: their batches need room that
    # the later phases' live models take
    sync_bn_sumsq(gen, DEV)
    softmax_launches = megatron_softmax(smi)
    gn_launches = unet_group_norm(smi)
    torch.cuda.empty_cache()
    # the ring-attention paths, early too: the 16384-token Mistral step
    # needs the room that the later phases' live models take
    ring_attn_launches = ring_attention_phase(smi)
    ring_train = ring_train_bf16(smi)
    ring_train_fp32()
    ring_gpt_launches = ring_gpt(smi)
    torch.cuda.empty_cache()
    # tensor and data parallelism across ranks (A10): processes of their
    # own on this card, before the phases that keep models live
    tp_launches = tp_phases(smi)
    ddp_launches = ddp_syncbn(smi)
    gc.collect()
    torch.cuda.empty_cache()

    prompts, new_tokens = workload()
    from apex_tpu_torch.models import generate

    model = build_model(torch.float32)
    outs, stats, elapsed, launches32 = drive_engine(model, prompts,
                                                    new_tokens)[1:]
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
    spec_fp32(model, prompts, new_tokens, outs, launches32)
    chunked_fp32(model)
    prefix_launches32 = engine_prefix_fp32(model)
    beam_launches = beam_fp32(model)
    del model
    torch.cuda.empty_cache()

    model = build_model(torch.bfloat16)
    drive_engine(model, prompts, new_tokens)               # warm
    steps = {}
    timed = [drive_engine(model, prompts, new_tokens, step_times=st)[1:]
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
    sampled_launches = engine_sampled_bf16(model, prompts, new_tokens, smi)
    prefix_launches = engine_prefix_bf16(model, smi)
    preempt_launches = frontend_preempt_bf16(model, smi)
    spec_launches = spec_bf16(model, prompts, new_tokens,
                              (timed[0][0], stats, elapsed), smi)
    chunk_launches, chunk_kv8_launches = chunked_bf16(model, smi)
    quant_runs = engine_quant_bf16(model, prompts, new_tokens, smi)
    mistral_fp32()
    mistral_model, mistral_run, mistral_launches = mistral_bf16(smi)

    train_fp32()
    train_step, train_launches = train_bf16(smi)
    bert_fp32()
    bert_step, bert_launches, bert_run = bert_bf16(smi)
    # amp O2 and remat on the same workload (A11): each frees its model
    bert_o2_launches = bert_o2_bf16(smi, bert_run)
    remat_launches = bert_remat_bf16(smi)
    # BASELINE configs #3 and #5 after BERT: each frees its model, so the
    # later phases find the room they had
    nmt_fp32()
    nmt_train_launches = nmt_bf16(smi)
    asp_bert_fp32()
    asp_launches = asp_bert_bf16(smi)
    # ResNet-50 before T5 and the Mistral-7B training phases: its 256-image
    # batch needs the room that their live models take
    resnet_fp32()
    resnet_step, resnet_launches, resnet_run = resnet_bf16(smi)
    resnet_o2_launches = resnet_o2_bf16(smi, resnet_run)
    nvg_launches = resnet_bf16(smi, optimizer="novograd")[1]
    dcgan_launches = dcgan_fp16(smi)
    transforms_launches = transforms_phase(smi)
    torch.cuda.empty_cache()
    # T5 before the Mistral-7B training phases, whose step (18 GB of
    # parameters and Adam state) stays live for its profile: the T5 batch
    # of 128 x 512 fits beside what the earlier phases keep
    t5_fp32()
    t5_run, t5_launches = t5_bf16(smi)
    t5_train_fp32()
    t5_train_step, t5_train_launches = t5_train_bf16(smi)
    me_launches = mistral_train_fp32()
    mistral_train_step, mistral_train_launches = mistral_train_bf16(smi)

    # where the time goes, last, so that no profiler state touches the times
    # above: one more run of the same workload, then each kernel alone at
    # the shapes of phase 2
    profile_phase("engine_bf16_profile",
                  partial(drive_engine, model, prompts, new_tokens),
                  cpu=False, ops={"paged_attention": PAGED_SYMBOLS})
    profile_spec_round(model, prompts, new_tokens)
    profile_quant(quant_runs)
    profile_phase("mistral_bf16_profile", short_run(mistral_run), cpu=False,
                  ops={"paged_attention_window": PAGED_SYMBOLS},
                  requests=NUM_SLOTS, budget_cap=PROFILE_BUDGET)
    del mistral_model, mistral_run
    torch.cuda.empty_cache()
    results = []
    for row, fn in checks:
        if row.get("path") in ("quant_serving", "mistral", "mistral_train",
                               "spec_chunked", "t5", "t5_train",
                               "window_bias", "resnet", "megatron_softmax",
                               "unet_group_norm", "ring", "nmt",
                               "head_dim"):
            continue                  # timed by queued_ms already
        ms, seen, split = kernel_device_ms(
            fn, kernel_symbol(row["name"], row["dtype"]))
        results.append(dict(name=row["name"], dtype=row["dtype"],
                            shape=row["shape"], device_ms=ms,
                            launches_seen=seen,
                            **({"device_ms_by_symbol": split}
                               if len(split) > 1 else {}),
                            **(dict(zip(("library_device_ms",
                                         "library_launches_seen"),
                                        library_device_ms(fn.library)))
                               if hasattr(fn, "library") else {})))
    emit("kernel_device_ms", card_before=card_state(), reps=20,
         results=results)
    # the same timed run once more, after the profiler: its slowdown, if any
    _, stats_after, elapsed_after, _ = drive_engine(model, prompts,
                                                    new_tokens)[1:]
    emit("engine_bf16_after_profile",
         tokens_per_s=stats_after["generated_tokens"] / elapsed_after)
    profile_phase("train_bf16_profile", train_step)
    profile_phase("bert_bf16_profile", bert_step)
    profile_phase("mistral_train_bf16_profile", mistral_train_step)
    del mistral_train_step
    torch.cuda.empty_cache()
    profile_phase("t5_bf16_profile", t5_run, cpu=False)
    profile_phase("t5_train_bf16_profile", t5_train_step)
    profile_resnet(resnet_step)

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
    # the s > 1 branches over GPT-2-small's 8-slot pool, bf16, each at the
    # s of the run that launches it: the fp block at a draft_len = 3 verify
    # (s = 4), the quantized one at the int8-pool chunked run's pieces (s =
    # 16); the fp row also carries, under "chunk", its s = 16 row with the
    # chunked run's launches
    main_shape.update({
        "paged_attention_block": [NUM_SLOTS, 12, BLOCK_S[0], PAGE_SIZE, 64,
                                  64],
        "paged_attention_quant_block": [NUM_SLOTS, 12, BLOCK_S[1], PAGE_SIZE,
                                        64, 64]})
    main_kind["paged_attention_quant_block"] = "int8"
    # the bias branches at T5's bf16 shapes: the forward at serving's
    # encoder (8 x 512, with the t5_generate run's launches), the backward
    # at training's encoder (128 x 512, with a training step's launches);
    # each also carries, under "t5_decoder", its row at the decoder's
    # causal 128 x 114, with the decoder's own launches in the timed
    # training steps (half the kernel's: each step runs L biased
    # self-attentions in the encoder and L in the decoder); the windowed
    # branches at their one row (no T5 path runs them: launches 0).
    # flash_fwd, flash_bwd_dq and flash_bwd_dkdv
    # carry, under "t5_cross", T5's cross-attention rows
    bias_shape = {"flash_fwd_bias": [T5_BATCH, T5_HEADS, T5_ENC_SEQ,
                                     T5_HEAD_DIM],
                  "flash_bwd_dq_bias": [T5_TRAIN_BATCH, T5_HEADS,
                                        T5_TRAIN_ENC, T5_HEAD_DIM],
                  "flash_bwd_dkdv_bias": [T5_TRAIN_BATCH, T5_HEADS,
                                          T5_TRAIN_ENC, T5_HEAD_DIM]}
    main_shape.update(bias_shape)
    # the softmax kernels at the shapes of their launches in
    # megatron_softmax: GPT-2-small's causal scores (forward and backward),
    # BERT-Large's (the masked and unmasked forward); GroupNorm at the UNet
    # block's (8, 320, 64, 64), SiLU fused
    gpt_scores = [SOFTMAX_GPT[0] * SOFTMAX_GPT[1], SOFTMAX_GPT[2],
                  SOFTMAX_GPT[2]]
    bert_scores = [*SOFTMAX_BERT, SOFTMAX_BERT[2]]
    unet_nhwc = [UNET_BATCH, UNET_SHAPES[0][1], UNET_SHAPES[0][1],
                 UNET_SHAPES[0][0]]
    main_shape.update({"scaled_softmax_fwd_causal": gpt_scores,
                       "scaled_softmax_bwd": gpt_scores,
                       "scaled_softmax_fwd_masked": bert_scores,
                       "scaled_softmax_fwd": bert_scores,
                       "group_norm_fwd": unet_nhwc,
                       "group_norm_bwd": unet_nhwc})
    main_kind.update({"group_norm_fwd": "silu", "group_norm_bwd": "silu"})
    # the ring branches at the shapes of the runs whose launches they
    # carry: the windowed ones at a ring hop's offset (4096) on
    # ``ring_train_bf16``'s 4096-token chunk, the others at the
    # ``ring_attention`` phase's 1024-token chunk off the diagonal (not
    # causal, dropout at a rank's origins)
    main_kind.update({n: f"offset {RING_OFFSETS[0]}" if "window" in n
                      else "attn noncausal" for n in RING_KERNELS})
    t5_dec_shape = [T5_TRAIN_BATCH, T5_HEADS, T5_TRAIN_DEC, T5_HEAD_DIM]
    by_path = {"serving": launches, "gpt_train": train_launches,
               "bert_train": bert_launches, "mistral": mistral_launches,
               **{label: run[1] for label, run in quant_runs.items()},
               "mistral_train": mistral_train_launches,
               "mistral_train_memory_efficient": me_launches,
               "spec": spec_launches, "chunked": chunk_launches,
               "chunked_kv8": chunk_kv8_launches, "t5": t5_launches,
               "t5_train": t5_train_launches,
               "resnet_train": resnet_launches,
               "resnet_novograd": nvg_launches,
               "megatron_softmax": softmax_launches,
               "unet_group_norm": gn_launches,
               "ring_attention": ring_attn_launches["ring"],
               "ring_attention_zigzag": ring_attn_launches["zigzag"],
               "ring_train": ring_train["ring"],
               "ring_train_zigzag": ring_train["zigzag"],
               "ring_gpt": ring_gpt_launches,
               "nmt_train": nmt_train_launches, "asp_bert": asp_launches,
               "serving_sampled": sampled_launches,
               "serving_prefix": prefix_launches,
               "serving_prefix_fp32": prefix_launches32,
               "serving_preempt": preempt_launches,
               "beam": beam_launches, "bert_o2_train": bert_o2_launches,
               "bert_remat_fwd_bwd": remat_launches,
               "resnet_o2_train": resnet_o2_launches,
               "dcgan_fp16": dcgan_launches,
               "transforms": transforms_launches,
               **tp_launches, "ddp_syncbn": ddp_launches}
    # the windowed block has no engine path (the reference refuses both
    # modes for windowed models), so its launches read 0
    block_path = {"paged_attention_block": "spec",
                  "paged_attention_window_block": "spec",
                  "paged_attention_quant_block": "chunked_kv8"}
    quant_path = {"dequant_matmul": "w8_kv8", "dequant_matmul_w4": "w4_kv8",
                  "paged_attention_quant": "w8_kv8"}
    timing = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms", "tflops", "tb_s")
    summary = []
    for name, (src, replaces) in _build.KERNELS.items():
        path = ("ring_train" if name in RING_KERNELS and "window" in name
                else "ring_attention" if name in RING_KERNELS
                else "megatron_softmax" if name in SOFTMAX_KERNELS
                else "unet_group_norm" if name in GROUP_NORM_KERNELS
                else "resnet_train" if name in ("sgd", "multi_tensor_scale")
                else "resnet_novograd" if name == "novograd"
                else "t5" if name == "flash_fwd_bias" else "t5_train"
                if name in BIAS_KERNELS else block_path[name]
                if name in BLOCK_KERNELS
                else "serving" if name in SERVING_KERNELS else "gpt_train"
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
                   and (r.get("path") != "resnet"
                        or path.startswith("resnet"))
                   and r["shape"] == main_shape.get(name, r["shape"])
                   and r.get("kind") == main_kind.get(name, r.get("kind"))
                   and not r.get("c2"))
        entry = dict(
            name=name, route="cuda",
            source=os.path.relpath(_build.source_path(name), HERE),
            replaces=replaces, launches=by_path[path][name],
            launches_by_path={k: v[name] for k, v in by_path.items()},
            max_abs_err=row["max_abs_err"],
            **{k: row[k] for k in ("sums_max_rel_err", "norms_max_rel_err")
               if k in row},
            ms=row["ms"], **{k: row[k] for k in ("tflops", "tb_s")
                             if k in row},
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            **{k: row[k] for k in ("kind", "shape", "unquantized_ms",
                                   "library", "kv_heads", "window",
                                   "out_rms", "s", "sk", "causal",
                                   "bias_shape", "use")
               if k in row and (path in (*quant_path.values(), "mistral")
                                or name in MISTRAL_TRAIN_NEW
                                or name in BLOCK_KERNELS
                                or name in BIAS_KERNELS)})
        if name in RING_KERNELS:
            keys = ("kind", "shape", "kv_heads", "causal", "window",
                    "causal_offset", "dropout", "dropout_origin", "out_rms",
                    "visible_pairs", "library")
            entry.update({k: row[k] for k in keys})
            entry["launches_per_step"] = {
                lay: by_path[p][name] / RING_TRAIN_TIMED
                for lay, p in (("ring", "ring_train"),
                               ("zigzag", "ring_train_zigzag"))}
            entry["other_rows"] = [
                dict({k: r[k] for k in ("kind", "dtype", "shape",
                                        "causal_offset", "visible_pairs")},
                     **{k: r[k] for k in timing if k in r})
                for r in rows if r["name"] == name and r is not row
                and r.get("path") != "head_dim"]
        hd = [r for r in rows if r["name"] == name
              and r.get("path") == "head_dim"]
        if hd:
            # the head dims above 128 (C3): every branch's row; no main
            # path of the repo runs d > 128, so these carry no launches
            entry["head_dim"] = [
                dict({k: r[k] for k in ("branch", "d", "dtype", "shape")},
                     **{k: r[k] for k in ("use", "s", "kv_heads", "sk",
                                          "window", "library")
                        if r.get(k) is not None},
                     **{k: r[k] for k in timing if k in r})
                for r in hd]
        if name == "segment_stats":
            rn = next(r for r in rows if r["name"] == name
                      and r.get("path") == "resnet")
            entry["resnet"] = dict(
                shape=rn["shape"], segments=rn["segments"],
                launches=nvg_launches[name],
                **{k: rn[k] for k in timing if k in rn})
        if path.startswith("resnet"):
            entry.update({k: row[k] for k in (
                "shape", "segments", "params", "cases", "skip_bit_identical",
                "whole_step_ms", "library") if k in row})
        if path in ("megatron_softmax", "unet_group_norm"):
            entry.update(shape=row["shape"], kind=row["kind"],
                         library=row["library"])
            entry["other_rows"] = [
                dict({k: r[k] for k in ("shape", "kind", "dtype")},
                     **{k: r[k] for k in timing if k in r})
                for r in rows if r["name"] == name and r is not row
                and r["dtype"] != "float32"]
        if name in ("xentropy_fwd", "xentropy_bwd"):
            nm = next(r for r in rows if r["name"] == name
                      and r.get("path") == "nmt")
            entry["nmt_train"] = dict(
                shape=nm["shape"], dtype=nm["dtype"],
                smoothing=nm["smoothing"],
                launches=nmt_train_launches[name],
                **{k: nm[k] for k in timing + ("bound_share",) if k in nm})
        if name in NMT_KERNELS and name.startswith("flash_"):
            nm = next(r for r in rows if r["name"] == name
                      and r.get("path") == "nmt")
            entry["nmt_train"] = dict(
                {k: nm[k] for k in ("shape", "dtype", "use", "dropout",
                                    "bias_shape", "bias_dtype", "out_rms")},
                launches=nmt_train_launches[name],
                **{k: nm[k] for k in timing if k in nm})
        if name == "multi_tensor_scale":
            bf = next(r for r in rows if r["name"] == name
                      and r["dtype"] == "bfloat16")
            entry["bfloat16"] = dict(shape=bf["shape"],
                                     **{k: bf[k] for k in timing if k in bf})
        if name in bias_shape:
            dec = next(r for r in rows if r["name"] == name
                       and r["dtype"] == "bfloat16"
                       and r["shape"] == t5_dec_shape)
            entry["t5_decoder"] = dict(
                shape=dec["shape"], sk=dec["sk"], causal=dec["causal"],
                bias_shape=dec["bias_shape"], dtype="bfloat16",
                launches=t5_train_launches[name] // 2,
                out_rms=dec["out_rms"],
                **{k: dec[k] for k in timing if k in dec})
        if name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
            entry["t5_cross"] = [
                dict(shape=r["shape"], sk=r["sk"], use=r["use"],
                     dtype="bfloat16", out_rms=r["out_rms"],
                     launches=by_path[r["path"]][name],
                     **{k: r[k] for k in timing if k in r})
                for r in rows if r["name"] == name
                and r.get("path") in ("t5", "t5_train")
                and r["dtype"] == "bfloat16"]
        if name == "paged_attention_block":
            ck = next(r for r in rows if r["name"] == name
                      and r["dtype"] == "bfloat16" and r["s"] == BLOCK_S[1])
            entry["chunk"] = dict(shape=ck["shape"], s=ck["s"],
                                  launches=chunk_launches[name],
                                  **{k: ck[k] for k in timing if k in ck})
        if name == "paged_attention_quant":
            win = next(r for r in rows if r["name"] == name
                       and r.get("path") == "mistral"
                       and r["dtype"] == "bfloat16" and r["kind"] == "int8")
            entry["mistral_window"] = dict(
                shape=win["shape"], kv_heads=win["kv_heads"],
                window=win["window"], dtype="bfloat16", kind="int8",
                unquantized_ms=win["unquantized_ms"],
                **{k: win[k] for k in timing if k in win})
        if name in train_shape:
            tr = next(r for r in rows if r["name"] == name
                      and r.get("path") == "mistral_train"
                      and r["dtype"] == "bfloat16"
                      and r["shape"] == train_shape[name])
            entry["mistral_train"] = dict(
                shape=tr["shape"], dtype="bfloat16", out_rms=tr["out_rms"],
                launches=mistral_train_launches[name],
                **{k: tr[k] for k in timing if k in tr})
        if path != "bert_train" and name in BERT_KERNELS:
            bert = next(r for r in rows if r["name"] == name
                        and r.get("path") == "bert"
                        and r["dtype"] == "bfloat16"
                        and r["shape"] == bert_shape.get(name, r["shape"]))
            entry["bert_train"] = dict(
                shape=bert["shape"], dtype="bfloat16",
                launches=bert_launches[name], **{k: bert[k] for k in timing if k in bert})
        summary.append(entry)
    emit("done", seconds=time.perf_counter() - START)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
