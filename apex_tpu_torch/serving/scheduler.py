"""Continuous-batching decode engine over the paged KV pool.

Counterpart of ``apex_tpu/serving/scheduler.py`` (``Request``,
``prompt_bucket``, ``make_shared_admit``, ``make_prefill_chunk``,
``PagedDecodeEngine``, ``generate_paged``). The engine owns the STATE (the
pool, the prefix cache, the device programs, the observability identity);
the host scheduling loop is :class:`~apex_tpu_torch.serving.frontend.
ServingFrontend`, and :meth:`PagedDecodeEngine.run` is a thin closed-loop
wrapper over it, as the reference's is, so ``run()`` takes the streaming
server's code path.

A fixed array of ``num_slots`` decode slots advances one token per engine
step. Admission prefills a prompt through the model's contiguous flash
path at its page-rounded bucket, scatters the K/V into freshly allocated
pages and takes the first token. A decode chunk runs ``sync_every``
single-token steps over all slots; done and idle slots keep their length
frozen and emit the EOS fill. The frontend's pump runs the reference's
order: dispatch the next chunk, then harvest the previous one (retire
finished slots), drop window pages, feed the mid-prefill slots, and admit
queued requests into the vacancies, head-of-line in the policy's order.
A slot that finishes in chunk N is thus harvested after chunk N + 1 ran
with it done, and its successor joins chunk N + 2, as in the reference.

The order is there for token parity with the reference, not for overlap.
In eager PyTorch the harvest's read of chunk N's tokens is queued on the
same stream behind chunk N + 1 and waits for it, so nothing overlaps, and
a vacancy is refilled one chunk later than a harvest-first loop would
refill it. What the order fixes is which decode chunks run between a
mid-prefill slot's pieces: over a quantized pool each of them writes at
the slot's frozen length and may requantize the page the next piece lands
on, so any other order changes that slot's tokens.

Sampled decode (``temperature``, ``top_k``, ``top_p`` and an int seed
``rng``) draws request ``r``'s token ``i`` with the noise of stream ``r``,
index ``i`` (``models/generation.sample_noise``), so its outputs are
SCHEDULING-INVARIANT: they depend on the request and the seed, not on the
slot, the step or the batch around it; across a preemption the draws
continue (a resume continues the stream at its token index, ``samp0``),
and the tokens with them up to the numerics of the resume's re-prefilled
tail (exact in fp32; in bf16 a near-tied choice can flip).

``prefix_cache=True`` adds cross-request KV reuse over a radix tree of
whole cached pages (``serving/prefix_cache.py``): admission points the
slot's table at the matched pages (refcounted, read-only) and prefills
only the uncached tail through :func:`make_shared_admit`, whose tail
attends through the flash kernel over the gathered prefix and itself (the
reference's tail takes the dense cached path); retirement moves the
request's full pages into the tree, and admission evicts refcount-0 pages
LRU-first when the free stack is short. Greedy outputs equal the
cache-off engine's: the shared pages replay stored K/V, and the tail's
rows attend as the cold prefill's do.

``kv_dtype="int8"`` or ``"fp8"`` serves over a quantized pool (int8 or
fp8 e4m3 pages with per-(page, kv head) scales); a model built with a
weight policy serves quantized block linears. A model whose config sets
``sliding_window`` (Mistral-style Llama) serves windowed: its paged decode
is banded to the window, and at every chunk boundary each active slot's
pages that fell wholly below the band return to the free stack
(``kv_pool.drop_slot_pages``, as the reference frontend's
``_drop_window_pages``), so a windowed slot holds O(window) live pages.

Two modes ride the paged kernel's ``s > 1`` query block:

- speculative decode (``draft_model``, ``draft_len``): a second pool in
  the draft config's geometry mirrors the target pool slot for slot and
  page for page (every alloc and free is made on both). Each round drafts
  ``k = draft_len + 1`` single-token steps over the draft pool, verifies
  them in ONE ``s = k`` paged target step, accepts per slot the longest
  prefix matching the target's greedy predictions plus the bonus token
  (capped by the budget and the first EOS), and rolls both pools back to
  the accepted length;
- chunked prefill (``prefill_chunk``): a prompt longer than one chunk is
  admitted with its pages allocated at length 0 and enters through the
  paged path in ``s = prefill_chunk`` pieces, one per loop iteration,
  interleaved with the decode chunks. Mid-prefill slots sit in the decode
  chunk as done, their frozen length where the next piece lands.

Greedy outputs are token-identical to per-request lock-step ``generate`` of
the same model in fp32 (over a quantized pool, prefill never reads the
pool, so first tokens match the full-precision pool's).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.models.generation import (_greedy_token, _sample_token,
                                              init_cache, is_vocab_parallel,
                                              validate_sampling)
from apex_tpu_torch.obs.events import EventLog
from apex_tpu_torch.obs.spans import SpanTracer
from apex_tpu_torch.ops.quant import resolve_kv_dtype
from apex_tpu_torch.serving import kv_pool
from apex_tpu_torch.serving.prefix_cache import PrefixCache

#: run() counters in the instrument registry (``serving.<name>``); a run's
#: stats are the deltas of these across it
_RUN_COUNTERS = ("admitted", "retired", "decode_steps", "busy_slot_steps",
                 "prefix_hits", "prefill_tokens_total",
                 "prefill_tokens_computed", "evicted_pages",
                 "deferred_admissions", "defrag_runs",
                 "preemptions", "resumes", "backpressure_spills",
                 "deadline_misses",
                 "tpot_slo_misses", "window_dropped_pages",
                 "spec_rounds", "spec_tokens", "chunked_prefills",
                 "prefill_chunks", "generated_tokens")

#: per-request latency histograms (``serving.<name>``, log-bucketed ms)
_RUN_HISTOGRAMS = ("ttft_ms", "tpot_ms", "queue_wait_ms", "decode_step_ms")

#: per-process engine ids, the ``engine`` label on run counters
_ENGINE_IDS = itertools.count()


@dataclasses.dataclass
class Request:
    """One decode request: a 1-D int prompt and its token budget, plus the
    frontend's scheduling fields (the reference's): ``priority`` (larger
    is more important; the queue is served highest first and a blocked
    request may preempt strictly lower-priority running work),
    ``deadline_ms`` (a TTFT objective from ``arrival_time``: breaks ties
    inside a priority class and arms preemption; a miss is counted, never
    dropped), ``arrival_time`` (``time.perf_counter`` timebase; None:
    stamped at submit), ``tpot_slo_ms`` (a time-per-output-token objective
    checked at retirement) and ``trace_id`` (32 hex chars; None: minted at
    submit)."""

    prompt: Any                      # (s0,) int array
    max_new_tokens: int
    priority: int = 0
    deadline_ms: Optional[float] = None
    arrival_time: Optional[float] = None
    tpot_slo_ms: Optional[float] = None
    trace_id: Optional[str] = None


def prompt_bucket(s0: int, page_size: int, max_positions: int) -> int:
    """Admission bucket for a raw prompt length: padded up to a whole page,
    capped at the position table."""
    return min(kv_pool.round_up(max(s0, 1), page_size), max_positions)


def _bucket_match_pages(m: int) -> int:
    """A radix match depth rounded DOWN to a power of two pages, as the
    reference rounds it (there to bound its admission compile keys; kept
    so the port's hits and skipped tokens equal the reference's)."""
    return 1 << (m.bit_length() - 1) if m > 0 else 0


def make_shared_admit(model, *, t_start: int, tail_bucket: int):
    """The shared-prefix admission: ``admit(cache, tail_ids, s0, slot,
    shared_row, n_private)`` gathers the matched prefix (``t_start`` tokens
    = ``t_start / page_size`` whole cached pages, dequantized from a
    quantized pool) from the pool into a contiguous buffer, runs the model
    over the ``(1, tail_bucket)`` zero-padded uncached tail with that
    buffer as its cache at length ``t_start`` (the prefix costs no forward
    FLOPs), installs the slot's row (shared pages,
    then ``n_private`` private ones) and scatters the tail's K/V into the
    private pages (``prefill_into_pages(start=t_start)``: shared pages are
    never written; the boundary page is always private). Returns ``(cache,
    last)``, the logits of prompt position ``s0 - 1``.

    The tail attends through the flash kernel over the buffer's first
    ``t_start + tail_bucket`` keys (``generation.flash_tail_attention``),
    where the reference takes its dense cached path: a row's flash output
    depends only on its query, the keys it sees and the key tiling from
    position 0, so a tail row gets the cold prefill's bits for it given
    the same K/V. The dense path's other summation order moved four of 24
    requests' bf16 tokens from the cache-off run's on the H100."""
    cfg = model.config
    if t_start < 1 or tail_bucket < 1:
        raise ValueError("shared admission needs t_start >= 1 matched "
                         "tokens and tail_bucket >= 1 tail tokens")
    bucket = t_start + tail_bucket

    def admit(cache, tail_ids, s0: int, slot: int, shared_row,
              n_private: int):
        ps = kv_pool.page_size_of(cache)
        if t_start % ps:
            raise ValueError(f"t_start={t_start} must be a page multiple "
                             f"({ps})")
        m = t_start // ps
        dev = cache["block_tables"].device
        pages = torch.as_tensor(shared_row[:m], dtype=torch.long,
                                device=dev)
        contig = init_cache(cfg, 1, bucket, device=dev)

        def gathered(pool_lc, name, dst):
            tiles = pool_lc[name + "_pages"][pages]         # (m, kv, ps, d)
            if name + "_scales" in pool_lc:
                tiles = (tiles.float()
                         * pool_lc[name + "_scales"][pages][:, :, None,
                                                            None])
            kv, d = tiles.shape[1], tiles.shape[3]
            dst[:, :, :t_start] = tiles.transpose(0, 1).reshape(
                1, kv, t_start, d).to(dst.dtype)
            return dst

        layers = [{"k": gathered(pool_lc, "k", lc["k"]),
                   "v": gathered(pool_lc, "v", lc["v"]), "flash_tail": True}
                  for pool_lc, lc in zip(cache["layers"], contig["layers"])]
        logits, contig = model(tail_ids, cache={"layers": layers,
                                                "len": t_start})
        kv_pool.alloc_slot_shared(cache, slot, shared_row, m, n_private)
        kv_pool.prefill_into_pages(cache, slot, contig["layers"], s0,
                                   start=t_start)
        return cache, logits[:, s0 - t_start - 1]

    return admit


def make_prefill_chunk(model, *, chunk: int):
    """The chunked-prefill step: ``prefill_step(cache, ids, slot, valid)``
    pushes the ``(1, chunk)`` token ids (the prompt's final piece
    zero-padded) of slot ``slot`` through the model's paged ``s = chunk``
    path on a view of the pool (the shared pages, the slot's block-table
    row and length), so the K/V lands in the slot's pages, and advances
    the slot's length by the true count ``valid``: padded positions stay
    above the length and are never read. Returns ``(cache, last)``, the
    logits of position ``valid - 1``, whose sample is the first token on
    the prompt's final piece."""
    if chunk < 1:
        raise ValueError("prefill chunk must be >= 1 token")

    def prefill_step(cache, ids, slot: int, valid: int):
        view = {"layers": cache["layers"],
                "block_tables": cache["block_tables"][slot:slot + 1],
                "len": cache["len"][slot:slot + 1]}
        logits, _ = model(ids, cache=view)
        cache["len"][slot] += valid
        return cache, logits[:, valid - 1]

    return prefill_step


class PagedDecodeEngine:
    """Continuous-batching greedy or sampled decode over ``num_slots``
    slots.

    ``run(requests)`` drains the queue through a fresh
    :class:`~apex_tpu_torch.serving.frontend.ServingFrontend` and returns
    ``(outputs, stats)``: ``outputs[i]`` is request ``i``'s generated tokens
    (up to and including its first EOS) and ``stats`` the frontend's
    ``stats()`` (the reference's keys, ``generated_tokens`` beside them);
    ``ttft_ms`` keeps the last run's time to first token by request.
    """

    def __init__(self, model, *, num_slots: int, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_pages_per_seq: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, rng: Optional[int] = None,
                 sync_every: int = 1, prefix_cache: bool = False,
                 draft_model=None, draft_len: int = 0,
                 prefill_chunk: Optional[int] = None, kv_dtype=None,
                 draft_kv_dtype="match",
                 host_tier_bytes: Optional[int] = None):
        cfg = model.config
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        # resolved eagerly: an unsupported kv_dtype is a named ValueError
        # here, never a silent full-precision pool
        resolve_kv_dtype(kv_dtype)
        # the draft pool mirrors the target pool page for page and dtype
        # for dtype
        if draft_kv_dtype == "match":
            draft_kv_dtype = kv_dtype
        if draft_len > 0 and draft_kv_dtype != kv_dtype:
            raise ValueError(
                f"kv-dtype-mismatch: the speculative draft pool must "
                f"share the target pool's kv_dtype (target "
                f"{kv_dtype!r}, draft {draft_kv_dtype!r}) — the pools "
                f"mirror each other slot-for-slot and page-for-page")
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.rng = validate_sampling(temperature, top_k, top_p, rng)
        # a config exposing sliding_window promises that its model's paged
        # branch bands paged_attention to the window: the engine frees
        # pages below the band, which an unbanded read would then reach
        self.window = getattr(cfg, "sliding_window", None)
        if prefix_cache and self.window is not None:
            raise ValueError(
                "prefix_cache does not compose with sliding-window "
                "models: the engine drops a windowed slot's pages once "
                "they fall below the attention band, and a dropped page "
                "cannot be shared radix-cache property (decode windowed "
                "models with prefix_cache=False)")
        if draft_len < 0:
            raise ValueError("draft_len must be >= 0")
        if draft_len > 0:
            if draft_model is None:
                raise ValueError(
                    "draft_len > 0 needs a draft_model to propose tokens")
            if temperature:
                raise ValueError(
                    "in-engine speculative decode is greedy-only: "
                    "acceptance compares draft proposals against the "
                    "target's greedy predictions (set temperature=0)")
            if prefix_cache:
                raise ValueError(
                    "speculative decode does not compose with "
                    "prefix_cache yet: shared pages would need a second "
                    "refcounted draft-pool mirror (run one or the other)")
            if self.window is not None or getattr(
                    draft_model.config, "sliding_window", None) is not None:
                raise ValueError(
                    "speculative decode does not support sliding-window "
                    "models: the engine drops pages below the band, "
                    "and the draft pool would need the same banded drop "
                    "protocol (use a full-attention target and draft)")
            if prefill_chunk is not None:
                raise ValueError(
                    "speculative decode and chunked prefill are mutually "
                    "exclusive engine modes for now (pick one)")
            if draft_len + 1 > page_size:
                raise ValueError(
                    f"draft_len + 1 = {draft_len + 1} exceeds the paged "
                    f"kernel's query-block limit page_size={page_size}")
        if prefill_chunk is not None:
            if not 1 <= prefill_chunk <= page_size:
                raise ValueError(
                    f"prefill_chunk must be in 1..page_size ({page_size}), "
                    f"got {prefill_chunk}: chunks ride the paged kernel's "
                    f"query block, which is capped at one page")
            if self.window is not None:
                raise ValueError(
                    "chunked prefill does not support sliding-window "
                    "models yet: in-progress chunks hold positions the "
                    "window-page dropper would free mid-prefill (use "
                    "monolithic admission for windowed models)")
        if host_tier_bytes:
            raise NotImplementedError(
                "the host tier (host_tier_bytes) is not ported yet "
                "(ROADMAP queue A item 9: the host tier, with its "
                "promote/demote path)")
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.num_slots = num_slots
        self.page_size = page_size
        self.eos_token_id = eos_token_id
        self.sync_every = sync_every
        self.draft_model = draft_model if draft_len > 0 else None
        # the models' logits are gathered before a token is chosen when
        # they are vocab-parallel (tensor_parallel_size > 1)
        self.vocab_parallel = is_vocab_parallel(model)
        self.draft_vocab_parallel = (is_vocab_parallel(draft_model)
                                     if draft_len > 0 else False)
        self.draft_len = draft_len
        self.prefill_chunk = prefill_chunk
        if max_pages_per_seq is None:
            max_pages_per_seq = kv_pool.cdiv(cfg.max_position_embeddings,
                                             page_size)
        if num_pages is None:
            # worst case: every slot holds a max-length sequence (+ null)
            num_pages = 1 + num_slots * max_pages_per_seq

        def pool(config):
            return kv_pool.init_paged_cache(
                config, num_slots, num_pages=num_pages, page_size=page_size,
                max_pages_per_seq=max_pages_per_seq, kv_dtype=kv_dtype,
                device=self.device)

        self.cache = pool(cfg)
        self.draft_cache = (pool(draft_model.config) if draft_len > 0
                            else None)
        self._prefill_step = (make_prefill_chunk(model, chunk=prefill_chunk)
                              if prefill_chunk is not None else None)
        # observability: the engine-lifetime event ring, the last run's
        # span tracer, and the ``engine`` label on every serving/pool/
        # prefix instrument, so two engines never mix their counts
        self.events = EventLog(capacity=4096)
        self.tracer: Optional[SpanTracer] = None
        self.obs_labels = {"engine": str(next(_ENGINE_IDS))}
        self.prefix = (PrefixCache(page_size,
                                   metrics_labels=self.obs_labels)
                       if prefix_cache else None)
        self.ttft_ms: list = []

    # --- request-key sampling (scheduling-invariant streams) ----------------

    def _first_token(self, last, stream: int, samp0: int = 0) -> int:
        """The token after a prompt from its last logits ``(1, V)``:
        greedy, or sampled with the noise of request stream ``stream`` at
        index ``samp0`` (0 at a cold admission, the resume point after a
        preemption)."""
        streams = torch.tensor([stream], dtype=torch.int64,
                               device=last.device)
        return int(_sample_token(last, self.rng, streams, samp0,
                                 temperature=self.temperature,
                                 top_k=self.top_k, top_p=self.top_p,
                                 vocab_parallel=self.vocab_parallel)[0])

    # --- device programs ----------------------------------------------------

    def _admit(self, prompt: np.ndarray, slot: int, n_pages: int,
               stream: int = 0, samp0: int = 0) -> int:
        """Contiguous flash prefill at the prompt's bucket, page alloc +
        scatter, the first token; a speculative engine prefills the draft
        pool too (the same pages: the pools mirror each other). The first
        token is always the target's."""
        s0 = prompt.shape[0]
        bucket = prompt_bucket(s0, self.page_size,
                               self.cfg.max_position_embeddings)
        ids = torch.zeros((1, bucket), dtype=torch.int32)
        ids[0, :s0] = torch.from_numpy(prompt)
        ids = ids.to(self.device)
        contig = init_cache(self.cfg, 1, bucket, device=self.device)
        logits, contig = self.model(ids, cache=contig)
        kv_pool.alloc_slot(self.cache, slot, n_pages)
        kv_pool.prefill_into_pages(self.cache, slot, contig["layers"], s0)
        if self.draft_len:
            contig = init_cache(self.draft_model.config, 1, bucket,
                                device=self.device)
            _, contig = self.draft_model(ids, cache=contig)
            kv_pool.alloc_slot(self.draft_cache, slot, n_pages)
            kv_pool.prefill_into_pages(self.draft_cache, slot,
                                       contig["layers"], s0)
        return self._first_token(logits[:, s0 - 1], stream, samp0)

    def _admit_shared(self, prompt: np.ndarray, slot: int, shared_row,
                      m: int, n_private: int, stream: int = 0,
                      samp0: int = 0) -> int:
        """The shared-prefix admission (:func:`make_shared_admit`) over the
        ``m`` matched pages of ``shared_row``: only the tail past them is
        prefilled."""
        s0, ps = prompt.shape[0], self.page_size
        t_start = m * ps
        tail_bucket = min(kv_pool.round_up(s0 - t_start, ps),
                          self.cfg.max_position_embeddings - t_start)
        ids = torch.zeros((1, tail_bucket), dtype=torch.int32)
        ids[0, :s0 - t_start] = torch.from_numpy(prompt[t_start:])
        admit = make_shared_admit(self.model, t_start=t_start,
                                  tail_bucket=tail_bucket)
        self.cache, last = admit(self.cache, ids.to(self.device), s0, slot,
                                 shared_row, n_private)
        return self._first_token(last, stream, samp0)

    def _chunk_admit(self, slot: int, n_pages: int, shared_row=None,
                     m: int = 0) -> None:
        """Chunked admission: the slot's whole page demand is allocated at
        once (after its ``m`` shared pages, if any), its length set to the
        shared prefix; the pieces advance the length as they land."""
        if m:
            kv_pool.alloc_slot_shared(self.cache, slot, shared_row, m,
                                      n_pages)
        else:
            kv_pool.alloc_slot(self.cache, slot, n_pages)
        self.cache["len"][slot] = m * self.page_size

    def _decode_chunk(self, tok, done, n_left, streams, samp_i):
        """``sync_every`` single-token steps over every slot; returns the
        updated ``(tok, done, n_left, samp_i)`` and the ``(sync_every,
        slots)`` tokens emitted. Slot ``s``'s token samples with the noise
        of stream ``streams[s]`` at its request's token index
        ``samp_i[s]``."""
        fill = self.eos_token_id if self.eos_token_id is not None else 0
        toks = []
        for _ in range(self.sync_every):
            len_before = self.cache["len"]
            logits, cache = self.model(tok[:, None], cache=self.cache)
            # done/idle slots ran against the null page; their length must
            # not creep
            cache["len"] = torch.where(done, len_before, cache["len"])
            self.cache = cache
            nxt = _sample_token(logits[:, 0], self.rng, streams, samp_i,
                                temperature=self.temperature,
                                top_k=self.top_k, top_p=self.top_p,
                                vocab_parallel=self.vocab_parallel)
            nxt = torch.where(done, torch.full_like(nxt, fill), nxt)
            n_left = torch.where(done, n_left, n_left - 1)
            samp_i = samp_i + 1
            if self.eos_token_id is not None:
                done = done | (nxt == self.eos_token_id)
            done = done | (n_left <= 0)
            toks.append(nxt)
            tok = nxt
        return tok, done, n_left, samp_i, torch.stack(toks)

    def _spec_chunk(self, tok, done, n_left):
        """``sync_every`` speculative rounds over every slot. A round runs
        ``k = draft_len + 1`` single-token draft steps from each slot's
        pending token (emitted, in neither pool), whose inputs ``[pending,
        d1 .. d_{k-1}]`` form the verify chunk; ONE ``s = k`` paged target
        step predicts the token after each chunk position; slot acceptance
        ``e`` is the longest prefix of proposals matching the predictions
        plus one, capped by the budget and the first EOS (0 for done
        slots); both pools roll back to ``len0 + e`` and the new pending
        token is prediction ``e - 1``. Returns the updated ``(tok, done,
        n_left)``, the ``(sync_every, slots, k)`` predictions and the
        ``(sync_every, slots)`` counts: round ``r`` emitted
        ``preds[r, slot, :counts[r, slot]]``."""
        eos = self.eos_token_id
        fill = eos if eos is not None else 0
        k = self.draft_len + 1
        rows = torch.arange(self.num_slots, device=tok.device)
        preds_all, counts = [], []
        for _ in range(self.sync_every):
            len0, dlen0 = self.cache["len"], self.draft_cache["len"]
            dcache, t_in, ins = self.draft_cache, tok, []
            for _ in range(k):
                ins.append(t_in)
                lg, dcache = self.draft_model(t_in[:, None], cache=dcache)
                t_in = _greedy_token(lg[:, 0], self.draft_vocab_parallel)
            chunk = torch.stack(ins, dim=1)                  # (slots, k)
            logits, cache = self.model(chunk, cache=self.cache)
            preds = _greedy_token(logits, self.vocab_parallel)  # (slots, k)
            match = (chunk[:, 1:] == preds[:, :-1]).to(torch.int32)
            m = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
            e = torch.minimum(m + 1, n_left)
            if eos is not None:
                iseos = preds == eos
                has_eos = iseos.any(dim=1)
                eos_idx = iseos.to(torch.int32).argmax(dim=1).to(torch.int32)
                # never emit past the first EOS prediction
                e = torch.minimum(e, torch.where(has_eos, eos_idx + 1, k))
            e = torch.where(done, 0, e)
            # per-slot rollback of both pools: chunk[:e] stays, the new
            # pending token preds[e - 1] stays unwritten
            cache["len"] = len0 + e
            dcache["len"] = dlen0 + e
            self.cache, self.draft_cache = cache, dcache
            tok = torch.where(done, fill,
                              preds[rows, (e - 1).clamp(0, k - 1)])
            n_left = n_left - e
            if eos is not None:
                done = done | (has_eos & (e == eos_idx + 1))
            done = done | (n_left <= 0)
            preds_all.append(preds)
            counts.append(e)
        return tok, done, n_left, torch.stack(preds_all), torch.stack(counts)

    # --- pool maintenance ---------------------------------------------------

    def _leak_suspected(self, free: int, active) -> bool:
        """True when the host's liveness count says more pages should be
        free than the stack shows (a free miscount somewhere): ``defrag``
        rebuilds the stack from actual liveness and recovers them.
        ``active``: the frontend's slot -> entry map (entries expose
        ``n_private``, the pages the slot owns)."""
        owned = sum(rec.n_private for rec in active.values())
        cached = len(self.prefix) if self.prefix is not None else 0
        usable = kv_pool.num_pages_of(self.cache) - 1    # the null page
        return usable - owned - cached > free

    def _defrag_now(self) -> None:
        """``defrag_map`` with the prefix cache's pages as extra liveness
        (they sit in no block table but must survive), then the radix tree
        remapped through the returned permutation; a speculative engine's
        draft pool, which mirrors the target's call for call, compacts in
        the same pass."""
        num_pages = kv_pool.num_pages_of(self.cache)
        extra = torch.zeros((num_pages,), dtype=torch.bool)
        if self.prefix is not None:
            extra[self.prefix.pages()] = True
        self.cache, new_idx = kv_pool.defrag_map(self.cache, extra)
        if self.prefix is not None:
            self.prefix.remap(new_idx.numpy())
        if self.draft_len:
            self.draft_cache = kv_pool.defrag(self.draft_cache)

    # --- the host loop ------------------------------------------------------

    def _validate_request(self, r: Request) -> int:
        """Reject a request the engine could never serve; returns its page
        demand, ``pages_for(prompt + max_new_tokens)``."""
        s0 = int(np.asarray(r.prompt).shape[0])
        ps = self.page_size
        max_pages = self.cache["block_tables"].shape[1]
        if s0 < 1:
            raise ValueError("prompt must hold at least one token")
        if r.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if s0 + r.max_new_tokens > self.cfg.max_position_embeddings:
            raise ValueError(
                f"prompt ({s0}) + max_new_tokens ({r.max_new_tokens}) "
                f"exceeds max_position_embeddings="
                f"{self.cfg.max_position_embeddings}")
        need = kv_pool.pages_for(s0 + r.max_new_tokens, ps)
        if need > max_pages:
            raise ValueError("request needs more than max_pages_per_seq "
                             "pages")
        if self.draft_len:
            # a round may write up to draft_len tokens past the final
            # emitted one before the rollback discards them: the position
            # and block tables of both models must absorb the overshoot
            k = self.draft_len + 1
            lim = min(self.cfg.max_position_embeddings,
                      self.draft_model.config.max_position_embeddings)
            if s0 + r.max_new_tokens + k > lim:
                raise ValueError(
                    f"prompt ({s0}) + max_new_tokens "
                    f"({r.max_new_tokens}) + draft block ({k}) exceeds "
                    f"max_position_embeddings={lim} under speculative "
                    f"decode")
            if kv_pool.pages_for(s0 + r.max_new_tokens + k, ps) > max_pages:
                raise ValueError(
                    f"request + draft-block overshoot needs more than "
                    f"max_pages_per_seq={max_pages} pages under "
                    f"speculative decode")
        if need > kv_pool.num_pages_of(self.cache) - 1:
            raise ValueError("request needs more pages than the pool holds")
        return need

    @torch.no_grad()
    def run(self, requests: Sequence[Request], *, tracer=None,
            policy=None):
        """Drain the request queue; returns ``(outputs, stats)``: a thin
        closed-loop wrapper over a fresh
        :class:`~apex_tpu_torch.serving.frontend.ServingFrontend` (its
        tracer and stats are run-scoped), pumped synchronously until every
        request retired, so ``run()`` takes the streaming server's path.
        ``policy`` defaults to ``PriorityDeadlinePolicy()``, which on plain
        requests (priority 0, no deadlines) is FIFO and never preempts.
        The whole batch is validated first: a bad request raises before
        any of its siblings start."""
        from apex_tpu_torch.serving.frontend import ServingFrontend

        for r in requests:
            self._validate_request(r)
        frontend = ServingFrontend(self, policy=policy, tracer=tracer)
        handles = [frontend.submit(r, request_id=i)
                   for i, r in enumerate(requests)]
        frontend.drain()
        outputs = [np.asarray(h.result(timeout=0), np.int32)
                   for h in handles]
        lives = frontend.tracer.lifecycles()
        self.ttft_ms = [lives.get(i, {}).get("ttft_ms")
                        for i in range(len(requests))]
        return outputs, frontend.stats()


@torch.no_grad()
def generate_paged(model, prompt_ids, max_new_tokens: int, *,
                   eos_token_id: Optional[int] = None,
                   temperature: float = 0.0, top_k: Optional[int] = None,
                   top_p: Optional[float] = None, rng: Optional[int] = None,
                   num_slots: Optional[int] = None, page_size: int = 16,
                   num_pages: Optional[int] = None, sync_every: int = 1,
                   prefix_cache: bool = False, kv_dtype=None,
                   return_stats: bool = False):
    """``generate``-shaped front end over the engine: a rectangular
    ``(batch, s0)`` prompt array returns ``(batch, s0 + max_new_tokens)``
    ids with EOS padding after a row finishes; a list of 1-D prompts of
    mixed lengths returns a list of 1-D outputs. Row ``i`` is request
    ``i``: sampled, it draws stream ``i`` as lock-step ``generate``'s row
    ``i`` does."""
    rect = hasattr(prompt_ids, "ndim") and prompt_ids.ndim == 2
    prompts = [np.asarray(torch.as_tensor(p).cpu(), np.int32).reshape(-1)
               for p in prompt_ids]
    engine = PagedDecodeEngine(
        model, num_slots=num_slots if num_slots is not None else len(prompts),
        page_size=page_size, num_pages=num_pages, eos_token_id=eos_token_id,
        temperature=temperature, top_k=top_k, top_p=top_p, rng=rng,
        sync_every=sync_every, prefix_cache=prefix_cache, kv_dtype=kv_dtype)
    outs, stats = engine.run([Request(p, max_new_tokens) for p in prompts])
    fill = eos_token_id if eos_token_id is not None else 0
    full = [torch.from_numpy(np.concatenate(
        [p, g, np.full((max_new_tokens - g.shape[0],), fill, np.int32)]))
        for p, g in zip(prompts, outs)]
    out = torch.stack(full) if rect else full
    return (out, stats) if return_stats else out
