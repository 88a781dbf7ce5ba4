"""Continuous-batching greedy decode engine over the paged KV pool.

Counterpart of ``apex_tpu/serving/scheduler.py`` (``Request``,
``prompt_bucket``, ``make_prefill_chunk``, ``PagedDecodeEngine``,
``generate_paged``) with the host loop of ``apex_tpu/serving/frontend.py``
reduced to its closed FIFO form: every request is queued at the start, in
order; no prefix cache, preemption, eviction or defrag.

A fixed array of ``num_slots`` decode slots advances one token per engine
step. Admission prefills a prompt through the model's contiguous flash
path at its page-rounded bucket, scatters the K/V into freshly allocated
pages and takes the greedy first token. A decode chunk runs ``sync_every``
single-token steps over all slots; done and idle slots keep their length
frozen and emit the EOS fill. The loop is the reference pump's, in its
order: dispatch the next chunk, then harvest the previous one (retire
finished slots, whose pages return to the free stack at once), feed the
mid-prefill slots, and admit queued requests into the vacancies while the
free pages cover each one's whole demand, ``pages_for(prompt +
max_new_tokens)``, head-of-line. A slot that finishes in chunk N is thus
harvested after chunk N + 1 ran with it done, and its successor joins
chunk N + 2, as in the reference.

The order is there for token parity with the reference, not for overlap.
In eager PyTorch the harvest's read of chunk N's tokens is queued on the
same stream behind chunk N + 1 and waits for it, so nothing overlaps, and
a vacancy is refilled one chunk later than a harvest-first loop would
refill it. What the order fixes is which decode chunks run between a
mid-prefill slot's pieces: over a quantized pool each of them writes at
the slot's frozen length and may requantize the page the next piece lands
on, so any other order changes that slot's tokens.

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
import time
from collections import deque
from typing import Any, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.models.generation import _greedy_token, init_cache
from apex_tpu_torch.ops.quant import resolve_kv_dtype
from apex_tpu_torch.serving import kv_pool


@dataclasses.dataclass
class Request:
    """One decode request: a 1-D int prompt and its token budget."""

    prompt: Any                      # (s0,) int array
    max_new_tokens: int


def prompt_bucket(s0: int, page_size: int, max_positions: int) -> int:
    """Admission bucket for a raw prompt length: padded up to a whole page,
    capped at the position table."""
    return min(kv_pool.round_up(max(s0, 1), page_size), max_positions)


def make_prefill_chunk(model, *, chunk: int):
    """The chunked-prefill step: ``prefill_step(cache, ids, slot, valid)``
    pushes the ``(1, chunk)`` token ids (the prompt's final piece
    zero-padded) of slot ``slot`` through the model's paged ``s = chunk``
    path on a view of the pool (the shared pages, the slot's block-table
    row and length), so the K/V lands in the slot's pages, and advances
    the slot's length by the true count ``valid``: padded positions stay
    above the length and are never read. Returns ``(cache, last)``, the
    logits of position ``valid - 1``, whose argmax is the first token on
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


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


@dataclasses.dataclass
class _Entry:
    """One admitted request in its slot: ``toks`` its generated tokens,
    ``joined`` the first decode chunk whose tokens are its own,
    ``pf_pos`` the prompt tokens fed so far while a chunked prefill is in
    progress (None once it decodes), ``dropped`` its leading table entries
    already window-dropped."""

    req: int
    toks: list = dataclasses.field(default_factory=list)
    joined: int = 0
    pf_pos: Optional[int] = None
    dropped: int = 0


class PagedDecodeEngine:
    """Continuous-batching greedy decode over ``num_slots`` slots.

    ``run(requests)`` drains the queue and returns ``(outputs, stats)``:
    ``outputs[i]`` is request ``i``'s generated tokens (up to and including
    its first EOS) and ``stats`` counts ``decode_steps``, ``admitted``,
    ``retired``, ``generated_tokens``, ``window_dropped_pages``,
    ``spec_rounds`` (slot rounds that emitted), ``spec_tokens``,
    ``mean_acceptance_len``, ``chunked_prefills`` and ``prefill_chunks``,
    with ``ttft_ms_p50``/``ttft_ms_p95``, the wall time from ``run()``'s
    start to each request's first token; ``ttft_ms`` keeps the last run's
    times by request.
    """

    def __init__(self, model, *, num_slots: int, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_pages_per_seq: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, sync_every: int = 1,
                 prefix_cache: bool = False, draft_model=None,
                 draft_len: int = 0, prefill_chunk: Optional[int] = None,
                 kv_dtype=None, draft_kv_dtype="match",
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
        # a config exposing sliding_window promises that its model's paged
        # branch bands paged_attention to the window: the engine frees
        # pages below the band, which an unbanded read would then reach
        self.window = getattr(cfg, "sliding_window", None)
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
        if temperature:
            raise _not_ported("sampled decode",
                              "queue A item 6: sampled decode")
        if prefix_cache or host_tier_bytes:
            raise _not_ported("the prefix cache and host tier",
                              "queue A item 6: host side of serving")
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.num_slots = num_slots
        self.page_size = page_size
        self.eos_token_id = eos_token_id
        self.sync_every = sync_every
        self.draft_model = draft_model if draft_len > 0 else None
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
        self.ttft_ms: list = []

    # --- device programs ----------------------------------------------------

    def _admit(self, prompt: np.ndarray, slot: int, n_pages: int) -> int:
        """Contiguous flash prefill at the prompt's bucket, page alloc +
        scatter, greedy first token; a speculative engine prefills the
        draft pool too (the same pages: the pools mirror each other). The
        first token is always the target's."""
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
        return int(_greedy_token(logits[:, s0 - 1])[0])

    def _chunk_admit(self, slot: int, n_pages: int) -> None:
        """Chunked admission: the slot's whole page demand is allocated at
        once, at length 0; the pieces advance the length as they land."""
        kv_pool.alloc_slot(self.cache, slot, n_pages)
        self.cache["len"][slot] = 0

    def _decode_chunk(self, tok, done, n_left):
        """``sync_every`` single-token steps over every slot; returns the
        updated ``(tok, done, n_left)`` and the ``(sync_every, slots)``
        tokens emitted."""
        fill = self.eos_token_id if self.eos_token_id is not None else 0
        toks = []
        for _ in range(self.sync_every):
            len_before = self.cache["len"]
            logits, cache = self.model(tok[:, None], cache=self.cache)
            # done/idle slots ran against the null page; their length must
            # not creep
            cache["len"] = torch.where(done, len_before, cache["len"])
            self.cache = cache
            nxt = _greedy_token(logits[:, 0])
            nxt = torch.where(done, torch.full_like(nxt, fill), nxt)
            n_left = torch.where(done, n_left, n_left - 1)
            if self.eos_token_id is not None:
                done = done | (nxt == self.eos_token_id)
            done = done | (n_left <= 0)
            toks.append(nxt)
            tok = nxt
        return tok, done, n_left, torch.stack(toks)

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
                t_in = _greedy_token(lg[:, 0])
            chunk = torch.stack(ins, dim=1)                  # (slots, k)
            logits, cache = self.model(chunk, cache=self.cache)
            preds = _greedy_token(logits)                    # (slots, k)
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
    def run(self, requests: Sequence[Request]):
        """Drain the request queue (closed FIFO loop); returns
        ``(outputs, stats)``."""
        needs = [self._validate_request(r) for r in requests]
        prompts = [np.asarray(r.prompt, np.int32).reshape(-1)
                   for r in requests]
        dev, n_slots, ps = self.device, self.num_slots, self.page_size
        max_pages = self.cache["block_tables"].shape[1]
        eos = self.eos_token_id
        state = {"tok": torch.zeros((n_slots,), dtype=torch.int32,
                                    device=dev),
                 "done": torch.ones((n_slots,), dtype=torch.bool, device=dev),
                 "n_left": torch.zeros((n_slots,), dtype=torch.int32,
                                       device=dev)}
        pending = deque(range(len(requests)))
        active: dict[int, _Entry] = {}
        outputs: list = [None] * len(requests)
        self.ttft_ms = [None] * len(requests)
        stats = {"decode_steps": 0, "admitted": 0, "retired": 0,
                 "generated_tokens": 0, "window_dropped_pages": 0,
                 "spec_rounds": 0, "spec_tokens": 0, "chunked_prefills": 0,
                 "prefill_chunks": 0}
        chunk_idx = 0
        t_start = time.perf_counter()

        def retire(slot):
            e = active.pop(slot)
            kv_pool.free_slot(self.cache, slot)
            if self.draft_len:
                kv_pool.free_slot(self.draft_cache, slot)
            outputs[e.req] = np.asarray(e.toks, np.int32)
            stats["retired"] += 1
            stats["generated_tokens"] += len(e.toks)

        def finished(e):
            return ((eos is not None and e.toks[-1] == eos)
                    or len(e.toks) >= requests[e.req].max_new_tokens)

        def start_decode(slot, e, tok0):
            """The first token arrived: the slot decodes from the next
            chunk on (or retires at once)."""
            self.ttft_ms[e.req] = (time.perf_counter() - t_start) * 1e3
            e.toks, e.joined, e.pf_pos = [tok0], chunk_idx + 1, None
            if finished(e):
                retire(slot)
                return
            state["tok"][slot] = tok0
            state["done"][slot] = False
            state["n_left"][slot] = requests[e.req].max_new_tokens - 1

        def harvest(idx, payload):
            if self.draft_len:
                preds, counts = (t.cpu().numpy() for t in payload)
                emitted = [[preds[r, slot, :counts[r, slot]]
                            for r in range(preds.shape[0])]
                           for slot in range(n_slots)]
            else:
                toks = payload.cpu().numpy()
                emitted = [[toks[:, slot]] for slot in range(n_slots)]
            for slot in list(active):
                e = active[slot]
                if e.pf_pos is not None or e.joined > idx:
                    continue     # mid-prefill, or admitted after the chunk
                done = False
                for run_toks in emitted[slot]:
                    if self.draft_len and run_toks.shape[0]:
                        stats["spec_rounds"] += 1
                        stats["spec_tokens"] += int(run_toks.shape[0])
                    for t in run_toks:
                        e.toks.append(int(t))
                        if finished(e):
                            done = True
                            break
                    if done:
                        break
                if done:
                    retire(slot)
                    state["done"][slot] = True

        def drop_window_pages():
            """Free each active slot's table entries wholly below the band
            of its next query position ``nxt`` (the device length at the
            last harvested chunk: prompt plus every decode step run):
            entry ``j`` is dead once ``(j + 1) * page_size - 1 <= nxt -
            window``."""
            for slot, e in active.items():
                nxt = prompts[e.req].shape[0] + len(e.toks) - 1
                upto = max((nxt + 1 - self.window) // ps, 0)
                if upto > e.dropped:
                    kv_pool.drop_slot_pages(self.cache, slot, upto)
                    stats["window_dropped_pages"] += upto - e.dropped
                    e.dropped = upto

        def feed(slot, e):
            """One ``prefill_chunk``-token piece of the slot's prompt, the
            last one zero-padded (``make_prefill_chunk``)."""
            p = prompts[e.req]
            t = e.pf_pos
            valid = min(self.prefill_chunk, p.shape[0] - t)
            ids = torch.zeros((1, self.prefill_chunk), dtype=torch.int32)
            ids[0, :valid] = torch.from_numpy(p[t:t + valid])
            self.cache, last = self._prefill_step(self.cache, ids.to(dev),
                                                  slot, valid)
            e.pf_pos = t + valid
            stats["prefill_chunks"] += 1
            if e.pf_pos >= p.shape[0]:
                start_decode(slot, e, int(_greedy_token(last)[0]))

        def admission():
            admitted = 0
            while pending:
                vacant = [s for s in range(n_slots) if s not in active]
                i = pending[0]
                if not vacant or kv_pool.free_page_count(self.cache) \
                        < needs[i]:
                    break                     # head-of-line
                pending.popleft()
                slot = vacant[0]
                admitted += 1
                stats["admitted"] += 1
                s0 = prompts[i].shape[0]
                c = self.prefill_chunk
                if (c is not None and s0 > c
                        and s0 + c - 1 <= max_pages * ps):
                    # chunked: no decode tokens until the last piece lands
                    self._chunk_admit(slot, needs[i])
                    stats["chunked_prefills"] += 1
                    e = active[slot] = _Entry(i, pf_pos=0)
                    feed(slot, e)             # the first piece rides now
                    continue
                tok0 = self._admit(prompts[i], slot, needs[i])
                e = active[slot] = _Entry(i)
                start_decode(slot, e, tok0)
            return admitted

        inflight = None
        while True:
            prev, inflight = inflight, None
            if any(e.pf_pos is None for e in active.values()):
                chunk_idx += 1
                stats["decode_steps"] += self.sync_every
                carry = (state["tok"], state["done"], state["n_left"])
                if self.draft_len:
                    tok, done, n_left, preds, counts = self._spec_chunk(
                        *carry)
                    payload = (preds, counts)
                else:
                    tok, done, n_left, payload = self._decode_chunk(*carry)
                state.update(tok=tok, done=done, n_left=n_left)
                inflight = (chunk_idx, payload)
            if prev is not None:
                harvest(*prev)
            if self.window is not None:
                drop_window_pages()
            for slot, e in list(active.items()):
                if e.pf_pos is not None:       # mid-prefill: its next piece
                    feed(slot, e)
            admitted = admission()
            if pending and not active and inflight is None \
                    and not admitted:
                raise RuntimeError(
                    "scheduler deadlock: a queued request cannot be "
                    "admitted with every slot vacant")
            if not (pending or active or inflight is not None):
                break
        stats["mean_acceptance_len"] = (stats["spec_tokens"]
                                        / max(stats["spec_rounds"], 1))
        if self.ttft_ms:
            stats["ttft_ms_p50"] = float(np.percentile(self.ttft_ms, 50))
            stats["ttft_ms_p95"] = float(np.percentile(self.ttft_ms, 95))
        return outputs, stats


@torch.no_grad()
def generate_paged(model, prompt_ids, max_new_tokens: int, *,
                   eos_token_id: Optional[int] = None,
                   num_slots: Optional[int] = None, page_size: int = 16,
                   num_pages: Optional[int] = None, sync_every: int = 1,
                   kv_dtype=None, return_stats: bool = False):
    """``generate``-shaped front end over the engine: a rectangular
    ``(batch, s0)`` prompt array returns ``(batch, s0 + max_new_tokens)``
    ids with EOS padding after a row finishes; a list of 1-D prompts of
    mixed lengths returns a list of 1-D outputs."""
    rect = hasattr(prompt_ids, "ndim") and prompt_ids.ndim == 2
    prompts = [np.asarray(torch.as_tensor(p).cpu(), np.int32).reshape(-1)
               for p in prompt_ids]
    engine = PagedDecodeEngine(
        model, num_slots=num_slots if num_slots is not None else len(prompts),
        page_size=page_size, num_pages=num_pages, eos_token_id=eos_token_id,
        sync_every=sync_every, kv_dtype=kv_dtype)
    outs, stats = engine.run([Request(p, max_new_tokens) for p in prompts])
    fill = eos_token_id if eos_token_id is not None else 0
    full = [torch.from_numpy(np.concatenate(
        [p, g, np.full((max_new_tokens - g.shape[0],), fill, np.int32)]))
        for p, g in zip(prompts, outs)]
    out = torch.stack(full) if rect else full
    return (out, stats) if return_stats else out
