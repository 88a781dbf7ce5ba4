"""Continuous-batching greedy decode engine over the paged KV pool.

Counterpart of ``apex_tpu/serving/scheduler.py`` (``Request``,
``prompt_bucket``, ``PagedDecodeEngine``, ``generate_paged``) with the host
loop of ``apex_tpu/serving/frontend.py`` reduced to its closed FIFO form:
no prefix cache, preemption, eviction or defrag.

A fixed array of ``num_slots`` decode slots advances one token per engine
step. Admission prefills a prompt through the model's contiguous flash
path at its page-rounded bucket, scatters the K/V into freshly allocated
pages and takes the greedy first token. A decode chunk runs ``sync_every``
single-token steps over all slots; done and idle slots keep their length
frozen and emit the EOS fill. At each chunk boundary the host retires
finished slots (their pages return to the free stack at once) and admits
queued requests into the vacancies while the free pages cover each one's
whole demand, ``pages_for(prompt + max_new_tokens)``, head-of-line.

``kv_dtype="int8"`` or ``"fp8"`` serves over a quantized pool (int8 or
fp8 e4m3 pages with per-(page, kv head) scales); a model built with a
weight policy serves quantized block linears. A model whose config sets
``sliding_window`` (Mistral-style Llama) serves windowed: its paged decode
is banded to the window, and at every chunk boundary each active slot's
pages that fell wholly below the band return to the free stack
(``kv_pool.drop_slot_pages``, as the reference frontend's
``_drop_window_pages``), so a windowed slot holds O(window) live pages.
Greedy outputs are token-identical to per-request lock-step ``generate`` of
the same model (over a quantized pool, prefill never reads the pool, so
first tokens match the full-precision pool's).
"""

from __future__ import annotations

import dataclasses
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


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class PagedDecodeEngine:
    """Continuous-batching greedy decode over ``num_slots`` slots.

    ``run(requests)`` drains the queue and returns ``(outputs, stats)``:
    ``outputs[i]`` is request ``i``'s generated tokens (up to and including
    its first EOS) and ``stats`` counts ``decode_steps``, ``admitted``,
    ``retired``, ``generated_tokens`` and ``window_dropped_pages``.
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
        if temperature:
            raise _not_ported("sampled decode",
                              "queue A item 6: sampled decode")
        if prefix_cache or host_tier_bytes:
            raise _not_ported("the prefix cache and host tier",
                              "queue A item 6: host side of serving")
        # resolved eagerly: an unsupported kv_dtype is a named ValueError
        # here, never a silent full-precision pool
        resolve_kv_dtype(kv_dtype)
        if draft_kv_dtype not in ("match", kv_dtype):
            raise _not_ported("a quantized draft pool (draft_kv_dtype)",
                              "queue A item 8: speculative decode")
        if draft_model is not None or draft_len:
            raise _not_ported("speculative decode", "queue A item 8")
        if prefill_chunk is not None:
            raise _not_ported("chunked prefill", "queue A item 8")
        # a config exposing sliding_window promises that its model's paged
        # branch bands paged_attention to the window: the engine frees
        # pages below the band, which an unbanded read would then reach
        self.window = getattr(cfg, "sliding_window", None)
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.num_slots = num_slots
        self.page_size = page_size
        self.eos_token_id = eos_token_id
        self.sync_every = sync_every
        if max_pages_per_seq is None:
            max_pages_per_seq = kv_pool.cdiv(cfg.max_position_embeddings,
                                             page_size)
        if num_pages is None:
            # worst case: every slot holds a max-length sequence (+ null)
            num_pages = 1 + num_slots * max_pages_per_seq
        self.cache = kv_pool.init_paged_cache(
            cfg, num_slots, num_pages=num_pages, page_size=page_size,
            max_pages_per_seq=max_pages_per_seq, kv_dtype=kv_dtype,
            device=self.device)

    # --- device programs ----------------------------------------------------

    def _admit(self, prompt: np.ndarray, slot: int, n_pages: int) -> int:
        """Contiguous flash prefill at the prompt's bucket, page alloc +
        scatter, greedy first token."""
        s0 = prompt.shape[0]
        bucket = prompt_bucket(s0, self.page_size,
                               self.cfg.max_position_embeddings)
        ids = torch.zeros((1, bucket), dtype=torch.int32)
        ids[0, :s0] = torch.from_numpy(prompt)
        contig = init_cache(self.cfg, 1, bucket, device=self.device)
        logits, contig = self.model(ids.to(self.device), cache=contig)
        kv_pool.alloc_slot(self.cache, slot, n_pages)
        kv_pool.prefill_into_pages(self.cache, slot, contig["layers"], s0)
        return int(_greedy_token(logits[:, s0 - 1])[0])

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

    # --- the host loop ------------------------------------------------------

    def _validate_request(self, r: Request) -> int:
        s0 = int(np.asarray(r.prompt).shape[0])
        if s0 < 1:
            raise ValueError("prompt must hold at least one token")
        if r.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if s0 + r.max_new_tokens > self.cfg.max_position_embeddings:
            raise ValueError(
                f"prompt ({s0}) + max_new_tokens ({r.max_new_tokens}) "
                f"exceeds max_position_embeddings="
                f"{self.cfg.max_position_embeddings}")
        need = kv_pool.pages_for(s0 + r.max_new_tokens, self.page_size)
        if need > self.cache["block_tables"].shape[1]:
            raise ValueError("request needs more than max_pages_per_seq "
                             "pages")
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
        dev, n_slots = self.device, self.num_slots
        tok = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        done = torch.ones((n_slots,), dtype=torch.bool, device=dev)
        n_left = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        pending = deque(range(len(requests)))
        active: dict[int, tuple[int, list]] = {}   # slot -> (request, toks)
        outputs: list = [None] * len(requests)
        stats = {"decode_steps": 0, "admitted": 0, "retired": 0,
                 "generated_tokens": 0, "window_dropped_pages": 0}
        dropped: dict[int, int] = {}    # slot -> leading entries dropped

        def retire(slot):
            i, toks = active.pop(slot)
            dropped.pop(slot, None)
            kv_pool.free_slot(self.cache, slot)
            outputs[i] = np.asarray(toks, np.int32)
            stats["retired"] += 1
            stats["generated_tokens"] += len(toks)

        def finished(i, toks):
            return ((self.eos_token_id is not None
                     and toks[-1] == self.eos_token_id)
                    or len(toks) >= requests[i].max_new_tokens)

        def drop_window_pages():
            """Free each active slot's table entries wholly below the band
            of its next query position ``nxt`` (the device length: prompt
            plus every decode step run): entry ``j`` is dead once
            ``(j + 1) * page_size - 1 <= nxt - window``."""
            ps = self.page_size
            for slot, (i, toks) in active.items():
                nxt = prompts[i].shape[0] + len(toks) - 1
                upto = max((nxt + 1 - self.window) // ps, 0)
                if upto > dropped.get(slot, 0):
                    kv_pool.drop_slot_pages(self.cache, slot, upto)
                    stats["window_dropped_pages"] += \
                        upto - dropped.get(slot, 0)
                    dropped[slot] = upto

        while pending or active:
            if self.window is not None:
                drop_window_pages()
            while pending:
                vacant = [s for s in range(n_slots) if s not in active]
                i = pending[0]
                if not vacant or kv_pool.free_page_count(self.cache) \
                        < needs[i]:
                    break                     # head-of-line
                pending.popleft()
                slot = vacant[0]
                tok0 = self._admit(prompts[i], slot, needs[i])
                stats["admitted"] += 1
                active[slot] = (i, [tok0])
                if finished(i, [tok0]):
                    retire(slot)
                    continue
                tok[slot] = tok0
                done[slot] = False
                n_left[slot] = requests[i].max_new_tokens - 1
            if not active:
                if pending:
                    raise RuntimeError(
                        "scheduler deadlock: a queued request cannot be "
                        "admitted with every slot vacant")
                break
            tok, done, n_left, toks = self._decode_chunk(tok, done, n_left)
            stats["decode_steps"] += self.sync_every
            toks_np = toks.cpu().numpy()
            for slot in list(active):
                i, out = active[slot]
                for t in toks_np[:, slot]:
                    out.append(int(t))
                    if finished(i, out):
                        retire(slot)
                        done[slot] = True
                        break
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
