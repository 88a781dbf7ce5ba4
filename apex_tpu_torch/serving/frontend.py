"""Serving front-end over the paged decode engine: streaming ingest,
priorities and deadlines, and page-spilling preemption.

Counterpart of ``apex_tpu/serving/frontend.py`` (``ServingFrontend``,
``StreamHandle``, ``ServingError``):

- **Ingest**: ``submit(request)`` is thread-safe and returns a
  :class:`StreamHandle` at once; tokens are pushed to the handle as decode
  chunks are harvested, and ``result()`` blocks for the whole output. The
  pump runs on a background thread (``start()``) or is driven
  synchronously (``drain()``, what ``PagedDecodeEngine.run()`` does).
- **Priorities and deadlines**: the pending queue is ordered by the
  injected :class:`~apex_tpu_torch.serving.policy.PriorityDeadlinePolicy`
  (priority, then earliest deadline, then arrival). ``deadline_ms`` is a
  TTFT objective; misses are counted (``serving.deadline_misses``), never
  dropped.
- **Preemption**: when a higher-priority request is blocked and the
  policy says it cannot wait, the lowest-priority active slot stops at a
  sync boundary, its full pages spill into the prefix cache
  (``release_slot`` with the tree's keep mask), and it re-enters the
  queue with its generated tokens folded into its prompt; its resume
  walks the tree and re-prefills only the tail (without a prefix cache,
  all of it). Sampled resumes continue the request's noise stream at its
  token index, so outputs are the same with preemption on or off, up to
  the numerics of the re-prefilled tail (exact in fp32; in bf16 a
  near-tied choice can flip).
- **Backpressure**: with ``backpressure_window``, a slot whose consumer
  has more unread tokens than that is spilled the same way and held out
  of admission until its consumer catches up to half the window.
- **The pump**: the engine's ``sync_every``-step decode chunk is
  dispatched first each iteration; then the previous chunk is harvested,
  finished slots retire, results stream, and admission runs. Eager
  PyTorch queues the harvest's read behind the in-flight chunk on one
  stream, so nothing overlaps on the card; the order is kept for token
  parity with the reference (``serving/scheduler.py``).

Differences from the reference, all of state the port does not have:
``_check_compile_storm`` and ``compile_watch`` (a jit recompile storm:
eager PyTorch compiles nothing at serve time; ``stats()`` reports
``jit.compiles``, ``jit.trace_cache_misses`` and ``compile_storms`` as 0),
and the host tier's ``_demote``/``_try_promote`` (not ported;
``host_tier_enabled`` is False).
``fleet.mint_trace_id`` has a local copy (:func:`mint_trace_id`).
"""

from __future__ import annotations

import hashlib
import itertools
import os
import queue as _queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from apex_tpu_torch.obs.spans import SpanTracer
from apex_tpu_torch.serving import kv_pool
from apex_tpu_torch.serving.policy import PriorityDeadlinePolicy
from apex_tpu_torch.serving.scheduler import (_RUN_COUNTERS, _RUN_HISTOGRAMS,
                                              Request, _bucket_match_pages)
from apex_tpu_torch.utils import metrics

__all__ = ["ServingError", "ServingFrontend", "StreamHandle",
           "mint_trace_id"]

#: sentinel closing a handle's token stream
_END = object()

_TRACE_SEQ = itertools.count()
_TRACE_SALT = os.urandom(16)


def mint_trace_id() -> str:
    """A process-independent trace id: 32 lowercase hex chars (the W3C
    ``traceparent`` trace-id width), as ``apex_tpu/obs/fleet.py`` mints
    them: pid, wall-clock nanoseconds, a per-process salt and a mint
    sequence feed the hash."""
    h = hashlib.sha256()
    h.update(_TRACE_SALT)
    h.update(os.getpid().to_bytes(8, "big"))
    h.update(time.time_ns().to_bytes(16, "big", signed=True))
    h.update(next(_TRACE_SEQ).to_bytes(8, "big"))
    return h.hexdigest()[:32]


class ServingError(RuntimeError):
    """Terminal serving failure delivered to a :class:`StreamHandle`:
    the pump died (engine fault, injected kill, scheduler deadlock), the
    frontend refused the request (draining, a fault hook's admission
    reject), or every failover attempt was exhausted (the router, which
    is not ported). A handle that fails raises this from
    ``result()`` AND from iteration/``get()``, so a streaming consumer
    can never block forever on a dead engine."""

#: pump timing series (run-local percentiles in ``stats()``):
#: ``dispatch_ready_ms`` = wall time of one decode chunk from dispatch to
#: the host holding its tokens, ``host_work_ms`` = the host side of one
#: pump iteration net of time blocked on the card, ``bubble_ms`` = card
#: idle between a chunk completing and the next dispatch
_PUMP_SERIES = ("pump.dispatch_ready_ms", "pump.host_work_ms",
                "pump.bubble_ms")


class StreamHandle:
    """One submitted request's streaming view: tokens arrive in order as
    the pump harvests decode chunks; iteration ends when the request
    retires (EOS / token budget) or is cancelled. ``result()`` blocks
    for the complete generated-token array. All methods are thread-safe
    (the pump pushes from its thread, callers consume from theirs)."""

    def __init__(self, request_id):
        self.request_id = request_id
        self._q: "_queue.Queue" = _queue.Queue()
        self._tokens: List[int] = []
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._cancelled = threading.Event()
        self._output: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        # consumption cursor: tokens the consumer has actually taken
        # (``get``/iteration advance it implicitly; ``ack`` explicitly),
        # so ``unread()`` is the in-flight-token window the frontend's
        # backpressure spill keys on
        self._consumed = 0

    # -- pump side -----------------------------------------------------------

    def _push(self, tok: int) -> None:
        with self._lock:
            self._tokens.append(tok)
        self._q.put(tok)

    def _finish(self, output: np.ndarray) -> None:
        self._output = output
        self._done.set()
        self._q.put(_END)

    def _fail(self, exc: BaseException) -> None:
        # terminal errors surface as ServingError everywhere (result,
        # get, iteration) with the original failure chained as the cause
        if not isinstance(exc, ServingError):
            wrapped = ServingError(
                f"request {self.request_id!r} failed: {exc!r}")
            wrapped.__cause__ = exc
            exc = wrapped
        self._error = exc
        self._done.set()
        self._q.put(_END)

    # -- caller side ---------------------------------------------------------

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancel(self) -> None:
        """Request cancellation: a pending request is dropped, an active
        one retires at the next sync boundary (its stream terminates and
        its pages free/spill normally). Idempotent; the already-streamed
        tokens remain the handle's output."""
        self._cancelled.set()

    def tokens_so_far(self) -> List[int]:
        with self._lock:
            return list(self._tokens)

    def unread(self) -> int:
        """Tokens pushed but not yet consumed — the per-consumer
        in-flight window. ``get``/iteration consume implicitly; a reader
        of :meth:`tokens_so_far` must :meth:`ack` explicitly."""
        with self._lock:
            return len(self._tokens) - self._consumed

    def ack(self, n: int) -> None:
        """Mark the first ``n`` streamed tokens consumed (monotonic;
        clamped to what has been pushed): a stalled reader stops acking
        and :meth:`unread` grows until the frontend spills the slot."""
        with self._lock:
            self._consumed = max(self._consumed,
                                 min(n, len(self._tokens)))

    @property
    def error(self) -> Optional[BaseException]:
        """The terminal :class:`ServingError`, if the request failed
        (readable once ``done``; ``result()``/iteration re-raise it)."""
        return self._error

    def get(self, timeout: Optional[float] = None) -> Optional[int]:
        """Next token, or None once the stream has terminated. Raises
        ``queue.Empty`` on timeout and the terminal
        :class:`ServingError` if the request failed — a consumer
        blocked on a stream whose engine died is woken and raised at,
        never left hanging."""
        tok = self._q.get(timeout=timeout)
        if tok is _END:
            self._q.put(_END)            # keep the stream terminated
            if self._error is not None:
                raise self._error
            return None
        with self._lock:
            self._consumed += 1          # queue order == push order
        return tok

    def __iter__(self):
        while True:
            tok = self.get()
            if tok is None:
                return
            yield tok

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the request finishes; the generated tokens (up to
        and including EOS), truncated at the cancellation point for a
        cancelled request. Re-raises a pump failure."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id!r} still running")
        if self._error is not None:
            raise self._error
        return self._output


class _Entry:
    """Pump-internal request state, reused across preempt/resume cycles:
    ``prompt`` is the CURRENT segment's prompt (the original plus every
    previously generated token after a preemption), ``prev`` the tokens
    generated by earlier segments, ``seg_tokens`` the current segment's.
    ``joined`` is the first decode-chunk index whose harvested tokens
    belong to this segment (pipelining: a chunk dispatched before the
    admission carries the PREVIOUS occupant's frozen fill tokens)."""

    __slots__ = ("idx", "handle", "prompt", "total_new", "priority",
                 "deadline_at", "arrival", "seq", "resume", "prev",
                 "seg_tokens", "nodes", "n_private", "joined",
                 "first_token_seen", "tpot_slo", "deadline_missed",
                 "win_dropped", "prefilling", "pf_pos", "pf_samp0")

    def __init__(self, idx, handle, prompt, total_new, priority,
                 deadline_at, arrival, seq):
        self.idx = idx
        self.handle = handle
        self.prompt = prompt
        self.total_new = total_new
        self.priority = priority
        self.deadline_at = deadline_at
        self.arrival = arrival
        self.seq = seq
        self.resume = False
        self.prev: List[int] = []
        self.seg_tokens: List[int] = []
        self.nodes: list = []
        self.n_private = 0
        self.joined = 0
        self.first_token_seen = False
        self.tpot_slo = None
        self.deadline_missed = False
        self.win_dropped = 0             # leading block-table entries
        #                                  already window-dropped
        self.prefilling = False          # chunked prefill in progress
        self.pf_pos = 0                  # prompt tokens fed so far
        self.pf_samp0 = 0

    @property
    def s0(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def seg_new(self) -> int:
        """This segment's token budget (total minus earlier segments)."""
        return self.total_new - len(self.prev)

    @property
    def generated(self) -> int:
        return len(self.prev) + len(self.seg_tokens)


class _Chunk:
    """An in-flight (dispatched, unharvested) decode chunk. ``toks_np`` and
    ``t_done`` cache the tokens read to the host and the moment the host
    first saw them, stamped as early as possible (an admission that reads
    the pool reads the chunk first) so ``decode_step_ms`` measures the
    chunk, not later host work."""

    __slots__ = ("toks", "idx", "t0", "toks_np", "t_done")

    def __init__(self, toks, idx, t0):
        self.toks = toks
        self.idx = idx
        self.t0 = t0
        self.toks_np = None
        self.t_done = None


class ServingFrontend:
    """Streaming ingest + priority/deadline scheduling + preemption over
    one :class:`~apex_tpu_torch.serving.scheduler.PagedDecodeEngine`.

    One frontend drives one engine; ``engine.run()`` builds a fresh one a
    call (its stats and tracer stay run-scoped), while a server holds a
    long-lived one with a background pump thread. The pump itself is
    single-threaded: only ``submit``/``cancel`` cross threads, through the
    ingest lock and the handles.
    """

    def __init__(self, engine, *, policy: Optional[PriorityDeadlinePolicy]
                 = None, tracer: Optional[SpanTracer] = None,
                 clock=time.perf_counter, fault_hook=None,
                 backpressure_window: Optional[int] = None):
        self.engine = engine
        # per-consumer in-flight-token bound (None = unbounded): an active
        # slot whose handle has more than this many unconsumed tokens is
        # spilled through the preemption path and held out of
        # re-admission until its consumer is back under half the window
        if backpressure_window is not None and backpressure_window < 1:
            raise ValueError("backpressure_window must be >= 1")
        self.backpressure_window = backpressure_window
        # fault-injection seam: an object with ``on_pump(frontend)``
        # (start of every pump iteration; may raise to kill the pump) and
        # ``on_submit(frontend, request)`` (may raise ServingError to
        # reject the submission); None = no faults
        self.fault_hook = fault_hook
        self.policy = policy if policy is not None \
            else PriorityDeadlinePolicy()
        self.clock = clock
        self.tracer = tracer if tracer is not None else SpanTracer()
        engine.tracer = self.tracer      # the engine's "last run" tracer
        n, dev = engine.num_slots, engine.device
        self._tok = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._done = torch.ones((n,), dtype=torch.bool, device=dev)
        self._n_left = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._samp_i = torch.zeros((n,), dtype=torch.int64, device=dev)
        self._streams = torch.zeros((n,), dtype=torch.int64, device=dev)
        self._ingest_lock = threading.Lock()
        self._ingest: deque = deque()
        self._pending: List[_Entry] = []
        self._active: Dict[int, _Entry] = {}
        self._inflight: Optional[_Chunk] = None
        self._chunk = 0
        self._submit_seq = itertools.count()
        self._pool_dirty = False
        self.peak_slots = 0
        self.peak_queue_depth = 0
        labels = engine.obs_labels
        self._C = {name: metrics.counter(f"serving.{name}", labels=labels)
                   for name in _RUN_COUNTERS}
        self._c0 = {name: c.value for name, c in self._C.items()}
        self._H = {name: metrics.histogram(f"serving.{name}", labels=labels)
                   for name in _RUN_HISTOGRAMS}
        self._per_run = {name: [] for name in _RUN_HISTOGRAMS
                         + _PUMP_SERIES}
        self._occ = metrics.gauge("serving.slots_in_use", labels=labels)
        self._qdepth = metrics.gauge("serving.queue_depth", labels=labels)
        # chunk device time by phase: a preempt-flush chunk is harvested
        # mid-iteration and must not pollute the steady-state distribution
        self._pump_H = {
            (name, phase): metrics.histogram(
                name, labels={**labels, "phase": phase})
            for name in ("pump.dispatch_ready_ms",)
            for phase in ("steady", "preempt")}
        self._host_H = metrics.histogram("pump.host_work_ms",
                                         labels=labels)
        self._bubble = metrics.gauge("pump.bubble_ms", labels=labels)
        self._last_ready: Optional[float] = None
        self._wait_s = 0.0
        # TPOT-SLO burn rate: (time, missed) per SLO-carrying retirement
        # inside the policy's rolling window (pump-confined state)
        self._slo_window: deque = deque()
        self._slo_burn = metrics.gauge("serving.slo_burn", labels=labels)
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._work_evt = threading.Event()
        self._failure: Optional[BaseException] = None
        self._accepting = True           # cleared by shutdown()

    # --- ingest -------------------------------------------------------------

    def submit(self, request: Request, *,
               request_id: Optional[int] = None) -> StreamHandle:
        """Enqueue one request; returns its streaming handle at once.

        Thread-safe. Validates the request's position and page budget
        first (``ValueError`` to the submitter, never to the pump).
        ``request_id`` defaults to a per-frontend sequence number; it keys
        the tracer's lifecycle AND the request's sampling stream, so two
        frontends given the same ids and seed draw the same tokens."""
        failure = self._failure          # one snapshot; re-checked locked
        if failure is not None:
            raise ServingError("frontend pump has failed") from failure
        self.engine._validate_request(request)
        if self.fault_hook is not None:
            self.fault_hook.on_submit(self, request)
        seq = next(self._submit_seq)
        idx = request_id if request_id is not None else seq
        now = self.clock()
        arrival = request.arrival_time if request.arrival_time is not None \
            else now
        deadline_at = (arrival + request.deadline_ms * 1e-3
                       if request.deadline_ms is not None else None)
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        handle = StreamHandle(idx)
        entry = _Entry(idx, handle, prompt, request.max_new_tokens,
                       request.priority, deadline_at, arrival, seq)
        entry.tpot_slo = request.tpot_slo_ms
        trace_id = request.trace_id if request.trace_id is not None \
            else mint_trace_id()
        self.tracer.event(idx, "enqueue",
                          prompt_tokens=int(prompt.shape[0]),
                          max_new_tokens=request.max_new_tokens,
                          priority=request.priority,
                          deadline_ms=request.deadline_ms,
                          trace_id=trace_id)
        with self._ingest_lock:
            # re-checked under the lock: a pump failure drains the ingest
            # queue under it, so an entry either lands before the drain
            # (and fails with the rest) or raises here
            if self._failure is not None:
                raise ServingError("frontend pump has failed") \
                    from self._failure
            if not self._accepting:
                raise ServingError("frontend is shutting down")
            self._ingest.append(entry)
            depth = len(self._ingest) + len(self._pending)
            self.peak_queue_depth = max(self.peak_queue_depth, depth)
        self._qdepth.set(depth)
        self._work_evt.set()
        return handle

    @property
    def queue_depth(self) -> int:
        with self._ingest_lock:
            return len(self._ingest) + len(self._pending)

    @property
    def pump_alive(self) -> bool:
        """True while the background pump thread runs (a synchronously
        driven frontend reports False: its caller is the pump)."""
        thread = self._thread
        return thread is not None and thread.is_alive()

    @property
    def failure(self) -> Optional[BaseException]:
        """The pump's terminal failure, if any."""
        with self._ingest_lock:
            return self._failure

    def _drain_ingest(self) -> None:
        with self._ingest_lock:
            while self._ingest:
                self._pending.append(self._ingest.popleft())

    # --- the pump -----------------------------------------------------------

    def pump(self) -> bool:
        """One scheduler iteration: dispatch the next decode chunk, then
        harvest the previous one (retire, stream, spill) and run admission
        and preemption. Returns True while work remains. Raises
        ``RuntimeError`` on a scheduler deadlock (a queued request that
        cannot be admitted with every slot vacant and every evictable page
        evicted).

        Any exception out of the pump (an engine fault, a deadlock, a
        fault hook's kill) is TERMINAL: the failure is published (later
        ``submit`` calls raise it) and every live handle fails with a
        :class:`ServingError` before the exception propagates, so no
        consumer blocked on ``result()`` or iteration hangs."""
        try:
            if self.fault_hook is not None:
                self.fault_hook.on_pump(self)
            with torch.no_grad():
                return self._pump_impl()
        except BaseException as exc:          # noqa: BLE001 — terminal
            self._fail_all(exc)
            raise

    def _fail_all(self, exc: BaseException) -> None:
        """Publish the pump's terminal failure and fail every live handle
        (ingest + pending + active). Idempotent: the first failure wins."""
        with self._ingest_lock:
            if self._failure is not None:
                return
            self._failure = exc
            victims = list(self._ingest)
            self._ingest.clear()
        victims += list(self._pending) + list(self._active.values())
        self._pending.clear()
        self._active.clear()
        self._inflight = None
        for entry in victims:
            entry.handle._fail(exc)

    def _pump_impl(self) -> bool:
        t_iter0 = self.clock()
        self._wait_s = 0.0
        self._drain_ingest()
        prev, self._inflight = self._inflight, None
        if any(not e.prefilling for e in self._active.values()):
            # the device sat idle from the last chunk's completion to this
            # dispatch: the pipeline bubble
            idle_since = prev.t_done if prev is not None \
                else self._last_ready
            self._dispatch()
            if idle_since is not None:
                bubble_ms = max(0.0,
                                (self._inflight.t0 - idle_since) * 1e3)
                self._bubble.set(bubble_ms)
                self._per_run["pump.bubble_ms"].append(bubble_ms)
                self._last_ready = None
        if prev is not None:
            self._harvest(prev)
        self._backpressure_spill()
        self._drop_window_pages()
        self._advance_prefills()
        admitted = self._admission()
        if (any(not self._bp_held(e) for e in self._pending)
                and not self._active and self._inflight is None
                and not admitted):
            raise RuntimeError(
                "scheduler deadlock: queued request cannot be admitted "
                "even with every slot vacant and every evictable cached "
                "page evicted (pool too small for its page demand?)")
        if self._pool_dirty:
            kv_pool.observe_pool(self.engine.cache,
                                 labels=self.engine.obs_labels)
            self._pool_dirty = False
        self._qdepth.set(len(self._pending))
        if prev is not None or admitted:
            host_ms = max(0.0, (self.clock() - t_iter0 - self._wait_s)
                          * 1e3)
            self._host_H.observe(host_ms)
            self._per_run["pump.host_work_ms"].append(host_ms)
        # a pending entry held by backpressure is no live work: the pump
        # has nothing to do for it until its consumer catches up
        alive = bool(self._active or self._inflight
                     or any(not self._bp_held(e) for e in self._pending))
        if not alive:
            self._last_ready = None      # idle gaps are not bubbles
        return alive

    def drain(self) -> None:
        """Pump until every submitted request has retired (what
        ``engine.run()`` does); leaves the pool gauges fresh."""
        while self.pump():
            pass
        self._occ.set(0)
        kv_pool.observe_pool(self.engine.cache,
                             labels=self.engine.obs_labels)

    def start(self) -> None:
        """Run the pump on a background thread until ``stop()``; a pump
        failure fails every live handle and is re-raised by later
        ``submit`` calls."""
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        self._stop_evt.clear()

        def loop():
            try:
                while not self._stop_evt.is_set():
                    if not self.pump():
                        self._work_evt.clear()
                        self._occ.set(0)
                        self._work_evt.wait(timeout=0.01)
            except BaseException as exc:          # noqa: BLE001
                self._fail_all(exc)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serving-frontend-pump")
        self._thread.start()

    def stop(self, timeout: Optional[float] = 30.0) -> None:
        """Stop the background pump thread (pending requests stay queued);
        for a clean end of life under load use :meth:`shutdown`."""
        if self._thread is None:
            return
        self._stop_evt.set()
        self._work_evt.set()
        self._thread.join(timeout)
        self._thread = None

    def _has_work(self) -> bool:
        return bool(self.queue_depth or self._active or self._inflight)

    def _cancel_live(self) -> None:
        """Cancel every live handle."""
        with self._ingest_lock:
            victims = [e.handle for e in self._ingest]
        victims += [e.handle for e in list(self._pending)]
        victims += [e.handle for e in list(self._active.values())]
        for handle in victims:
            handle.cancel()

    def shutdown(self, deadline_s: float = 30.0, *,
                 mode: str = "drain") -> None:
        """Graceful end of life under load: stop accepting (later
        ``submit`` raises :class:`ServingError`), then resolve every
        queued, active and mid-stream request: ``mode="drain"`` finishes
        them (cancelling once ``deadline_s`` expires), ``mode="cancel"``
        cancels them at once (each stream ends at its next sync boundary
        with the tokens streamed so far). Every handle reaches ``done``,
        every page not cached returns to the free stack, and the
        background thread, if any, is joined."""
        if mode not in ("drain", "cancel"):
            raise ValueError(f"shutdown mode must be 'drain' or "
                             f"'cancel', got {mode!r}")
        with self._ingest_lock:
            self._accepting = False
        deadline = self.clock() + deadline_s
        if mode == "cancel":
            self._cancel_live()
        if self._thread is not None:
            cancelled = mode == "cancel"
            while (self._has_work() and self.pump_alive
                   and self.failure is None):
                if self.clock() >= deadline:
                    if cancelled:
                        break
                    self._cancel_live()
                    cancelled = True
                    deadline = self.clock() + max(deadline_s, 1.0)
                time.sleep(0.002)
            self.stop()
        # the pump is ours now (or always was): drive what remains,
        # deadline-bounded while draining, then bounded by a pump budget
        # once everything is cancelled (cancels resolve within about two
        # boundaries), so shutdown always ends
        cancelled = mode == "cancel"
        budget: Optional[int] = None
        try:
            while self._has_work():
                if not cancelled and self.clock() >= deadline:
                    self._cancel_live()
                    cancelled = True
                if cancelled:
                    if budget is None:
                        budget = 4 * self.engine.num_slots + 16
                    budget -= 1
                    if budget < 0:
                        break
                if not self.pump():
                    if cancelled or not any(self._bp_held(e)
                                            for e in self._pending):
                        break
                    time.sleep(0.002)
        except Exception:                # noqa: BLE001 — handles already
            pass                         # failed by pump(); stop cleanly
        leftovers = []
        with self._ingest_lock:
            leftovers += list(self._ingest)
            self._ingest.clear()
        leftovers += list(self._pending) + list(self._active.items())
        self._pending.clear()
        if self._active and self.failure is None:
            # release the stragglers' pages before failing them: no page
            # leaks even when the deadline expired with slots decoding
            for slot, entry in list(self._active.items()):
                self._release_pages(slot, entry)
                self._done[slot] = True
            self._active.clear()
        exc = ServingError(f"frontend shutdown ({mode}) deadline "
                           f"expired with requests unresolved")
        for item in leftovers:
            entry = item[1] if isinstance(item, tuple) else item
            entry.handle._fail(exc)
        self._occ.set(0)
        self._qdepth.set(0)
        if self.failure is None:
            kv_pool.observe_pool(self.engine.cache,
                                 labels=self.engine.obs_labels)

    # --- device chunk dispatch/harvest --------------------------------------

    def _dispatch(self) -> None:
        eng = self.engine
        self._chunk += 1
        busy = sum(1 for e in self._active.values()
                   if e.joined <= self._chunk)
        self._C["busy_slot_steps"].inc(busy * eng.sync_every)
        self._C["decode_steps"].inc(eng.sync_every)
        t0 = self.clock()
        if eng.draft_len:
            # speculative chunk: (target predictions, per-slot per-round
            # acceptance counts); the harvest emits toks[r, slot,
            # :counts[r, slot]]
            self._tok, self._done, self._n_left, toks, counts = \
                eng._spec_chunk(self._tok, self._done, self._n_left)
            self._inflight = _Chunk((toks, counts), self._chunk, t0)
        else:
            (self._tok, self._done, self._n_left, self._samp_i,
             toks) = eng._decode_chunk(self._tok, self._done, self._n_left,
                                       self._streams, self._samp_i)
            self._inflight = _Chunk(toks, self._chunk, t0)
        self.peak_slots = max(self.peak_slots, len(self._active))
        self._occ.set(len(self._active))

    def _materialize(self, chunk: _Chunk):
        """Read the chunk's tokens to the host (waiting for the card) and
        stamp its completion time, once."""
        if chunk.toks_np is None:
            t_enter = self.clock()
            chunk.toks_np = (tuple(t.cpu().numpy() for t in chunk.toks)
                             if isinstance(chunk.toks, tuple)
                             else chunk.toks.cpu().numpy())
            chunk.t_done = self.clock()
            self._wait_s += chunk.t_done - t_enter
            self._last_ready = chunk.t_done
        return chunk.toks_np

    def _harvest(self, chunk: _Chunk, *, phase: str = "steady") -> None:
        eng = self.engine
        toks_np = self._materialize(chunk)
        chunk_ms = (chunk.t_done - chunk.t0) * 1e3
        step_ms = chunk_ms / eng.sync_every
        self._H["decode_step_ms"].observe(step_ms)
        self._per_run["decode_step_ms"].append(step_ms)
        self._pump_H[("pump.dispatch_ready_ms", phase)].observe(chunk_ms)
        if phase == "steady":
            self._per_run["pump.dispatch_ready_ms"].append(chunk_ms)
        eos = eng.eos_token_id
        spec = isinstance(toks_np, tuple)
        if spec:
            preds_np, counts_np = toks_np
        for slot in list(self._active):
            entry = self._active[slot]
            if entry.prefilling:
                continue                 # _advance_prefills handles it
            if entry.handle.cancelled:
                self._retire(slot, cancelled=True)
                self._done[slot] = True
                continue
            if entry.joined > chunk.idx:
                continue                 # admitted after this chunk ran
            finished = False
            runs = ([preds_np[r, slot, :int(counts_np[r, slot])]
                     for r in range(preds_np.shape[0])] if spec
                    else [toks_np[:, slot]])
            for run in runs:
                if spec and run.shape[0]:
                    self._C["spec_rounds"].inc()
                    self._C["spec_tokens"].inc(int(run.shape[0]))
                for t in run:
                    t = int(t)
                    entry.seg_tokens.append(t)
                    entry.handle._push(t)
                    if ((eos is not None and t == eos)
                            or entry.generated >= entry.total_new):
                        finished = True
                        break
                if finished:
                    break
            if finished:
                self._retire(slot)
                self._done[slot] = True

    def _drop_window_pages(self) -> None:
        """Sliding-window models only: free each active slot's pages that
        fell wholly below the attention band (``kv_pool.drop_slot_pages``).
        Entry ``j`` is dead once the next query position ``p`` satisfies
        ``(j + 1) * page_size - 1 <= p - window``; the band only moves
        forward, so each page frees once."""
        eng = self.engine
        window = eng.window
        if window is None:
            return
        ps = eng.page_size
        for slot, entry in self._active.items():
            # the device length at the last harvested boundary: prompt
            # plus every decode step run; the next query sits there
            nxt = entry.s0 + len(entry.seg_tokens) - 1
            upto = max((nxt + 1 - window) // ps, 0)
            if upto > entry.win_dropped:
                kv_pool.drop_slot_pages(eng.cache, slot, upto)
                freed = upto - entry.win_dropped
                entry.win_dropped = upto
                entry.n_private -= freed
                self._C["window_dropped_pages"].inc(freed)
                self._pool_dirty = True

    def _flush(self) -> None:
        """Harvest the in-flight chunk (if any) so every active record's
        tokens are current: the precondition of a preemption spill."""
        prev, self._inflight = self._inflight, None
        if prev is not None:
            self._harvest(prev, phase="preempt")

    # --- retirement / preemption --------------------------------------------

    def _release_pages(self, slot: int, entry: _Entry) -> None:
        """Return slot ``slot``'s pages: with a prefix cache, its full
        written pages (prompt + fed tokens) move into the radix tree (so a
        later match, this request's own resume included, hits) and the
        partial tail frees; without one everything frees."""
        eng = self.engine
        if eng.prefix is None:
            kv_pool.free_slot(eng.cache, slot)
            if eng.draft_len:
                kv_pool.free_slot(eng.draft_cache, slot)
            return
        if entry.prefilling:
            # mid-prefill (cancel, shutdown): only the fed pieces are
            # written; their full pages are cacheable
            written = entry.pf_pos
            seq = entry.prompt[:written]
        else:
            # written K/V: the prompt and every token fed while alive (all
            # but the last sampled one); only full pages are shareable
            written = entry.s0 + len(entry.seg_tokens) - 1
            seq = np.concatenate(
                [entry.prompt, np.asarray(entry.seg_tokens[:-1],
                                          np.int32)])
        row = eng.cache["block_tables"][slot].cpu().numpy()
        keep = eng.prefix.release_and_insert(seq, written, entry.nodes, row)
        kv_pool.release_slot(eng.cache, slot, torch.from_numpy(keep))

    def _observe_lifecycle(self, idx) -> dict:
        life = self.tracer.lifecycle(idx)
        for name in ("ttft_ms", "tpot_ms", "queue_wait_ms"):
            if name in life:
                self._H[name].observe(life[name])
                self._per_run[name].append(life[name])
        return life

    def _observe_slo(self, entry: _Entry, life: dict, now: float) -> None:
        """The TPOT-SLO check (once, at retirement) and the rolling burn
        gauge over the policy's window: the share of SLO-carrying
        retirements that missed their TTFT deadline or TPOT target."""
        missed_tpot = (entry.tpot_slo is not None
                       and life.get("tpot_ms") is not None
                       and life["tpot_ms"] > entry.tpot_slo)
        if missed_tpot:
            self._C["tpot_slo_misses"].inc()
            self.tracer.event(entry.idx, "tpot_slo_miss",
                              tpot_ms=life["tpot_ms"],
                              slo_ms=entry.tpot_slo)
            self.engine.events.emit("tpot_slo_miss", request=entry.idx,
                                    tpot_ms=round(life["tpot_ms"], 3),
                                    slo_ms=entry.tpot_slo)
        if entry.tpot_slo is None and entry.deadline_at is None:
            return
        self._slo_window.append(
            (now, bool(missed_tpot or entry.deadline_missed)))
        horizon = now - self.policy.slo_window_s
        while self._slo_window and self._slo_window[0][0] < horizon:
            self._slo_window.popleft()
        misses = sum(1 for _, m in self._slo_window if m)
        self._slo_burn.set(misses / len(self._slo_window))

    def _retire(self, slot: int, *, cancelled: bool = False) -> None:
        eng = self.engine
        entry = self._active.pop(slot)
        output = np.asarray(entry.prev + entry.seg_tokens, np.int32)
        self._C["retired"].inc()
        self._C["generated_tokens"].inc(int(output.shape[0]))
        n_seg = len(entry.seg_tokens)
        self.tracer.end(entry.idx, "decode", new_tokens=n_seg)
        self.tracer.event(entry.idx, "retire", slot=slot,
                          new_tokens=int(output.shape[0]),
                          cancelled=cancelled)
        eng.events.emit("cancel" if cancelled else "retire",
                        request=entry.idx, slot=slot,
                        new_tokens=int(output.shape[0]))
        life = self._observe_lifecycle(entry.idx)
        if not cancelled:
            self._observe_slo(entry, life, self.clock())
        self._release_pages(slot, entry)
        self._pool_dirty = True
        entry.handle._finish(output)

    def _preempt(self, slot: int) -> None:
        """Stop the victim at this (flushed) sync boundary, spill its full
        pages into the prefix cache, and requeue it with its generated
        tokens folded into the prompt: the resume re-prefills only the
        uncached tail (without a prefix cache, all of it)."""
        eng = self.engine
        entry = self._active.pop(slot)
        self.tracer.end(entry.idx, "decode",
                        new_tokens=len(entry.seg_tokens))
        self.tracer.begin(entry.idx, "preempted")
        self.tracer.event(entry.idx, "preempt", slot=slot,
                          generated=entry.generated)
        self._C["preemptions"].inc()
        eng.events.emit("preempt", request=entry.idx, slot=slot,
                        generated=entry.generated)
        self._release_pages(slot, entry)
        self._pool_dirty = True
        self._done[slot] = True
        # the resume prompt carries every generated token (the last one,
        # never written, re-prefills); the budget shrinks by what was
        # delivered
        entry.prompt = np.concatenate(
            [entry.prompt, np.asarray(entry.seg_tokens, np.int32)])
        entry.prev = entry.prev + entry.seg_tokens
        entry.seg_tokens = []
        entry.nodes = []
        entry.resume = True
        self._pending.append(entry)

    # --- consumption-aware backpressure -------------------------------------

    def _bp_stalled(self, entry: _Entry) -> bool:
        """An ACTIVE slot whose consumer stalled past the window (a
        backpressure-spill victim); cancelled handles excluded."""
        w = self.backpressure_window
        return (w is not None and not entry.prefilling
                and not entry.handle.cancelled
                and entry.handle.unread() > w)

    def _bp_held(self, entry: _Entry) -> bool:
        """A PENDING entry whose consumer is still behind: held out of
        admission until its unread tokens fall to half the window."""
        w = self.backpressure_window
        return (w is not None and entry.resume
                and not entry.handle.cancelled
                and entry.handle.unread() > w // 2)

    def _backpressure_spill(self) -> None:
        """Spill every active slot whose reader stalled past the window
        through the preemption path (bypassing the policy: the victim is
        refusing to pin pool pages behind a stalled consumer)."""
        if self.backpressure_window is None or not self._active:
            return
        victims = [s for s, e in self._active.items()
                   if self._bp_stalled(e)]
        if not victims:
            return
        self._flush()
        for slot in victims:
            entry = self._active.get(slot)
            if entry is None or not self._bp_stalled(entry):
                continue                 # the flush retired or changed it
            self._C["backpressure_spills"].inc()
            self.tracer.event(entry.idx, "backpressure_spill",
                              slot=slot, unread=entry.handle.unread())
            self.engine.events.emit("backpressure_spill",
                                    request=entry.idx, slot=slot,
                                    unread=entry.handle.unread())
            self._preempt(slot)

    def _maybe_preempt(self, candidate: _Entry, now: float) -> bool:
        """Try to free a slot (and spill pages) for a blocked
        ``candidate``; True when the boundary state changed (a victim was
        preempted, or the flush itself retired slots), so the caller
        retries the candidate."""
        eng = self.engine
        if not self.policy.wants_preempt(candidate, now):
            return False
        # a candidate the whole pool cannot hold is a deadlock, not a
        # reason to stop running work
        need_total = kv_pool.pages_for(candidate.s0 + candidate.seg_new,
                                       eng.page_size)
        if need_total > kv_pool.num_pages_of(eng.cache) - 1:
            return False
        # a mid-prefill slot has emitted nothing: never a victim
        decoding = {s: e for s, e in self._active.items()
                    if not e.prefilling}
        victim_slot = self.policy.select_victim(candidate, decoding, now)
        if victim_slot is None:
            return False
        n_active = len(self._active)
        self._flush()
        if victim_slot not in self._active:
            return True                  # the flush retired it: retry
        if len(self._active) < n_active and any(
                s not in self._active for s in range(eng.num_slots)):
            return True                  # the flush freed another slot
        self._preempt(victim_slot)
        return True

    # --- admission ----------------------------------------------------------

    def _try_admit(self, entry: _Entry, slot: int, now: float) -> bool:
        """Admit ``entry`` into vacant ``slot`` if the pool can hold it
        (evicting and defragmenting as needed); False defers it
        (head-of-line). A resume's prefix match is not floored to a power
        of two pages: its depth is its own written length, so its whole
        spilled prefix is reused."""
        eng = self.engine
        tr = self.tracer
        ps = eng.page_size
        prompt, s0, idx = entry.prompt, entry.s0, entry.idx
        need_total = kv_pool.pages_for(s0 + entry.seg_new, ps)
        # match BEFORE the page check: matched pages are shared, not
        # allocated; acquired at once so the eviction below sees them
        # pinned
        nodes = eng.prefix.match(prompt) if eng.prefix is not None else []
        if not entry.resume:
            nodes = nodes[:_bucket_match_pages(len(nodes))]
        if nodes:
            eng.prefix.acquire(nodes)
        m = len(nodes)
        need = need_total - m
        if self._inflight is not None:
            self._materialize(self._inflight)
        free = int(kv_pool.free_page_count(eng.cache))
        if free < need and eng.prefix is not None:
            pages = eng.prefix.evict(need - free)
            if pages:
                kv_pool.push_free_pages(eng.cache, pages)
                self._C["evicted_pages"].inc(len(pages))
                eng.events.emit("evict", request=idx, pages=len(pages))
                free += len(pages)
        if free < need and eng._leak_suspected(free, self._active):
            eng._defrag_now()
            self._C["defrag_runs"].inc()
            eng.events.emit("defrag", request=idx)
            free = int(kv_pool.free_page_count(eng.cache))
        if free < need:
            if nodes:
                eng.prefix.release(nodes)
            self._C["deferred_admissions"].inc()
            eng.events.emit("defer", request=idx, need_pages=need,
                            free_pages=free)
            return False
        if entry.resume:
            tr.end(idx, "preempted")
            tr.event(idx, "resume", slot=slot, cached_pages=m,
                     resumed_at=entry.generated)
            self._C["resumes"].inc()
            eng.events.emit("resume", request=idx, slot=slot,
                            cached_pages=m)
        tr.event(idx, "admit", slot=slot, free_pages=free, cached_pages=m)
        samp0 = len(entry.prev)          # a resume continues its stream
        max_pages = eng.cache["block_tables"].shape[1]
        row = np.zeros((max_pages,), np.int32)
        row[:m] = [n.page for n in nodes]
        if m:
            self._C["prefix_hits"].inc()
        # chunked prefill: allocate the pages now and feed the uncached
        # tail through the paged s > 1 path a piece per pump iteration,
        # interleaved with the decode chunks; a tail of at most one piece
        # keeps the monolithic path
        if (eng.prefill_chunk is not None and s0 - m * ps > eng.prefill_chunk
                and s0 + eng.prefill_chunk - 1 <= max_pages * ps):
            tr.begin(idx, "prefill", cached_tokens=m * ps,
                     computed_tokens=s0 - m * ps, chunked=True)
            eng._chunk_admit(slot, need, row, m)
            self._C["admitted"].inc()
            self._C["chunked_prefills"].inc()
            self._C["prefill_tokens_total"].inc(s0)
            self._C["prefill_tokens_computed"].inc(s0 - m * ps)
            eng.events.emit("admit", request=idx, slot=slot,
                            prompt_tokens=s0, cached_tokens=m * ps,
                            priority=entry.priority, chunked=True)
            entry.nodes = nodes
            entry.n_private = need
            entry.win_dropped = 0
            entry.seg_tokens = []
            entry.prefilling = True
            entry.pf_pos = m * ps
            entry.pf_samp0 = samp0
            # no harvestable decode tokens until the prefill finishes
            entry.joined = self._chunk + (1 << 30)
            self._active[slot] = entry
            self._pool_dirty = True
            self._feed_chunk(slot, entry)    # the first piece rides now
            return True
        # the prefill span covers the admission and the first token's
        # read: its end is the first token's arrival
        with tr.span(idx, "prefill", cached_tokens=m * ps,
                     computed_tokens=s0 - m * ps):
            if m == 0:
                tok0 = eng._admit(prompt, slot, need, idx, samp0)
            else:
                tok0 = eng._admit_shared(prompt, slot, row, m, need, idx,
                                         samp0)
        self._first_token_seen(entry, slot)
        tr.begin(idx, "decode", slot=slot)
        self._C["admitted"].inc()
        self._C["prefill_tokens_total"].inc(s0)
        self._C["prefill_tokens_computed"].inc(s0 - m * ps)
        eng.events.emit("admit", request=idx, slot=slot, prompt_tokens=s0,
                        cached_tokens=m * ps, priority=entry.priority)
        entry.nodes = nodes
        entry.n_private = need
        entry.win_dropped = 0            # a fresh row: nothing dropped
        self._start_decode(slot, entry, tok0, samp0)
        return True

    def _first_token_seen(self, entry: _Entry, slot: int) -> None:
        """The first-token event and the TTFT deadline check, once per
        request (a resume's re-admission never counts again)."""
        if entry.first_token_seen:
            return
        entry.first_token_seen = True
        self.tracer.event(entry.idx, "first_token", slot=slot)
        if entry.deadline_at is not None and self.clock() > entry.deadline_at:
            entry.deadline_missed = True
            self._C["deadline_misses"].inc()
            self.tracer.event(entry.idx, "deadline_miss")
            self.engine.events.emit("deadline_miss", request=entry.idx)

    def _start_decode(self, slot: int, entry: _Entry, tok0: int,
                      samp0: int) -> None:
        """Hand the slot its first token: it decodes from the next chunk
        on (or retires at once)."""
        entry.seg_tokens = [tok0]
        entry.joined = self._chunk + 1
        self._active[slot] = entry
        entry.handle._push(tok0)
        self._pool_dirty = True
        if ((self.engine.eos_token_id is not None
             and tok0 == self.engine.eos_token_id) or entry.seg_new == 1):
            self._retire(slot)
            return
        self._tok[slot] = tok0
        self._done[slot] = False
        self._n_left[slot] = entry.seg_new - 1
        self._samp_i[slot] = samp0 + 1
        self._streams[slot] = entry.idx

    def _advance_prefills(self) -> bool:
        """Feed ONE piece to every mid-prefill slot; finish the ones whose
        prompt is exhausted into decoding slots. True when any slot
        advanced."""
        if self.engine.prefill_chunk is None:
            return False
        advanced = False
        for slot in list(self._active):
            entry = self._active.get(slot)
            if entry is None or not entry.prefilling:
                continue
            if entry.handle.cancelled:
                self._abort_prefill(slot, entry)
                continue
            self._feed_chunk(slot, entry)
            advanced = True
        return advanced

    def _feed_chunk(self, slot: int, entry: _Entry) -> None:
        eng = self.engine
        c = eng.prefill_chunk
        t, s0 = entry.pf_pos, entry.s0
        valid = min(c, s0 - t)
        ids = torch.zeros((1, c), dtype=torch.int32)   # the last piece pads
        ids[0, :valid] = torch.from_numpy(entry.prompt[t:t + valid])
        eng.cache, last = eng._prefill_step(eng.cache, ids.to(eng.device),
                                            slot, valid)
        entry.pf_pos = t + valid
        self._C["prefill_chunks"].inc()
        if entry.pf_pos >= s0:
            # the first token's read waits for the whole stream: stamp
            # the in-flight decode chunk's completion first
            if self._inflight is not None:
                self._materialize(self._inflight)
            tok0 = eng._first_token(last, entry.idx, entry.pf_samp0)
            entry.prefilling = False
            self.tracer.end(entry.idx, "prefill")
            self._first_token_seen(entry, slot)
            self.tracer.begin(entry.idx, "decode", slot=slot)
            self._start_decode(slot, entry, tok0, entry.pf_samp0)

    def _abort_prefill(self, slot: int, entry: _Entry) -> None:
        """Cancellation mid-prefill: release the pages (full fed pages
        stay cacheable) and finish the handle with the earlier segments'
        tokens."""
        eng = self.engine
        self._active.pop(slot)
        self._C["retired"].inc()
        self.tracer.end(entry.idx, "prefill")
        self.tracer.event(entry.idx, "retire", slot=slot,
                          new_tokens=len(entry.prev), cancelled=True)
        eng.events.emit("cancel", request=entry.idx, slot=slot,
                        new_tokens=len(entry.prev))
        self._release_pages(slot, entry)
        self._pool_dirty = True
        entry.handle._finish(np.asarray(entry.prev, np.int32))

    def _admission(self) -> int:
        """Fill vacant slots from the policy-ordered pending queue;
        preempt for the head when the policy demands it. Head-of-line
        blocking holds inside the order: if the most urgent pending
        request cannot get pages, nothing behind it jumps the queue."""
        eng = self.engine
        now = self.clock()
        held: List[_Entry] = []
        if self.backpressure_window is not None and self._pending:
            # entries held by backpressure wait on their consumer, not on
            # slots or pages: they sit out the pass and block nobody
            held = [e for e in self._pending if self._bp_held(e)]
            if held:
                held_ids = {id(e) for e in held}
                self._pending = [e for e in self._pending
                                 if id(e) not in held_ids]
        self._pending.sort(key=lambda e: self.policy.sort_key(e, now))
        admitted = 0
        preempts_left = eng.num_slots    # bounds the preempt-retry loop
        while self._pending:
            entry = self._pending[0]
            if entry.handle.cancelled:
                self._pending.pop(0)
                eng.events.emit("cancel", request=entry.idx, queued=True)
                entry.handle._finish(np.asarray(entry.prev, np.int32))
                continue
            free_slots = [s for s in range(eng.num_slots)
                          if s not in self._active]
            if not free_slots:
                if preempts_left > 0 and self._maybe_preempt(entry, now):
                    preempts_left -= 1
                    continue
                break
            if self._try_admit(entry, free_slots[0], now):
                self._pending.pop(0)
                admitted += 1
                continue
            # page-short: preemption can spill a lower-priority slot's
            # pages into evictable cached ones; retry once per victim
            if preempts_left > 0 and self._maybe_preempt(entry, now):
                preempts_left -= 1
                continue
            break
        self._pending.extend(held)
        return admitted

    # --- run-scoped stats ---------------------------------------------------

    def counter_deltas(self) -> Dict[str, float]:
        """This frontend's ``serving.*`` counter deltas since construction,
        recording nothing (safe to poll)."""
        return {name: c.value - self._c0[name]
                for name, c in self._C.items()}

    def stats(self) -> dict:
        """The engine-stats dict of this frontend's lifetime so far:
        counter deltas since construction and run-local latency
        percentiles, with the reference's keys (``generated_tokens``
        beside them). The keys the reference fills from what eager
        PyTorch on one card does not have state the port's values:
        ``jit.compiles``, ``jit.trace_cache_misses`` and
        ``compile_storms`` are 0 (nothing is traced or compiled at serve
        time), ``tp_world`` is the engine's tensor-parallel size (1 but
        for ``serving/tp.py``'s engine), ``host_tier_enabled`` False (the host
        tier is not ported). Records every numeric stat as a
        ``serving.<name>`` raw series: call once per run."""
        eng = self.engine
        d = self.counter_deltas()
        with self._ingest_lock:
            peak_queue_depth = self.peak_queue_depth
        stats = {
            "decode_steps": int(d["decode_steps"]),
            "admitted": int(d["admitted"]),
            "retired": int(d["retired"]),
            "generated_tokens": int(d["generated_tokens"]),
            "peak_slots_in_use": self.peak_slots,
            "slot_occupancy": (d["busy_slot_steps"]
                               / max(d["decode_steps"] * eng.num_slots,
                                     1)),
            "deferred_admissions": int(d["deferred_admissions"]),
            "defrag_runs": int(d["defrag_runs"]),
            "tp_world": getattr(eng, "tp_world", 1),
            "preemptions": int(d["preemptions"]),
            "resumes": int(d["resumes"]),
            "backpressure_spills": int(d["backpressure_spills"]),
            "deadline_misses": int(d["deadline_misses"]),
            "tpot_slo_misses": int(d["tpot_slo_misses"]),
            "window_dropped_pages": int(d["window_dropped_pages"]),
            "slo_burn": self._slo_burn.value,
            "peak_queue_depth": peak_queue_depth,
            "prefix_cache_enabled": eng.prefix is not None,
            "prefix_hits": int(d["prefix_hits"]),
            "prefix_hit_rate": d["prefix_hits"] / max(d["admitted"], 1),
            "prefix_cached_pages": (len(eng.prefix)
                                    if eng.prefix is not None else 0),
            "evicted_pages": int(d["evicted_pages"]),
            "prefill_tokens_total": int(d["prefill_tokens_total"]),
            "prefill_tokens_computed": int(d["prefill_tokens_computed"]),
            "prefill_tokens_skipped": int(d["prefill_tokens_total"]
                                          - d["prefill_tokens_computed"]),
            "spec_rounds": int(d["spec_rounds"]),
            "spec_tokens": int(d["spec_tokens"]),
            "mean_acceptance_len": (d["spec_tokens"]
                                    / max(d["spec_rounds"], 1)),
            "chunked_prefills": int(d["chunked_prefills"]),
            "prefill_chunks": int(d["prefill_chunks"]),
            "host_tier_enabled": False,
        }
        bubbles = self._per_run["pump.bubble_ms"]
        stats["pump.bubble_ms"] = float(np.mean(bubbles)) if bubbles \
            else 0.0
        stats["jit.compiles"] = 0
        stats["jit.trace_cache_misses"] = 0
        stats["compile_storms"] = 0
        for name, vals in self._per_run.items():
            if vals:
                stats[f"{name}_p50"] = float(np.percentile(vals, 50))
                stats[f"{name}_p95"] = float(np.percentile(vals, 95))
        for name, val in stats.items():
            if isinstance(val, bool):
                continue
            metrics.record(f"serving.{name}", val)
        return stats
