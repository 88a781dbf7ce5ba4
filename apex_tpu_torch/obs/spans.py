"""Per-request lifecycle spans: the "why was request 17 slow?" layer.

A :class:`SpanTracer` records named intervals (spans) and instants
(events — zero-duration spans) per request id, entirely host-side: no
device syncs, a few dict operations per request phase. The serving
scheduler drives the canonical lifecycle

    enqueue -> admit -> prefill -> first_token -> decode -> retire

from which :meth:`SpanTracer.lifecycle` derives the operator metrics:

- ``queue_wait_ms`` — enqueue to admit (slot + page availability),
- ``ttft_ms``       — enqueue to first token (queue wait + prefill),
- ``tpot_ms``       — decode span / (new_tokens - 1): steady-state
  time-per-output-token,
- ``prefill`` attrs — ``cached_tokens`` vs ``computed_tokens`` (the
  prefix-cache split).

The port's copy of ``apex_tpu/obs/spans.py``. Where the reference enters
a ``jax.profiler.TraceAnnotation``, a nested span here enters
``torch.profiler.record_function``, so a ``torch.profiler`` capture of a
serving run shows the request phases as labeled host ranges beside the
device timeline.

Timestamps come from an injectable monotonic ``clock`` (tests pass a
fake); they are durations-on-one-host, not wall time — the
:class:`~apex_tpu_torch.obs.events.EventLog` records wall-clock for
correlation with external logs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["PHASES", "Span", "SpanTracer"]

#: canonical request lifecycle, in order. The bracketed middle may repeat:
#: the serving front-end preempts a running request (``preempt`` instant,
#: then a ``preempted`` interval open until its ``resume`` instant, whose
#: re-admission opens a fresh ``prefill``/``decode`` pair), so a request
#: can carry several decode segments — :meth:`SpanTracer.lifecycle` sums
#: them and reports the total time-in-preempted as ``preempted_ms``.
PHASES = ("enqueue", "admit", "prefill", "first_token", "decode",
          "preempt", "preempted", "resume", "retire")


@dataclasses.dataclass
class Span:
    """One named interval (or instant, when ``t_end == t_start``) in a
    request's lifecycle. ``attrs`` carries phase payloads (token counts,
    slot ids); :meth:`duration_ms` is None while the span is open."""

    request_id: object
    name: str
    t_start: float
    t_end: Optional[float] = None
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def duration_ms(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return (self.t_end - self.t_start) * 1e3


class SpanTracer:
    """Collects spans per request id and assembles lifecycle summaries.

    Thread-safe; begin/end of one span must pair on one thread (the
    profiler annotation is thread-scoped). The scheduler creates a fresh
    tracer per ``run()`` so lifecycles describe exactly one run.
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.RLock()
        self._spans: Dict[object, List[Span]] = {}
        self._open: Dict[Tuple[object, str], Tuple[Span, object]] = {}

    # -- recording ------------------------------------------------------

    def event(self, request_id, name: str, **attrs) -> Span:
        """Record an instant (zero-duration span)."""
        t = self._clock()
        span = Span(request_id, name, t, t, attrs)
        with self._lock:
            self._spans.setdefault(request_id, []).append(span)
        return span

    def begin(self, request_id, name: str, annotate: bool = False,
              **attrs) -> Span:
        """Open a span. ``annotate=True`` additionally enters a
        ``torch.profiler.record_function`` range — only safe when the
        matching ``end`` nests LIFO on this thread (use :meth:`span` for
        that); free-form overlapping spans (concurrent requests' decode
        intervals) must leave it False."""
        span = Span(request_id, name, self._clock(), None, attrs)
        with self._lock:
            key = (request_id, name)
            if key in self._open:
                # check BEFORE entering the annotation: raising with an
                # entered range would leave it open on this thread and
                # mis-nest every later one
                raise RuntimeError(f"span {name!r} already open for "
                                   f"request {request_id!r}")
            ann = None
            if annotate:
                ann = torch.profiler.record_function(
                    f"req{request_id}:{name}")
                ann.__enter__()
            self._open[key] = (span, ann)
            self._spans.setdefault(request_id, []).append(span)
        return span

    def end(self, request_id, name: str, **attrs) -> Span:
        with self._lock:
            try:
                span, ann = self._open.pop((request_id, name))
            except KeyError:
                raise RuntimeError(f"end({name!r}) for request "
                                   f"{request_id!r} without begin()")
            # mutate under the lock: a concurrent reader (lifecycles /
            # to_dicts from an export thread) must never see t_end set
            # while the closing attrs are still missing
            span.t_end = self._clock()
            span.attrs.update(attrs)
        if ann is not None:
            ann.__exit__(None, None, None)
        return span

    @contextlib.contextmanager
    def span(self, request_id, name: str, **attrs):
        """Properly-nested interval: rides a profiler range, so it shows
        up as a labeled host span in ``torch.profiler`` captures."""
        s = self.begin(request_id, name, annotate=True, **attrs)
        try:
            yield s
        finally:
            self.end(request_id, name)

    # -- reading --------------------------------------------------------

    def requests(self) -> List[object]:
        with self._lock:
            return list(self._spans)

    def spans(self, request_id) -> List[Span]:
        with self._lock:
            return list(self._spans.get(request_id, ()))

    def lifecycle(self, request_id) -> Dict[str, object]:
        """Derived per-request metrics from the canonical phases. Keys
        appear only when their source spans exist (a partial lifecycle —
        a still-running request — yields what is known so far).

        Preemption-aware: a preempted-and-resumed request carries one
        ``prefill``/``decode`` span pair per segment, so segment spans
        are SUMMED (``decode_ms``, ``prefill_ms``, ``new_tokens``,
        ``cached_tokens``/``computed_tokens`` are totals across
        segments), the boundary instants anchor on the FIRST occurrence
        (``queue_wait_ms``/``ttft_ms`` measure the original arrival, not
        a resume), and closed ``preempted`` intervals report their total
        as ``preempted_ms`` with the count as ``preemptions``. ``tpot``
        is decode time per generated token — preempted/queued time
        excluded by construction."""
        by_name: Dict[str, List[Span]] = {}
        for s in self.spans(request_id):
            by_name.setdefault(s.name, []).append(s)

        def first(name):
            spans = by_name.get(name)
            return spans[0] if spans else None

        out: Dict[str, object] = {"request_id": request_id}
        enq = first("enqueue")
        admit = first("admit")
        ftok = first("first_token")
        if enq is not None and admit is not None:
            out["queue_wait_ms"] = (admit.t_start - enq.t_start) * 1e3
        if enq is not None and ftok is not None:
            out["ttft_ms"] = (ftok.t_start - enq.t_start) * 1e3
        prefills = [s for s in by_name.get("prefill", ())
                    if s.duration_ms is not None]
        if prefills:
            out["prefill_ms"] = sum(s.duration_ms for s in prefills)
            for k in ("cached_tokens", "computed_tokens"):
                vals = [s.attrs[k] for s in prefills if k in s.attrs]
                if vals:
                    out[k] = sum(vals)
        decodes = [s for s in by_name.get("decode", ())
                   if s.duration_ms is not None]
        if decodes:
            out["decode_ms"] = sum(s.duration_ms for s in decodes)
            n_new = [s.attrs["new_tokens"] for s in decodes
                     if "new_tokens" in s.attrs]
            if n_new:
                total_new = int(sum(n_new))
                out["new_tokens"] = total_new
                # token 0 samples at admit; decode produces the rest
                out["tpot_ms"] = out["decode_ms"] / max(total_new - 1, 1)
        preempted = [s for s in by_name.get("preempted", ())
                     if s.duration_ms is not None]
        if by_name.get("preempted"):
            out["preemptions"] = len(by_name["preempted"])
            out["preempted_ms"] = sum(s.duration_ms for s in preempted)
        retires = by_name.get("retire")
        if enq is not None and retires:
            out["total_ms"] = (retires[-1].t_start - enq.t_start) * 1e3
        return out

    def lifecycles(self) -> Dict[object, Dict[str, object]]:
        return {rid: self.lifecycle(rid) for rid in self.requests()}
