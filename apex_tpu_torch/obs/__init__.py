"""Serving observability of the port: per-request lifecycle spans
(``spans.SpanTracer``) and the bounded event ring (``events.EventLog``)."""

from apex_tpu_torch.obs.events import EventLog
from apex_tpu_torch.obs.spans import PHASES, Span, SpanTracer

__all__ = ["EventLog", "PHASES", "Span", "SpanTracer"]
