"""Bounded ring-buffer event log.

The port's copy of the parts of ``apex_tpu/obs/events.py`` the serving
engine uses (the reference imports nothing of JAX there): the serving
engine ``emit()``\\ s small dict events (admissions, retirements,
evictions, defrags, deferrals, preemptions) into a fixed-capacity ring,
so memory is bounded however long the process serves; ``tail()`` reads
the last N, oldest dropped first (``dropped`` says how many). Events
carry a gap-free ``seq`` and a wall-clock ``t`` (``time.time``; the
injectable ``clock`` makes tests deterministic). The reference's
incremental reads and JSONL dump (``since``, ``dump``) serve its fleet
scrape and HTTP port, which are not ported.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, Optional

__all__ = ["EventLog"]


class EventLog:
    """Thread-safe fixed-capacity event ring."""

    def __init__(self, capacity: int = 1024, clock=time.time):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._clock = clock
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def emit(self, kind: str, **fields) -> dict:
        """Append one event; returns a COPY of the stored record (same
        contract as :meth:`tail` — mutating it cannot corrupt the
        ring)."""
        with self._lock:
            rec = {"seq": self._seq, "t": self._clock(), "kind": kind,
                   **fields}
            self._seq += 1
            self._buf.append(rec)
        return dict(rec)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    @property
    def total(self) -> int:
        """Events ever emitted (retained + dropped)."""
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        """Events pushed out of the ring by newer ones."""
        with self._lock:
            return self._seq - len(self._buf)

    def tail(self, n: Optional[int] = None) -> List[dict]:
        """The last ``n`` retained events (all of them when ``n`` is
        None), oldest first. Returns copies — mutating them does not
        corrupt the ring."""
        with self._lock:
            events = list(self._buf)
        if n is not None:
            events = events[-n:]
        return [dict(e) for e in events]
