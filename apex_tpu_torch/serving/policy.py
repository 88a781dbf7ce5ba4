"""Admission policy for the serving front-end: priorities, deadlines,
preemption victims.

The port's copy of ``apex_tpu/serving/policy.py`` (pure Python), unchanged
in behaviour.

The policy is pure host-side decision logic — it never touches the pool
or the device. ``ServingFrontend`` (``serving/frontend.py``) consults it
at every sync boundary to (a) order the pending queue, (b) decide whether
a blocked request justifies preempting a running one, and (c) pick the
victim. Keeping the three decisions in one small object makes the
scheduling discipline swappable (tests inject aggressive variants; a
deployment can subclass) without touching the pump.

Semantics:

- **priority** — larger int = more important. The pending queue is served
  highest-priority first; FIFO (arrival order) inside a priority class.
  Priorities are strict for *ordering* but only preemption (below) lets a
  late high-priority arrival displace work already running.
- **deadline_ms** — a TTFT service-level objective: the request should
  receive its first token within ``deadline_ms`` of ``arrival_time``.
  Deadlines break ties *within* a priority class (earliest deadline
  first) and arm preemption: a request that would otherwise sit blocked
  past its deadline may evict lower-priority running work. A missed
  deadline does not drop the request — it is still served, and the miss
  is counted (``serving.deadline_misses``).
- **preemption** — triggered only when a strictly-higher-priority request
  is blocked (no vacant slot, or not enough free pages) AND the policy
  says it cannot wait: its deadline is within ``preempt_margin_ms`` of
  now (or already past), or ``preempt_on_priority`` is set (preempt on
  priority alone, deadline or not). The victim is always the
  lowest-priority active request (ties: the most recently admitted one —
  the least sunk decode work); a victim is never preempted for an equal-
  or lower-priority candidate, so preempt/resume cannot ping-pong.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

__all__ = ["PriorityDeadlinePolicy"]


@dataclasses.dataclass
class PriorityDeadlinePolicy:
    """Priority-then-EDF admission order with deadline-armed preemption.

    ``preemption``: master switch — False degrades to pure queue ordering
    (a blocked high-priority request waits for a natural retirement).
    ``preempt_margin_ms``: how far ahead of a blocked request's deadline
    the policy acts; 0 preempts only once the deadline is already lost,
    a large margin preempts as soon as the request is blocked (tests and
    latency-critical tiers use this).
    ``preempt_on_priority``: preempt for any strictly-higher-priority
    blocked request even without a deadline — the most aggressive
    setting, used by the forced-preemption bench workload.
    ``slo_window_s``: the rolling window over which the frontend's
    ``serving.slo_burn`` gauge reports the SLO miss RATE (TTFT-deadline
    and TPOT-SLO misses over SLO-carrying retirements) — the policy owns
    the deadline semantics, so it owns the burn-rate horizon too.
    """

    preemption: bool = True
    preempt_margin_ms: float = 0.0
    preempt_on_priority: bool = False
    slo_window_s: float = 60.0

    # -- queue ordering ------------------------------------------------------

    def sort_key(self, entry, now: float) -> Tuple:
        """Total order over pending entries: higher priority first, then
        earliest deadline, then arrival time, then submission sequence
        (a stable FIFO tiebreak for identical clocks)."""
        deadline = entry.deadline_at if entry.deadline_at is not None \
            else math.inf
        return (-entry.priority, deadline, entry.arrival, entry.seq)

    # -- preemption ----------------------------------------------------------

    def at_risk(self, entry, now: float) -> bool:
        """True when ``entry`` (pending, blocked) is inside its preempt
        margin: waiting any longer risks (or has already caused) a
        deadline miss."""
        if entry.deadline_at is None:
            return False
        return now + self.preempt_margin_ms * 1e-3 >= entry.deadline_at

    def wants_preempt(self, candidate, now: float) -> bool:
        """Should a blocked ``candidate`` displace running work at all?
        (Victim eligibility is ``select_victim``'s call.)"""
        if not self.preemption:
            return False
        return self.preempt_on_priority or self.at_risk(candidate, now)

    def select_victim(self, candidate, active: Dict[int, object],
                      now: float) -> Optional[int]:
        """The slot to preempt for ``candidate``, or None. Only a
        strictly-lower-priority victim qualifies (equal priority never
        preempts — no ping-pong); among those, the lowest priority, and
        inside that class the most recently admitted (least sunk decode
        progress, mirroring vLLM's last-come-first-preempted)."""
        best_slot, best_key = None, None
        for slot, entry in active.items():
            if entry.priority >= candidate.priority:
                continue
            key = (entry.priority, -entry.seq)
            if best_key is None or key < best_key:
                best_slot, best_key = slot, key
        return best_slot
