"""Typed metric instruments and the scalar registry.

Counterpart of ``apex_tpu/utils/metrics.py`` in the parts the serving
frontend reads: :class:`Counter` (monotonic), :class:`Gauge` (last value)
and :class:`Histogram` (log-bucketed, p50/p90/p99), each with optional
labels, interned in a process-wide registry by :func:`counter` /
:func:`gauge` / :func:`histogram` (the same ``(name, labels)`` always
returns the same object), and the raw scalar series ``record`` appends
to. The serving engine and frontend (``apex_tpu_torch/serving``) count
into it under ``serving.*`` names. The reference delivers ``record``
values from inside jitted programs by ``jax.debug.callback``; eager
PyTorch has no traced values, so ``record`` takes a number (a 0-d tensor
is read on the host) and appends it at once. Every registry mutation
takes the module lock. The reference's exporters' views (``snapshot``,
``summary``), ``AverageMeter`` and ``StepTimer`` are not ported.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Dict, List, Optional, Tuple


__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge",
           "histogram", "record"]

# one re-entrant lock guards the raw series, the instrument table, and
# every instrument's internal state: a frontend's pump thread counts while
# another thread reads a summary
_LOCK = threading.RLock()
_REGISTRY: Dict[str, List[float]] = collections.defaultdict(list)

LabelsKey = Tuple[Tuple[str, str], ...]
_INSTRUMENTS: "Dict[Tuple[str, LabelsKey], Instrument]" = {}


def _labels_key(labels: Optional[Dict[str, str]]) -> LabelsKey:
    return tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))


class Instrument:
    """Base: a named, optionally-labeled metric. Subclasses define the
    measurement semantics; construction goes through :func:`counter` /
    :func:`gauge` / :func:`histogram` so equal ``(name, labels)`` pairs
    share one instance process-wide."""

    kind = "untyped"

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels or {})

    def key(self) -> Tuple[str, LabelsKey]:
        return (self.name, _labels_key(self.labels))

    def config(self) -> Dict[str, object]:
        """Layout parameters that must agree across every label set of a
        name (one Prometheus family, one layout)."""
        return {}


class Counter(Instrument):
    """Monotonically non-decreasing count (requests admitted, pages
    evicted). Per-interval rates/deltas are the READER's job (the
    scheduler derives per-run stats from start/end values)."""

    kind = "counter"

    def __init__(self, name, labels=None):
        super().__init__(name, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"Counter.inc({n}): counters only go up — "
                             "use a Gauge for signed deltas")
        with _LOCK:
            self._value += float(n)

    @property
    def value(self) -> float:
        with _LOCK:
            return self._value


class Gauge(Instrument):
    """Last-written value (free pages, slots in use)."""

    kind = "gauge"

    def __init__(self, name, labels=None):
        super().__init__(name, labels)
        self._value = 0.0

    def set(self, v) -> None:
        with _LOCK:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with _LOCK:
            self._value += float(n)

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with _LOCK:
            return self._value


class Histogram(Instrument):
    """Log-bucketed histogram with quantile estimation.

    Bucket ``i`` covers ``(base * growth**(i-1), base * growth**i]``
    (bucket 0 covers ``(0, base]``; the last bucket is open-ended), so a
    fixed, small bucket array spans microseconds to hours — the standard
    latency-histogram layout. :meth:`quantile` walks the cumulative
    counts and interpolates linearly inside the target bucket, clamped to
    the observed ``[min, max]`` (a single-observation histogram reports
    that exact value at every quantile; errors are bounded by one bucket's
    width, i.e. a factor of ``growth``).
    """

    kind = "histogram"

    def __init__(self, name, labels=None, *, base: float = 1e-2,
                 growth: float = 2.0, n_buckets: int = 48):
        super().__init__(name, labels)
        if base <= 0 or growth <= 1 or n_buckets < 2:
            raise ValueError("Histogram needs base > 0, growth > 1, "
                             "n_buckets >= 2")
        self.base = float(base)
        self.growth = float(growth)
        self.n_buckets = n_buckets
        self._lg = math.log(growth)
        self._counts = [0] * n_buckets
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -- write ----------------------------------------------------------

    def _bucket_index(self, v: float) -> int:
        if v <= self.base:
            return 0
        # le semantics at boundaries: v == base*growth**i lands in bucket
        # i (the 1e-9 slack absorbs log() round-off at exact powers)
        i = int(math.ceil(math.log(v / self.base) / self._lg - 1e-9))
        return min(max(i, 0), len(self._counts) - 1)

    def observe(self, v) -> None:
        v = float(v)
        with _LOCK:
            self._counts[self._bucket_index(v)] += 1
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    # -- read -----------------------------------------------------------

    @property
    def count(self) -> int:
        with _LOCK:
            return self._count

    @property
    def sum(self) -> float:
        with _LOCK:
            return self._sum

    def bucket_le(self, i: int) -> float:
        """Upper bound of bucket ``i`` (inf for the last bucket)."""
        if i >= len(self._counts) - 1:
            return math.inf
        return self.base * self.growth ** i

    def buckets(self) -> List[Tuple[float, int]]:
        """``[(le, cumulative_count), ...]`` — the Prometheus layout."""
        out, cum = [], 0
        with _LOCK:
            for i, c in enumerate(self._counts):
                cum += c
                out.append((self.bucket_le(i), cum))
        return out

    def quantile(self, q: float) -> float:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with _LOCK:
            if self._count == 0:
                return 0.0
            target = q * self._count
            cum = 0.0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if cum + c >= target:
                    lo = 0.0 if i == 0 else self.bucket_le(i - 1)
                    hi = self.bucket_le(i)
                    if math.isinf(hi):
                        hi = self._max
                    frac = (target - cum) / c
                    v = lo + frac * (hi - lo)
                    return min(max(v, self._min), self._max)
                cum += c
            return self._max

    def percentiles(self) -> Dict[str, float]:
        return {"p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}

    def config(self) -> Dict[str, object]:
        return {"base": self.base, "growth": self.growth,
                "n_buckets": self.n_buckets}


def _instrument(cls, name: str, labels: Optional[Dict[str, str]], **kw):
    key = (name, _labels_key(labels))
    with _LOCK:
        inst = _INSTRUMENTS.get(key)
        if inst is None:
            # kind AND layout are properties of the NAME (the Prometheus
            # data model: one family, one type, one bucket layout) — a
            # sibling label set must agree on both
            sibling = next((i for (n, _), i in _INSTRUMENTS.items()
                            if n == name), None)
            if sibling is not None and not isinstance(sibling, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{sibling.kind} (labels {sibling.labels}), not "
                    f"{cls.kind}")
            inst = cls(name, labels, **kw)
            if sibling is not None and inst.config() != sibling.config():
                raise ValueError(
                    f"metric {name!r} label set {inst.labels} asks for "
                    f"config {inst.config()} but the family is "
                    f"registered with {sibling.config()}")
            _INSTRUMENTS[key] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"not {cls.kind}")
        elif kw:
            # a histogram() call asking for different buckets than the
            # registered instance must fail loudly — silently returning
            # the old layout would mis-bucket every observation
            drift = {k: (v, getattr(inst, k)) for k, v in kw.items()
                     if getattr(inst, k, v) != v}
            if drift:
                raise ValueError(
                    f"metric {name!r} already registered with different "
                    f"config: {drift} (requested, registered)")
        return inst


def counter(name: str, labels: Optional[Dict[str, str]] = None) -> Counter:
    return _instrument(Counter, name, labels)


def gauge(name: str, labels: Optional[Dict[str, str]] = None) -> Gauge:
    return _instrument(Gauge, name, labels)


def histogram(name: str, labels: Optional[Dict[str, str]] = None,
              **kw) -> Histogram:
    return _instrument(Histogram, name, labels, **kw)


def _append(name: str, value) -> None:
    with _LOCK:
        _REGISTRY[name].append(float(value))


def record(name: str, value) -> None:
    """Append a scalar to the raw series ``name`` (a 0-d tensor is read
    on the host, which waits for the device)."""
    _append(name, float(value))
