"""Metrics registry: counters / gauges / histograms with bounded label
sets (DESIGN.md §16).

Before this module every layer kept its own ad-hoc dict of counters —
``Coordinator.stats``, ``CheckpointManager.stats``, per-channel dicts —
and ``MPIJob.stats()`` merged them by iterating live dicts while rank
threads mutated them (a torn read at best, ``RuntimeError: dictionary
changed size during iteration`` at worst once a new key landed
mid-iteration).  The registry keeps the exact same shape callers rely
on — ``stats["checkpoints"] += 1``, ``dict(coord.stats)`` — but every
group carries its own lock and ``snapshot()`` hands back one consistent
plain dict.

Three primitives:

  * ``MetricGroup``  — a named, locked mapping of scalar counters and
    gauges.  This is the drop-in replacement for the old stats dicts:
    it implements the Mapping protocol plus item assignment and
    ``add``, so existing ``stats[k] += n`` call sites keep working
    unchanged, including the serialization helpers that receive a
    group through the ``stats=`` parameter.
  * ``LabeledCounter`` — a counter family keyed by one label with a
    bounded series count; overflow collapses into ``"__overflow__"``
    instead of growing without limit.
  * ``Histogram``   — fixed exponential buckets
    (``REPRO_METRICS_HIST_BUCKETS`` of them), count/sum/min/max.

Every primitive self-registers (weakly) into the process-wide
``REGISTRY``; ``REGISTRY.snapshot()`` is the debugging view over
everything alive in the process.  Job-facing APIs (``MPIJob.stats()``,
``CheckpointManager.stats``) stay compatible snapshot views on top.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

from repro_torch.core import tunables

OVERFLOW_LABEL = "__overflow__"


class MetricGroup(Mapping):
    """A named group of scalar metrics behind one lock.

    Drop-in for the old ad-hoc stats dicts: supports ``g[k]``,
    ``g[k] = v``, ``g[k] += n`` (get+set under the caller's statement,
    each side atomic), ``g.get(k, d)``, ``dict(g)`` and ``g.add(k, n)``
    for a single-lock read-modify-write.  ``snapshot()`` returns a plain
    dict taken under the lock — the one-consistent-view primitive
    ``MPIJob.stats()`` builds on.
    """

    # Mapping defines __eq__ (value equality), which clears __hash__;
    # restore identity hashing so groups can live in the weak REGISTRY
    __hash__ = object.__hash__

    def __init__(self, name: str, initial: Optional[Mapping] = None):
        self.name = name
        self._lock = threading.RLock()
        self._vals: Dict[str, float] = dict(initial or {})
        REGISTRY.register(self)

    # -- mapping protocol (reads) --
    def __getitem__(self, key: str):
        with self._lock:
            return self._vals[key]

    def get(self, key: str, default=None):
        with self._lock:
            return self._vals.get(key, default)

    def __iter__(self) -> Iterator[str]:
        return iter(self.snapshot())

    def __len__(self) -> int:
        with self._lock:
            return len(self._vals)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._vals

    def keys(self):
        return self.snapshot().keys()

    def items(self):
        return self.snapshot().items()

    def values(self):
        return self.snapshot().values()

    # -- writes --
    def __setitem__(self, key: str, value) -> None:
        with self._lock:
            self._vals[key] = value

    def add(self, key: str, n=1):
        """Atomic read-modify-write; returns the new value."""
        with self._lock:
            v = self._vals.get(key, 0) + n
            self._vals[key] = v
            return v

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._vals)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"MetricGroup({self.name!r}, {self.snapshot()!r})"


class LabeledCounter:
    """Counter family with ONE label dimension and a bounded series set.

    The first ``max_series`` distinct labels each get their own counter;
    anything beyond collapses into ``OVERFLOW_LABEL`` so a caller
    feeding unbounded strings (rank lists, exception reprs) cannot grow
    the registry without limit.
    """

    def __init__(self, name: str, max_series: int = 64):
        self.name = name
        self.max_series = max_series
        self._lock = threading.Lock()
        self._series: Dict[str, int] = {}
        REGISTRY.register(self)

    def inc(self, label: str, n: int = 1) -> None:
        with self._lock:
            key = str(label)
            if key not in self._series and len(self._series) >= self.max_series:
                key = OVERFLOW_LABEL
            self._series[key] = self._series.get(key, 0) + n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._series)


def default_buckets(n: Optional[int] = None,
                    base: float = 1e-5) -> Tuple[float, ...]:
    """``n`` exponential bucket upper bounds starting at ``base``
    seconds (10us), quadrupling: 10us, 40us, 160us, ... — wide enough to
    cover a proxy batch and a multi-second checkpoint write in one
    histogram."""
    n = tunables.METRICS_HIST_BUCKETS if n is None else n
    return tuple(base * (4 ** i) for i in range(max(1, n)))


class Histogram:
    """Fixed-bucket histogram (count / sum / min / max + bucket counts).

    Buckets are upper bounds; observations above the last bound land in
    the implicit +inf bucket.  The bucket COUNT is bounded by
    ``REPRO_METRICS_HIST_BUCKETS`` so snapshots stay small.
    """

    def __init__(self, name: str, buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.buckets = tuple(buckets) if buckets else default_buckets()
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)
        self._n = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        REGISTRY.register(self)

    def observe(self, value: float) -> None:
        with self._lock:
            i = 0
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    break
            else:
                i = len(self.buckets)
            self._counts[i] += 1
            self._n += 1
            self._sum += value
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value

    def snapshot(self) -> dict:
        with self._lock:
            return {"count": self._n, "sum": self._sum,
                    "min": self._min, "max": self._max,
                    "buckets": list(self.buckets),
                    "counts": list(self._counts)}


class Registry:
    """Weak set of every live metric object in the process.  Weak so a
    stopped job's groups disappear with the job instead of accumulating
    across a long test session."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objs: "weakref.WeakSet" = weakref.WeakSet()

    def register(self, obj) -> None:
        with self._lock:
            self._objs.add(obj)

    def snapshot(self) -> List[dict]:
        with self._lock:
            objs = list(self._objs)
        out = []
        for o in objs:
            out.append({"name": o.name, "type": type(o).__name__,
                        "values": o.snapshot()})
        return out


REGISTRY = Registry()


def group(name: str, initial: Optional[Mapping] = None) -> MetricGroup:
    return MetricGroup(name, initial)


def labeled_counter(name: str, max_series: int = 64) -> LabeledCounter:
    return LabeledCounter(name, max_series)


def histogram(name: str,
              buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
    return Histogram(name, buckets)
