"""Metrics group (copy of ``repro.core.metrics.MetricGroup`` and the
registry it registers with).

A ``MetricGroup`` is a named, locked mapping of scalar counters and
gauges: ``stats["saves"] += 1``, ``stats.get(k, 0.0)``, ``dict(stats)``
work as on a dict, every mutation is atomic under the group lock and
``snapshot()`` is one consistent plain dict.  Each group registers
(weakly) into the process-wide ``REGISTRY``.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, Iterator, List, Mapping, Optional


class MetricGroup(Mapping):
    """A named group of scalar metrics behind one lock.

    Supports ``g[k]``, ``g[k] = v``, ``g[k] += n`` (get+set under the
    caller's statement, each side atomic), ``g.get(k, d)``, ``dict(g)``
    and ``g.add(k, n)`` for a single-lock read-modify-write.
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


class Registry:
    """Weak set of every live metric group in the process.  Weak so a
    dropped manager's group disappears with it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objs: "weakref.WeakSet" = weakref.WeakSet()

    def register(self, obj) -> None:
        with self._lock:
            self._objs.add(obj)

    def snapshot(self) -> List[dict]:
        with self._lock:
            objs = list(self._objs)
        return [{"name": o.name, "type": type(o).__name__,
                 "values": o.snapshot()} for o in objs]


REGISTRY = Registry()
