"""Failure detection of the rank world (the port's copy of the detector
half of ``repro.distributed.faults``).

  * HeartbeatMonitor — missed-heartbeat failure detector on a MONOTONIC
    clock (wall-clock jumps cannot mass-declare ranks dead); ranks ping
    from step boundaries AND from inside blocked calls (api._on_idle), so
    "parked in Recv" is alive and "thread gone" is dead within timeout_s.
  * StragglerTracker — per-rank step-duration EWMA; ranks slower than
    ``factor`` x median are flagged.
  * RankKilled — the injected failure of tests and benchmarks.

The reference's ``FaultTolerantDriver``, its driver events and
``kill_rank_process`` kill rank processes, so they come with the process
world (ROADMAP item 6c-ii).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np


class HeartbeatMonitor:
    def __init__(self, n_ranks: int, timeout_s: float = 1.0):
        self.timeout = timeout_s
        self.last: Dict[int, float] = {
            r: time.monotonic() for r in range(n_ranks)}
        self._lock = threading.Lock()

    def ping(self, rank: int) -> None:
        with self._lock:
            self.last[rank] = time.monotonic()

    def remove(self, rank: int) -> None:
        """Forget a rank entirely (it was removed from the world): a
        replaced rank must stop being reported dead on every poll."""
        with self._lock:
            self.last.pop(rank, None)

    def reset(self, rank: int) -> None:
        """Re-arm a rank (a replacement joined under the same id)."""
        with self._lock:
            self.last[rank] = time.monotonic()

    def dead_ranks(self) -> List[int]:
        now = time.monotonic()
        with self._lock:
            return [r for r, t in self.last.items()
                    if now - t > self.timeout]


class StragglerTracker:
    """Per-rank step-duration EWMA with an optional COMPUTE split.

    Wall-clock durations alone go blind under per-step collectives: every
    rank's step collapses to the slowest rank's (everyone waits in the
    allreduce), so ``dur`` is near-uniform and the median test flags
    nobody.  When the runtime also records the step's compute time (wall
    minus µs blocked on the transport — api.MPI's wait telemetry,
    DESIGN.md §12), detection runs on ``comp`` instead: the straggler is
    the one rank COMPUTING slowly while its peers sit waiting for it.
    Wall-only callers (and old snapshots) keep the original behavior."""

    def __init__(self, n_ranks: int, factor: float = 3.0, ema: float = 0.5):
        self.factor = factor
        self.ema = ema
        self.dur: Dict[int, float] = {}
        self.comp: Dict[int, float] = {}
        self._lock = threading.Lock()

    def record(self, rank: int, seconds: float,
               compute: Optional[float] = None) -> None:
        with self._lock:
            prev = self.dur.get(rank)
            self.dur[rank] = seconds if prev is None else \
                self.ema * seconds + (1 - self.ema) * prev
            if compute is not None:
                prev = self.comp.get(rank)
                self.comp[rank] = compute if prev is None else \
                    self.ema * compute + (1 - self.ema) * prev

    def stragglers(self) -> List[int]:
        with self._lock:
            if len(self.comp) >= 2:
                # median floored so an almost-all-wait workload (median
                # compute ~0) doesn't flag every rank that computes at all
                med = max(float(np.median(list(self.comp.values()))), 1e-3)
                return [r for r, d in self.comp.items()
                        if d > self.factor * med]
            if len(self.dur) < 2:
                return []
            med = float(np.median(list(self.dur.values())))
            return [r for r, d in self.dur.items() if d > self.factor * med]

    def forget(self, rank: int) -> None:
        """Drop a rank's series (it left the world — recovery or
        migration); a stale EWMA must not skew the median for survivors."""
        with self._lock:
            self.dur.pop(rank, None)
            self.comp.pop(rank, None)

    def report(self) -> Dict[int, dict]:
        """Per-rank wall/compute/wait EWMAs (seconds) for operator surfaces
        (MPIJob.stats(), the driver's ``wait:`` events)."""
        with self._lock:
            out: Dict[int, dict] = {}
            for r, wall in self.dur.items():
                comp = self.comp.get(r)
                out[r] = {
                    "wall_s": wall,
                    "compute_s": comp,
                    "wait_s": (max(wall - comp, 0.0)
                               if comp is not None else None),
                }
            return out


class RankKilled(Exception):
    """Injected failure (tests/benchmarks)."""
