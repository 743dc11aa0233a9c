"""Data-plane retention: the contribution ledger (DESIGN.md §14).

``ContributionLedger`` is the bounded per-job pin of every in-flight
collective's per-rank input that makes MANA-style mid-collective
recovery possible — it lives here because it is a data-plane concern
(bounded payload retention), not a control-flow one.

The reference's module also holds the shared-memory tensor ring
(``ShmRing``, ``RingRef``) of its process world; the port brings those
with that world (ROADMAP item 6c-ii).

Knob (environment — definition shared via core/tunables.py):

  REPRO_LEDGER_OPS         contribution-ledger op capacity
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.tunables import LEDGER_MAX_OPS


# --------------------------------------------------------------------------
# Contribution ledger: pinned collective inputs for mid-collective recovery
# --------------------------------------------------------------------------

class LedgerOp:
    """One in-flight collective: each member rank's input (a private copy)
    plus the op descriptor the first contributor registered.  ``committed``
    is the set of WORLD ranks that finished the op — once every live
    member has committed, the pinned bytes are released."""

    __slots__ = ("key", "meta", "contribs", "committed", "stamp")

    def __init__(self, key: Tuple[int, int], meta: dict, stamp: int):
        self.key = key
        self.meta = meta                       # algo/op/ranks/tags/shape...
        self.contribs: Dict[int, Any] = {}     # world rank -> input copy
        self.committed: set = set()
        self.stamp = stamp                     # insertion order, for LRU

    def nbytes(self) -> int:
        total = 0
        for v in self.contribs.values():
            total += v.nbytes if isinstance(v, np.ndarray) else 64
        return total


class ContributionLedger:
    """Bounded pin of every in-flight collective's per-rank send buffer
    (DESIGN.md §14).  Ranks ``contribute`` their input at collective entry
    (BEFORE any wire traffic) and ``commit`` on completion; the recovery
    engine reads a dead rank's retained contribution back out to finish
    the operation over the survivors with zero recomputation.

    Keyed by ``(comm_vid, entry_seq)`` — the per-comm monotone collective
    sequence number at entry, identical on every member of a BSP step, so
    all ranks' contributions to one logical op land in one entry without
    any extra agreement round.

    Bounded two ways: fully-committed ops are dropped eagerly, and when
    more than ``max_ops`` distinct ops are pinned the OLDEST is evicted
    (recovery for it would then miss → rollback fallback — safe, just
    slower).  Thread-safe: in the thread world every rank thread writes
    directly; in the process world the parent's endpoint threads write on
    behalf of their children."""

    def __init__(self, n_ranks: int, max_ops: int = LEDGER_MAX_OPS):
        self.n = n_ranks
        self.max_ops = max(1, int(max_ops))
        self._ops: Dict[Tuple[int, int], LedgerOp] = {}
        self._lock = threading.Lock()
        self._stamp = 0
        self.stats = {"contributions": 0, "commits": 0, "evicted_ops": 0,
                      "released_ops": 0, "peak_bytes": 0, "hits": 0,
                      "misses": 0}

    def _pinned_bytes_locked(self) -> int:
        return sum(op.nbytes() for op in self._ops.values())

    # ------------------------------------------------------------- data path
    def contribute(self, key: Tuple[int, int], rank: int, value: Any,
                   meta: Optional[dict] = None) -> None:
        """Pin ``rank``'s input for op ``key`` (copied — the caller's array
        is about to be mutated by the reduce)."""
        if isinstance(value, np.ndarray):
            value = np.array(value, copy=True)
        with self._lock:
            op = self._ops.get(key)
            if op is None:
                self._stamp += 1
                op = self._ops[key] = LedgerOp(key, dict(meta or {}),
                                               self._stamp)
            elif meta and not op.meta:
                op.meta = dict(meta)
            op.contribs[rank] = value
            op.committed.discard(rank)         # re-run after a rewind
            self.stats["contributions"] += 1
            if len(self._ops) > self.max_ops:
                oldest = min(self._ops.values(), key=lambda o: o.stamp)
                del self._ops[oldest.key]
                self.stats["evicted_ops"] += 1
            self.stats["peak_bytes"] = max(self.stats["peak_bytes"],
                                           self._pinned_bytes_locked())

    def commit(self, key: Tuple[int, int], rank: int,
               live_ranks: Optional[set] = None) -> None:
        """Mark ``rank`` done with op ``key``; release the op once every
        member (intersected with ``live_ranks`` when given) committed."""
        with self._lock:
            op = self._ops.get(key)
            if op is None:
                return
            op.committed.add(rank)
            self.stats["commits"] += 1
            members = set(op.meta.get("ranks") or op.contribs)
            if live_ranks is not None:
                members &= set(live_ranks)
            if members and members <= op.committed:
                del self._ops[key]
                self.stats["released_ops"] += 1

    # ------------------------------------------------------------- recovery
    def get(self, key: Tuple[int, int]) -> Optional[LedgerOp]:
        with self._lock:
            op = self._ops.get(key)
            self.stats["hits" if op is not None else "misses"] += 1
            return op

    def drop(self, key: Tuple[int, int]) -> None:
        """Release one op unconditionally (recovery consumed it, or its
        dead contributor means it can never fully commit)."""
        with self._lock:
            if self._ops.pop(tuple(key), None) is not None:
                self.stats["released_ops"] += 1

    def uncommitted_ops_of(self, rank: int) -> list:
        """Keys of pinned ops ``rank`` contributed to but never committed —
        the instant-eligibility probe for recovery (empty ⇒ the dead rank
        was between collectives and rollback is the only option)."""
        with self._lock:
            return [op.key for op in self._ops.values()
                    if rank in op.contribs and rank not in op.committed]

    def pinned_bytes(self) -> int:
        with self._lock:
            return self._pinned_bytes_locked()

    def snapshot_stats(self) -> dict:
        with self._lock:
            return dict(self.stats, pinned_ops=len(self._ops),
                        pinned_bytes=self._pinned_bytes_locked())
