"""Zero-copy data plane: the shared-memory tensor ring (DESIGN.md §12).

The paper's proxy argument is that interposition can be cheap enough to
leave on always.  The batched wire protocol makes that true of the
CONTROL plane; this module closes the gap for the DATA plane of same-host
process worlds: tensor payloads at least ``RING_PAYLOAD_MIN`` bytes land
in a ``multiprocessing.shared_memory`` segment shared by the launcher and
every forked rank child, and the socket frames carry only a DESCRIPTOR
(``RingRef``: slot, length, generation stamp, dtype, shape) — the payload
bytes cross the address-space boundary zero-copy instead of being
pickled, framed, sent, reassembled and unpickled.

Design constraints, in order:

  * CORRECTNESS FIRST — the ring is an optimization with a mandatory
    inline fallback: ``try_put`` returns None when the ring is full, the
    payload is too large, or the segment could not be created (no
    /dev/shm), and the sender ships the tensor inline exactly as before.
    Results are bit-identical either way (asserted by the fabric parity
    tests and the committed bench contract).
  * CHECKPOINT SAFETY — descriptors are resolved (copied out + slot
    freed) by the receiving child's channel BEFORE anything reaches the
    MessageCache, so a checkpoint can never capture a dangling RingRef.
    The drain invariant does the rest: at snapshot time Σsent==Σreceived
    means every descriptor was delivered and resolved, hence
    ``in_flight() == 0`` — asserted next to channel-empty-at-snapshot.
  * SIMPLICITY — fixed-size slots and a linear scan under one
    fork-inherited lock.  Slot counts are tiny (default 16); payload
    copies in and out dominate by orders of magnitude.

This module also hosts the ``ContributionLedger`` (DESIGN.md §14): the
bounded per-job pin of every in-flight collective's per-rank input that
makes MANA-style mid-collective recovery possible — it lives here because
it is a data-plane concern (bounded payload retention), not a control-flow
one.

Knobs (environment — definitions shared via core/tunables.py):

  REPRO_SHMRING_MIN_BYTES  inline/ring crossover (default 256 KiB;
                           REPRO_RING_MIN_BYTES kept as an alias)
  REPRO_RING_SLOTS         slot count (default 16)
  REPRO_RING_SLOT_BYTES    per-slot capacity (default 8 MiB)
  REPRO_LEDGER[_OPS]       contribution-ledger enable / op capacity
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from multiprocessing import Lock
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.tunables import LEDGER_MAX_OPS, SHMRING_MIN_BYTES

try:
    from multiprocessing import shared_memory
except ImportError:                                    # pragma: no cover
    shared_memory = None  # type: ignore[assignment]

#: payloads at least this large ride the ring; smaller ones ship inline
#: (descriptor + bookkeeping would cost more than the memcpy they save)
RING_PAYLOAD_MIN = SHMRING_MIN_BYTES

DEFAULT_SLOTS = int(os.environ.get("REPRO_RING_SLOTS", 16))
DEFAULT_SLOT_BYTES = int(os.environ.get("REPRO_RING_SLOT_BYTES", 1 << 23))


@dataclass(frozen=True)
class RingRef:
    """Wire descriptor for a payload parked in the ring.  This is what the
    frame carries instead of the tensor; it must stay tiny and picklable.
    ``seq`` is the slot's generation stamp at put time, verified at read
    time: a descriptor resolved after its slot was reclaimed (or reused
    by a later put) fails loudly instead of delivering another payload's
    bytes.  An O(1) check on purpose — a full-payload checksum would cost
    more than the memcpy the ring exists to avoid (same-host shared
    memory has the same integrity as the sockets it replaces)."""
    slot: int
    length: int
    seq: int
    dtype: str
    shape: Tuple[int, ...]


def _shm_free_bytes() -> Optional[int]:
    """Available bytes on /dev/shm, or None when unknowable (non-Linux
    posix shm still works; we just can't budget against it)."""
    try:
        st = os.statvfs("/dev/shm")
        return st.f_bavail * st.f_frsize
    except (OSError, AttributeError):
        return None


def shm_available() -> bool:
    """Can this host create a shared-memory segment at all?  (CI's
    shm-ring leg probes this to skip gracefully.)"""
    if shared_memory is None:
        return False
    try:
        probe = shared_memory.SharedMemory(create=True, size=4096)
    except (OSError, ValueError):
        return False
    probe.close()
    try:
        probe.unlink()
    except (OSError, FileNotFoundError):
        pass
    return True


class ShmRing:
    """Fixed-slot shared-memory ring, created by the launcher BEFORE the
    rank children fork (the segment, the slot-state bytes inside it, and
    the allocation lock are all inherited by address space — children
    never attach by name, so a child crash can't orphan an attachment).

    Segment layout: ``slots`` state bytes (0 free / 1 in use), then
    ``slots`` little-endian u32 generation stamps (bumped on every claim
    of that slot), then ``slots`` data slots of ``slot_bytes`` each.
    Writers claim a free slot under the lock, memcpy the tensor in, and
    ship a RingRef; readers verify state + generation, memcpy out into a
    fresh writable array, and free the slot.  Readers free out of order —
    which is why slots are independent rather than a circular bump
    allocator."""

    def __init__(self, shm, slots: int, slot_bytes: int, lock):
        self.shm = shm
        self.slots = slots
        self.slot_bytes = slot_bytes
        self.lock = lock
        self.name = shm.name
        self._seq_off = slots            # u32 stamps follow the state bytes
        self._data_off = slots + 4 * slots

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def create(cls, slots: int = DEFAULT_SLOTS,
               slot_bytes: int = DEFAULT_SLOT_BYTES) -> Optional["ShmRing"]:
        """Build a ring, shrinking to fit the host's shared-memory budget;
        None when no usable segment can be created (the fabric then runs
        ringless — slower, never wrong)."""
        if shared_memory is None:
            return None
        budget = _shm_free_bytes()
        while True:
            want = 5 * slots + slots * slot_bytes
            # keep a 2x headroom: tmpfs enforces capacity at page-fault
            # time (SIGBUS), not at ftruncate — never create a segment
            # the mount can't actually back
            if budget is None or want * 2 <= budget:
                try:
                    shm = shared_memory.SharedMemory(create=True, size=want)
                    break
                except (OSError, ValueError):
                    pass
            if slots > 4:
                slots //= 2
            elif slot_bytes > (1 << 20):
                slot_bytes //= 2
            else:
                return None
        shm.buf[:5 * slots] = bytes(5 * slots)  # all free, stamps at 0
        return cls(shm, slots, slot_bytes, Lock())

    def destroy(self) -> None:
        """Close + unlink (launcher side, after every child has exited)."""
        try:
            self.shm.close()
        except (BufferError, OSError):
            pass
        try:
            self.shm.unlink()
        except (OSError, FileNotFoundError):
            pass

    # ------------------------------------------------------------ data path
    def try_put(self, arr: np.ndarray) -> Optional[RingRef]:
        """Park a tensor in a free slot; None when it doesn't fit (caller
        ships inline).  The copy into shared memory happens OUTSIDE the
        lock — the slot is already claimed, only the scan is serialized."""
        src = memoryview(np.ascontiguousarray(arr)).cast("B")
        n = src.nbytes
        if n == 0 or n > self.slot_bytes:
            return None
        buf = self.shm.buf
        slot = None
        with self.lock:
            for i in range(self.slots):
                if buf[i] == 0:
                    buf[i] = 1
                    so = self._seq_off + 4 * i
                    seq = (int.from_bytes(buf[so:so + 4], "little")
                           + 1) & 0xFFFFFFFF
                    buf[so:so + 4] = seq.to_bytes(4, "little")
                    slot = i
                    break
        if slot is None:
            return None
        off = self._data_off + slot * self.slot_bytes
        # the copy is ordered before the descriptor by the socket send
        # that ships the RingRef — the reader can never observe a
        # half-written slot
        buf[off:off + n] = src
        return RingRef(slot=slot, length=n, seq=seq,
                       dtype=str(arr.dtype), shape=tuple(arr.shape))

    def read(self, ref: RingRef) -> np.ndarray:
        """Resolve a descriptor: verify the slot still holds THIS put's
        payload (state in-use, generation stamps match), copy out into a
        fresh WRITABLE array, free the slot.  Exactly-once per ref — the
        channel resolves each envelope as it is delivered."""
        buf = self.shm.buf
        so = self._seq_off + 4 * ref.slot
        with self.lock:
            live = buf[ref.slot] == 1
            seq = int.from_bytes(buf[so:so + 4], "little")
        if not live or seq != ref.seq:
            raise RuntimeError(
                f"ring slot {ref.slot} generation mismatch (descriptor "
                f"seq {ref.seq}, slot seq {seq}, "
                f"{'in use' if live else 'reclaimed'}): descriptor "
                f"resolved after reclamation?")
        off = self._data_off + ref.slot * self.slot_bytes
        out = np.empty(ref.shape, dtype=np.dtype(ref.dtype))
        memoryview(out).cast("B")[:] = buf[off:off + ref.length]
        with self.lock:
            buf[ref.slot] = 0
        return out

    def in_flight(self) -> int:
        """How many slots hold an unresolved payload — 0 at every snapshot
        (the ring half of channel-empty-at-snapshot)."""
        buf = self.shm.buf
        return sum(1 for i in range(self.slots) if buf[i] != 0)


# thread-safety note: try_put/read are called from different PROCESSES
# (sender child / receiver child); the multiprocessing.Lock covers the
# slot-state scan.  Within one process the channel is single-threaded
# (one plugin thread), so no extra threading.Lock is needed — kept as a
# module-level assert hook for tests that want to pin that assumption.
_SINGLE_THREAD_CHANNEL = threading.local()


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
