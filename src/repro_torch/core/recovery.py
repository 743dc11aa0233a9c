"""Survivor-only mid-collective recovery (DESIGN.md §14).

When a rank dies INSIDE a collective, the survivors hold everything
needed to finish the step without rolling anybody back: the
ContributionLedger (core/dataplane.py) pinned every member's input to the
in-flight operation — including the dead rank's — and the per-comm
collective sequence numbers identify exactly which logical operation each
rank is stuck in.  This module holds the pure half of the machinery:

  * ``replay_ring`` / ``replay_tree`` — finish an interrupted allreduce
    from the ledgered inputs, applying the EXACT float association the
    wire dance would have produced (right-fold around the ring per chunk;
    level-synchronous binomial combine for the tree), so the recovered
    result is bit-identical to the unfaulted control.  Conceptually this
    is the ring rebuilt over the live ranks: the reduce is replayed once
    from the retained send buffers and the allgather degenerates into the
    coordinator's delivery fan-out to the survivors.
  * ``op_descriptor`` — the (comm, entry-seq) identity of a collective
    plus the wire tags its envelopes carry, so survivors can purge the
    half-finished dance from their caches.
  * ``participate`` — the rank-side driver of the coordinator's recovery
    sub-FSM (collect → quiesce → patch → resume), one copy shared by the
    thread and process substrates.

The coordinator side (eligibility, phase transitions, result fan-out)
lives in ``Coordinator.begin_recovery``/``recovery_poll``; the job side
(dead-inbox drain, parent bookkeeping) in ``MPIJob.recover``.  The
fallback ladder — ledger miss, multi-failure, timeout → classic
bump→abort→reshaped-restart — is policy in ``FaultTolerantDriver``."""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.messages import COLL_TAG_BASE

#: reduction functions, shared with core/api.py (kept here so the pure
#: replay half has no import cycle with the MPI stub)
REDUCE_OPS: Dict[str, Callable] = {
    "sum": lambda a, b: a + b,
    "max": np.maximum,
    "min": np.minimum,
    "prod": lambda a, b: a * b,
}


class RecoveryUnavailable(RuntimeError):
    """Recovery cannot even be attempted (wrong phase, ledger disabled or
    empty for the dead rank, multi-failure) — fall back immediately."""


class RecoveryFailed(RuntimeError):
    """An attempted recovery did not complete (timeout, partial ledger,
    unsupported in-flight op) — the world must fall back to restart."""


class CollectiveInterrupted(Exception):
    """Raised out of a blocked collective when the coordinator opens a
    recovery epoch; caught by the collective's entry frame, never by
    user code."""

    def __init__(self, token: int):
        super().__init__(f"recovery epoch {token}")
        self.token = token


# --------------------------------------------------------------------------
# op identity
# --------------------------------------------------------------------------

def _ctag_value(seq: int, op_code: int) -> int:
    return COLL_TAG_BASE + (seq << 4) + op_code


def op_descriptor(comm: int, seq0: int, algo: str, op: str,
                  ranks: Tuple[int, ...]) -> dict:
    """Identity + wire footprint of one logical allreduce entered at
    per-comm sequence ``seq0``.  ``tags`` lists every collective tag the
    dance uses (ring: reduce-scatter then allgather; tree: Reduce then
    Bcast) so survivors can purge stranded envelopes exactly."""
    if algo == "ring":
        tags = (_ctag_value(seq0, 6), _ctag_value(seq0 + 1, 7))
    else:
        tags = (_ctag_value(seq0, 5), _ctag_value(seq0 + 1, 1))
    return {"kind": "op", "key": (int(comm), int(seq0)), "algo": algo,
            "op": op, "comm": int(comm), "ranks": tuple(ranks),
            "tags": tags}


# --------------------------------------------------------------------------
# bit-exact replay
# --------------------------------------------------------------------------

def replay_ring(contribs: List[np.ndarray], op: str) -> np.ndarray:
    """Finish a ring allreduce from the members' inputs (comm-rank order),
    reproducing the wire association exactly.  In ``_ring_allreduce`` the
    complete chunk ``c`` ends at comm rank ``(c-1) % n`` having been built
    as a right-fold around the ring starting from rank ``c``'s own chunk:

        acc = x_c[c]
        for k in 1..n-1:  acc = fn(x_{(c+k)%n}[c], acc)

    (each hop computes ``chunks[recv_idx] = fn(own, incoming)``), and the
    allgather phase moves complete chunks verbatim — so concatenating the
    folds IS the wire result, bit for bit."""
    fn = REDUCE_OPS[op]
    n = len(contribs)
    ref = contribs[0]
    chunks_of = [np.array_split(np.asarray(c).reshape(-1), n)
                 for c in contribs]
    out = []
    for c in range(n):
        acc = chunks_of[c][c]
        for k in range(1, n):
            acc = fn(chunks_of[(c + k) % n][c], acc)
        out.append(acc)
    return np.concatenate(out).reshape(np.asarray(ref).shape)


def replay_tree(contribs: List[Any], op: str) -> Any:
    """Finish a tree allreduce (binomial Reduce to comm rank 0, result
    broadcast verbatim) from the members' inputs (comm-rank order).  The
    wire Reduce merges level-synchronously with doubling spans — member
    ``m`` absorbs ``m+k`` at level ``k`` iff ``m % 2k == 0`` and
    ``m+k < n``, each partner frozen since its own level ``k/2`` — and
    every merge is ``acc = fn(acc, other)``; the simulation below applies
    the identical calls in the identical order."""
    fn = REDUCE_OPS[op]
    n = len(contribs)
    acc = list(contribs)
    k = 1
    while k < n:
        for m in range(0, n, 2 * k):
            if m + k < n:
                acc[m] = fn(acc[m], acc[m + k])
        k *= 2
    return acc[0]


def replay_op(desc: dict, contribs_by_world: Dict[int, Any]) -> Any:
    """Replay one ledgered op from per-WORLD-rank contributions; raises
    KeyError if any member's input is missing (caller turns that into a
    ledger-miss fallback)."""
    ordered = [contribs_by_world[r] for r in desc["ranks"]]
    if desc["algo"] == "ring":
        return replay_ring(ordered, desc["op"])
    return replay_tree(ordered, desc["op"])


# --------------------------------------------------------------------------
# rank-side participation (one copy for both substrates)
# --------------------------------------------------------------------------

def participate(mpi, desc: Optional[dict]) -> Tuple[str, Any]:
    """Drive this rank through the active recovery epoch.  ``desc`` is the
    op descriptor when called from inside an interrupted collective, or a
    ``{"kind": "boundary"|"finished"}`` marker when called from the rank
    loop.  Blocks until the coordinator resolves the epoch and returns
    one of:

      ("deliver", value)  — the stuck op was finished centrally from the
                            ledger; return ``value`` from the collective
      ("rerun", None)     — this rank's attempt never completed and the
                            dead rank never entered it: rewind the
                            sequence numbers and re-run over the shrunk
                            communicator
      ("none", None)      — nothing to do (boundary/finished rank)
      ("cancelled", None) — the epoch was cancelled; the world is falling
                            back to abort → restart
    """
    coord = mpi.coord
    token = coord.recovery_token
    if token is None:
        return ("cancelled", None)
    # push buffered sends NOW so the quiesce phase sees every envelope
    # this rank will ever emit for the interrupted step
    mpi.channel.flush_async()
    info: Optional[dict] = dict(desc) if desc else {"kind": "boundary"}
    patched = False
    while True:
        coord.check_aborted()
        if mpi._on_idle is not None:
            mpi._on_idle()
        rep = coord.recovery_poll(mpi.rank, info, generation=mpi.generation,
                                  token=token)
        info = None
        phase = rep.get("phase")
        if phase == "collect":
            time.sleep(0.001)
        elif phase == "quiesce":
            pumped = mpi._pump_all()
            info = {"quiet": pumped == 0}
            if pumped == 0:
                time.sleep(0.001)
        elif phase == "patch":
            if not patched:
                mpi._apply_recovery_patch(rep["dead"], rep["purge"])
                patched = True
                info = {"patched": True}
            else:
                time.sleep(0.001)
        elif phase == "resume":
            mpi._rec_done_token = token
            action = rep.get("action", "none")
            if action == "deliver":
                return ("deliver", rep.get("result"))
            return (action, None)
        else:                              # cancelled / idle
            mpi._rec_done_token = token
            return ("cancelled", None)


def await_fallback(mpi, timeout: float = 120.0) -> None:
    """After a cancelled recovery the in-memory world may be part-patched;
    the only safe continuation is the driver's abort → restart.  Park
    here (heartbeat alive) until the abort lands — or join a NEW recovery
    epoch if the driver retries instead."""
    deadline = time.time() + timeout
    while True:
        mpi.coord.check_aborted()          # raises JobAborted: the exit
        if mpi._on_idle is not None:
            mpi._on_idle()
        token = mpi.coord.recovery_token
        if token is not None and token != mpi._rec_done_token:
            return                         # new epoch: caller re-enters
        if time.time() > deadline:
            raise TimeoutError("cancelled recovery was never followed by "
                               "abort, retry, or restart")
        time.sleep(0.005)
