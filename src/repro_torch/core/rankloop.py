"""One step/FSM loop for every substrate (DESIGN.md §14 prerequisite).

Before the mid-collective recovery work, the thread world
(``runtime.MPIJob._rank_main``/``_do_checkpoint``) and the process world
(``procworld._child_main``/``_child_checkpoint``) each carried their own
copy of the rank lifecycle: the step loop with its checkpoint-trigger,
pre-copy-streaming and agreement gates, the finished-but-serving loop,
and the flush → drain → snapshot → resume/exit checkpoint dance.
Recovery adds a fourth concern — enlist in a recovery epoch from every
blocked position — and four copies of THAT would have ended auditability.

This module is the single copy.  ``run_rank`` + ``checkpoint_rank`` drive
an ``api.MPI`` plugin against a small substrate adapter (``RankHost``
below; one implementation lives beside each substrate).  The loop also
emits an FSM TRACE — one tuple per lifecycle event — which the
cross-substrate parity suite asserts on: for the same program, the thread
and the process world must produce IDENTICAL traces.

Recovery participation (DESIGN.md §14): a rank parked at a step boundary
or in the finished-but-serving loop enlists in an open recovery epoch
from here (``kind: boundary/finished``); a rank blocked inside a ledgered
collective enlists from the collective's own retry frame
(api.MPI.Allreduce); a rank busy computing enlists at whichever of those
two positions it reaches first.  Ranks blocked in plain point-to-point
calls never enlist — the epoch then times out and the driver falls back
to the classic bump → abort → reshaped-restart, which is always safe.
"""
from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

from repro_torch.core import recovery as _recovery
from repro_torch.core import trace as _trace
from repro_torch.core.coordinator import (PHASE_DRAIN, PHASE_EXIT, PHASE_JOIN,
                                    PHASE_PENDING, PHASE_RESUME, PHASE_RUN)


class RankHost:
    """Substrate adapter: everything the unified loop cannot do the same
    way on both substrates.  The thread world implements these against
    the in-process MPIJob; the process world against its SocketChannel /
    CoordClient pair.  ``step_fn`` is the application step function."""

    #: serve-loop idle sleep: the thread world can afford a tight poll,
    #: the process world paces itself at ~200 replied pings/s
    serve_sleep = 0.0005

    def __init__(self, step_fn):
        self.step_fn = step_fn
        self.mig_done = 0              # last pre-copy round streamed
        self.events: List[tuple] = []  # the FSM trace (parity suite)

    def trace(self, *event) -> None:
        self.events.append(tuple(event))
        # mirror every FSM trace tuple into the flight recorder as an
        # instant; host.events itself stays byte-identical across
        # substrates (the parity suite asserts on it)
        if _trace.ENABLED:
            _trace.instant(
                "rank." + str(event[0]), cat="rank",
                rank=getattr(self, "rank", None),
                args={"detail": list(event[1:])} if len(event) > 1 else None)

    def ckpt_trace_ctx(self, mpi):
        """(trace_id, span_id) of the coordinating checkpoint/recovery
        span, so this rank's checkpoint spans parent under it — the
        process world reads it off the piggybacked coord-state tuple."""
        return None

    # ---- hooks (substrate-specific) -------------------------------------
    def tick(self, mpi) -> None:
        """Top-of-loop liveness: heartbeat ping (thread world) or a
        refresh RPC when no recent frame carried one (process world)."""
        raise NotImplementedError

    def trigger_step(self, coord) -> Optional[int]:
        """Armed checkpoint_at step, or None."""
        raise NotImplementedError

    def fire_trigger(self, mpi) -> None:
        """First rank at the trigger step requests the checkpoint."""
        raise NotImplementedError

    def stream_round(self, mpi, state, step: int, round_no: int) -> None:
        """Ship one pre-copy migration round (DESIGN.md §13)."""
        raise NotImplementedError

    def record_step(self, mpi, wall: float, compute: float) -> None:
        """Step telemetry: straggler record + data-plane counters +
        step-boundary flush of buffered sends."""
        raise NotImplementedError

    def assert_empty(self, mpi) -> None:
        """The channel-empty-at-snapshot invariant (+ ring slots)."""
        raise NotImplementedError

    def drained_stat(self, mpi) -> None:
        """Account the drained-message count into coordinator stats."""
        raise NotImplementedError

    def save_image(self, mpi, state, step: int) -> bool:
        """Write this rank's image + report the manifest entry.  Returns
        True when this rank is a migration LEAVER (a hot-joined
        replacement takes the rank over after the snapshot ack)."""
        raise NotImplementedError

    def wait_phase_alive(self, mpi, *phases: str) -> str:
        """coord.wait_phase that keeps the heartbeat beating."""
        raise NotImplementedError

    def finish(self, mpi, state) -> None:
        """Report normal completion (results + mark_finished)."""
        raise NotImplementedError


def _maybe_recover(host: RankHost, mpi, kind: str) -> None:
    """Enlist in an open recovery epoch from a safe position (step
    boundary / finished-serving).  Loops because a cancelled epoch may be
    retried: ``await_fallback`` either raises JobAborted (the fallback
    landed) or returns when a NEW epoch opens — which we then join."""
    coord = mpi.coord
    while True:
        tok = coord.recovery_token
        if tok is None or tok == mpi._rec_done_token:
            return
        outcome, _ = _recovery.participate(mpi, {"kind": kind})
        host.trace("recover", kind, outcome)
        if outcome != "cancelled":
            return
        _recovery.await_fallback(mpi)


def run_rank(host: RankHost, mpi, state: Any, step: int,
             n_steps: int) -> Tuple[str, Any]:
    """The rank lifecycle, substrate-free.  Returns ``(status, state)``
    with status one of:

      "done"     — ran to n_steps and every peer is finished
      "exit"     — a checkpoint with resume=False ended the world
      "migrated" — migration final; a replacement owns this rank now
    """
    coord = mpi.coord
    rank = mpi.rank
    while step < n_steps:
        host.tick(mpi)
        coord.check_aborted()
        mpi.step_idx = step
        _maybe_recover(host, mpi, "boundary")
        trig = host.trigger_step(coord)
        if (trig is not None and step >= trig
                and coord.phase == PHASE_RUN
                and coord.recovery_token is None):
            host.fire_trigger(mpi)
        # pre-copy streaming (DESIGN.md §13): a new migration round
        # opened — ship this rank's dirty leaves at the step boundary and
        # keep computing (no drain, no pause)
        mig_round = coord.mig_round
        if (mig_round and host.mig_done < mig_round
                and coord.phase == PHASE_RUN):
            host.mig_done = mig_round
            host.stream_round(mpi, state, step, mig_round)
        if coord.phase in (PHASE_PENDING, PHASE_DRAIN):
            agreed = coord.propose_ckpt_step(rank, step)
            mpi._proposed_gen = coord.ckpt_round
            if agreed is not None and step >= agreed:
                res = checkpoint_rank(host, mpi, state, step)
                if res:
                    return (res, state)
                continue
            if agreed is None:
                # wait for agreement; serve nothing (at boundary)
                time.sleep(0.0002)
                continue
        w0 = mpi.wait_us_total()
        t_step = time.time()
        state = host.step_fn(mpi, state, step)
        wall = time.time() - t_step
        # compute/wait split: wall minus time blocked on the transport
        # this step — under per-step collectives the wall clocks collapse
        # to the slowest rank, the compute split does not (DESIGN.md §12)
        compute = max(wall - (mpi.wait_us_total() - w0) / 1e6, 0.0)
        host.record_step(mpi, wall, compute)
        host.trace("step", step)
        step += 1
    mpi.flush()      # surface deferred send errors; empty the channel
    host.finish(mpi, state)
    host.trace("finish", step)
    # keep serving the checkpoint FSM until every live rank is done — an
    # async checkpoint (or a recovery epoch) may land while peers run
    while not coord.all_finished():
        coord.check_aborted()
        host.tick(mpi)
        _maybe_recover(host, mpi, "finished")
        mig_round = coord.mig_round
        if (mig_round and host.mig_done < mig_round
                and coord.phase == PHASE_RUN):
            # a finished rank still streams its (now static) state —
            # rounds need every rank's entry to complete
            host.mig_done = mig_round
            host.stream_round(mpi, state, step, mig_round)
        if coord.phase in (PHASE_PENDING, PHASE_DRAIN):
            mpi.step_idx = step
            agreed = coord.propose_ckpt_step(rank, step)
            mpi._proposed_gen = coord.ckpt_round
            if agreed is not None and step >= agreed:
                res = checkpoint_rank(host, mpi, state, step)
                if res:
                    return (res, state)
                continue
        time.sleep(host.serve_sleep)
    return ("done", state)


def checkpoint_rank(host: RankHost, mpi, state: Any, step: int):
    """Flush → drain → snapshot → resume/exit (the paper's FSM, one copy
    for both substrates).  Returns a truthy status when this rank's
    execution should end: "exit" (checkpoint with resume=False) or
    "migrated" (migration final — a replacement takes the rank over).

    The whole dance runs inside a ``rank.ckpt`` span parented under the
    coordinator's round span (ctx piggybacked across the socket in the
    process world), so every nested span — the drain loop, the image
    save, the chunk-store RPCs under it — lands on the coordinating
    save's timeline."""
    ctx = host.ckpt_trace_ctx(mpi) if _trace.ENABLED else None
    with _trace.span("rank.ckpt", parent=ctx, cat="rank", rank=mpi.rank,
                     generation=mpi.generation, args={"step": step}):
        return _checkpoint_rank(host, mpi, state, step)


def _checkpoint_rank(host: RankHost, mpi, state: Any, step: int):
    coord = mpi.coord
    # flush in-flight batches FIRST: every fire-and-forget send this rank
    # issued is on the transport and its exact counters are at the
    # coordinator before the rank acks drained (DESIGN.md §5)
    mpi.flush()
    with _trace.span("rank.drain", cat="rank", rank=mpi.rank):
        while coord.phase == PHASE_DRAIN:
            coord.check_aborted()
            host.tick(mpi)           # draining is alive, not dead
            pumped = mpi._pump_all()
            coord.ack_drained(mpi.rank, generation=mpi.generation)
            coord.drain_complete()
            if not pumped:
                time.sleep(0.0002)
    # the channel-empty-at-snapshot invariant: nothing buffered in the
    # plugin, nothing queued to or from the proxy (+ ring slots free)
    host.assert_empty(mpi)
    coord.note_empty_channel(mpi.rank)
    # messages that crossed the checkpoint boundary (restored from cache)
    host.drained_stat(mpi)
    with _trace.span("rank.save_image", cat="rank", rank=mpi.rank,
                     args={"step": step}):
        leaver = host.save_image(mpi, state, step)
    host.trace("ckpt", step)
    # leaver decision is made INSIDE save_image, BEFORE this ack:
    # join_expected/migrating are stable until the join barrier completes,
    # which cannot happen before this rank acks — reading them after the
    # ack races the replacement's hot_join clearing them
    coord.ack_snapshot(mpi.rank, generation=mpi.generation)
    if leaver:
        host.trace("migrated", step)
        return "migrated"
    phase = host.wait_phase_alive(mpi, PHASE_RESUME, PHASE_EXIT, PHASE_JOIN)
    if phase == PHASE_JOIN:          # survivor parked at the join barrier
        host.trace("join", step)
        phase = host.wait_phase_alive(mpi, PHASE_RESUME, PHASE_EXIT)
    if phase == PHASE_EXIT:
        host.trace("exit", step)
        return "exit"
    coord.resume_running(mpi.rank)
    host.wait_phase_alive(mpi, PHASE_RUN, PHASE_PENDING, PHASE_DRAIN)
    host.trace("resume", step)
    return False
