"""DMTCP-style coordinator: checkpoint orchestration FSM, the global
sent/received counter aggregation that detects drain completion, and —
since the elastic-restart refactor — a generation-based MEMBERSHIP service.

Phases:  RUN -> DRAIN -> SNAPSHOT -> (RESUME | EXIT)

The coordinator never sees application data — only counters and phase
acknowledgements (exactly the DMTCP coordinator's role in the paper).

Membership (DESIGN.md §8): the world's shape is an epoch called the
*generation*.  Ranks join with a generation number; a dead/removed rank
bumps the generation; any rank-originated message stamped with a stale
generation is rejected with ``StaleGenerationError`` so a zombie rank from
a previous incarnation of the job cannot corrupt a restarted one."""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import metrics as _metrics
from repro_torch.core import recovery as _recovery
from repro_torch.core import trace as _trace


PHASE_RUN = "run"
PHASE_PENDING = "pending"      # ranks converge on a common checkpoint step
PHASE_DRAIN = "drain"
PHASE_SNAPSHOT = "snapshot"
PHASE_JOIN = "join"            # migration final: replacements hot-join the
                               # live generation before the world resumes
PHASE_RESUME = "resume"
PHASE_EXIT = "exit"


class StaleGenerationError(RuntimeError):
    """A message stamped with a superseded membership generation."""


class JobAborted(RuntimeError):
    """The job was aborted (dead rank / external cancel); ranks unwind."""


@dataclass
class RankCounters:
    sent: int = 0
    received: int = 0


class Membership:
    """Generation-based membership: which world shape is current.

    A Membership object OUTLIVES any single MPIJob — the fault-tolerant
    driver owns one and threads it through restarts, so a rank checkpointed
    in generation g can never ack, propose or report into generation g+1.
    """

    def __init__(self, world_size: int, generation: int = 0):
        self._lock = threading.Lock()
        self.world_size = world_size
        self.generation = generation
        #: (generation, world_size, dead_ranks) per epoch, oldest first
        self.history: List[Tuple[int, int, Tuple[int, ...]]] = [
            (generation, world_size, ())]

    def bump(self, dead: Sequence[int] = (),
             world_size: Optional[int] = None) -> int:
        """Start a new membership epoch: remove `dead`, adopt `world_size`
        (default: shrink by the number of dead ranks).  Returns the new
        generation."""
        with self._lock:
            if world_size is None:
                world_size = self.world_size - len(set(dead))
            if world_size < 1:
                raise ValueError(
                    f"membership bump would leave world_size={world_size}")
            self.generation += 1
            self.world_size = world_size
            self.history.append(
                (self.generation, world_size, tuple(sorted(set(dead)))))
            return self.generation

    def check(self, generation: Optional[int]) -> None:
        """Reject a stale-generation message (None = unstamped, accepted —
        intra-job calls are implicitly current)."""
        if generation is None:
            return
        with self._lock:
            if generation != self.generation:
                raise StaleGenerationError(
                    f"message from generation {generation} rejected: "
                    f"current generation is {self.generation} "
                    f"(world_size={self.world_size})")


class Coordinator:
    def __init__(self, n_ranks: int, membership: Optional[Membership] = None,
                 timeout: float = 60.0):
        self.n = n_ranks
        self.timeout = timeout
        self.membership = membership or Membership(n_ranks)
        self.phase = PHASE_RUN
        self._lock = threading.Condition()
        #: the LIVE world-rank set: mid-collective recovery removes dead
        #: ranks from it WITHOUT renumbering (world-rank ids stay sparse;
        #: every "all ranks agreed" count below compares against this set,
        #: not the original n)
        self._live: set = set(range(n_ranks))
        self._counters: Dict[int, RankCounters] = {
            r: RankCounters() for r in range(n_ranks)}
        self._drain_ack: set = set()
        self._snap_ack: set = set()
        self._resume_after_snapshot = True
        self._barrier_gen = 0
        self._barrier_count = 0
        self._finished: set = set()
        self.aborted: Optional[str] = None
        # registry-backed, individually locked: dict(coord.stats) and
        # stats["k"] += 1 keep working, but snapshot() is one consistent
        # view no matter which rank threads are bumping counters
        self.stats = _metrics.MetricGroup("coordinator", {
            "drain_rounds": 0, "drain_wall_s": 0.0,
            "drained_messages": 0, "checkpoints": 0,
            "counter_reports": 0, "empty_channel_snapshots": 0,
            "stale_rejected": 0,
            "migrations": 0, "migrate_rounds": 0,
            "migrate_pause_s": 0.0,
            "recoveries": 0, "recovery_wall_s": 0.0,
            "recovered_ops": 0, "rerun_ops": 0,
            "recovery_cancelled": 0})
        # flight-recorder span handles for the in-flight checkpoint round
        # and recovery epoch; phase sub-spans nest under the round/epoch
        # root, and the root's ctx is what trace_ctx() piggybacks to
        # rank children over the wire (DESIGN.md §16)
        self._ckpt_span = None
        self._ckpt_phase_span = None
        self._rec_span = None
        self._rec_phase_span = None
        # ---- mid-collective recovery state (DESIGN.md §14): the active
        # epoch's sub-FSM (collect -> quiesce -> patch -> resume), the
        # ledger consulted for retained contributions, and the outcome log
        self._rec: Optional[dict] = None
        self._rec_epoch = 0
        self._rec_ledger = None
        self._rec_log: Dict[int, dict] = {}
        # ---- live-migration state (DESIGN.md §13): pre-copy round counter
        # ranks poll at step boundaries, their per-round stream reports,
        # and the hot-join barrier for the stop-the-world final
        self._mig_round = 0
        self._mig_entries: Dict[int, dict] = {}
        self._mig_final = False
        self._join_expected: frozenset = frozenset()
        self._joined: set = set()
        #: per-generation data-plane telemetry: generation -> rank ->
        #: latest counter dict (compute/wait split, bytes per fabric);
        #: ranks overwrite their own slot, so memory is O(gens x ranks)
        self._telemetry: Dict[int, Dict[int, dict]] = {}

    # ---- membership ---------------------------------------------------------
    @property
    def generation(self) -> int:
        """Current membership generation (the world-shape epoch)."""
        return self.membership.generation

    def join(self, rank: int, generation: Optional[int] = None) -> int:
        """A rank enters the world at `generation`; stale joins rejected,
        out-of-world ranks refused.  Returns the current generation."""
        self._check_gen(generation)
        if not 0 <= rank < self.n:
            raise ValueError(f"rank {rank} outside world of {self.n}")
        return self.membership.generation

    def _check_gen(self, generation: Optional[int]) -> None:
        try:
            self.membership.check(generation)
        except StaleGenerationError:
            with self._lock:
                self.stats["stale_rejected"] += 1
            raise

    # ---- tracing ------------------------------------------------------------
    def trace_ctx(self) -> Optional[tuple]:
        """(trace_id, span_id) of the in-flight recovery epoch or
        checkpoint round, for piggybacking on proc-world reply frames so
        a rank child's work parents under the coordinating operation.
        Lock-free read: span handles are replaced atomically and a
        slightly stale ctx only mis-parents a span, never corrupts."""
        span = self._rec_span or self._ckpt_span
        if span is None:
            return None
        return span.ctx

    def _ckpt_phase_trace_locked(self, name: Optional[str]) -> None:
        """Close the current checkpoint-phase sub-span and open `name`
        (None = just close) nested under the round's root span."""
        if self._ckpt_phase_span is not None:
            self._ckpt_phase_span.end()
            self._ckpt_phase_span = None
        if name is not None and self._ckpt_span is not None:
            self._ckpt_phase_span = _trace.begin(
                "coord." + name, parent=self._ckpt_span, cat="coord",
                generation=self.membership.generation)

    def _end_ckpt_span_locked(self, **args) -> None:
        self._ckpt_phase_trace_locked(None)
        if self._ckpt_span is not None:
            self._ckpt_span.end(**args)
            self._ckpt_span = None

    def _rec_phase_trace_locked(self, name: Optional[str]) -> None:
        """Same, for the recovery sub-FSM (collect/quiesce/patch/resume
        nested under recover.epoch)."""
        if self._rec_phase_span is not None:
            self._rec_phase_span.end()
            self._rec_phase_span = None
        if name is not None and self._rec_span is not None:
            self._rec_phase_span = _trace.begin(
                "recover." + name, parent=self._rec_span, cat="coord",
                generation=self.membership.generation)

    # ---- abort --------------------------------------------------------------
    def abort(self, reason: str) -> None:
        """Cancel the job: every blocked rank raises JobAborted at its next
        pump/wait instead of timing out (what makes dead-rank detection →
        restart fast)."""
        with self._lock:
            if self.aborted is None:
                self.aborted = reason
                _trace.instant("coord.abort", cat="coord",
                               generation=self.membership.generation,
                               args={"reason": reason})
            self._lock.notify_all()

    def check_aborted(self) -> None:
        if self.aborted is not None:
            raise JobAborted(self.aborted)

    def mark_finished(self, rank: int) -> None:
        with self._lock:
            self._finished.add(rank)
            self._lock.notify_all()

    def all_finished(self) -> bool:
        with self._lock:
            return (self._live <= self._finished
                    and self.phase == PHASE_RUN)

    @property
    def live_set(self) -> frozenset:
        """World ranks currently in the live set (sparse after a
        mid-collective recovery removed a dead rank in place)."""
        with self._lock:
            return frozenset(self._live)

    # ---- counters (the Σsent == Σreceived heuristic) -----------------------
    def report_counters(self, rank: int, sent: int, received: int,
                        generation: Optional[int] = None) -> None:
        self._check_gen(generation)
        with self._lock:
            c = self._counters.get(rank)
            if c is None:        # removed by recovery: stale report, drop
                return
            c.sent, c.received = sent, received
            self.stats["counter_reports"] += 1
            self._lock.notify_all()

    def stat_add(self, key: str, n: int = 1) -> None:
        """Thread-safe stats bump — process-world rank children report
        their per-rank statistics (e.g. drained_messages) through their
        endpoint via this, since they cannot touch the dict in-process."""
        with self._lock:
            self.stats.add(key, n)

    def report_telemetry(self, rank: int, counters: dict,
                         generation: Optional[int] = None) -> None:
        """Latest per-rank data-plane counters (MPI.telemetry()), keyed by
        membership generation.  Piggybacks on the same stamped paths as
        report_counters: a zombie rank from a superseded world is rejected,
        not aggregated."""
        self._check_gen(generation)
        with self._lock:
            gen = self.membership.generation if generation is None \
                else generation
            self._telemetry.setdefault(gen, {})[rank] = dict(counters)

    def telemetry_summary(self, generation: Optional[int] = None) -> dict:
        """Aggregate view for one generation (default: current): per-rank
        counter dicts plus a numeric total across ranks."""
        with self._lock:
            gen = self.membership.generation if generation is None \
                else generation
            ranks = {r: dict(c) for r, c in
                     self._telemetry.get(gen, {}).items()}
        total: Dict[str, float] = {}
        for c in ranks.values():
            for k, v in c.items():
                if isinstance(v, (int, float)):
                    total[k] = total.get(k, 0) + v
        return {"generation": gen, "ranks": ranks, "total": total}

    def note_empty_channel(self, rank: int) -> None:
        """Rank verified its proxy channel empty right before snapshotting
        (the drain invariant, asserted — not just claimed — each ckpt)."""
        with self._lock:
            self.stats["empty_channel_snapshots"] += 1

    def network_empty(self) -> bool:
        with self._lock:
            s = sum(c.sent for c in self._counters.values())
            r = sum(c.received for c in self._counters.values())
            return s == r

    # ---- checkpoint FSM -----------------------------------------------------
    def request_checkpoint(self, resume: bool = True) -> None:
        """Asynchronous, DMTCP-style: may be called from any thread at any
        time.  Ranks converge on ckpt_step = max(next step index across
        ranks), run up to it (so every send a pre-ckpt_step recv depends on
        is issued — BSP per-step communication closure, DESIGN.md §2), then
        drain."""
        with self._lock:
            if self.phase != PHASE_RUN:
                raise RuntimeError(f"checkpoint during phase {self.phase}")
            if self._rec is not None and not self._rec.get("error"):
                raise RuntimeError("checkpoint during mid-collective "
                                   "recovery")
            self._resume_after_snapshot = resume
            self._drain_ack.clear()
            self._snap_ack.clear()
            self._proposals: Dict[int, int] = {}
            self.ckpt_step: Optional[int] = None
            self.phase = PHASE_PENDING
            self._drain_t0 = time.time()
            round_no = self.stats.add("checkpoints")
            self._ckpt_span = _trace.begin(
                "coord.ckpt_round", cat="coord",
                generation=self.membership.generation,
                args={"round": round_no, "resume": resume})
            self._ckpt_phase_trace_locked("pending")
            self._lock.notify_all()

    def propose_ckpt_step(self, rank: int, next_boundary: int,
                          generation: Optional[int] = None) -> Optional[int]:
        """NON-BLOCKING.  A rank proposes the next step boundary it will
        reach (called at a boundary, or from inside a blocked Recv with
        current_step+1 — that is what makes agreement deadlock-free when
        ranks run at different speeds).  Returns the agreed step once all
        ranks have proposed, else None.  First proposal per rank wins."""
        self._check_gen(generation)
        with self._lock:
            if self.phase not in (PHASE_PENDING, PHASE_DRAIN):
                return self.ckpt_step
            self._proposals.setdefault(rank, next_boundary)
            if (self.ckpt_step is None
                    and self._live <= set(self._proposals)):
                self.ckpt_step = max(self._proposals.values())
                self.phase = PHASE_DRAIN
                self._ckpt_phase_trace_locked("drain")
                self._lock.notify_all()
            return self.ckpt_step

    @property
    def ckpt_round(self) -> int:
        """How many checkpoint FSM rounds have started (NOT the membership
        generation — see `generation`)."""
        return self.stats["checkpoints"]

    def ack_drained(self, rank: int,
                    generation: Optional[int] = None) -> None:
        """Rank reports: at step boundary, no un-pumped traffic visible."""
        self._check_gen(generation)
        with self._lock:
            self._drain_ack.add(rank)
            self._lock.notify_all()

    def unack_drained(self, rank: int) -> None:
        with self._lock:
            self._drain_ack.discard(rank)

    def drain_complete(self) -> bool:
        """All ranks quiesced AND the network is globally empty."""
        with self._lock:
            if not self._live <= self._drain_ack:
                return False
            s = sum(c.sent for c in self._counters.values())
            r = sum(c.received for c in self._counters.values())
            if s == r:
                if self.phase == PHASE_DRAIN:
                    self.phase = PHASE_SNAPSHOT
                    self.stats["drain_wall_s"] += time.time() - self._drain_t0
                    self._ckpt_phase_trace_locked("snapshot")
                    self._lock.notify_all()
                return True
            self.stats["drain_rounds"] += 1
            return False

    def ack_snapshot(self, rank: int,
                     generation: Optional[int] = None) -> None:
        self._check_gen(generation)
        with self._lock:
            self._snap_ack.add(rank)
            if self._live <= self._snap_ack:
                if not self._resume_after_snapshot:
                    self.phase = PHASE_EXIT
                    self._end_ckpt_span_locked(outcome="exit")
                elif self._join_expected:
                    # migration final: hold the world until every
                    # replacement hot-joins the live generation
                    self.phase = PHASE_JOIN
                    self._ckpt_phase_trace_locked("join")
                else:
                    self.phase = PHASE_RESUME
                    self._ckpt_phase_trace_locked("resume")
                self._lock.notify_all()
            self._lock.notify_all()

    def resume_running(self, rank: int) -> None:
        with self._lock:
            if self.phase == PHASE_RESUME:
                self._drain_ack.discard(rank)
                if not self._drain_ack:
                    self.phase = PHASE_RUN
                    self._end_ckpt_span_locked(outcome="resumed")
                    self._lock.notify_all()

    def wait_phase(self, *phases: str,
                   timeout: Optional[float] = None) -> str:
        timeout = self.timeout if timeout is None else timeout
        deadline = time.time() + timeout
        with self._lock:
            while self.phase not in phases:
                if self.aborted is not None:
                    raise JobAborted(self.aborted)
                left = deadline - time.time()
                if left <= 0:
                    raise TimeoutError(
                        f"waiting for {phases}, still {self.phase} "
                        f"after {timeout:g}s")
                self._lock.wait(left)
            return self.phase

    # ---- live migration (pre-copy rounds + hot-join, DESIGN.md §13) ---------
    @property
    def mig_round(self) -> int:
        """Current pre-copy round (0 = no migration streaming).  Ranks
        poll this at step boundaries; seeing a round they have not
        streamed yet, they digest-diff their state against the last
        streamed manifest and ship only the dirty leaves — the world
        keeps computing."""
        return self._mig_round

    @property
    def migrating(self) -> bool:
        """True between request_migration_final and the world resuming —
        ranks save their images leaf-split so pre-copied chunks become
        references."""
        return self._mig_final

    @property
    def join_expected(self) -> frozenset:
        return self._join_expected

    def begin_round(self, round_no: int) -> None:
        """Open pre-copy round `round_no`: every rank streams its dirty
        leaf set at its next step boundary.  Only legal while RUNNING —
        rounds never overlap the checkpoint FSM."""
        with self._lock:
            if self.phase != PHASE_RUN:
                raise RuntimeError(
                    f"migration round during phase {self.phase}")
            if self._rec is not None and not self._rec.get("error"):
                raise RuntimeError("migration round during mid-collective "
                                   "recovery")
            self._mig_round = round_no
            self._mig_entries = {}
            self.stats["migrate_rounds"] += 1
            self._lock.notify_all()

    def report_round(self, rank: int, round_no: int, entry: dict,
                     generation: Optional[int] = None) -> None:
        """A rank finished streaming its dirty leaves for `round_no`.
        Late reports from a superseded round are dropped (the driver has
        already moved on)."""
        self._check_gen(generation)
        with self._lock:
            if round_no == self._mig_round:
                self._mig_entries[rank] = dict(entry)
                self._lock.notify_all()

    def wait_round(self, round_no: int,
                   timeout: Optional[float] = None) -> Dict[int, dict]:
        """Driver side: block until every rank streamed `round_no`."""
        timeout = self.timeout if timeout is None else timeout
        deadline = time.time() + timeout
        with self._lock:
            while (round_no == self._mig_round
                   and not self._live <= set(self._mig_entries)):
                if self.aborted is not None:
                    raise JobAborted(self.aborted)
                left = deadline - time.time()
                if left <= 0:
                    raise TimeoutError(
                        f"migration round {round_no}: "
                        f"{len(self._mig_entries)}/{self.n} ranks streamed "
                        f"after {timeout:g}s")
                self._lock.wait(left)
            return {r: dict(e) for r, e in self._mig_entries.items()}

    def request_migration_final(self, join_ranks: Sequence[int],
                                resume: bool = True) -> None:
        """The stop-the-world tail of migrate(): a normal checkpoint FSM
        round except (a) ranks save leaf-split images (pre-copied chunks
        become references — the pause pays only the final dirty delta)
        and (b) after the last snapshot ack the phase goes to PHASE_JOIN
        until each rank in `join_ranks` hot-joins via a replacement
        restored from the just-committed manifest."""
        with self._lock:
            if self.phase != PHASE_RUN:
                raise RuntimeError(
                    f"migration final during phase {self.phase}")
            self._join_expected = frozenset(join_ranks)
            self._joined = set()
            self._mig_final = True
            self.stats["migrations"] += 1
        self.request_checkpoint(resume=resume)

    def hot_join(self, rank: int, generation: Optional[int] = None) -> None:
        """A replacement rank checks into the RUNNING generation (the
        join barrier): once every expected rank has joined, the world
        resumes — no membership bump, no survivor-clone restart."""
        self._check_gen(generation)
        with self._lock:
            self._joined.add(rank)
            if (self.phase == PHASE_JOIN
                    and self._joined >= self._join_expected):
                self._mig_final = False
                self._mig_round = 0
                self._join_expected = frozenset()
                self.phase = PHASE_RESUME
                self._ckpt_phase_trace_locked("resume")
            self._lock.notify_all()

    # ---- mid-collective recovery (DESIGN.md §14) ----------------------------
    #
    # A dead rank inside a collective opens a recovery EPOCH instead of an
    # abort: survivors enlist with the exact op they are stuck in
    # (collect), pump the transport dry (quiesce), purge the half-finished
    # dance + shrink the world in place + zero counters (patch), then
    # either take the centrally-replayed result of the interrupted op
    # (finished from the ContributionLedger's retained inputs — zero
    # recomputation, bit-identical) or re-run an op the dead rank never
    # entered over the shrunk communicator (resume).  The membership
    # generation is NOT bumped — the world stays the same epoch, minus one
    # rank.  Any ineligibility (ledger miss, multi-failure, timeout)
    # cancels the epoch and the driver falls back to bump→abort→restart.

    @property
    def recovery_token(self) -> Optional[int]:
        """Active recovery epoch id, None when no recovery is running (or
        the last one was cancelled).  Ranks compare this against the last
        epoch they participated in to decide whether to enlist."""
        with self._lock:
            rec = self._rec
            if rec is None or rec.get("error"):
                return None
            return rec["token"]

    def begin_recovery(self, dead: Sequence[int], ledger) -> int:
        """Open a recovery epoch for `dead` (parent side).  Raises
        RecoveryUnavailable when recovery cannot even be attempted —
        instant, so the non-collective-death case costs microseconds
        before falling back."""
        dead_set = frozenset(int(d) for d in dead)
        with self._lock:
            if self._rec is not None and self._rec.get("error"):
                self._rec = None            # superseded failed epoch
            if self._rec is not None:
                raise _recovery.RecoveryUnavailable("recovery already active")
            if self.phase != PHASE_RUN:
                raise _recovery.RecoveryUnavailable(
                    f"checkpoint FSM in phase {self.phase}")
            if self.aborted is not None:
                raise _recovery.RecoveryUnavailable("job already aborted")
            if len(dead_set) != 1:
                raise _recovery.RecoveryUnavailable(
                    f"multi-failure ({sorted(dead_set)})")
            if not dead_set <= self._live:
                raise _recovery.RecoveryUnavailable(
                    f"{sorted(dead_set - self._live)} not in live set")
            if len(self._live - dead_set) < 1:
                raise _recovery.RecoveryUnavailable("no survivors")
            if ledger is None:
                raise _recovery.RecoveryUnavailable("ledger disabled")
            dead_keys: List[tuple] = []
            for d in dead_set:
                dead_keys += ledger.uncommitted_ops_of(d)
            if not dead_keys:
                # the dead rank was BETWEEN collectives: nothing retained
                # to finish on its behalf — rollback is the only option
                raise _recovery.RecoveryUnavailable("ledger-miss")
            self._rec_epoch += 1
            self._rec_ledger = ledger
            self._rec = {
                "token": self._rec_epoch, "dead": dead_set,
                "phase": "collect", "t0": time.time(),
                "enlisted": {}, "quiet": {}, "purge": [],
                "needs": {}, "results": {}, "actions": {},
                "patched": set(), "resumed": set(),
                "dead_keys": [tuple(k) for k in dead_keys],
                "error": None,
            }
            self._rec_span = _trace.begin(
                "recover.epoch", cat="coord",
                generation=self.membership.generation,
                args={"token": self._rec_epoch,
                      "dead": sorted(dead_set)})
            self._rec_phase_trace_locked("collect")
            self._lock.notify_all()
            return self._rec_epoch

    def recovery_poll(self, rank: int, info: Optional[dict] = None,
                      generation: Optional[int] = None,
                      token: Optional[int] = None) -> dict:
        """Rank-side driver RPC for the recovery sub-FSM: ingest `info`
        (enlistment desc / quiesce report / patch ack), advance the phase
        when its gate is met, and reply with what the rank should do
        next.  The resume reply is terminal per rank — delivering the
        instruction marks the rank resumed."""
        self._check_gen(generation)
        with self._lock:
            rec = self._rec
            if rec is None:
                return {"phase": "idle"}
            if rec.get("error") or rank in rec["dead"] \
                    or (token is not None and token != rec["token"]):
                return {"phase": "cancelled"}
            waiting = self._live - rec["dead"]
            phase = rec["phase"]
            if phase == "collect":
                if info and info.get("kind") in ("op", "boundary",
                                                 "finished"):
                    rec["enlisted"][rank] = dict(info)
                if waiting <= set(rec["enlisted"]):
                    err = self._plan_recovery_locked(rec)
                    if err:
                        self._cancel_locked(rec, err)
                        return {"phase": "cancelled"}
                    rec["phase"] = "quiesce"
                    self._rec_phase_trace_locked("quiesce")
            elif phase == "quiesce":
                if info is not None and "quiet" in info:
                    rec["quiet"][rank] = (rec["quiet"].get(rank, 0) + 1
                                          if info["quiet"] else 0)
                if all(rec["quiet"].get(r, 0) >= 2 for r in waiting):
                    rec["phase"] = "patch"
                    self._rec_phase_trace_locked("patch")
            elif phase == "patch":
                if info and info.get("patched"):
                    rec["patched"].add(rank)
                    if waiting <= rec["patched"]:
                        rec["phase"] = "resume"
                        self._rec_phase_trace_locked("resume")
            if rec["phase"] == "patch":
                return {"phase": "patch",
                        "dead": sorted(rec["dead"]),
                        "purge": list(rec["purge"])}
            if rec["phase"] == "resume":
                action, key = rec["actions"].get(rank, ("none", None))
                rep = {"phase": "resume", "action": action}
                if action == "deliver":
                    rep["result"] = rec["results"][key]
                rec["resumed"].add(rank)
                if waiting <= rec["resumed"]:
                    self._finalize_recovery_locked(rec)
                return rep
            return {"phase": rec["phase"]}

    def _plan_recovery_locked(self, rec: dict) -> Optional[str]:
        """All survivors enlisted: decide per interrupted op whether it is
        finished centrally from the ledger (some member — dead or moved-on
        — can no longer re-run it) or re-run over the shrunk communicator
        (the dead rank never entered it and every live member is stuck in
        it), replay the central ones, and build the purge list + per-rank
        actions.  Returns an error string → cancel (fallback)."""
        live_after = self._live - rec["dead"]
        by_key: Dict[tuple, dict] = {}
        for r, d in rec["enlisted"].items():
            if d.get("kind") != "op":
                continue
            ent = by_key.setdefault(tuple(d["key"]),
                                    {"desc": d, "stuck": set()})
            ent["stuck"].add(r)
        purge: List[tuple] = []
        for key, ent in by_key.items():
            desc = ent["desc"]
            purge += [(desc["comm"], t) for t in desc["tags"]]
            members = set(desc["ranks"])
            op = self._rec_ledger.get(key)
            contribs = op.contribs if op is not None else {}
            dead_members = members & rec["dead"]
            all_live_stuck = ent["stuck"] >= (members & live_after)
            if dead_members and dead_members <= set(contribs):
                # the dead rank DID contribute: finish the op centrally
                # from every member's retained input — zero recomputation,
                # bit-identical to the unfaulted dance
                complete = True
            elif dead_members:
                # the dead rank never entered this op (it died one op
                # behind): every live member re-runs it over the shrunk
                # communicator.  Requires all of them stuck in it — and
                # they are: no member can finish a collective the dead
                # rank never fed (the dependency chain passes through
                # every member) — checked anyway, fail → fallback.
                if not all_live_stuck:
                    return f"ledger-miss:op{key}"
                complete = False
            else:
                # healthy sub-communicator op merely caught by the
                # quiesce: re-run if everyone is still in it, finish
                # centrally if a member already moved past
                complete = not all_live_stuck
            if complete:
                try:
                    rec["results"][key] = _recovery.replay_op(
                        desc, contribs)
                except KeyError as e:
                    return f"ledger-miss:op{key}:rank{e}"
                rec["needs"][key] = "complete"
            else:
                rec["needs"][key] = "rerun"
        rec["purge"] = purge
        for r in live_after:
            d = rec["enlisted"].get(r)
            if d and d.get("kind") == "op":
                key = tuple(d["key"])
                rec["actions"][r] = (
                    ("deliver", key) if rec["needs"][key] == "complete"
                    else ("rerun", key))
            else:
                rec["actions"][r] = ("none", None)
        return None

    def _finalize_recovery_locked(self, rec: dict) -> None:
        """Every survivor took its resume instruction: shrink the live
        set in place (same generation), drop the dead rank's bookkeeping,
        release the ledger entries recovery consumed, log the outcome."""
        for key, need in rec["needs"].items():
            if need == "complete":
                self._rec_ledger.drop(key)
        for key in rec["dead_keys"]:
            if rec["needs"].get(key) != "rerun":
                self._rec_ledger.drop(key)
        self._live -= rec["dead"]
        for r in rec["dead"]:
            self._counters.pop(r, None)
            self._finished.discard(r)
            self._drain_ack.discard(r)
            self._snap_ack.discard(r)
        wall = time.time() - rec["t0"]
        self.stats["recoveries"] += 1
        self.stats["recovery_wall_s"] += wall
        n_complete = sum(1 for v in rec["needs"].values()
                         if v == "complete")
        self.stats["recovered_ops"] += n_complete
        self.stats["rerun_ops"] += len(rec["needs"]) - n_complete
        self._rec_log[rec["token"]] = {
            "ok": True, "dead": sorted(rec["dead"]), "wall_s": wall,
            "completed_ops": n_complete,
            "rerun_ops": len(rec["needs"]) - n_complete,
        }
        self._rec = None
        self._rec_phase_trace_locked(None)
        if self._rec_span is not None:
            self._rec_span.end(outcome="ok", wall_s=round(wall, 6),
                               completed_ops=n_complete,
                               rerun_ops=len(rec["needs"]) - n_complete)
            self._rec_span = None
        self._lock.notify_all()

    def _cancel_locked(self, rec: dict, reason: str) -> None:
        rec["error"] = reason
        self.stats["recovery_cancelled"] += 1
        self._rec_log[rec["token"]] = {
            "ok": False, "dead": sorted(rec["dead"]), "error": reason,
            "wall_s": time.time() - rec["t0"],
        }
        self._rec_phase_trace_locked(None)
        if self._rec_span is not None:
            self._rec_span.end(outcome="cancelled", error=reason)
            self._rec_span = None
        self._lock.notify_all()

    def cancel_recovery(self, token: int, reason: str) -> None:
        """Parent side: give up on an epoch (timeout).  Parked survivors
        see "cancelled" at their next poll and hold position until the
        driver's abort lands."""
        with self._lock:
            rec = self._rec
            if rec is not None and rec["token"] == token \
                    and not rec.get("error"):
                self._cancel_locked(rec, reason)

    def recovery_status(self, token: int) -> Optional[dict]:
        """Outcome of epoch `token`: None while still running, else the
        logged result dict ({"ok": bool, ...})."""
        with self._lock:
            done = self._rec_log.get(token)
            if done is not None:
                return dict(done)
            rec = self._rec
            if rec is not None and rec["token"] == token:
                return None
            return {"ok": False, "error": "superseded"}

    # ---- generic barrier -----------------------------------------------------
    def barrier(self, rank: int, timeout: Optional[float] = None,
                generation: Optional[int] = None) -> None:
        self._check_gen(generation)
        timeout = self.timeout if timeout is None else timeout
        with self._lock:
            gen = self._barrier_gen
            self._barrier_count += 1
            if self._barrier_count == len(self._live):
                self._barrier_count = 0
                self._barrier_gen += 1
                self._lock.notify_all()
                return
            deadline = time.time() + timeout
            while self._barrier_gen == gen:
                if self.aborted is not None:
                    raise JobAborted(self.aborted)
                left = deadline - time.time()
                if left <= 0:
                    raise TimeoutError(
                        f"barrier timeout after {timeout:g}s "
                        f"(rank {rank}, {self._barrier_count}/{self.n} "
                        f"arrived)")
                self._lock.wait(left)
