"""Failure detection, straggler mitigation, and the elastic restart driver.

At fleet scale the paper's protocol is what makes failures cheap: because
the checkpoint is implementation-free, a replacement node (or a different
cluster/transport, or a DIFFERENT WORLD SIZE) restores without any state
from the dead rank.  Here:

  * HeartbeatMonitor — missed-heartbeat failure detector on a MONOTONIC
    clock (wall-clock jumps cannot mass-declare ranks dead); ranks ping
    from step boundaries AND from inside blocked calls (api._on_idle), so
    "parked in Recv" is alive and "thread gone" is dead within timeout_s.
  * StragglerTracker — per-rank step-duration EWMA; ranks slower than
    ``factor`` x median are flagged.  The driver ACTS on the
    flag: a rank flagged for ``straggler_windows`` consecutive monitor
    polls is EXCLUDED at the next checkpoint boundary — the driver
    requests an immediate checkpoint, waits for it to commit, then runs
    the same bump→abort→reshaped-restart path a death takes.  Nothing is
    lost (the boundary just checkpointed) and the slow rank stops gating
    every collective.
  * FaultTolerantDriver — run an MPIJob with periodic checkpoints and a
    live monitor.  On a dead rank: bump the membership generation (zombie
    messages from the old world are rejected from that instant), abort the
    job (blocked ranks unwind in milliseconds, not Recv-timeout minutes),
    and restart from the newest valid checkpoint — shrunk by the dead
    ranks, grown to a target size, or on a different transport
    (DESIGN.md §8 state machine).
"""
from __future__ import annotations

import enum
import inspect
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import metrics as _metrics
from repro_torch.core import trace as _trace
from repro_torch.core.coordinator import Membership
from repro_torch.core.procworld import RankProcessDied  # noqa: F401  (re-export:
# the driver-facing "a rank's OS process vanished" error lives with the
# process world but is detected and consumed here)


class DriverEventKind(str, enum.Enum):
    """The driver's event vocabulary, pinned (test_observability).  Every
    entry in ``FaultTolerantDriver.events`` is a ``DriverEvent`` of one of
    these kinds; the legacy colon-joined string form is the event's str
    value, so existing ``e.startswith("dead:")`` consumers keep working."""

    START = "start"                  # start:fresh
    RESTART = "restart"              # restart:<ckpt>:world=N:gen=G
    DEAD = "dead"                    # dead:[ranks]:gen=G
    STRAGGLER = "straggler"          # straggler:[ranks]:gen=G
    RECOVER = "recover"              # recover:[ranks]:wall_s=..:completed=..
    FALLBACK = "fallback"            # fallback:[ranks]:<reason>
    MIGRATE = "migrate"              # migrate:[ranks]:pause_s=..:rounds=..
    MIGRATE_FAILED = "migrate-failed"  # migrate-failed:[ranks]:<error>
    CKPT = "ckpt"                    # ckpt:<dir name>
    WAIT = "wait"                    # wait:rank=R:compute_s=..:wall_s=..
    DONE = "done"                    # done
    FAILURE = "failure"              # failure:<error type>


@dataclass(frozen=True)
class DriverEventPayload:
    """Structured half of a DriverEvent: what the colon-string encodes,
    without the parsing."""
    kind: DriverEventKind
    ranks: Optional[Tuple[int, ...]] = None
    generation: Optional[int] = None
    detail: dict = field(default_factory=dict)


class DriverEvent(str):
    """A typed driver event that IS its legacy string form.

    ``str(ev)``, equality, startswith — everything the existing tests and
    log consumers do — see the exact colon-joined string the driver used
    to append; ``ev.kind`` / ``ev.payload`` carry the typed form for new
    consumers (no regex re-parsing of ranks and generations)."""

    kind: DriverEventKind
    payload: DriverEventPayload

    def __new__(cls, kind: "DriverEventKind | str", text: str,
                ranks: Optional[Sequence[int]] = None,
                generation: Optional[int] = None, **detail):
        self = super().__new__(cls, text)
        self.kind = DriverEventKind(kind)
        self.payload = DriverEventPayload(
            kind=self.kind,
            ranks=tuple(ranks) if ranks is not None else None,
            generation=generation, detail=detail)
        return self


#: driver events by kind — bounded label set (the pinned vocabulary)
_EVENT_COUNTER = _metrics.labeled_counter("driver_events",
                                          max_series=len(DriverEventKind))


def kill_rank_process(job, rank: int, sig: int = signal.SIGKILL) -> int:
    """REAL fault injection for process worlds: signal the rank's OS
    process (default SIGKILL — no cleanup, no goodbye; the endpoint sees a
    torn socket and records the death immediately).  Returns the pid.

    Raises ValueError for thread worlds, unknown ranks, or ranks whose
    process already exited — a thread-world test wanting a deterministic
    death raises RankKilled from the step instead.

    The liveness check and the kill cannot be atomic with plain pids (the
    victim could die and its pid be recycled in between); the check runs
    immediately before the signal to keep that window at a few
    microseconds.  Closing it fully needs pidfds (Linux >= 5.3) — fine
    for a fault injector aimed at our OWN just-verified-alive children."""
    proc = job._proc._procs.get(rank) if job._proc is not None else None
    if proc is None or proc.pid is None or not proc.is_alive():
        raise ValueError(
            f"rank {rank} has no live OS process (thread world, not "
            f"launched, or already exited); rank_pids={job.rank_pids()}")
    os.kill(proc.pid, sig)
    return proc.pid


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


class FaultTolerantDriver:
    """Run-to-completion with checkpoint/restart recovery (MPIJob level).

    Two factory styles are accepted (detected by arity):

      * legacy — ``job_factory()`` and ``restart_factory(path, transport)``:
        every incarnation keeps the original world size;
      * elastic — ``job_factory(world_size, membership)`` and
        ``restart_factory(path, transport, world_size, dead_ranks,
        membership)``: on failure the driver bumps the shared Membership
        generation and restarts at ``world_size - dead`` (or whatever
        ``world_size_after_failure`` says — an int for a fixed target such
        as grow-to-4, or a callable ``(world, dead) -> new_world``).

    Detection is two-channel: a raised rank exception lands in
    ``job.errors`` immediately, and a silently hung/vanished rank misses
    heartbeats.  Either way the driver aborts the incarnation — blocked
    peers unwind at their next pump — instead of waiting out Recv
    timeouts.
    """

    def __init__(self, job_factory: Callable,
                 restart_factory: Callable,
                 ckpt_root: str | Path, ckpt_every: int,
                 max_restarts: int = 3,
                 world_size_after_failure:
                     Union[int, Callable[[int, Tuple[int, ...]], int],
                           None] = None,
                 min_world_size: int = 1,
                 monitor_poll_s: float = 0.02,
                 membership: Optional[Membership] = None,
                 straggler_windows: int = 0,
                 recovery: bool = True,
                 recovery_timeout_s: float = 10.0,
                 recovery_backoff_s: float = 5.0,
                 migrate_windows: int = 0):
        self.job_factory = job_factory
        self.restart_factory = restart_factory
        self.ckpt_root = Path(ckpt_root)
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.world_size_after_failure = world_size_after_failure
        self.min_world_size = min_world_size
        self.monitor_poll_s = monitor_poll_s
        self.membership = membership
        #: straggler policy (0 disables): a rank the StragglerTracker
        #: flags for this many CONSECUTIVE monitor polls is excluded at
        #: the next checkpoint boundary — checkpoint now, then treat it
        #: like a death (bump -> abort -> reshaped restart without it)
        self.straggler_windows = straggler_windows
        #: mid-collective recovery policy (DESIGN.md §14): when a single
        #: rank dies, FIRST try job.recover() — finish the in-flight step
        #: over the survivors, same generation, same incarnation.  Only a
        #: failed/ineligible recovery takes the classic
        #: bump → abort → reshaped-restart ladder below.
        self.recovery = recovery
        self.recovery_timeout_s = recovery_timeout_s
        #: after a failed recovery attempt, don't re-attempt for
        #: backoff * 2^(consecutive_failures - 1) seconds — a world whose
        #: failures keep being unrecoverable goes straight to restart
        self.recovery_backoff_s = recovery_backoff_s
        #: auto-migration (opt-in, DESIGN.md §13): a rank flagged slow for
        #: this many CONSECUTIVE monitor polls is live-migrated
        #: (job.migrate — pre-copy rounds, bounded pause, same
        #: incarnation) instead of waiting for the exclusion ladder
        self.migrate_windows = migrate_windows
        self.events: List[DriverEvent] = []
        #: per-recovery reports ({"dead", "wall_s", "completed_ops", ...})
        self.recoveries: List[dict] = []
        self._rec_failures = 0
        self._rec_block_until = 0.0
        self._elastic_jobs = (
            len(inspect.signature(job_factory).parameters) >= 2)
        self._elastic_restarts = (
            len(inspect.signature(restart_factory).parameters) >= 5)

    # ------------------------------------------------------------- plumbing
    def _event(self, kind: "DriverEventKind | str", text: str,
               ranks: Optional[Sequence[int]] = None,
               generation: Optional[int] = None, **detail) -> DriverEvent:
        """Append one typed event + mirror it into the flight recorder and
        the driver_events labeled counter."""
        ev = DriverEvent(kind, text, ranks=ranks, generation=generation,
                         **detail)
        self.events.append(ev)
        _trace.instant("driver." + ev.kind.value, cat="driver",
                       generation=generation, args={"text": text})
        _EVENT_COUNTER.inc(ev.kind.value)
        return ev

    def _latest_valid(self) -> Optional[Path]:
        from repro_torch.core.ckpt_protocol import checkpoint_valid, load_manifest
        if not self.ckpt_root.exists():
            return None

        def committed_at(d: Path) -> float:
            # manifest commit time, not directory name: straggler-exclude
            # checkpoints interleave with periodic at_N dirs, so
            # lexicographic order no longer tracks recency
            try:
                return float(load_manifest(d).get("time", 0.0))
            except Exception:
                return -1.0

        cands = sorted((d for d in self.ckpt_root.iterdir() if d.is_dir()),
                       key=lambda d: (committed_at(d), d.name))
        for d in reversed(cands):
            # deep=True: restart is rare and correctness-critical — pay
            # the full digest scan so a size-preserving bit flip (invisible
            # to the manifest-only fast path) falls back to an older
            # checkpoint instead of failing the recovery mid-restart
            if checkpoint_valid(d, deep=True):
                return d
        return None

    def _next_world(self, world: int, dead: Tuple[int, ...]) -> int:
        policy = self.world_size_after_failure
        if callable(policy):
            new = policy(world, dead)
        elif policy is not None:
            new = int(policy)
        else:
            new = world - len(dead)
        return max(new, self.min_world_size)

    def _fresh_job(self):
        if self._elastic_jobs:
            return self.job_factory(
                self.membership.world_size if self.membership else None,
                self.membership)
        return self.job_factory()

    def _restart_job(self, latest: Path, transport: str,
                     dead: Tuple[int, ...], dead_gen: Optional[int]):
        if not self._elastic_restarts:
            return self.restart_factory(latest, transport)
        from repro_torch.core.ckpt_protocol import load_manifest
        man = load_manifest(latest)
        # dead rank ids are only meaningful against the INCARNATION that
        # wrote the checkpoint — identified by its membership generation
        # (world sizes can repeat across generations under a replacement
        # policy); if the newest valid image predates the incarnation the
        # death was observed in, restart by target size alone
        if dead_gen is not None and man.get("generation", 0) != dead_gen:
            dead = ()
        world = (self.membership.world_size if self.membership
                 else man["n_ranks"] - len(dead))
        return self.restart_factory(latest, transport, world, dead,
                                    self.membership)

    @staticmethod
    def _detect_dead(job) -> Tuple[int, ...]:
        return tuple(sorted(set(job.failed_ranks())
                            | set(job.heartbeat.dead_ranks())))

    def _declare_dead(self, job, dead: Tuple[int, ...],
                      kind: str = "dead") -> Tuple[int, ...]:
        """Bump the membership generation for an observed death set.  A
        set covering the WHOLE world is an incarnation failure, not a
        shrink (a shrink-by-all would leave no survivors): keep the world
        size and restore every image.  Returns the dead set to carry into
        the restart (empty for total outage).  `kind` labels the event
        ("dead" for failures, "straggler" for policy exclusions — the
        restart path is identical)."""
        observed = dead
        if len(dead) >= job.n:
            gen = self.membership.bump(world_size=job.n)
            dead = ()
        else:
            gen = self.membership.bump(
                dead, world_size=self._next_world(job.n, dead))
        self._event(kind, f"{kind}:{list(observed)}:gen={gen}",
                    ranks=observed, generation=gen)
        return dead

    def _confirmed_stragglers(self, job, counts: Dict[int, int],
                              windows: int) -> Tuple[int, ...]:
        """Update per-rank consecutive-flag counts from the tracker and
        return ranks past the threshold (never so many that the world
        would shrink below min_world_size)."""
        flagged = set(job.stragglers.stragglers())
        for r in list(counts):
            if r not in flagged:
                del counts[r]            # consecutive means consecutive
        for r in flagged:
            counts[r] = counts.get(r, 0) + 1
        slow = sorted(r for r, c in counts.items() if c >= windows)
        while slow and job.n - len(slow) < self.min_world_size:
            slow.pop()
        return tuple(slow)

    def _try_recover(self, job, dead: Tuple[int, ...]) -> bool:
        """Attempt survivor-only mid-collective recovery.  True: the world
        is whole again (same incarnation, same generation) — keep
        monitoring.  False: fall through to the restart ladder."""
        if not self.recovery or not hasattr(job, "recover"):
            return False
        if time.monotonic() < self._rec_block_until:
            self._event(DriverEventKind.FALLBACK,
                        f"fallback:{list(dead)}:backoff",
                        ranks=dead, reason="backoff")
            return False
        try:
            rep = job.recover(dead, timeout=self.recovery_timeout_s)
        except Exception as e:  # noqa: BLE001 - any failure falls back
            self._rec_failures += 1
            self._rec_block_until = time.monotonic() + \
                self.recovery_backoff_s * 2 ** (self._rec_failures - 1)
            self._event(DriverEventKind.FALLBACK,
                        f"fallback:{list(dead)}:{type(e).__name__}:{e}",
                        ranks=dead, error=type(e).__name__)
            return False
        self._rec_failures = 0
        self._rec_block_until = 0.0
        self.recoveries.append(rep)
        self._event(
            DriverEventKind.RECOVER,
            f"recover:{rep['dead']}:wall_s={rep['wall_s']:.4f}"
            f":completed={rep['completed_ops']}:rerun={rep['rerun_ops']}",
            ranks=rep["dead"], wall_s=rep["wall_s"],
            completed_ops=rep["completed_ops"], rerun_ops=rep["rerun_ops"])
        return True

    def _auto_migrate(self, job, slow: Tuple[int, ...]) -> None:
        """Live-migrate confirmed-slow ranks (pre-copy rounds while the
        world runs, pause bounded by the final dirty delta).  Blocks the
        monitor thread for the migration — dead-rank detection resumes at
        the next poll; a death DURING the migration surfaces through the
        normal error/heartbeat channels and aborts this incarnation."""
        gen = self.membership.generation if self.membership else 0
        ck = self.ckpt_root / f"mig_g{gen:04d}_{len(self.events)}"
        try:
            rep = job.migrate(ck, ranks=list(slow))
        except Exception as e:  # noqa: BLE001 - migration is best-effort
            self._event(DriverEventKind.MIGRATE_FAILED,
                        f"migrate-failed:{list(slow)}:{type(e).__name__}",
                        ranks=slow, error=type(e).__name__)
            return
        for r in slow:
            job.stragglers.forget(r)
        self._event(
            DriverEventKind.MIGRATE,
            f"migrate:{list(slow)}:pause_s={rep['pause_s']:.4f}"
            f":rounds={len(rep['rounds'])}"
            f":final_fraction={rep['final_fraction']:.4f}",
            ranks=slow, pause_s=rep["pause_s"], rounds=len(rep["rounds"]),
            final_fraction=rep["final_fraction"])

    def _exclude_stragglers(self, job, slow: Tuple[int, ...]) -> bool:
        """The 'next checkpoint boundary' half of the straggler policy:
        request an immediate checkpoint and wait for its manifest to
        commit, so the reshaped restart resumes from the boundary the
        exclusion happens at (zero recomputation).  False (skip the
        exclusion this poll) when the job is finishing or a concurrent
        checkpoint round holds the coordinator — both resolve by the
        next poll."""
        ck = self.ckpt_root / (
            f"strag_g{self.membership.generation:04d}_{len(self.events)}")
        try:
            job.checkpoint(ck, resume=True)
            # bounded: if a rank dies mid-checkpoint the wait times out
            # and the next poll handles it as the death it is
            job.wait_checkpoint(timeout=30.0)
        except (RuntimeError, TimeoutError):
            return False
        self._event(DriverEventKind.CKPT, f"ckpt:{ck.name}", name=ck.name)
        return True

    # ------------------------------------------------------------------ run
    def run(self, n_steps: int, transport_after_failure: str = "shm",
            timeout: float = 120.0):
        attempts = 0
        pending_dead: Tuple[int, ...] = ()
        pending_gen: Optional[int] = None     # generation the death was seen in
        while True:
            latest = self._latest_valid()
            if latest is None:
                job = self._fresh_job()
                self._event(DriverEventKind.START, "start:fresh")
            else:
                job = self._restart_job(latest, transport_after_failure,
                                        pending_dead, pending_gen)
                self._event(
                    DriverEventKind.RESTART,
                    f"restart:{latest.name}:world={job.n}"
                    f":gen={job.coord.generation}",
                    generation=job.coord.generation,
                    ckpt=latest.name, world=job.n)
            pending_dead, pending_gen = (), None
            if self.membership is None:
                # adopt the first incarnation's membership: it survives
                # every later job and is what stale messages die against
                self.membership = job.coord.membership
            start = max(job.start_steps) if latest is not None else 0
            # schedule periodic checkpoints from the next multiple
            nxt = ((start // self.ckpt_every) + 1) * self.ckpt_every
            if nxt < n_steps:
                job.checkpoint_at(nxt, self.ckpt_root / f"at_{nxt:08d}")

            box: dict = {}

            def _run_job(job=job, box=box):
                try:
                    box["result"] = job.run(n_steps, timeout=timeout)
                except BaseException as e:  # noqa: BLE001 - surfaced below
                    box["error"] = e

            # re-arm heartbeats from THIS thread before monitoring begins:
            # a slow image restore must not make the first dead_ranks()
            # poll (which can run before the job thread is ever scheduled)
            # mass-declare healthy ranks dead
            for r in range(job.n):
                job.heartbeat.reset(r)
            t = threading.Thread(target=_run_job, daemon=True,
                                 name="ftd-job")
            t.start()
            dead: Tuple[int, ...] = ()
            dying_gen = self.membership.generation
            strag_counts: Dict[int, int] = {}
            mig_counts: Dict[int, int] = {}
            migrated: set = set()       # at most one migration per rank
            deadline = time.monotonic() + timeout
            while t.is_alive():
                dead = self._detect_dead(job)
                if not dead and self.migrate_windows:
                    slow = tuple(
                        r for r in self._confirmed_stragglers(
                            job, mig_counts, self.migrate_windows)
                        if r not in migrated)
                    if slow:
                        migrated |= set(slow)
                        self._auto_migrate(job, slow)
                        continue
                if not dead and self.straggler_windows:
                    slow = self._confirmed_stragglers(
                        job, strag_counts, self.straggler_windows)
                    if slow and self._exclude_stragglers(job, slow):
                        # wait-time attribution record per excluded rank:
                        # the telemetry evidence (compute vs wall) that
                        # justified the exclusion, kept in the event log
                        report = job.stragglers.report()
                        for r in slow:
                            rep = report.get(r, {})
                            comp, wall = rep.get("compute_s"), rep.get("wall_s")
                            self._event(
                                DriverEventKind.WAIT,
                                f"wait:rank={r}"
                                f":compute_s={comp if comp is None else round(comp, 4)}"
                                f":wall_s={wall if wall is None else round(wall, 4)}",
                                ranks=(r,), compute_s=comp, wall_s=wall)
                        dead = self._declare_dead(job, slow,
                                                  kind="straggler")
                        job.abort(
                            f"straggler ranks {list(slow)} excluded "
                            f"(generation {self.membership.generation})")
                        break
                if dead:
                    # settling window: co-failing ranks (one crash taking
                    # the whole step down, a switch dying under several
                    # nodes) rarely land in the same poll; batch them into
                    # ONE generation bump instead of cascading restarts
                    time.sleep(max(0.05, 2 * self.monitor_poll_s))
                    dead = self._detect_dead(job)
                    if not dead:
                        continue    # transient blip: the rank recovered
                    if self._try_recover(job, dead):
                        # the step finished over the survivors; this
                        # incarnation keeps running — no bump, no restart
                        dead = ()
                        continue
                    dead = self._declare_dead(job, dead)
                    job.abort(f"dead ranks declared "
                              f"(generation {self.membership.generation})")
                    break
                if time.monotonic() > deadline:
                    job.abort("driver timeout")
                    break
                time.sleep(self.monitor_poll_s)
            # cooperating ranks observe the abort within milliseconds; a
            # rank wedged in non-MPI user code should not make recovery
            # wait out the full driver timeout a second time
            t.join(min(timeout, 10.0))
            job.stop()
            if "result" in box and not dead:
                self._event(DriverEventKind.DONE, "done")
                return box["result"]
            if "result" not in box and not dead:
                # the job died faster than the monitor could poll (every
                # rank crashed at once): post-mortem detection still bumps
                # the generation so zombies of this incarnation are locked
                # out before the restart
                post = self._detect_dead(job)
                if post:
                    dead = self._declare_dead(job, post)
            attempts += 1
            err = box.get("error")
            self._event(
                DriverEventKind.FAILURE,
                f"failure:{type(err).__name__ if err else 'DeadRank'}",
                error=type(err).__name__ if err else "DeadRank")
            if attempts > self.max_restarts:
                if err is not None:
                    raise err
                raise RuntimeError(
                    f"exceeded max_restarts={self.max_restarts}")
            pending_dead, pending_gen = dead, dying_gen
