"""MPIJob — launch ranks, drive the paper's checkpoint FSM, restart.

App contract (DESIGN.md §2 assumption notes):
  * an application is ``init_fn(mpi) -> state`` plus
    ``step_fn(mpi, state, step_idx) -> state`` run for a number of steps;
  * messages received in step k were sent in steps <= k (BSP-style
    communication closure) — sends may freely cross checkpoint boundaries
    (that IS the drained in-flight case the paper is about).

Checkpointing is ASYNCHRONOUS like DMTCP's coordinator: call
``job.checkpoint(dir)`` from any thread while the job runs; ranks agree on
a common boundary step, run up to it (draining the network), snapshot, and
resume or exit.  ``MPIJob.restart`` reconstructs the job from images on ANY
transport — checkpoint under shm, restart under tcp is the paper's §7
cross-implementation restart — and, since the elastic refactor, for ANY
world shape: ``MPIJob.restart(ck, step_fn, init_fn, world_size=K,
dead_ranks=(r,))`` shrinks, grows, or replaces members, remapping every
world-rank reference in the images through the old→new map (DESIGN.md §8).

Two execution substrates share this class: the THREAD world (ranks are
threads, proxies are MPIProxy threads) and the PROCESS world
(``transport="proc"``: ranks are forked OS processes behind per-rank
socket proxy endpoints — core/procworld.py, DESIGN.md §10).  Checkpoints
restore across substrates in both directions, and across the two
packages.  This module imports no ``torch``: the process world forks rank
children from it, and a forked child must stay off torch."""
from __future__ import annotations

import os
import pickle
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

from repro_torch.checkpoint import chunkstore
from repro_torch.checkpoint.chunkstore import ChunkStoreBackend, StoreSpec
from repro_torch.core import rankloop
from repro_torch.core import recovery as _recovery
from repro_torch.core import trace as _trace
from repro_torch.core.api import MPI, remap_mpi_snapshot
from repro_torch.core.ckpt_protocol import (RankImage, commit_manifest,
                                      load_manifest, load_rank_image,
                                      save_rank_image)
from repro_torch.core.dataplane import ContributionLedger, RingRef
from repro_torch.core import migrate as migration
from repro_torch.core.coordinator import (Coordinator, Membership,
                                          PHASE_DRAIN, PHASE_EXIT,
                                          PHASE_JOIN, PHASE_PENDING,
                                          PHASE_RESUME, PHASE_RUN)
from repro_torch.core.proxy import MPIProxy, ProxyChannel
from repro_torch.core.transport import make_transport
from repro_torch.core.tunables import LEDGER_ENABLED
from repro_torch.core.virtualization import make_rank_map


class _ThreadRankHost(rankloop.RankHost):
    """Thread-world substrate adapter: the unified rank loop
    (core/rankloop.py) talking to the in-process MPIJob."""

    def __init__(self, job: "MPIJob", rank: int):
        super().__init__(job.step_fn)
        self.job = job
        self.rank = rank
        self.mig_done = job._mig_rounds_done.get(rank, 0)

    def tick(self, mpi) -> None:
        self.job.heartbeat.ping(self.rank)   # arm before a maybe-long step

    def trigger_step(self, coord):
        # under the fire lock: a reader arriving mid-fire blocks until the
        # phase flip is visible instead of slipping past the boundary on a
        # (trigger popped, phase still RUN) transient
        with self.job._ckpt_lock:
            trig = self.job._trigger
        return trig[0] if trig is not None else None

    def fire_trigger(self, mpi) -> None:
        # first rank to reach the trigger step fires it (a rank-0-only
        # trigger lets other ranks race past the boundary before the
        # request ever goes out).  The whole pop + request runs UNDER the
        # lock: a peer that lost the pop race blocks here until the phase
        # flip is visible, so no rank can slip past the agreed boundary
        # into the next step — the agreement is deterministic (and the
        # FSM traces with it)
        with self.job._ckpt_lock:
            trig, self.job._trigger = self.job._trigger, None
            if trig is not None:
                try:
                    self.job.checkpoint(trig[1], resume=trig[2])
                except RuntimeError:
                    # lost the race with a recovery epoch opening: re-arm
                    # so the first post-recovery boundary fires it instead
                    self.job._trigger = trig

    def stream_round(self, mpi, state, step: int, round_no: int) -> None:
        self.job._stream_round(self.rank, state, step, round_no)

    def record_step(self, mpi, wall: float, compute: float) -> None:
        # step-boundary liveness: push buffered fire-and-forget sends so
        # peers blocked in Recv can see them (no round trip)
        mpi.flush_async()
        self.job.heartbeat.ping(self.rank)
        self.job.stragglers.record(self.rank, wall, compute=compute)
        self.job.coord.report_telemetry(self.rank, mpi.telemetry(),
                                        generation=mpi.generation)

    def assert_empty(self, mpi) -> None:
        assert mpi.channel.is_empty(), \
            f"rank {self.rank}: proxy channel not empty at snapshot"

    def drained_stat(self, mpi) -> None:
        self.job.coord.stat_add("drained_messages", len(mpi.cache))

    def save_image(self, mpi, state, step: int) -> bool:
        job = self.job
        coord = job.coord
        # a migration final saves the app payload leaf-split: every leaf
        # pre-copy already streamed is a store reference, so the
        # stop-the-world window ships only the final dirty delta
        mig = coord.migrating
        leaves = migration.split_state(state) if mig else None
        image = RankImage(rank=self.rank, n_ranks=job.n, step_idx=step,
                          mpi_state=mpi.snapshot(),
                          app_state=(b"" if leaves is not None
                                     else pickle.dumps(state)))
        entry = save_rank_image(job._ckpt_dir, image,
                                store=job._ckpt_chunks, app_leaves=leaves)
        job._commit_rank_entry(self.rank, entry, step)
        return bool(mig and self.rank in coord.join_expected)

    def wait_phase_alive(self, mpi, *phases: str) -> str:
        return self.job._wait_phase_alive(self.rank, *phases)

    def ckpt_trace_ctx(self, mpi):
        # in-process: read the coordinator's active round/epoch span
        # directly (the process world pulls the same ctx off the wire)
        return self.job.coord.trace_ctx()

    def finish(self, mpi, state) -> None:
        self.job.states[self.rank] = state
        self.job.results[self.rank] = state
        self.job.coord.mark_finished(self.rank)


class MPIJob:
    def __init__(self, n_ranks: int,
                 step_fn: Callable[[MPI, Any, int], Any],
                 init_fn: Callable[[MPI], Any],
                 transport: str = "shm",
                 heartbeat_timeout: float = 5.0,
                 membership: Optional[Membership] = None,
                 coord_timeout: float = 60.0,
                 ckpt_store: Optional[str | Path | StoreSpec
                                      | ChunkStoreBackend] = None):
        self.n = n_ranks
        self.step_fn = step_fn
        self.init_fn = init_fn
        self.transport_name = transport
        #: shared content-addressed chunk store for incremental rank
        #: images: consecutive checkpoints (possibly in different dirs)
        #: reference unchanged payloads instead of rewriting them
        #: (DESIGN.md §9).  Anything ``chunkstore.open_store`` resolves:
        #: a directory path, a ``StoreSpec``, a canonical spec string
        #: (``remote://host:port[?cache=DIR]``, or the sharded
        #: ``remote://h1:p1,h2:p2,...?replicas=R`` form — DESIGN.md §11,
        #: §15), or a built backend.  None keeps every checkpoint dir
        #: self-contained.
        self.ckpt_store = ckpt_store if ckpt_store else None
        self.coord = Coordinator(n_ranks, membership=membership,
                                 timeout=coord_timeout)
        self.transport = make_transport(transport)
        self.transport.start(n_ranks)
        if getattr(self.transport, "proc_world", False):
            # PROCESS world (DESIGN.md §10): ranks are real OS processes
            # forked at run() time; their proxies are per-rank endpoint
            # threads in THIS process (core/procworld.py).  Keyed off the
            # transport's `proc_world` attribute so ring-enabled variants
            # ("shmring") inherit the whole launch path.  No in-process
            # plugin objects exist — snapshots restore in the children.
            from repro_torch.core.procworld import ProcWorld
            self.channels: List[ProxyChannel] = []
            self.proxies: List[MPIProxy] = []
            self.mpis: List[MPI] = []
            self._proc = ProcWorld(self)
        else:
            self._proc = None
            self.channels = [ProxyChannel() for _ in range(n_ranks)]
            self.proxies = [MPIProxy(r, self.transport, self.channels[r])
                            for r in range(n_ranks)]
            for p in self.proxies:
                p.start()
            self.mpis = [MPI(r, n_ranks, self.channels[r], self.coord)
                         for r in range(n_ranks)]
        #: proc mode: rank -> remapped MPI snapshot, applied by the forked
        #: child (admin replay runs against ITS endpoint, not in-process)
        self._restore_snaps: Dict[int, dict] = {}
        self.states: List[Any] = [None] * n_ranks
        self.start_steps = [0] * n_ranks
        self.results: List[Any] = [None] * n_ranks
        self.errors: Dict[int, BaseException] = {}
        self._err_lock = threading.Lock()
        self._ckpt_dir: Optional[Path] = None
        self._ckpt_chunks: Optional[ChunkStoreBackend] = None
        self._ckpt_store_obj: Optional[ChunkStoreBackend] = None
        self._ckpt_meta: Dict[int, dict] = {}
        self._ckpt_lock = threading.Lock()
        # serializes stats() snapshot assembly (satellite of DESIGN.md
        # §16: one consistent view, not a merge of live mutating dicts)
        self._stats_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._restored = False
        self._trigger: Optional[tuple] = None   # (step, dir, resume)
        #: live-migration (DESIGN.md §13) per-rank streaming state: the
        #: chunk names shipped last round (the digest-diff baseline) and
        #: the highest round each rank has streamed
        self._mig_digests: Dict[int, Dict[str, str]] = {}
        self._mig_rounds_done: Dict[int, int] = {}
        #: ranks whose thread is a hot-joined replacement: start from
        #: states[rank]/start_steps[rank] instead of init_fn
        self._resume_ranks: set = set()
        self._n_steps: Optional[int] = None
        #: set by an elastic restart: how this world was reshaped from the
        #: checkpointed one (recorded into the next manifest's meta)
        self.restore_info: Optional[dict] = None
        from repro_torch.distributed.faults import (HeartbeatMonitor,
                                              StragglerTracker)
        self.heartbeat = HeartbeatMonitor(n_ranks, timeout_s=heartbeat_timeout)
        self.stragglers = StragglerTracker(n_ranks)
        #: retained-send-buffer ledger for mid-collective recovery
        #: (DESIGN.md §14): every rank pins its input to the in-flight
        #: collective here; the parent replays a dead rank's step from it.
        #: In the process world children ship contributions over their
        #: endpoint sockets into this same parent-side instance.
        self.ledger = (ContributionLedger(n_ranks)
                       if LEDGER_ENABLED else None)
        #: per-rank FSM traces from the unified rank loop (parity suite)
        self._fsm_traces: Dict[int, list] = {}
        # blocked-but-alive ranks keep the heartbeat beating (a rank parked
        # in Recv is NOT dead; one whose thread died stops pinging at once)
        for r, m in enumerate(self.mpis):
            m._on_idle = (lambda rr=r: self.heartbeat.ping(rr))
            m.ledger = self.ledger

    # ------------------------------------------------------------------ run
    def _rank_main(self, rank: int, n_steps: int) -> None:
        """Thin thread wrapper over the unified rank loop
        (rankloop.run_rank): init-or-restore, run, record the outcome."""
        mpi = self.mpis[rank]
        host = _ThreadRankHost(self, rank)
        try:
            if self._restored or rank in self._resume_ranks:
                state = self.states[rank]
                host.trace("restore", self.start_steps[rank])
            else:
                mpi.Init()
                state = self.init_fn(mpi)
                host.trace("init")
            # run() semantics are absolute: run(N) executes steps [start, N)
            status, state = rankloop.run_rank(
                host, mpi, state, self.start_steps[rank], n_steps)
            if status == "exit":
                self.states[rank] = state
            # "migrated": the replacement thread owns states[rank] now —
            # do not clobber it; "done" already stored via host.finish
        except BaseException as e:  # noqa: BLE001 - surfaced to driver
            with self._err_lock:
                self.errors[rank] = e
            raise
        finally:
            with self._ckpt_lock:
                self._fsm_traces.setdefault(rank, []).extend(host.events)

    def _commit_rank_entry(self, rank: int, entry: dict, step: int) -> None:
        """Record one rank's image entry; the LAST entry commits the
        manifest.  Shared by the thread world (rank threads land here
        directly) and the process world (children write their own images;
        their endpoints call this — agreement and the commit stay with the
        parent, DESIGN.md §10).  After a mid-collective recovery the world
        is SPARSE (dead world ranks removed, survivors not renumbered):
        the manifest commits on the LIVE count and records the holes so a
        later restart can compact over them."""
        with self._ckpt_lock:
            self._ckpt_meta[rank] = entry
            live = self.coord.live_set
            if len(self._ckpt_meta) == len(live):
                meta = {"transport": self.transport_name, "step": step,
                        "world_size": self.n}
                if len(live) < self.n:
                    meta["recovered_dead_ranks"] = sorted(
                        set(range(self.n)) - live)
                if self.restore_info is not None:
                    meta["elastic"] = self.restore_info
                root = getattr(self._ckpt_chunks, "root", None)
                commit_manifest(self._ckpt_dir, self._ckpt_meta, meta=meta,
                                generation=self.coord.generation,
                                chunk_dir=(os.path.relpath(
                                    root, self._ckpt_dir)
                                    if root is not None else None),
                                store_spec=getattr(self._ckpt_chunks,
                                                   "fetch_spec", None))

    def _wait_phase_alive(self, rank: int, *phases: str) -> str:
        """wait_phase that keeps the heartbeat beating: a rank parked here
        while a slower peer writes a large image must not be declared
        dead.  Overall deadline is still the coordinator's timeout."""
        deadline = time.time() + self.coord.timeout
        while True:
            self.heartbeat.ping(rank)
            try:
                return self.coord.wait_phase(
                    *phases, timeout=min(0.25, self.coord.timeout))
            except TimeoutError:
                if time.time() > deadline:
                    raise TimeoutError(
                        f"waiting for {phases} after "
                        f"{self.coord.timeout:g}s") from None

    def run(self, n_steps: int, timeout: float = 300.0) -> List[Any]:
        # re-arm heartbeats NOW: image load / admin replay between
        # construction and run() must not count against the first pings
        for r in range(self.n):
            self.heartbeat.reset(r)
        self._n_steps = n_steps
        if self._proc is not None:
            return self._proc.run(n_steps, timeout)
        self._threads = [
            threading.Thread(target=self._rank_main, args=(r, n_steps),
                             daemon=True, name=f"rank-{r}")
            for r in range(self.n)]
        for t in self._threads:
            t.start()
        deadline = time.time() + timeout
        for t in self._threads:
            t.join(max(deadline - time.time(), 0.001))
            if t.is_alive():
                raise TimeoutError(f"{t.name} did not finish")
        if self.errors:
            # a rank recovered mid-collective is gone from the live set by
            # the time the survivors can finish (finalize runs inside the
            # last resume poll) — its death is an absorbed fault, not a
            # job failure, even if recover() hasn't popped the record yet
            live = self.coord.live_set
            fatal = [(r, e) for r, e in self.errors.items() if r in live]
            if fatal:
                rank, err = fatal[0]
                raise RuntimeError(f"rank {rank} failed: {err!r}") from err
        return self.results

    # ------------------------------------------------------------ checkpoint
    def _store_backend(self) -> Optional[ChunkStoreBackend]:
        """THE job-level resolution point for ``ckpt_store``: every path
        that needs the shared backend — checkpoint saves, restart image
        loads, migration destinations — funnels through here, so the
        str/Path/StoreSpec/backend handling lives in exactly one place
        (``chunkstore.open_store``) and the job memoizes ONE backend for
        its lifetime: a remote store keeps its connections + presence
        knowledge across checkpoint boundaries (mirrors
        procworld._child_store on the child side).  None when the job
        has no shared store (self-contained checkpoint dirs)."""
        if self.ckpt_store is None:
            return None
        if self._ckpt_store_obj is None:
            self._ckpt_store_obj = chunkstore.open_store(self.ckpt_store)
        return self._ckpt_store_obj

    def _prepare_ckpt(self, ckpt_dir: str | Path) -> None:
        self._ckpt_dir = Path(ckpt_dir)
        self._ckpt_chunks = (self._store_backend()
                             or chunkstore.open_store(
                                 None, default=self._ckpt_dir / "chunks"))
        self._ckpt_meta = {}

    def checkpoint(self, ckpt_dir: str | Path, resume: bool = True) -> None:
        """Asynchronous checkpoint request (any thread, any time)."""
        over = (self._proc.finished() if self._proc is not None
                else self.coord.all_finished()
                and all(not t.is_alive() for t in self._threads))
        if over:
            raise RuntimeError("job already finished; nothing to checkpoint")
        self._prepare_ckpt(ckpt_dir)
        self.coord.request_checkpoint(resume=resume)

    def checkpoint_at(self, step: int, ckpt_dir: str | Path,
                      resume: bool = True) -> None:
        """Deterministic trigger: rank 0 requests the checkpoint when it
        reaches `step` (the DMTCP coordinator's interval-checkpoint mode)."""
        self._ckpt_dir = Path(ckpt_dir)
        self._trigger = (step, Path(ckpt_dir), resume)

    def wait_checkpoint(self, timeout: float = 120.0) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._ckpt_lock:
                if len(self._ckpt_meta) >= len(self.coord.live_set):
                    return
            time.sleep(0.001)
        raise TimeoutError("checkpoint did not complete")

    # -------------------------------------------- live migration (§13)
    def _stream_round(self, rank: int, state: Any, step: int,
                      round_no: int) -> None:
        """One pre-copy round for one rank, at a step boundary while the
        world keeps running: digest-diff against the last streamed round,
        upload only the dirty leaves, report the entry."""
        entry, digests = migration.stream_round(
            self._ckpt_chunks, state, self._mig_digests.get(rank, {}))
        entry["step_idx"] = step
        self._mig_digests[rank] = digests
        self._mig_rounds_done[rank] = round_no
        self.coord.report_round(rank, round_no, entry,
                                generation=self.mpis[rank].generation)

    def migrate(self, ckpt_dir: str | Path, ranks: Sequence[int] = (0,),
                dest_cache: Optional[str | Path] = None,
                max_rounds: int = 8, min_shrink: float = 0.25,
                timeout: Optional[float] = None,
                lease_ttl: float = 600.0) -> dict:
        """Pre-copy live migration (DESIGN.md §13): move `ranks` to a
        "new host" with the pause bounded by the final dirty delta, not
        total state size.

        Phase 1 (world keeps computing): stream rounds of app-state
        chunks to the checkpoint store — each round ships only leaves
        dirtied since the last (digest-diff); streamed-but-uncommitted
        chunks are pinned under a gc lease; with `dest_cache` set and a
        remote store, each round is also prefetched into the destination
        cache.  Rounds stop when the dirty set reaches zero or stops
        shrinking by at least `min_shrink` per round.

        Phase 2 (stop-the-world): one checkpoint FSM pass with leaf-split
        images (pre-copied leaves are references), then replacements for
        `ranks` restore through the destination store (fetch-on-miss
        pulls only what pre-copy didn't stage) and hot-join the RUNNING
        generation at the join barrier — same generation, no restart.

        Blocks the calling thread (drive it beside run() like the fault
        driver does); returns a report with per-round dirty bytes, the
        pause wall-time and the final-round wire fraction."""
        coord = self.coord
        timeout = coord.timeout if timeout is None else timeout
        ranks = sorted(set(int(r) for r in ranks))
        bad = [r for r in ranks if not 0 <= r < self.n]
        if bad:
            raise ValueError(f"migrate ranks {bad} outside world of {self.n}")
        over = (self._proc.finished() if self._proc is not None
                else self.coord.all_finished()
                and all(not t.is_alive() for t in self._threads))
        if over:
            raise RuntimeError("job already finished; nothing to migrate")
        self._prepare_ckpt(ckpt_dir)
        store = self._ckpt_chunks
        spec = (getattr(store, "fetch_spec", None)
                or getattr(store, "spec", None))
        remote = None
        if spec is not None:
            sp = StoreSpec.parse(str(spec))
            if sp.scheme == "remote":
                remote = sp
        remote_spec = remote.canonical() if remote is not None else None
        dest = None
        if dest_cache is not None and remote is not None:
            # destination = the SAME store (endpoints, namespace,
            # replication — sharded specs compose for free) seen through
            # the new host's cache dir
            dest = chunkstore.open_store(remote.with_cache(dest_cache))
        lease_id = f"migrate-{os.getpid()}-{os.urandom(3).hex()}"
        rounds: List[dict] = []
        prefetched: set = set()
        staged: set = set()       # every chunk any pre-copy round shipped
        # thread world: materialise the replacements' states at the
        # destination DURING the rounds, so the pause patches only the
        # final delta (process-world children restore in the forked
        # replacement instead — the parent can't hand objects across)
        staging: Optional[Dict[int, migration.StagedState]] = None
        if self._proc is None:
            staging = {r: migration.StagedState(dest or store)
                       for r in ranks}
        prev_dirty: Optional[int] = None
        converged = False
        mig_span = _trace.begin("migrate", cat="coord",
                                generation=coord.generation,
                                args={"ranks": list(ranks),
                                      "max_rounds": max_rounds})
        for k in range(1, max_rounds + 1):
            # each pre-copy round is a span nested under the migrate
            # root; break exits close the round span cleanly
            with _trace.span("migrate.round", parent=mig_span, cat="coord",
                             args={"round": k}) as rspan:
                coord.begin_round(k)
                entries = coord.wait_round(k, timeout=timeout)
                migration.write_round_manifest(
                    self._ckpt_dir, k, entries, generation=coord.generation,
                    store_spec=remote_spec)
                chunks = migration.entries_chunks(entries)
                staged |= chunks
                if hasattr(store, "lease"):
                    try:  # pin: a concurrent gc can never collect the round
                        store.lease(chunks, ttl=lease_ttl, lease_id=lease_id)
                    except (ConnectionError, OSError):
                        pass
                dirty = sum(e.get("shipped_bytes", 0)
                            for e in entries.values())
                total = sum(e.get("total_bytes", 0)
                            for e in entries.values())
                rounds.append({"round": k, "dirty_bytes": dirty,
                               "total_bytes": total})
                rspan.end(dirty_bytes=dirty, total_bytes=total)
                if dest is not None:
                    # warm the destination while the world runs: the
                    # join-time fetch then misses only the final delta.
                    # Batched when the destination can (one get_many per
                    # shard per batch); per-name fallback otherwise.
                    fresh = sorted(chunks - prefetched)
                    pf = getattr(dest, "prefetch", None)
                    if pf is not None:
                        try:
                            pf(fresh)
                        except (OSError, KeyError):
                            pass
                    else:
                        for name in fresh:
                            try:
                                dest.get(name)
                            except (OSError, KeyError):
                                pass
                    prefetched.update(fresh)
                if staging is not None:
                    for r in ranks:
                        if r in entries:
                            staging[r].absorb(entries[r])
                if dirty == 0:
                    converged = True
                    break
                if (prev_dirty is not None
                        and dirty > (1.0 - min_shrink) * prev_dirty):
                    converged = True  # dirty set stopped shrinking: drain
                    break
                prev_dirty = dirty
        # ---- stop-the-world final delta + hot-join
        t0 = time.time()
        with _trace.span("migrate.final", parent=mig_span, cat="coord"):
            coord.request_migration_final(ranks)
            coord.wait_phase(PHASE_JOIN, timeout=timeout)
            self._spawn_replacements(ranks, dest or store, staging)
            coord.wait_phase(PHASE_RUN, PHASE_PENDING, PHASE_DRAIN,
                             timeout=timeout)
        pause = time.time() - t0
        coord.stat_add("migrate_pause_s", pause)
        mig_span.end(rounds=len(rounds), converged=converged,
                     pause_s=round(pause, 6))
        # wire accounting from the committed manifest (substrate-free: in
        # the process world children upload through their own store
        # connections, so parent-side store counters see nothing): the
        # final round shipped exactly the parts no pre-copy round staged
        man = load_manifest(self._ckpt_dir)
        parts = [p for e in man["ranks"].values()
                 for p in e["parts"].values()]
        total_ck = sum(p["bytes"] for p in parts)
        final_bytes = sum(p["bytes"] for p in parts
                          if p["chunk"] not in staged)
        if hasattr(store, "unlease"):
            try:   # rounds are covered by the committed manifest now
                store.unlease(lease_id)
            except (ConnectionError, OSError):
                pass
        return {"dir": str(self._ckpt_dir), "ranks": ranks,
                "rounds": rounds, "converged": converged,
                "pause_s": pause, "final_bytes": final_bytes,
                "total_bytes": total_ck,
                "final_fraction": (final_bytes / total_ck
                                   if total_ck else 0.0)}

    def _spawn_replacements(self, ranks: Sequence[int], img_store,
                            staging=None) -> None:
        """Start a replacement for each migrated rank: restore its app
        state from the just-committed manifest THROUGH the destination
        store (fetch-on-miss — the "new host" path), then hand the rank
        to a thread that hot-joins the live generation.  MPI state stays
        behind the proxy (the paper's argument): the plugin-side objects
        survive the move untouched in the thread world, and the process
        world replays them into the replacement child.  With `staging`
        (migrate()'s per-rank StagedState) the pre-copied leaves are
        already live objects; only the final delta is fetched here."""
        if self._proc is not None:
            spec = getattr(img_store, "spec", None)
            self._proc.spawn_replacements(ranks, self._n_steps or 0,
                                          str(spec) if spec else None)
            return
        man = load_manifest(self._ckpt_dir)
        for r in ranks:
            ent = man["ranks"][str(r)]
            st = staging.get(r) if staging else None
            if (st is not None
                    and any(k.startswith("app/") for k in ent["parts"])):
                self.states[r], _ = st.materialize(ent)
                self.start_steps[r] = ent["step_idx"]
            else:
                img = load_rank_image(self._ckpt_dir, r, store=img_store)
                self.states[r] = img.state_obj()
                self.start_steps[r] = img.step_idx
            self._resume_ranks.add(r)
            self.heartbeat.reset(r)
            t = threading.Thread(target=self._replacement_main,
                                 args=(r, self._n_steps or 0),
                                 daemon=True, name=f"rank-{r}-joined")
            self._threads.append(t)
            t.start()

    def _replacement_main(self, rank: int, n_steps: int) -> None:
        """A migrated rank's replacement: state already staged from the
        committed manifest; announce at the join barrier, complete the
        resume handshake the departed thread would have run, then behave
        like any other rank."""
        mpi = self.mpis[rank]
        coord = self.coord
        try:
            coord.hot_join(rank, generation=mpi.generation)
            phase = self._wait_phase_alive(rank, PHASE_RESUME, PHASE_EXIT)
            if phase == PHASE_EXIT:
                return
            coord.resume_running(rank)
            self._wait_phase_alive(rank, PHASE_RUN, PHASE_PENDING,
                                   PHASE_DRAIN)
        except BaseException as e:  # noqa: BLE001 - surfaced to driver
            with self._err_lock:
                self.errors[rank] = e
            raise
        self._rank_main(rank, n_steps)

    def failed_ranks(self) -> List[int]:
        """Thread-safe snapshot of ranks whose thread raised (the driver's
        monitor polls this concurrently with rank threads failing)."""
        with self._err_lock:
            return sorted(self.errors)

    def abort(self, reason: str) -> None:
        """Cancel a running job: every rank — stepping, blocked in Recv, or
        draining — raises JobAborted at its next check instead of waiting
        out a timeout.  Used by the fault-tolerant driver the moment the
        heartbeat flags a dead rank (seconds, not Recv-timeout minutes)."""
        self.coord.abort(reason)
        # faults are exactly when the ring matters: persist it (no-op
        # unless REPRO_TRACE_DIR is set)
        _trace.dump(role="driver")

    # ------------------------------------------- mid-collective recovery
    def recover(self, dead: Sequence[int], timeout: float = 10.0) -> dict:
        """Survivor-only mid-collective recovery (DESIGN.md §14): finish
        the in-flight step over the live ranks and keep THIS world
        running — no generation bump, no restart, zero recomputation.

        Opens a recovery epoch at the coordinator (raises
        RecoveryUnavailable if the failure is not recoverable: wrong
        phase, multi-failure, or the dead rank left no pinned
        contribution in the ledger), then waits for every survivor to
        enlist, quiesce, patch its world tables and resume.  On success
        the dead rank's transport/heartbeat/error bookkeeping is cleared
        and the epoch report is returned; on timeout the epoch is
        cancelled and RecoveryFailed is raised — the caller falls back to
        the classic bump→abort→reshaped-restart."""
        dead = tuple(sorted({int(r) for r in dead}))
        token = self.coord.begin_recovery(dead, self.ledger)
        deadline = time.time() + timeout
        while True:
            st = self.coord.recovery_status(token)
            if st is not None:
                break
            # drain the dead ranks' transport inboxes: envelopes addressed
            # to a corpse must not linger as phantom in-flight traffic —
            # and in a shmring world their RingRef descriptors must be
            # read out, or the dead rank's unclaimed slots would trip the
            # ring.in_flight()==0 invariant at the next checkpoint
            ring = self._proc.ring if self._proc is not None else None
            for r in dead:
                try:
                    for env in self.transport.poll_all(r):
                        if ring is not None and isinstance(
                                getattr(env, "payload", None), RingRef):
                            ring.read(env.payload)
                except Exception:
                    pass
            if time.time() > deadline:
                self.coord.cancel_recovery(token, "timeout")
                raise _recovery.RecoveryFailed(
                    f"recovery of ranks {list(dead)} timed out "
                    f"after {timeout:g}s")
            time.sleep(0.002)
        if not st.get("ok"):
            raise _recovery.RecoveryFailed(
                st.get("error") or "recovery cancelled")
        # parent bookkeeping: the dead rank is no longer a member — stop
        # monitoring it, forget its error, and (process world) mark its
        # corpse reaped so wait() does not re-record the kill as a fault
        for r in dead:
            if self._proc is not None:
                with self._proc._lock:
                    self._proc._done.add(r)
            self.heartbeat.remove(r)
            self.stragglers.forget(r)
            with self._err_lock:
                self.errors.pop(r, None)
        st = dict(st)
        st["dead"] = list(dead)
        return st

    def fsm_trace(self, rank: int) -> list:
        """The rank's lifecycle trace from the unified loop (one tuple per
        event) — the cross-substrate parity suite asserts thread and
        process worlds produce identical traces for the same program."""
        with self._ckpt_lock:
            return list(self._fsm_traces.get(rank, []))

    def stats(self) -> dict:
        """Operator-facing job statistics (DESIGN.md §12): coordinator FSM
        counters, the per-generation data-plane telemetry aggregate
        (compute/wait split, bytes per fabric), the straggler tracker's
        per-rank wall/compute/wait report, and — when the checkpoint
        store is a sharded tier — per-shard health (DESIGN.md §15).

        One CONSISTENT snapshot: each sub-source is registry-backed (a
        locked ``metrics.MetricGroup`` or an internally locked reporter)
        so its snapshot is atomic, and the whole merge runs under the
        job's stats lock — rank threads bumping counters mid-call can no
        longer tear the view or blow up a dict iteration."""
        with self._stats_lock:
            store = self._ckpt_chunks or self._ckpt_store_obj
            health = getattr(store, "health", None)
            return {
                "transport": self.transport_name,
                "world_size": self.n,
                "live_ranks": sorted(self.coord.live_set),
                "generation": self.coord.generation,
                "coordinator": self.coord.stats.snapshot(),
                "telemetry": self.coord.telemetry_summary(),
                "stragglers": self.stragglers.report(),
                "ledger": (self.ledger.snapshot_stats()
                           if self.ledger is not None else None),
                "ckpt_store": health() if health is not None else None,
            }

    def dump_trace(self, trace_dir: Optional[str | Path] = None):
        """Dump THIS process's flight-recorder ring (spans from the
        coordinator FSM, proxies/endpoints, checkpoint pipeline and chunk
        client — in the process world rank children dump their own rings
        on exit).  Target: `trace_dir` or REPRO_TRACE_DIR; returns the
        written path, or None when neither is set.  Merge per-process
        dumps with ``python -m repro_torch.core.trace merge <dir>``."""
        return _trace.dump(
            role="driver",
            trace_dir=str(trace_dir) if trace_dir is not None else None)

    def rank_pids(self) -> Dict[int, int]:
        """PID-based membership view of a PROCESS world (rank -> pid of
        its live OS process); empty for thread worlds.  This is what real
        fault injection targets: ``os.kill(job.rank_pids()[r], SIGKILL)``
        (distributed/faults.kill_rank_process)."""
        return self._proc.pids() if self._proc is not None else {}

    def stop(self) -> None:
        """Deterministic, leak-free teardown: stop every proxy (a
        fire-and-forget STOP — see MPIProxy.stop for why it must not be
        replied), JOIN the proxy threads, then stop the transport (which
        joins its own reader/switchboard threads).  A process world
        additionally SIGTERM -> SIGKILLs any rank process still alive and
        reaps its exit code — no orphans survive a stop()."""
        if self._proc is not None:
            self._proc.stop()
            self.transport.stop()
            _trace.dump(role="driver")
            return
        for p in self.proxies:
            try:
                p.stop()
            except Exception:
                pass
        for p in self.proxies:
            p.join(timeout=5.0)
        self.transport.stop()
        _trace.dump(role="driver")

    # --------------------------------------------------------------- restart
    @classmethod
    def restart(cls, ckpt_dir: str | Path,
                step_fn: Callable[[MPI, Any, int], Any],
                init_fn: Callable[[MPI], Any],
                transport: str = "shm",
                world_size: Optional[int] = None,
                dead_ranks: Sequence[int] = (),
                membership: Optional[Membership] = None,
                heartbeat_timeout: float = 5.0,
                coord_timeout: float = 60.0,
                ckpt_store: Optional[str | Path | StoreSpec
                                     | ChunkStoreBackend] = None
                ) -> "MPIJob":
        """Reconstruct a job from a checkpoint on ANY transport — and, when
        `world_size` / `dead_ranks` reshape the world, for ANY topology:

          * fresh proxies + transport (the switchboard is rebuilt for the
            NEW world size), admin-log replay, cache preload;
          * survivors compact over the holes left by `dead_ranks` (the
            old→new rank map from `make_rank_map`);
          * a grown world seeds its new members from survivor images
            (communicator layout + collective sequence cloned, in-flight
            history cleared);
          * `membership` (usually the driver's, already bumped past the
            dead generation) makes every stale-generation message from a
            zombie of the old world rejectable.

        The reshape is recorded in `job.restore_info` and stamped into the
        next checkpoint manifest this job writes."""
        ckpt_dir = Path(ckpt_dir)
        man = load_manifest(ckpt_dir)
        man_meta = man.get("meta", {})
        # a checkpoint taken AFTER a mid-collective recovery is sparse:
        # the manifest's n_ranks counts live entries only, world_size the
        # original shape, and recovered_dead_ranks the holes — fold them
        # into dead_ranks so the reshape map compacts over both
        old_n = int(man_meta.get("world_size", man["n_ranks"]))
        dead = tuple(sorted({int(r) for r in dead_ranks}
                            | {int(r) for r in
                               man_meta.get("recovered_dead_ranks", ())}))
        bad = [r for r in dead if not 0 <= r < old_n]
        if bad:
            raise ValueError(f"dead_ranks {bad} outside world of {old_n}")
        new_n = world_size if world_size is not None else old_n - len(dead)
        survivors = [r for r in range(old_n) if r not in dead]
        if new_n < 1 or not survivors:
            raise ValueError(
                f"cannot restart: world_size={new_n}, "
                f"{len(survivors)} surviving rank images")
        reshaped = (new_n != old_n) or bool(dead)
        job = cls(new_n, step_fn, init_fn, transport=transport,
                  heartbeat_timeout=heartbeat_timeout,
                  membership=membership, coord_timeout=coord_timeout,
                  ckpt_store=ckpt_store)
        rank_map = make_rank_map(old_n, new_n, dead)
        sources: Dict[int, int] = {}
        images: Dict[int, RankImage] = {}    # grow clones reuse one load
        claimed: Set[int] = set()            # images whose obj is taken
        # image reads route through the restart's store — resolved by the
        # SAME job-level point the save path uses (_store_backend), so
        # str/Path/StoreSpec/backend handling cannot diverge between save
        # and restore.  On a fresh host (empty cache) only the parts the
        # cache lacks are fetched from the chunk service; without a store
        # the manifest's recorded canonical spec still covers the local
        # misses (DESIGN.md §11).  The restored job's checkpoints reuse
        # the backend (connection + presence knowledge already warm).
        img_store = job._store_backend()
        with _trace.span("restore.images", cat="ckpt",
                         args={"dir": ckpt_dir.name, "world": new_n,
                               "reshaped": reshaped}):
            for r in range(new_n):
                src = survivors[r % len(survivors)]
                sources[r] = src
                if src not in images:
                    images[src] = load_rank_image(ckpt_dir, src,
                                                  store=img_store)
                img = images[src]
                snap = img.mpi_state
                if reshaped:
                    snap = remap_mpi_snapshot(snap, rank_map, r, new_n,
                                              clone=r >= len(survivors))
                if job._proc is not None:
                    # process world: the snapshot restores INSIDE the
                    # forked child (admin replay must run against the
                    # child's own endpoint); stash it for fork-time
                    # inheritance
                    job._restore_snaps[r] = snap
                else:
                    job.mpis[r].restore(snap)
                # first taker of an image gets the materialised object (no
                # re-pickle pass); clones of the same image get private
                # copies
                job.states[r] = img.state_obj(fresh=src in claimed)
                claimed.add(src)
                job.start_steps[r] = img.step_idx
        job._restored = True
        if reshaped:
            job.restore_info = {
                "from": ckpt_dir.name,
                "old_world": old_n,
                "new_world": new_n,
                "dead_ranks": list(dead),
                "rank_map": {str(o): n for o, n in rank_map.items()},
                "sources": {str(r): s for r, s in sources.items()},
                "generation": job.coord.generation,
                "from_transport": man.get("meta", {}).get("transport"),
                "to_transport": transport,
            }
        return job
