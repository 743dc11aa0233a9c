"""The PROCESS world — ranks as real OS processes behind socket proxies
(DESIGN.md §10).

The paper's whole argument is that the proxy is a *separate process* from
the MPI application: the app's address space holds no MPI state, so a
checkpoint of the app alone restores onto any implementation.  The thread
world simulates that boundary; this module makes it real.  Selecting
``MPIJob(..., transport="proc")``:

  * LAUNCHER (parent) — ``ProcWorld`` forks one child process per rank,
    accepts one socket per rank, and runs a per-rank ENDPOINT thread that
    owns a ``ProxyCore`` (sequence numbers + comm tables) over the
    parent-side ``ProcTransport`` fabric.  The endpoint speaks the SAME
    versioned batch wire protocol as the in-thread ProxyChannel, framed
    exactly like TcpTransport frames (``read_frame``/``write_frame``).
    Membership is over PIDs: the launcher reaps exit codes, pings the
    heartbeat on every frame a rank sends, and a torn/half-written socket
    (a SIGKILLed child) is recorded as a dead rank the instant its
    connection drops — no timeout needed.
  * RANK CHILD — ``_child_main`` runs the same step loop as
    ``MPIJob._rank_main`` against a ``SocketChannel`` (ProxyChannel
    look-alike over the socket) and a ``CoordClient`` (Coordinator
    look-alike: replied calls are RPCs; phase/abort/ckpt-round piggyback
    on EVERY reply, so the cached view is at most one round trip stale).
    At a checkpoint the CHILD writes its own rank image into the shared
    content-addressed chunk store; agreement and the manifest commit stay
    with the parent (``ckpt_entry``).

Children are forked (not spawned): step/init closures and restored
snapshots transfer by address-space inheritance, never by pickling — the
same reason the checkpoint images stay implementation-free.  Fork-safety
caveat: the launcher may host background threads and state a fork does
not carry over (torch's intra-op pool, a CUDA context, a process group,
a checkpoint manager's writer pool), and forking a multithreaded process
is only safe for children that avoid the affected libraries — which is
why nothing a rank child runs imports ``torch`` (the core package,
``distributed.proxy_grad``, ``distributed.faults``, the chunk store and
service, ``launch.procrun``; proxy_grad is pure numpy for exactly this
reason), and why a launcher that saves tensors waits for its manager
before it forks.  If a child ever wedges pre-connect anyway, the
layered mitigations bound the damage: per-test timeouts fail the test,
the driver's heartbeat declares the silent rank dead and restarts
reshaped, and stop()/the conftest reaper SIGKILL stragglers.

Wire protocol additions (served by the endpoint, not by ProxyCore):

  ("ping", ())                       liveness + coord-state refresh
  ("coord", (method, args, kwargs))  whitelisted Coordinator RPC
  ("stats_add", (key, n))            per-rank stat into coord.stats
  ("straggler", (rank, wall[, compute]))  per-step wall + compute split
                                     -> StragglerTracker
  ("telemetry", (rank, counters))    MPI.telemetry() counters -> coordinator
  ("ckpt_info", ())                  -> (ckpt_dir, chunk_store_spec)
  ("ckpt_entry", (rank, entry, step))  manifest entry; parent commits last
  ("fire_trigger", ())               first rank at a checkpoint_at step
  ("finish", (rank, state_bytes))    normal completion (result to parent)
  ("ckpt_exit", (rank, state_bytes)) checkpoint-with-exit completion
  ("fail", (rank, exc_bytes))        rank raised; parent records the error
  ("contrib", (key, rank, value, meta))  ledger contribution: the rank's
                                     input to the collective it is
                                     entering, pinned parent-side for
                                     mid-collective recovery (§14)
  ("contrib_commit", (key, rank))    the rank committed the collective
  ("trace", (rank, events))          the rank's FSM trace (parity suite)

Every reply is ``(ok, value, coord_state)`` with ``coord_state =
(phase, aborted_reason, ckpt_round, trigger_step, all_finished,
mig_round, mig_final_ranks, recovery_token, trace_ctx)`` — mig_round/
mig_final_ranks piggyback the live-migration FSM (DESIGN.md §13): the
pre-copy round children stream at their next step boundary, and the
ranks being migrated out at a migration final (``None`` outside one).
``recovery_token`` piggybacks the mid-collective recovery epoch
(DESIGN.md §14): non-None while an epoch is open, which is how a child
parked at a boundary or inside a collective learns to enlist.
``trace_ctx`` piggybacks the coordinator's open checkpoint/recovery
span (DESIGN.md §16): a ``(trace_id, span_id)`` pair the child uses to
parent its own ``rank.ckpt`` span — which is how a rank's chunk upload
ends up causally nested under the coordinating save in the merged
timeline, despite living in a different process.
"""
from __future__ import annotations

import itertools
import multiprocessing
import os
import pickle
import socket
import struct
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import dataclasses

import numpy as np

from repro_torch.checkpoint import chunkstore
from repro_torch.core import migrate as migration
from repro_torch.core import rankloop
from repro_torch.core.ckpt_protocol import (RankImage, load_rank_image,
                                      save_rank_image)
from repro_torch.core.coordinator import (JobAborted, PHASE_DRAIN, PHASE_EXIT,
                                    PHASE_JOIN, PHASE_PENDING, PHASE_RESUME,
                                    PHASE_RUN)
from repro_torch.core.dataplane import RING_PAYLOAD_MIN, RingRef, ShmRing
from repro_torch.core import trace as _trace
from repro_torch.core.messages import Envelope
from repro_torch.core.proxy import (CMD_POLL_ALL, CMD_SEND, PROTOCOL_VERSION,
                              ProtocolError, ProxyChannel, ProxyCore)
from repro_torch.core.transport import (dumps_parts, loads_body, read_exact,
                                  read_frame_mv, write_frame_parts)

_WORLD_SEQ = itertools.count()

#: Coordinator methods a rank child may invoke over the wire.  Everything
#: else on the coordinator (request_checkpoint, abort, membership bumps)
#: belongs to the launcher/driver side and is deliberately unreachable.
COORD_RPC_METHODS = frozenset({
    "join", "propose_ckpt_step", "ack_drained", "unack_drained",
    "drain_complete", "note_empty_channel", "ack_snapshot",
    "resume_running", "wait_phase", "report_counters", "mark_finished",
    "all_finished", "barrier", "check_aborted",
    "report_round", "hot_join", "recovery_poll",
})


class RankProcessDied(RuntimeError):
    """A rank's OS process vanished mid-protocol (SIGKILL, OOM, crash)."""


def _safe_exc(e: BaseException) -> BaseException:
    """An exception that survives a pickle round trip (reply frames and
    ``fail`` reports carry real exception objects when they can)."""
    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}")


# =========================================================================
# parent side
# =========================================================================

class ProcWorld:
    """Launcher + supervisor: fork rank processes, serve their proxy
    endpoints, reap exit codes, capture per-rank stdout/stderr."""

    def __init__(self, job, log_dir: Optional[str | Path] = None):
        self.job = job
        self.n = job.n
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(self.n)
        self._srv.settimeout(0.2)
        self.port = self._srv.getsockname()[1]
        self.log_dir = Path(log_dir or os.environ.get("REPRO_PROC_LOG_DIR")
                            or (Path(tempfile.gettempdir()) / "procworld"))
        self._seq = next(_WORLD_SEQ)
        self._procs: Dict[int, multiprocessing.Process] = {}
        self._conns: Dict[int, socket.socket] = {}
        self._endpoints: Dict[int, threading.Thread] = {}
        self._threads: List[threading.Thread] = []
        self._done: set = set()            # ranks that reported a terminal RPC
        self._lock = threading.Lock()
        self._halt = threading.Event()
        self._launched = False
        self.exit_codes: Dict[int, Optional[int]] = {}
        # shared-memory tensor ring (shmring fabric): created BEFORE the
        # children fork so the segment + lock are inherited by address
        # space; None = ringless (plain proc, or /dev/shm unavailable —
        # payloads then ship inline, slower but bit-identical)
        self.ring: Optional[ShmRing] = (
            ShmRing.create()
            if getattr(job.transport, "use_ring", False) else None)

    # ------------------------------------------------------------- plumbing
    def pids(self) -> Dict[int, int]:
        """LIVE PID-based membership: rank -> pid, only for processes that
        are still alive.  An exited rank drops out immediately — its pid
        number may already belong to someone else, so handing it to a
        killer (faults.kill_rank_process) would be a stale reference.
        Snapshot the dict: launch() inserts concurrently with callers
        polling from other threads (the fault injector does exactly
        that)."""
        return {r: p.pid for r, p in list(self._procs.items())
                if p.pid is not None and p.is_alive()}

    def log_path(self, rank: int) -> Path:
        return self.log_dir / f"world{self._seq:04d}-rank{rank}.log"

    def finished(self) -> bool:
        return self._launched and all(p.exitcode is not None
                                      for p in list(self._procs.values()))

    def _record_error(self, rank: int, err: BaseException) -> None:
        job = self.job
        with job._err_lock:
            job.errors.setdefault(rank, err)
        _trace.instant(
            "fault.rank_died" if isinstance(err, RankProcessDied)
            else "fault.rank_failed",
            cat="coord", rank=rank,
            args={"error": type(err).__name__, "detail": str(err)})

    # ------------------------------------------------------------------ run
    def run(self, n_steps: int, timeout: float) -> List[Any]:
        self.launch(n_steps)
        return self.wait(timeout)

    def launch(self, n_steps: int) -> None:
        assert not self._launched, "a process world launches exactly once"
        self._launched = True
        self.log_dir.mkdir(parents=True, exist_ok=True)
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"procworld-{self._seq}-accept")
        t.start()
        self._threads.append(t)
        # fork start method: step/init closures and restored snapshots are
        # inherited by address space, exactly like the thread world sees
        # them — nothing is pickled across the boundary
        ctx = multiprocessing.get_context("fork")
        for r in range(self.n):
            p = ctx.Process(target=_child_main,
                            args=(self.job, r, self.port, n_steps,
                                  str(self.log_path(r))),
                            daemon=True, name=f"rank-{r}")
            p.start()
            self._procs[r] = p

    def spawn_replacements(self, ranks, n_steps: int,
                           store_spec: Optional[str]) -> None:
        """Fork a hot-join replacement child per migrated rank (DESIGN.md
        §13): the leaver exited cleanly after its snapshot ack, so its
        rank image is in the just-committed manifest — the replacement
        restores from there through `store_spec` (the destination store:
        fetch-on-miss pulls only what pre-copy didn't stage) and checks
        in at the join barrier.  Called by MPIJob.migrate while the world
        is parked in PHASE_JOIN."""
        ctx = multiprocessing.get_context("fork")
        ckpt_dir = str(self.job._ckpt_dir)
        for r in ranks:
            old = self._procs.get(r)
            if old is not None:
                old.join(10.0)        # leaver exits right after ckpt_exit
            # the leaver's endpoint thread must finish its clean-exit check
            # BEFORE the rank leaves _done — otherwise it would misread the
            # leaver's own EOF as a mid-protocol death
            with self._lock:
                ep = self._endpoints.get(r)
            if ep is not None:
                ep.join(10.0)
            with self._lock:
                # the rank is live again: a torn socket on the REPLACEMENT
                # must be detected as a death, not excused by the leaver's
                # clean goodbye
                self._done.discard(r)
            self.exit_codes.pop(r, None)
            p = ctx.Process(target=_child_main,
                            args=(self.job, r, self.port, n_steps,
                                  str(self.log_path(r)),
                                  (ckpt_dir, store_spec)),
                            daemon=True, name=f"rank-{r}-joined")
            p.start()
            self._procs[r] = p

    def _accept_loop(self) -> None:
        # runs until stop(): a live migration forks replacement children
        # mid-job (spawn_replacements), so the listener must keep accepting
        # after the initial n ranks have connected — a reconnect for a rank
        # simply replaces its conn entry and gets a fresh endpoint thread
        while not self._halt.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:            # server socket closed by stop()
                return
            # rank handshake: 4-byte rank id, same as the tcp switchboard
            raw = read_exact(conn, 4)
            if raw is None:
                conn.close()
                continue
            rank = struct.unpack("!i", raw)[0]
            t = threading.Thread(target=self._serve_rank, args=(rank, conn),
                                 daemon=True,
                                 name=f"procworld-{self._seq}-endpoint-{rank}")
            with self._lock:
                self._conns[rank] = conn
                self._endpoints[rank] = t
            t.start()
            self._threads.append(t)

    # ------------------------------------------------------------- endpoint
    def _coord_state(self) -> tuple:
        c = self.job.coord
        # trigger + phase under the fire lock: mid-fire (trigger popped,
        # phase not yet flipped) a lock-free snapshot would show
        # trigger=None ∧ phase=RUN and let a child slip past the agreed
        # boundary into the next step
        with self.job._ckpt_lock:
            trig = self.job._trigger
            phase = c.phase
        return (phase, c.aborted, c.ckpt_round,
                trig[0] if trig is not None else None,
                c.all_finished(), c.mig_round,
                tuple(sorted(c.join_expected)) if c.migrating else None,
                c.recovery_token, c.trace_ctx())

    def _serve_rank(self, rank: int, conn: socket.socket) -> None:
        """One rank's proxy endpoint: the process-world twin of
        MPIProxy._serve, owning this rank's ProxyCore over the fabric."""
        job = self.job
        core = ProxyCore(rank, job.transport)
        deferred: Optional[Exception] = None
        win = _trace.BatchWindow("endpoint.batch", rank=rank)
        try:
            while True:
                blob = read_frame_mv(conn)
                if blob is None:
                    return                      # EOF / torn frame
                job.heartbeat.ping(rank)
                version, cmds, want_reply = loads_body(blob)
                if version != PROTOCOL_VERSION:
                    err: Exception = ProtocolError(
                        f"child speaks v{version}, "
                        f"endpoint v{PROTOCOL_VERSION}")
                    if want_reply:
                        self._reply(conn, False, err)
                    else:
                        deferred = deferred or err
                    continue
                if want_reply and deferred is not None:
                    err, deferred = deferred, None
                    self._reply(conn, False, err)
                    continue
                try:
                    if _trace.ENABLED:
                        t0 = time.monotonic()
                        result = self._execute(core, rank, cmds)
                        win.add(time.monotonic() - t0, len(cmds))
                    else:
                        result = self._execute(core, rank, cmds)
                    if want_reply:
                        self._reply(conn, True, result)
                except Exception as e:  # surfaced now or at the next reply
                    if want_reply:
                        self._reply(conn, False, _safe_exc(e))
                    else:
                        deferred = deferred or e
        except OSError:
            return                              # reply write hit a dead peer
        finally:
            win.flush()
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                clean = rank in self._done or self._halt.is_set()
            if not clean:
                # the socket died before the rank said goodbye: a real
                # SIGKILL/crash.  Record it NOW — detection in one poll,
                # not after a heartbeat timeout.
                pid = self._procs.get(rank).pid if rank in self._procs else "?"
                self._record_error(rank, RankProcessDied(
                    f"rank {rank} (pid {pid}) lost its proxy connection "
                    f"mid-protocol (killed?); log: {self.log_path(rank)}"))

    def _reply(self, conn: socket.socket, ok: bool, value: Any) -> None:
        # SG framing: poll replies carrying tensor envelopes ship the
        # arrays as out-of-band buffers by gather write — no concatenation
        # of header + pickled body, no pickling of the tensor bytes
        try:
            parts = dumps_parts((ok, value, self._coord_state()))
        except Exception as e:                 # unpicklable result
            parts = dumps_parts((False, _safe_exc(e), self._coord_state()))
        write_frame_parts(conn, parts)

    def _execute(self, core: ProxyCore, rank: int, cmds) -> Any:
        """Run one batch: plain proxy commands go through the shared
        ProxyCore executor (sends coalesce as usual); launcher-side
        commands are handled here, in order."""
        result: Any = None
        buf: List[tuple] = []
        for cmd, args in cmds:
            if cmd in _ENDPOINT_CMDS:
                if buf:
                    result = core.execute_batch(buf)
                    buf = []
                result = self._endpoint_cmd(cmd, rank, args)
            else:
                buf.append((cmd, args))
        if buf:
            result = core.execute_batch(buf)
        return result

    def _endpoint_cmd(self, cmd: str, rank: int, args: tuple) -> Any:
        job = self.job
        if cmd == "ping":
            return None
        if cmd == "coord":
            method, cargs, ckwargs = args
            if method not in COORD_RPC_METHODS:
                raise ValueError(f"coordinator method {method!r} not "
                                 f"callable from a rank child")
            return getattr(job.coord, method)(*cargs, **ckwargs)
        if cmd == "stats_add":
            key, n = args
            job.coord.stat_add(key, n)
            return None
        if cmd == "straggler":
            r, wall, *rest = args      # 2-arg form = wall-clock only
            job.stragglers.record(r, wall,
                                  compute=rest[0] if rest else None)
            return None
        if cmd == "telemetry":
            r, counters = args
            job.coord.report_telemetry(r, counters)
            return None
        if cmd == "ckpt_info":
            # the store SPEC, not a directory: a child rebuilds an
            # equivalent backend (its own socket for a remote/caching
            # store — it speaks sockets to the chunk service exactly like
            # it speaks sockets to everything else, DESIGN.md §11)
            with job._ckpt_lock:
                return (str(job._ckpt_dir), job._ckpt_chunks.spec)
        if cmd == "ckpt_entry":
            r, entry, step = args
            job._commit_rank_entry(r, entry, step)
            return None
        if cmd == "fire_trigger":
            # pop + request under the lock (mirrors the thread world's
            # fire_trigger): a child that lost the pop race has its RPC
            # blocked here until the phase flip is visible, and the reply
            # piggybacks the PENDING state — no rank slips past the
            # agreed boundary, the agreement is deterministic
            with job._ckpt_lock:
                trig, job._trigger = job._trigger, None
                if trig is not None and job.coord.phase == PHASE_RUN:
                    try:
                        job.checkpoint(trig[1], resume=trig[2])
                    except RuntimeError:
                        # a recovery epoch opened first: re-arm for the
                        # first post-recovery boundary
                        job._trigger = trig
            return None
        if cmd == "finish":
            r, blob = args
            state = pickle.loads(blob)
            job.states[r] = state
            job.results[r] = state
            job.coord.mark_finished(r)
            with self._lock:
                self._done.add(r)
            return None
        if cmd == "ckpt_exit":
            r, blob = args
            job.states[r] = pickle.loads(blob)
            with self._lock:
                self._done.add(r)
            return None
        if cmd == "fail":
            r, blob = args
            try:
                err = pickle.loads(blob)
            except Exception:
                err = RuntimeError(f"rank {r} failed (unpicklable error)")
            self._record_error(r, err)
            with self._lock:
                self._done.add(r)
            return None
        if cmd == "contrib":
            # ledger contribution (DESIGN.md §14): the child pins its
            # collective input PARENT-side so the parent can replay the
            # op after the child is SIGKILLed.  ContributionLedger copies
            # ndarray values, so the wire buffer is not retained.
            key, r, value, meta = args
            if job.ledger is not None:
                job.ledger.contribute(tuple(key), r, value, meta=meta)
            return None
        if cmd == "contrib_commit":
            key, r = args
            if job.ledger is not None:
                job.ledger.commit(tuple(key), r,
                                  live_ranks=job.coord.live_set)
            return None
        if cmd == "trace":
            r, events = args
            with job._ckpt_lock:
                job._fsm_traces.setdefault(r, []).extend(
                    tuple(e) for e in events)
            return None
        raise ValueError(f"unknown endpoint command {cmd!r}")

    # ------------------------------------------------------------- waiting
    def wait(self, timeout: float) -> List[Any]:
        """Block until every rank process exits (the thread world's join);
        reap exit codes; surface the first recorded error."""
        job = self.job
        deadline = time.monotonic() + timeout
        while True:
            alive = [r for r, p in self._procs.items() if p.is_alive()]
            for r, p in self._procs.items():
                if not p.is_alive() and r not in self.exit_codes:
                    p.join(0.1)                       # reap the zombie
                    self.exit_codes[r] = p.exitcode
                    with self._lock:
                        clean = r in self._done
                    if not clean and p.exitcode != 0 and r not in job.errors:
                        # died before it ever connected (or between connect
                        # and its first frame): the endpoint EOF path never
                        # saw it — record from the exit code
                        self._record_error(r, RankProcessDied(
                            f"rank {r} exited with code {p.exitcode} "
                            f"before finishing; log: {self.log_path(r)}"))
            if not alive:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank-{alive[0]} did not finish")
            time.sleep(0.005)
        # every child has exited, so no ring descriptor can be in flight:
        # unlink the segment now (stop() covers the kill/timeout paths)
        if self.ring is not None:
            self.ring.destroy()
            self.ring = None
        if job.errors:
            rank, err = next(iter(job.errors.items()))
            raise RuntimeError(f"rank {rank} failed: {err!r}") from err
        return job.results

    # ------------------------------------------------------------- teardown
    def stop(self) -> None:
        """Deterministic, leak-free teardown: close the wire, then
        SIGTERM -> SIGKILL any rank process still alive, and reap."""
        self._halt.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values())
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for r, p in self._procs.items():
            if p.is_alive():
                p.terminate()
        for r, p in self._procs.items():
            p.join(2.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
            self.exit_codes.setdefault(r, p.exitcode)
        for t in self._threads:
            t.join(5.0)
        if self.ring is not None:
            self.ring.destroy()
            self.ring = None


_ENDPOINT_CMDS = frozenset({
    "ping", "coord", "stats_add", "straggler", "telemetry", "ckpt_info",
    "ckpt_entry", "fire_trigger", "finish", "ckpt_exit", "fail",
    "contrib", "contrib_commit", "trace",
})


# =========================================================================
# child side
# =========================================================================

class SocketChannel(ProxyChannel):
    """The ProxyChannel over the endpoint socket (child side).

    Subclasses the real channel: batching, MAX_BATCH auto-flush, and the
    stats contract are INHERITED, so the plugin (api.MPI) — and the tests
    that assert on round_trips/async_batches — cannot tell it from the
    queue channel.  Only the frame-transport hooks differ: SG frames over
    the socket (tensor payloads as out-of-band buffers), and every reply
    refreshes ``coord_state`` for free, which keeps the child's view of
    the checkpoint FSM one round trip fresh.

    With a ring (shmring fabric) the hooks add the zero-copy rewrite:
    outbound tensor payloads >= RING_PAYLOAD_MIN are parked in the shared
    segment and the frame carries a RingRef descriptor; inbound envelopes
    have their descriptors RESOLVED (copied out + slot freed) before
    anything reaches the plugin — the MessageCache, and therefore any
    checkpoint, can never hold a dangling descriptor."""

    def __init__(self, port: int, rank: int, connect_timeout: float = 10.0,
                 ring: Optional[ShmRing] = None):
        super().__init__()
        self.rank = rank
        self.ring = ring
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=connect_timeout)
        self.sock.settimeout(None)
        self.sock.sendall(struct.pack("!i", rank))
        #: (phase, aborted_reason, ckpt_round, trigger_step, all_finished,
        #: mig_round, mig_final_ranks, recovery_token, trace_ctx) —
        #: piggybacked on every reply
        self.coord_state: tuple = (PHASE_RUN, None, 0, None, False, 0,
                                   None, None, None)

    # ---- frame transport hooks ---------------------------------------------
    def _push(self, frame: tuple) -> None:
        ring = self.ring
        if ring is not None:
            version, cmds, want_reply = frame
            out = None
            for i, (cmd, args) in enumerate(cmds):
                if cmd != CMD_SEND:
                    continue
                payload = args[3]      # (dst, tag, comm, payload, dt, count)
                if (isinstance(payload, np.ndarray)
                        and payload.nbytes >= RING_PAYLOAD_MIN):
                    ref = ring.try_put(payload)
                    if ref is not None:     # else ring full: ship inline
                        if out is None:
                            out = list(cmds)
                        out[i] = (cmd, args[:3] + (ref,) + args[4:])
                        self.stats["ring_bytes"] += payload.nbytes
            if out is not None:
                frame = (version, out, want_reply)
        try:
            write_frame_parts(self.sock, dumps_parts(frame))
        except OSError:
            self.closed = True
            raise RuntimeError("proxy channel closed") from None

    def _resolve(self, val: Any) -> Any:
        """Swap RingRef payloads for the real tensors (freeing the slots).
        Runs on every reply, BEFORE the value reaches the plugin."""
        if isinstance(val, Envelope):
            if isinstance(val.payload, RingRef):
                return dataclasses.replace(
                    val, payload=self.ring.read(val.payload))
            return val
        if isinstance(val, list):
            return [self._resolve(v) for v in val]
        return val

    def _await_reply(self) -> Any:
        blob = read_frame_mv(self.sock)
        if blob is None:
            self.closed = True
            raise RuntimeError("proxy channel closed")
        ok, val, state = loads_body(blob)
        self.coord_state = state
        if not ok:
            raise val
        if self.ring is not None:
            val = self._resolve(val)
        return val

    def poll_all_fast(self) -> Any:
        # the base class's preallocated singleton frame is a queue-identity
        # trick; over a socket a plain replied poll is the same thing
        return self.call(CMD_POLL_ALL)

    def poll_miss_hint(self) -> bool:
        # no cross-process non-consuming peek: Iprobe pays the round trip
        return False

    def is_empty(self) -> bool:
        # single-threaded child: after flush() nothing is buffered here and
        # nothing can be in flight — the channel-empty-at-snapshot invariant
        return not self._pending and not self.closed

    def refresh(self) -> tuple:
        """Replied ping: heartbeat + fresh coord state in one round trip."""
        self.call("ping")
        return self.coord_state


class CoordClient:
    """Coordinator look-alike for the rank child.

    Replied methods are RPCs through the channel; ``phase`` /
    ``check_aborted`` / ``ckpt_round`` read the piggybacked cache (updated
    by EVERY reply — a child blocked in Recv refreshes every poll_wait)."""

    def __init__(self, chan: SocketChannel, generation: int, timeout: float):
        self.chan = chan
        self.generation = generation
        self.timeout = timeout

    # ---- cached view -------------------------------------------------------
    @property
    def phase(self) -> str:
        return self.chan.coord_state[0]

    @property
    def ckpt_round(self) -> int:
        return self.chan.coord_state[2]

    @property
    def trigger_step(self) -> Optional[int]:
        return self.chan.coord_state[3]

    @property
    def mig_round(self) -> int:
        return self.chan.coord_state[5]

    @property
    def mig_final_ranks(self) -> Optional[tuple]:
        """Ranks being migrated out at a migration final, None outside
        one.  Safe to read from the cache: join_expected is set BEFORE
        the checkpoint request goes out and stays stable until the join
        barrier completes — any coord_state showing the pending phase of
        a migration final already carries it."""
        return self.chan.coord_state[6]

    @property
    def recovery_token(self) -> Optional[int]:
        """Active recovery epoch id (DESIGN.md §14), None when no epoch
        is open.  Cached view is at most one reply stale — and every
        recovery_poll reply refreshes it, so a parked rank converges."""
        st = self.chan.coord_state
        return st[7] if len(st) > 7 else None

    @property
    def trace_ctx(self) -> Optional[tuple]:
        """(trace_id, span_id) of the coordinator's open checkpoint or
        recovery span (DESIGN.md §16), None outside one.  Cached view:
        the ckpt_info reply a rank issues right before saving its image
        refreshes it, so the parent link is current when it matters."""
        st = self.chan.coord_state
        return st[8] if len(st) > 8 else None

    def check_aborted(self) -> None:
        reason = self.chan.coord_state[1]
        if reason is not None:
            raise JobAborted(reason)

    # ---- RPCs --------------------------------------------------------------
    def _rpc(self, method: str, *args, **kwargs) -> Any:
        return self.chan.call("coord", method, args, kwargs)

    def join(self, rank, generation=None):
        return self._rpc("join", rank, generation)

    def propose_ckpt_step(self, rank, next_boundary, generation=None):
        return self._rpc("propose_ckpt_step", rank, next_boundary,
                         generation=generation)

    def report_counters(self, rank, sent, received, generation=None):
        # fire-and-forget, like the sends it accounts for: the epoch push
        # must not turn every REPORT_EPOCH-th send into a round trip.  The
        # socket is ordered, so the report reaches the coordinator before
        # any later replied call (ack_drained relies on exactly this); a
        # StaleGenerationError surfaces at the next replied call instead
        # of here (deferred-error slot, same as a failed send).
        self.chan.send_async("coord", "report_counters", (rank, sent, received),
                             {"generation": generation})

    def ack_drained(self, rank, generation=None):
        return self._rpc("ack_drained", rank, generation=generation)

    def drain_complete(self):
        return self._rpc("drain_complete")

    def note_empty_channel(self, rank):
        return self._rpc("note_empty_channel", rank)

    def ack_snapshot(self, rank, generation=None):
        return self._rpc("ack_snapshot", rank, generation=generation)

    def resume_running(self, rank):
        return self._rpc("resume_running", rank)

    def mark_finished(self, rank):
        return self._rpc("mark_finished", rank)

    def report_round(self, rank, round_no, entry, generation=None):
        return self._rpc("report_round", rank, round_no, entry,
                         generation=generation)

    def recovery_poll(self, rank, info=None, generation=None, token=None):
        return self._rpc("recovery_poll", rank, info,
                         generation=generation, token=token)

    def hot_join(self, rank, generation=None):
        return self._rpc("hot_join", rank, generation=generation)

    def all_finished(self):
        # cached: piggybacked on every reply, refreshed by the serving
        # loop's periodic ping — a finished rank must not burn a dedicated
        # RPC per poll just to learn whether its peers are done
        return self.chan.coord_state[4]

    def barrier(self, rank, timeout=None, generation=None):
        return self._rpc("barrier", rank, timeout=timeout,
                         generation=generation)

    def wait_phase_alive(self, *phases: str) -> str:
        """The child's _wait_phase_alive: short parent-side waits so every
        loop sends a frame (= heartbeat) until the phase flips."""
        deadline = time.time() + self.timeout
        while True:
            try:
                return self._rpc("wait_phase", *phases, timeout=0.25)
            except TimeoutError:
                if time.time() > deadline:
                    raise TimeoutError(
                        f"waiting for {phases} after "
                        f"{self.timeout:g}s") from None


class _ChildLedger:
    """Ledger client for a rank child: contributions ship to the parent's
    ContributionLedger as fire-and-forget endpoint commands, flushed
    immediately so the bytes are on the socket BEFORE the collective's
    first wire hop — a SIGKILL landing anywhere inside the dance finds
    this rank's input already pinned parent-side (DESIGN.md §14)."""

    def __init__(self, chan: SocketChannel):
        self.chan = chan

    def contribute(self, key, rank, value, meta=None):
        self.chan.send_async("contrib", tuple(key), rank, value, meta)
        self.chan.flush_async()

    def commit(self, key, rank):
        # the commit may ride the next batch: a kill before it lands just
        # leaves the entry pinned, which recovery treats as "in flight"
        self.chan.send_async("contrib_commit", tuple(key), rank)


class _ProcRankHost(rankloop.RankHost):
    """Process-world substrate adapter: the unified rank loop
    (core/rankloop.py) RPC'd through the child's SocketChannel."""

    serve_sleep = 0.005   # a finished rank idles at ~200 replied pings/s

    def __init__(self, job, chan: SocketChannel, coord: CoordClient,
                 rank: int):
        super().__init__(job.step_fn)
        self.job = job
        self.chan = chan
        self.coord = coord
        self.rank = rank
        self.reported_finish = False
        self._last_rt = -1
        self._mig_digests: Dict[str, str] = {}

    def tick(self, mpi) -> None:
        # heartbeat + coord-state freshness: a communication-heavy step
        # already refreshed both through its own replied frames; only a
        # compute-only step needs the dedicated ping round trip
        rt = self.chan.stats["round_trips"]
        if rt == self._last_rt:
            self.chan.refresh()
            rt = self.chan.stats["round_trips"]
        self._last_rt = rt

    def trigger_step(self, coord):
        return coord.trigger_step

    def ckpt_trace_ctx(self, mpi):
        return self.coord.trace_ctx

    def fire_trigger(self, mpi) -> None:
        self.chan.call("fire_trigger")

    def stream_round(self, mpi, state, step: int, round_no: int) -> None:
        _child_stream_round(self.chan, self.coord, mpi, state, step,
                            round_no, self._mig_digests)

    def record_step(self, mpi, wall: float, compute: float) -> None:
        # telemetry rides the async batch, like the sends it accounts
        self.chan.send_async("straggler", self.rank, wall, compute)
        self.chan.send_async("telemetry", self.rank, mpi.telemetry())
        mpi.flush_async()

    def assert_empty(self, mpi) -> None:
        chan = self.chan
        assert chan.is_empty(), \
            f"rank {self.rank}: proxy channel not empty at snapshot"
        if chan.ring is not None:
            # ring half of the invariant: Σsent == Σreceived counts
            # envelopes AFTER descriptor resolution, so a drained network
            # implies every ring slot was read back and freed — no
            # checkpoint can capture a dangling descriptor
            n_live = chan.ring.in_flight()
            assert n_live == 0, \
                f"rank {self.rank}: {n_live} ring slot(s) in flight " \
                f"at snapshot"

    def drained_stat(self, mpi) -> None:
        self.chan.call("stats_add", "drained_messages", len(mpi.cache))

    def save_image(self, mpi, state, step: int) -> bool:
        ckpt_dir, store_spec = self.chan.call("ckpt_info")
        # migration final (DESIGN.md §13): save the app payload leaf-split
        # so every leaf pre-copy already streamed is a store reference and
        # the stop-the-world window ships only the final dirty delta.  The
        # ckpt_info reply just refreshed coord_state, so the cached
        # mig_final_ranks is current — and stable until this rank acks.
        mig_ranks = self.coord.mig_final_ranks
        leaves = (migration.split_state(state)
                  if mig_ranks is not None else None)
        image = RankImage(rank=self.rank, n_ranks=self.job.n,
                          step_idx=step, mpi_state=mpi.snapshot(),
                          app_state=(b"" if leaves is not None
                                     else pickle.dumps(state)))
        entry = save_rank_image(Path(ckpt_dir), image,
                                store=_child_store(store_spec),
                                app_leaves=leaves)
        self.chan.call("ckpt_entry", self.rank, entry, step)
        return mig_ranks is not None and self.rank in mig_ranks

    def wait_phase_alive(self, mpi, *phases: str) -> str:
        return self.coord.wait_phase_alive(*phases)

    def finish(self, mpi, state) -> None:
        self.chan.call("finish", self.rank, pickle.dumps(state))
        self.reported_finish = True


def _redirect_io(log_path: str) -> Any:
    """Point the child's fds 1/2 (and sys.stdout/stderr) at its rank log —
    the launcher-side capture the CI uploads on failure."""
    Path(log_path).parent.mkdir(parents=True, exist_ok=True)
    f = open(log_path, "a", buffering=1)
    os.dup2(f.fileno(), 1)
    os.dup2(f.fileno(), 2)
    sys.stdout = f
    sys.stderr = f
    return f


def _child_main(job, rank: int, port: int, n_steps: int,
                log_path: str,
                mig_resume: Optional[tuple] = None) -> None:
    """The rank process entry point — the process-world twin of
    MPIJob._rank_main + _do_checkpoint, RPC'd through the SocketChannel.
    Runs in a forked child; exits via os._exit (no inherited atexit).

    `mig_resume` = ``(ckpt_dir, store_spec)`` marks a hot-join
    replacement (DESIGN.md §13): restore this rank's image from the
    just-committed migration manifest through the destination store,
    announce at the join barrier, then run like any other rank."""
    code = 1
    chan = None
    logf = None
    try:
        logf = _redirect_io(log_path)
        print(f"[procworld] rank {rank} pid {os.getpid()} starting "
              f"(world {job.n}, steps {n_steps})")
        # inherited parent-side fds are not ours: the listener, and the
        # endpoint connections of every rank that connected before this
        # fork (closing the child's dup leaves the parent's end intact)
        try:
            job._proc._srv.close()
        except Exception:
            pass
        for c in list(job._proc._conns.values()):
            try:
                c.close()
            except Exception:
                pass
        from repro_torch.core.api import MPI
        chan = SocketChannel(port, rank, ring=getattr(job._proc, "ring", None))
        coord = CoordClient(chan, generation=job.coord.generation,
                            timeout=job.coord.timeout)
        mpi = MPI(rank, job.n, chan, coord)
        host = _ProcRankHost(job, chan, coord, rank)
        if job.ledger is not None:
            # the fork inherited the PARENT's ledger flag; the child's own
            # contributions ship over the endpoint socket into the
            # parent-side instance (which is what survives a SIGKILL)
            mpi.ledger = _ChildLedger(chan)
        if mig_resume is not None:
            # hot-join replacement: the image is in the manifest the
            # migration final just committed; reads route through the
            # destination store so a cold cache fetches only the parts
            # pre-copy rounds didn't stage
            mr_dir, mr_spec = mig_resume
            img = load_rank_image(
                Path(mr_dir), rank,
                store=_child_store(mr_spec) if mr_spec else None)
            mpi.restore(img.mpi_state)
            state = img.state_obj()
            step = img.step_idx
            coord.hot_join(rank, generation=mpi.generation)
            phase = coord.wait_phase_alive(PHASE_RESUME, PHASE_EXIT)
            if phase == PHASE_EXIT:
                chan.call("ckpt_exit", rank, pickle.dumps(state))
                code = 0
                return
            coord.resume_running(rank)
            coord.wait_phase_alive(PHASE_RUN, PHASE_PENDING, PHASE_DRAIN)
        elif not job._restored:
            mpi.Init()
            state = job.init_fn(mpi)
            step = job.start_steps[rank]
            host.trace("init")
        else:
            mpi.restore(job._restore_snaps[rank])
            state = job.states[rank]
            step = job.start_steps[rank]
            host.trace("restore", step)
        status, state = rankloop.run_rank(host, mpi, state, step, n_steps)
        if status in ("exit", "migrated") and not host.reported_finish:
            # exit/migrated out of the STEP loop: the parent has no final
            # state for this rank yet (the serve-loop variants already
            # reported theirs through "finish")
            chan.call("ckpt_exit", rank, pickle.dumps(state))
        try:
            chan.call("trace", rank, host.events)
        except Exception:
            pass               # trace shipping is best-effort diagnostics
        code = 0
    except BaseException as e:  # noqa: BLE001 - shipped to the launcher
        print(f"[procworld] rank {rank} failed: {type(e).__name__}: {e}")
        if chan is not None and not chan.closed:
            try:
                chan.call("fail", rank, pickle.dumps(_safe_exc(e)))
            except Exception:
                pass
        code = 1
    finally:
        try:
            # flight-recorder dump (no-op unless REPRO_TRACE_DIR is set):
            # the at-fork hook cleared the parent's inherited ring, so
            # this file holds only events this rank process emitted
            _trace.dump(role=f"rank{rank}")
        except Exception:
            pass
        try:
            if chan is not None:
                chan.sock.close()
        except Exception:
            pass
        try:
            if logf is not None:
                logf.flush()
        except Exception:
            pass
        os._exit(code)


#: per-child memo of opened chunk-store backends: consecutive checkpoints
#: against a remote store reuse one connection instead of re-dialing the
#: chunk server every boundary (populated only after the fork — the
#: parent never writes it, so nothing stale is inherited).  The key is
#: the CANONICAL StoreSpec string the parent hands out via ``ckpt_info``
#: — any spec kind ``open_store`` accepts, a sharded multi-endpoint one
#: included (the child then dials every shard itself, DESIGN.md §15)
_CHILD_STORES: Dict[str, Any] = {}


def _child_store(spec: str):
    st = _CHILD_STORES.get(spec)
    if st is None:
        st = chunkstore.open_store(spec)
        _CHILD_STORES[spec] = st
    return st


def _child_stream_round(chan: SocketChannel, coord: CoordClient, mpi,
                        state, step: int, round_no: int,
                        digests: Dict[str, str]) -> None:
    """One pre-copy round for this child (the process-world twin of
    MPIJob._stream_round): digest-diff the app state against the last
    streamed round, upload only the dirty leaves through the child's own
    store connection, report the entry to the coordinator."""
    _, store_spec = chan.call("ckpt_info")
    entry, new_digests = migration.stream_round(
        _child_store(store_spec), state, digests)
    entry["step_idx"] = step
    digests.clear()
    digests.update(new_digests)
    coord.report_round(mpi.rank, round_no, entry,
                       generation=mpi.generation)


