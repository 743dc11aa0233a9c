"""The passive MPI stub (the paper's DMTCP plugin).

Implements the paper's validated API — Init / Finalize / Comm_size /
Comm_rank / Type_size / Send / Recv / Probe / Iprobe / Get_count — plus its
"future work" list (§5/§7): Isend / Irecv / Test / Wait, the collectives
(Bcast, Barrier, Scatter, Gather, Allgather, Reduce, Allreduce) built on
Send/Recv plumbing, and communicator/group management with virtualized ids.

Checkpoint-relevant rules implemented here (paper §4, updated for the
batched wire protocol — DESIGN.md §3/§5):
  * every Recv/Probe/Iprobe consults the drained-message CACHE FIRST;
  * administrative calls are LOGGED for replay;
  * Send/Isend are FIRE-AND-FORGET through the channel's async path; every
    blocking call piggybacks (and therefore flushes) buffered sends, and
    the runtime flushes at step and checkpoint boundaries;
  * sent/received counters feed the coordinator's drain heuristic in
    EPOCHS: during PHASE_RUN they are flushed every REPORT_EPOCH ops (the
    coordinator never reads them in that phase), and EXACTLY whenever the
    checkpoint FSM is active — which is the only time drain_complete()
    evaluates them, so the heuristic still holds (proof in DESIGN.md §5);
  * a blocked Recv participates in checkpoint agreement via non-blocking
    proposals (the pending-call re-issue of paper challenge 2 reduces to
    cache-first matching after restart).
"""
from __future__ import annotations

import functools
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core import recovery as _recovery
from repro_torch.core.coordinator import Coordinator, PHASE_PENDING, PHASE_RUN
from repro_torch.core.drain import MessageCache, remap_cache_snapshot
from repro_torch.core.messages import (ANY_SOURCE, ANY_TAG, COLL_TAG_BASE, DATATYPES,
                                 Status, pack, payload_nbytes, unpack)
from repro_torch.core.proxy import (CMD_POLL_ALL, CMD_POLL_WAIT, CMD_REGISTER_COMM,
                              CMD_REGISTER_RANK, CMD_SEND,
                              CMD_UNREGISTER_COMM, ProxyChannel)
from repro_torch.core.replay import AdminLog
from repro_torch.core.tunables import ALLREDUCE_RING_MIN_BYTES
from repro_torch.core.virtualization import (RankMap, VirtualIds, WORLD_VID,
                                       remap_vids_snapshot)

COMM_WORLD = WORLD_VID

# counter-report epoch: during PHASE_RUN, sent/received counters are pushed
# to the coordinator at most once per this many operations
REPORT_EPOCH = 32

# Allreduce algorithm crossover: payloads at least this large use the ring
# (bandwidth-optimal), smaller ones the binomial tree (latency-optimal).
# All ranks share one GIL here so serialization is effectively a shared
# resource; real clusters would set this far lower.  Env-tunable via
# REPRO_ALLREDUCE_RING_MIN_BYTES (core/tunables.py).
RING_MIN_BYTES = ALLREDUCE_RING_MIN_BYTES

# blocking-call wait policy: one CMD_POLL_WAIT round trip parks the proxy
# on the transport for up to this long; the plugin thread sleeps on the
# response queue meanwhile.  Bounded so a blocked Recv still participates
# in checkpoint agreement every few milliseconds.
_POLL_WAIT_S = 0.005

# reduction functions live in core/recovery.py so the recovery replay
# applies bit-identical ops without an import cycle
_OPS = _recovery.REDUCE_OPS


class CheckpointExit(Exception):
    """Raised out of the step loop when a checkpoint requested exit."""


def _collective_op(fn):
    """Attribute waiting inside this call to COLLECTIVE time (not plain
    recv time): the compute/wait telemetry split (DESIGN.md §12) needs to
    see through per-step collectives, where every rank's wall-clock step
    collapses to the slowest rank's and durations alone cannot tell who
    the straggler is.  Depth-counted so nested collectives (Allreduce ->
    Reduce -> Bcast) attribute once."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        self._coll_depth += 1
        try:
            return fn(self, *args, **kwargs)
        finally:
            self._coll_depth -= 1
    return wrapper


class MPI:
    def __init__(self, rank: int, n_ranks: int, channel: ProxyChannel,
                 coordinator: Coordinator):
        self.rank = rank
        self.n = n_ranks
        self.channel = channel
        self.coord = coordinator
        self.cache = MessageCache()
        self.vids = VirtualIds(n_ranks)
        self.admin = AdminLog()
        self.sent = 0
        self.received = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        # compute/wait split telemetry: µs this rank spent BLOCKED on the
        # transport, attributed to collectives vs plain recv/poll by
        # _coll_depth at the moment of the wait (see _collective_op)
        self.wait_recv_us = 0
        self.wait_coll_us = 0
        self._coll_depth = 0
        self.coll_seq: dict = {COMM_WORLD: 0}
        self.step_idx = 0                 # maintained by the runtime
        #: membership generation this rank joined with — stamped on every
        #: coordinator report so a zombie rank from a superseded world is
        #: rejected (StaleGenerationError) instead of corrupting the job
        self.generation = coordinator.generation
        self._proposed_gen = -1
        self._initialized = False
        self._ops_since_report = 0
        #: runtime hook: called whenever this rank is blocked-but-alive
        #: (pumping an empty transport) so the heartbeat keeps beating
        self._on_idle: Optional[Callable[[], None]] = None
        #: mid-collective recovery (DESIGN.md §14): the ContributionLedger
        #: (or its process-world client) pinning collective inputs, the
        #: descriptor of the op currently on the wire, and the last
        #: recovery epoch this rank participated in
        self.ledger = None
        self._rec_op: Optional[dict] = None
        self._rec_done_token: Optional[int] = None
        #: test-only fault injection: called at every ring hop with
        #: (phase, hop_index) — lets kill-point tests die mid-dance
        self._hop_hook: Optional[Callable[[str, int], None]] = None

    # ------------------------------------------------------------------ admin
    def Init(self) -> None:
        self.admin.append("init", (self.rank, self.n))
        self.coord.join(self.rank, self.generation)
        self.channel.call(CMD_REGISTER_RANK, self.rank, self.n)
        self._initialized = True

    def Finalize(self) -> None:
        self.flush()
        self.admin.append("finalize", ())
        self._initialized = False

    def Comm_size(self, comm: int = COMM_WORLD) -> int:
        return self.vids.comms[comm].size()

    def Comm_rank(self, comm: int = COMM_WORLD) -> int:
        return self.vids.comms[comm].rank_of(self.rank)

    @staticmethod
    def Type_size(datatype: str) -> int:
        return DATATYPES[datatype]

    # ------------------------------------------------------- point to point
    def _world_dst(self, dest: int, comm: int) -> int:
        return self.vids.comms[comm].world_rank(dest)

    def _report(self) -> None:
        """Exact counter push (always used when the checkpoint FSM runs).
        Generation-stamped: a rank whose world was superseded raises
        StaleGenerationError here instead of polluting the new epoch."""
        self._ops_since_report = 0
        self.coord.report_counters(self.rank, self.sent, self.received,
                                   generation=self.generation)

    def _maybe_report(self) -> None:
        """Epoch-based flush: exact whenever phase != RUN (the only time the
        coordinator evaluates the drain heuristic), else every REPORT_EPOCH
        operations."""
        self._ops_since_report += 1
        if (self.coord.phase != PHASE_RUN
                or self._ops_since_report >= REPORT_EPOCH):
            self._report()

    def flush(self) -> None:
        """Blocking: every buffered/queued async command has executed on the
        proxy; raises any deferred send error.  Called by the runtime at
        checkpoint boundaries and at end-of-run."""
        self.channel.flush()
        self._report()

    def flush_async(self) -> None:
        """Non-blocking: push buffered sends to the proxy (step-boundary
        liveness — peers polling the transport will see them)."""
        self.channel.flush_async()

    def Send(self, value: Any, dest: int, tag: int = 0,
             comm: int = COMM_WORLD) -> None:
        assert 0 <= tag < COLL_TAG_BASE, "user tags must be < COLL_TAG_BASE"
        self._send_raw(value, dest, tag, comm)

    def _send_raw(self, value: Any, dest: int, tag: int, comm: int) -> None:
        """Fire-and-forget: buffered into the channel's current batch; no
        round trip.  Errors surface at the next blocking call or flush()."""
        payload, dtype, count = pack(value)
        self.channel.send_async(CMD_SEND, self._world_dst(dest, comm), tag,
                                comm, payload, dtype, count)
        self.sent += 1
        self.bytes_sent += payload_nbytes(payload)
        self._maybe_report()

    def _pump_all(self) -> int:
        """ONE round trip drains every available envelope into the cache
        (bulk poll).  Buffered sends piggyback on the same batch; an idle
        channel takes the preallocated fast frame (no batch machinery)."""
        return self._absorb(self.channel.poll_all_fast())

    def _pump_wait(self) -> int:
        """Blocking bulk poll: the proxy parks on the transport up to
        _POLL_WAIT_S and replies with everything that arrived.  Buffered
        sends piggyback first, so this also flushes.  The time blocked here
        IS the wait half of the compute/wait telemetry split."""
        t0 = time.perf_counter()
        try:
            return self._absorb(self.channel.call(CMD_POLL_WAIT,
                                                  _POLL_WAIT_S))
        finally:
            us = int((time.perf_counter() - t0) * 1e6)
            if self._coll_depth:
                self.wait_coll_us += us
            else:
                self.wait_recv_us += us

    def _absorb(self, envs: list) -> int:
        if not envs:
            return 0
        self.cache.put_many(envs)
        self.received += len(envs)
        self.bytes_received += sum(payload_nbytes(e.payload) for e in envs)
        self._maybe_report()
        return len(envs)

    def _participate_if_pending(self) -> None:
        """Inside a blocked call: keep checkpoint agreement deadlock-free,
        keep the heartbeat alive, unwind promptly on abort, and — when a
        recovery epoch opens while this rank is blocked inside a ledgered
        collective — jump out to the recovery path."""
        self.coord.check_aborted()
        if self._on_idle is not None:
            self._on_idle()
        if self._rec_op is not None:
            tok = self.coord.recovery_token
            if tok is not None and tok != self._rec_done_token:
                raise _recovery.CollectiveInterrupted(tok)
        if (self.coord.phase == PHASE_PENDING
                and self._proposed_gen < self.coord.ckpt_round):
            self.coord.propose_ckpt_step(self.rank, self.step_idx + 1,
                                         generation=self.generation)
            self._proposed_gen = self.coord.ckpt_round

    def Recv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             comm: int = COMM_WORLD, timeout: float = 120.0,
             _status_out: Optional[Status] = None) -> Any:
        src_world = (source if source in (ANY_SOURCE,)
                     else self.vids.comms[comm].world_rank(source))
        deadline = time.time() + timeout
        while True:
            env = self.cache.match(src_world, tag, comm)
            if env is not None:
                if _status_out is not None:
                    _status_out.source = env.src
                    _status_out.tag = env.tag
                    _status_out.count = env.count
                    _status_out.dtype = env.dtype
                return unpack(env)
            if not self._pump_wait():
                self._participate_if_pending()
                if time.time() > deadline:
                    raise TimeoutError(
                        f"rank {self.rank}: Recv(src={source}, tag={tag}) "
                        f"timed out")

    def Probe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
              comm: int = COMM_WORLD, timeout: float = 120.0) -> Status:
        src_world = (source if source == ANY_SOURCE
                     else self.vids.comms[comm].world_rank(source))
        deadline = time.time() + timeout
        while True:
            env = self.cache.match(src_world, tag, comm, remove=False)
            if env is not None:
                return Status(source=env.src, tag=env.tag, count=env.count,
                              dtype=env.dtype)
            if not self._pump_wait():
                self._participate_if_pending()
                if time.time() > deadline:
                    raise TimeoutError("Probe timeout")

    def Iprobe(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
               comm: int = COMM_WORLD) -> Tuple[bool, Optional[Status]]:
        src_world = (source if source == ANY_SOURCE
                     else self.vids.comms[comm].world_rank(source))
        # cache-first (paper §4 rule): a hit answers without any proxy
        # round trip; a definite transport-empty hint answers a miss the
        # same way; only the ambiguous middle pays the (fast-path) poll
        env = self.cache.match(src_world, tag, comm, remove=False)
        if env is None and self.channel.poll_miss_hint():
            return False, None
        if env is None and self._pump_all():
            env = self.cache.match(src_world, tag, comm, remove=False)
        if env is None:
            return False, None
        return True, Status(source=env.src, tag=env.tag, count=env.count,
                            dtype=env.dtype)

    @staticmethod
    def Get_count(status: Status, datatype: str) -> int:
        return status.get_count(datatype)

    # --------------------------------------------------------- non-blocking
    def Isend(self, value: Any, dest: int, tag: int = 0,
              comm: int = COMM_WORLD) -> int:
        """Buffered-send semantics: payload handed to the proxy immediately;
        the request completes at once (paper §6 notes Isend needs caching of
        additional data — the proxy's outbound path IS that buffer here)."""
        self.Send(value, dest, tag, comm)
        req = self.vids.new_request("send", self.rank, tag, comm)
        req.done = True
        return req.vid

    def Irecv(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
              comm: int = COMM_WORLD) -> int:
        src_world = (source if source == ANY_SOURCE
                     else self.vids.comms[comm].world_rank(source))
        req = self.vids.new_request("recv", src_world, tag, comm)
        return req.vid

    def Test(self, request: int) -> Tuple[bool, Any]:
        req = self.vids.requests[request]
        if req.done:
            return True, req.value
        self._pump_all()
        env = self.cache.match(req.src, req.tag, req.comm_vid)
        if env is None:
            return False, None
        req.done = True
        req.value = unpack(env)
        req.status = Status(source=env.src, tag=env.tag, count=env.count,
                            dtype=env.dtype)
        return True, req.value

    def Wait(self, request: int, timeout: float = 120.0) -> Any:
        deadline = time.time() + timeout
        while True:
            done, val = self.Test(request)
            if done:
                self.vids.requests.pop(request, None)
                return val
            self._participate_if_pending()
            if time.time() > deadline:
                raise TimeoutError("Wait timeout")
            self._pump_wait()

    # ------------------------------------------------------------ collectives
    def _ctag(self, comm: int, op_code: int) -> int:
        seq = self.coll_seq.get(comm, 0)
        self.coll_seq[comm] = seq + 1
        return COLL_TAG_BASE + (seq << 4) + op_code

    @_collective_op
    def Barrier(self, comm: int = COMM_WORLD) -> None:
        """Binomial-tree barrier rooted at comm-rank 0: fold-in up the tree,
        release wave back down — 2·log2(n) critical-path hops, every token
        send fire-and-forget through the batched channel."""
        info = self.vids.comms[comm]
        n, me = info.size(), info.rank_of(self.rank)
        if n == 1:
            return
        tag_in = self._ctag(comm, 0)
        tag_out = self._ctag(comm, 11)
        k = 1
        while k < n:                      # fold-in (tree reduce of a token)
            if me % (2 * k) == 0:
                if me + k < n:
                    self.Recv(source=me + k, tag=tag_in, comm=comm)
            else:                         # me % (2*k) == k
                self._send_raw(b"", me - k, tag_in, comm)
                break
            k *= 2
        k = 1
        while k < n:                      # release (tree broadcast)
            if me < k:
                if me + k < n:
                    self._send_raw(b"", me + k, tag_out, comm)
            elif me < 2 * k:
                self.Recv(source=me - k, tag=tag_out, comm=comm)
            k *= 2

    @_collective_op
    def Bcast(self, value: Any, root: int = 0, comm: int = COMM_WORLD) -> Any:
        """Binomial-tree broadcast."""
        info = self.vids.comms[comm]
        n, me = info.size(), info.rank_of(self.rank)
        tag = self._ctag(comm, 1)
        rel = (me - root) % n
        k = 1
        while k < n:
            if rel < k:
                if rel + k < n:
                    self._send_raw(value, (root + rel + k) % n, tag, comm)
            elif rel < 2 * k:
                value = self.Recv(source=(root + rel - k) % n, tag=tag,
                                  comm=comm)
            k *= 2
        return value

    @_collective_op
    def Scatter(self, values: Optional[List[Any]], root: int = 0,
                comm: int = COMM_WORLD) -> Any:
        info = self.vids.comms[comm]
        n, me = info.size(), info.rank_of(self.rank)
        tag = self._ctag(comm, 2)
        if me == root:
            assert values is not None and len(values) == n
            for r in range(n):
                if r != me:
                    self._send_raw(values[r], r, tag, comm)
            return values[me]
        return self.Recv(source=root, tag=tag, comm=comm)

    @_collective_op
    def Gather(self, value: Any, root: int = 0,
               comm: int = COMM_WORLD) -> Optional[List[Any]]:
        info = self.vids.comms[comm]
        n, me = info.size(), info.rank_of(self.rank)
        tag = self._ctag(comm, 3)
        if me == root:
            out: List[Any] = [None] * n
            out[me] = value
            for _ in range(n - 1):
                st = Status()
                v = self.Recv(source=ANY_SOURCE, tag=tag, comm=comm,
                              _status_out=st)
                out[info.ranks.index(st.source)] = v
            return out
        self._send_raw(value, root, tag, comm)
        return None

    @_collective_op
    def Allgather(self, value: Any, comm: int = COMM_WORLD) -> List[Any]:
        """Ring allgather (n-1 steps)."""
        info = self.vids.comms[comm]
        n, me = info.size(), info.rank_of(self.rank)
        tag = self._ctag(comm, 4)
        out: List[Any] = [None] * n
        out[me] = value
        cur, cur_idx = value, me
        for _ in range(n - 1):
            self._send_raw((cur_idx, cur), (me + 1) % n, tag, comm)
            cur_idx, cur = self.Recv(source=(me - 1) % n, tag=tag, comm=comm)
            out[cur_idx] = cur
        return out

    @_collective_op
    def Reduce(self, value: Any, op: str = "sum", root: int = 0,
               comm: int = COMM_WORLD) -> Any:
        """Binomial-tree reduce."""
        info = self.vids.comms[comm]
        n, me = info.size(), info.rank_of(self.rank)
        tag = self._ctag(comm, 5)
        rel = (me - root) % n
        fn = _OPS[op]
        acc = value
        k = 1
        while k < n:
            if rel % (2 * k) == 0:
                if rel + k < n:
                    other = self.Recv(source=(root + rel + k) % n, tag=tag,
                                      comm=comm)
                    acc = fn(acc, other)
            elif rel % (2 * k) == k:
                self._send_raw(acc, (root + rel - k) % n, tag, comm)
                return None
            k *= 2
        return acc if rel == 0 else None

    #: sentinel returned by _finish_recovery when the op must re-run
    _RERUN = object()

    @_collective_op
    def Allreduce(self, value: Any, op: str = "sum",
                  comm: int = COMM_WORLD,
                  algo: Optional[str] = None) -> Any:
        """Algorithm selection: ring reduce-scatter + allgather (the real
        HPC algorithm — constant per-endpoint traffic) for large ndarrays;
        binomial tree reduce + bcast (2·log2(n) hops) for everything else,
        where hop latency dominates.  RING_MIN_BYTES is tuned for this
        GIL-bound substrate — a real multi-host fabric crosses over far
        earlier.  `algo` pins "ring" or "tree" explicitly (must agree
        across ranks); None auto-selects by payload size.

        Recovery frame (DESIGN.md §14): the input is pinned in the
        ContributionLedger BEFORE any wire traffic, and the dance runs
        under an op descriptor so a recovery epoch opened while this rank
        is blocked can interrupt it.  Depending on the coordinator's plan
        the op is then delivered centrally (bit-identical ledger replay),
        re-run over the shrunk communicator, or abandoned to the abort
        fallback — each retry iteration re-reads the (possibly shrunk)
        communicator."""
        if algo not in (None, "ring", "tree"):
            raise ValueError(f"unknown allreduce algo {algo!r}")
        while True:
            info = self.vids.comms[comm]
            n = info.size()
            if n == 1:
                return value
            ringable = isinstance(value, np.ndarray) and value.size >= n
            use_ring = (ringable if algo == "ring"
                        else ringable and algo is None
                        and value.nbytes >= RING_MIN_BYTES)
            seq0 = self.coll_seq.get(comm, 0)
            desc = _recovery.op_descriptor(
                comm, seq0, "ring" if use_ring else "tree", op, info.ranks)
            if self.ledger is not None:
                self.ledger.contribute(desc["key"], self.rank, value,
                                       meta={"ranks": desc["ranks"]})
            tok = self.coord.recovery_token
            if tok is not None and tok != self._rec_done_token:
                # an epoch opened while this rank was computing: enlist
                # with the fresh contribution before touching the wire
                result = self._finish_recovery(desc, comm, seq0)
                if result is not MPI._RERUN:
                    return result
                continue
            self._rec_op = desc
            try:
                if use_ring:
                    result = self._ring_allreduce(value, op, comm)
                else:
                    result = self.Bcast(self.Reduce(value, op, 0, comm),
                                        0, comm)
            except _recovery.CollectiveInterrupted:
                result = self._finish_recovery(desc, comm, seq0)
                if result is not MPI._RERUN:
                    return result
                continue
            finally:
                self._rec_op = None
            if self.ledger is not None:
                self.ledger.commit(desc["key"], self.rank)
            return result

    def _finish_recovery(self, desc: dict, comm: int, seq0: int) -> Any:
        """Ride one recovery epoch out from inside (or at the entry of) a
        ledgered collective.  Returns the centrally-delivered result, or
        the _RERUN sentinel after rewinding the sequence number so the
        caller's retry loop re-runs the dance over the patched world."""
        outcome, delivered = _recovery.participate(self, desc)
        if outcome == "deliver":
            # the logical op consumed both of its tag-sequence slots
            self.coll_seq[comm] = seq0 + 2
            if self.ledger is not None:
                self.ledger.commit(desc["key"], self.rank)
            return delivered
        if outcome == "cancelled":
            # only the driver's abort → restart (or a retry epoch) is a
            # safe continuation of a part-patched world
            _recovery.await_fallback(self)
        self.coll_seq[comm] = seq0
        return MPI._RERUN

    def _apply_recovery_patch(self, dead: List[int],
                              purge: List[Tuple[int, int]]) -> None:
        """Coordinator-ordered world patch (recovery sub-FSM, phase
        ``patch``): purge every envelope of the interrupted dances, shrink
        the dead ranks out of every communicator IN PLACE (world-rank ids
        stay sparse), re-register the shrunk memberships with the proxy
        and zero the drain counters — safe because quiesce just proved the
        transport empty, and cache matches never bump ``received``."""
        dead_set = set(dead)
        purge_set = {(int(c), int(t)) for c, t in purge}
        self.cache.envelopes = [
            e for e in self.cache.envelopes
            if (e.comm_vid, e.tag) not in purge_set
            and not (e.src in dead_set and e.tag >= COLL_TAG_BASE)]
        self.vids.shrink_world(dead_set)
        for vid, info in self.vids.comms.items():
            if vid != WORLD_VID:
                self.channel.call(CMD_REGISTER_COMM, vid, info.ranks)
        self.sent = 0
        self.received = 0
        self._report()

    def _ring_allreduce(self, value: np.ndarray, op: str = "sum",
                        comm: int = COMM_WORLD) -> np.ndarray:
        """Ring reduce-scatter + ring allgather: 2·(n-1) steps of S/n-sized
        chunks, ~2·S bytes through every endpoint regardless of n — also
        the data-parallel gradient path in distributed/proxy_grad.py."""
        info = self.vids.comms[comm]
        n, me = info.size(), info.rank_of(self.rank)
        tag_rs = self._ctag(comm, 6)
        tag_ag = self._ctag(comm, 7)
        fn = _OPS[op]
        flat = value.reshape(-1)
        chunks = np.array_split(flat, n)
        chunks = [c.copy() for c in chunks]
        # reduce-scatter
        for step in range(n - 1):
            send_idx = (me - step) % n
            recv_idx = (me - step - 1) % n
            self._send_raw(chunks[send_idx], (me + 1) % n, tag_rs, comm)
            incoming = self.Recv(source=(me - 1) % n, tag=tag_rs, comm=comm)
            chunks[recv_idx] = fn(chunks[recv_idx], incoming)
            if self._hop_hook is not None:
                self._hop_hook("rs", step)
        # allgather
        for step in range(n - 1):
            send_idx = (me - step + 1) % n
            recv_idx = (me - step) % n
            self._send_raw(chunks[send_idx], (me + 1) % n, tag_ag, comm)
            chunks[recv_idx] = self.Recv(source=(me - 1) % n, tag=tag_ag,
                                         comm=comm)
            if self._hop_hook is not None:
                self._hop_hook("ag", step)
        return np.concatenate(chunks).reshape(value.shape)

    def Sendrecv(self, value: Any, dest: int, sendtag: int, source: int,
                 recvtag: int, comm: int = COMM_WORLD) -> Any:
        """Combined send+receive (deadlock-free here: sends are buffered
        through the proxy).  Also used internally with collective tags."""
        self._send_raw(value, dest, sendtag, comm)
        return self.Recv(source=source, tag=recvtag, comm=comm)

    @_collective_op
    def Alltoall(self, values: List[Any], comm: int = COMM_WORLD) -> List[Any]:
        """values[j] goes to comm-rank j; returns what each rank sent me."""
        info = self.vids.comms[comm]
        n, me = info.size(), info.rank_of(self.rank)
        assert len(values) == n
        tag = self._ctag(comm, 8)
        out: List[Any] = [None] * n
        out[me] = values[me]
        for off in range(1, n):
            dst = (me + off) % n
            src = (me - off) % n
            out[src] = self.Sendrecv(values[dst], dst, tag, src, tag, comm)
        return out

    @_collective_op
    def Reduce_scatter(self, value: Any, op: str = "sum",
                       comm: int = COMM_WORLD) -> Any:
        """Ring reduce-scatter: rank i returns the fully-reduced block i of
        value split into comm_size chunks along axis 0."""
        info = self.vids.comms[comm]
        n, me = info.size(), info.rank_of(self.rank)
        chunks = [c.copy() for c in np.array_split(np.asarray(value), n)]
        if n == 1:
            return chunks[0]
        fn = _OPS[op]
        tag = self._ctag(comm, 9)
        for step in range(n - 1):
            send_idx = (me - step) % n
            recv_idx = (me - step - 1) % n
            self._send_raw(chunks[send_idx], (me + 1) % n, tag, comm)
            chunks[recv_idx] = fn(chunks[recv_idx],
                                  self.Recv(source=(me - 1) % n, tag=tag,
                                            comm=comm))
        # after the ring, block (me+1)%n is complete here; route it home
        tag2 = self._ctag(comm, 10)
        owner = (me + 1) % n
        mine = self.Sendrecv(chunks[owner], owner, tag2, (me - 1) % n, tag2,
                             comm)
        return mine

    # ------------------------------------------------- communicators / groups
    def Comm_group(self, comm: int = COMM_WORLD) -> int:
        info = self.vids.comms[comm]
        g = self.vids.new_group(info.ranks)
        self.admin.append("group_incl", (tuple(info.ranks),), g.vid)
        return g.vid

    def Group_incl(self, group: int, ranks: List[int]) -> int:
        base = self.vids.groups[group]
        sub = tuple(base.ranks[r] for r in ranks)
        g = self.vids.new_group(sub)
        self.admin.append("group_incl", (sub,), g.vid)
        return g.vid

    def Comm_create_group(self, group: int, comm: int = COMM_WORLD) -> Optional[int]:
        g = self.vids.groups[group]
        if self.rank not in g.ranks:
            return None
        c = self.vids.new_comm(g.ranks)
        self.admin.append("comm_create", (tuple(g.ranks),), c.vid)
        self.channel.call(CMD_REGISTER_COMM, c.vid, tuple(g.ranks))
        self.coll_seq.setdefault(c.vid, 0)
        return c.vid

    def Comm_split(self, color: int, key: int, comm: int = COMM_WORLD) -> int:
        """Implemented with Allgather plumbing (paper §6: 'a simple matter
        of plumbing')."""
        info = self.vids.comms[comm]
        me = info.rank_of(self.rank)
        all_ck = self.Allgather((color, key, self.rank), comm)
        mine = sorted((k, wr) for c, k, wr in all_ck if c == color)
        ranks = tuple(wr for _, wr in mine)
        c = self.vids.new_comm(ranks)
        self.admin.append("comm_create", (ranks,), c.vid)
        self.channel.call(CMD_REGISTER_COMM, c.vid, ranks)
        self.coll_seq.setdefault(c.vid, 0)
        return c.vid

    def Group_free(self, group: int) -> None:
        self.vids.free_group(group)
        self.admin.append("group_free", (), group)

    def Comm_free(self, comm: int) -> None:
        self.vids.free_comm(comm)
        self.coll_seq.pop(comm, None)
        self.admin.append("comm_free", (), comm)
        self.channel.call(CMD_UNREGISTER_COMM, comm)

    # -------------------------------------------------------------- telemetry
    def wait_us_total(self) -> int:
        """Total µs blocked on the transport (recv + collective); the
        runtime differences this across a step to split wall time into
        compute vs wait for the StragglerTracker."""
        return self.wait_recv_us + self.wait_coll_us

    def telemetry(self) -> dict:
        """Per-rank data-plane counter snapshot (DESIGN.md §12): the
        compute/wait split plus bytes moved per fabric.  Piggybacked to the
        coordinator at step boundaries and surfaced via MPIJob.stats()."""
        ch = getattr(self.channel, "stats", None) or {}
        return {
            "wait_recv_us": self.wait_recv_us,
            "wait_coll_us": self.wait_coll_us,
            "bytes_sent": self.bytes_sent,
            "bytes_received": self.bytes_received,
            "ring_bytes": int(ch.get("ring_bytes", 0)),
            "round_trips": int(ch.get("round_trips", 0)),
            "async_batches": int(ch.get("async_batches", 0)),
            "sent": self.sent,
            "received": self.received,
        }

    # ------------------------------------------------------------- checkpoint
    def snapshot(self) -> dict:
        return {
            "rank": self.rank,
            "n": self.n,
            "cache": self.cache.snapshot(),
            "vids": self.vids.snapshot(),
            "admin": self.admin.snapshot(),
            "sent": self.sent,
            "received": self.received,
            "bytes_sent": self.bytes_sent,
            "bytes_received": self.bytes_received,
            "wait_recv_us": self.wait_recv_us,
            "wait_coll_us": self.wait_coll_us,
            "coll_seq": dict(self.coll_seq),
        }

    def restore(self, snap: dict) -> None:
        assert snap["rank"] == self.rank and snap["n"] == self.n
        self.cache = MessageCache.restore(snap["cache"])
        self.admin = AdminLog.restore(snap["admin"])
        self.vids = VirtualIds(self.n)
        # replay admin ops against the FRESH proxy (any transport), then
        # overlay exact virtual-id tables (incl. pending recvs)
        self.admin.replay(self.vids, _ProxyFacade(self.channel))
        self.vids.restore(snap["vids"], self.n)
        self.sent = snap["sent"]
        self.received = snap["received"]
        self.bytes_sent = snap.get("bytes_sent", 0)
        self.bytes_received = snap.get("bytes_received", 0)
        self.wait_recv_us = snap.get("wait_recv_us", 0)
        self.wait_coll_us = snap.get("wait_coll_us", 0)
        self.coll_seq = dict(snap["coll_seq"])
        self._initialized = True
        self._report()


def remap_mpi_snapshot(snap: dict, rank_map: RankMap, new_rank: int,
                       new_n: int, clone: bool = False) -> dict:
    """World-remap one rank's MPI.snapshot() for an elastic restart.

    `clone=True` marks a GROWN member (a new rank seeded from a survivor's
    image): it inherits the survivor's communicator layout and collective
    sequence numbers (so the first post-restart collective lines up across
    old and new members) but has NO in-flight history — cache and pending
    recvs are cleared.

    sent/received reset to 0 for every member: the drain heuristic's
    Σsent == Σreceived invariant is epoch-scoped to the membership
    generation, and messages exchanged with dead ranks would otherwise
    unbalance the sums forever (DESIGN.md §8)."""
    vids_snap, dropped_comms = remap_vids_snapshot(snap["vids"], rank_map,
                                                   new_n)
    admin = AdminLog.restore(snap["admin"]).remap(rank_map, new_rank, new_n)
    if clone:
        cache: list = []
        vids_snap = dict(vids_snap, pending_recvs=[])
    else:
        cache = remap_cache_snapshot(snap["cache"], rank_map, dropped_comms)
    coll_seq = {int(v): s for v, s in snap["coll_seq"].items()
                if int(v) not in dropped_comms}
    return {
        "rank": new_rank,
        "n": new_n,
        "cache": cache,
        "vids": vids_snap,
        "admin": admin.snapshot(),
        "sent": 0,
        "received": 0,
        "bytes_sent": snap.get("bytes_sent", 0),
        "bytes_received": snap.get("bytes_received", 0),
        "wait_recv_us": snap.get("wait_recv_us", 0),
        "wait_coll_us": snap.get("wait_coll_us", 0),
        "coll_seq": coll_seq,
    }


class _ProxyFacade:
    """Adapter giving AdminLog.replay proxy-method names over the channel."""

    def __init__(self, channel: ProxyChannel):
        self.channel = channel

    def register_rank(self, rank: int, n: int) -> None:
        self.channel.call(CMD_REGISTER_RANK, rank, n)

    def register_comm(self, vid: int, ranks: tuple) -> None:
        self.channel.call(CMD_REGISTER_COMM, vid, ranks)

    def unregister_comm(self, vid: int) -> None:
        self.channel.call(CMD_UNREGISTER_COMM, vid)
