"""The MPI proxy — owner of the ACTIVE transport (paper §3).

Each rank's plugin talks to its proxy exclusively through a ProxyChannel
(two queues = the paper's "single, ephemeral interface").  Since the batched
protocol rewrite the interface is a real versioned wire protocol (see
DESIGN.md §3) rather than ad-hoc tuples:

  * every queue item is a BATCH ``(version, [(cmd, args), ...], want_reply)``
    — one cross-thread hop carries many commands;
  * sends are FIRE-AND-FORGET: the plugin buffers them and pushes batches
    without waiting for a reply; errors land in a deferred-error slot on the
    proxy and are raised at the next replied call (every blocking call and
    every checkpoint boundary replies);
  * ``CMD_POLL_ALL`` drains every available envelope in ONE round trip;
  * ``CMD_FLUSH`` is the sync barrier: when its reply arrives, every
    previously queued command has executed and any deferred error has been
    surfaced — this is what makes the channel *verifiably empty* at
    snapshot time.

The proxy thread pumps batches; it holds transport handles, per-destination
sequence numbers and comm-addressing tables — ALL of which are rebuilt from
the admin log on restart and are NEVER serialized into a checkpoint.  The
assertion of the architecture: ``grep`` finds no transport reference in
api.py, ckpt_protocol.py or runtime.py rank images.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import trace as _trace
from repro_torch.core.messages import Envelope
from repro_torch.core.transport import Transport

PROTOCOL_VERSION = 2

CMD_SEND = "send"
CMD_POLL = "poll"
CMD_POLL_ALL = "poll_all"
CMD_POLL_WAIT = "poll_wait"
CMD_FLUSH = "flush"
CMD_REGISTER_RANK = "register_rank"
CMD_REGISTER_COMM = "register_comm"
CMD_UNREGISTER_COMM = "unregister_comm"
CMD_STOP = "stop"

# fire-and-forget buffer auto-pushes past this many commands so a long
# send burst cannot grow the plugin-side buffer without bound
MAX_BATCH = 64

# preallocated singleton poll frame for the idle-channel fast path: built
# once, pushed verbatim — no per-call batch list, no concat (see
# ProxyChannel.poll_all_fast / MPIProxy._serve's matching branch)
_POLL_ALL_FAST_FRAME = (PROTOCOL_VERSION, ((CMD_POLL_ALL, ()),), True)


class ProtocolError(RuntimeError):
    """Channel and proxy disagree on the wire-protocol version."""


class ProxyChannel:
    """The checkpoint-boundary interface.  At checkpoint time this must be
    EMPTY (``flush()`` then ``is_empty()`` — asserted by the runtime before
    every snapshot); nothing here is serialized.

    Threading contract: exactly ONE plugin thread issues commands and
    exactly ONE proxy thread serves them, so at most one reply is ever
    outstanding and the response queue needs no correlation ids.

    Transport of the frames themselves is pluggable through two hooks —
    ``_push(frame)`` and ``_await_reply()``: this base class rides a pair
    of queues to an in-process proxy thread; the PROCESS world's
    SocketChannel (core/procworld.py) overrides the hooks to ship the
    identical frames over a socket.  Batching, MAX_BATCH auto-flush, and
    the stats contract live HERE, once.
    """

    def __init__(self) -> None:
        self.requests: "queue.SimpleQueue" = queue.SimpleQueue()
        self.responses: "queue.SimpleQueue" = queue.SimpleQueue()
        self._pending: List[Tuple[str, tuple]] = []
        self.closed = False          # set by the proxy thread on exit
        #: installed by the owning proxy: a zero-argument, non-consuming
        #: inbox-emptiness closure (Transport.peek bound to this rank).
        #: The plugin still never sees a transport — just an opaque hint.
        self.inbox_peek: Optional[Any] = None
        # ring_bytes counts payload bytes rerouted through the shared-memory
        # tensor ring (always 0 on this in-process base class; the process
        # world's ring-aware SocketChannel bumps it — DESIGN.md §12)
        self.stats = {"round_trips": 0, "async_batches": 0, "commands": 0,
                      "peek_misses": 0, "ring_bytes": 0}

    # ---- fire-and-forget path ---------------------------------------------
    def send_async(self, cmd: str, *args) -> None:
        """Queue a command with no reply.  Errors surface at the next
        replied call (deferred-error slot on the proxy)."""
        self._pending.append((cmd, args))
        if len(self._pending) >= MAX_BATCH:
            self.flush_async()

    def flush_async(self) -> None:
        """Push buffered commands as one fire-and-forget batch (no wait)."""
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        self.stats["async_batches"] += 1
        self.stats["commands"] += len(batch)
        self._push((PROTOCOL_VERSION, batch, False))

    # ---- replied path ------------------------------------------------------
    def call(self, cmd: str, *args) -> Any:
        """One round trip.  Buffered fire-and-forget commands piggyback on
        the same batch (executed first, in order), so a blocking call also
        flushes — and surfaces any deferred error."""
        if self.closed:
            raise RuntimeError("proxy channel closed")
        batch = self._pending + [(cmd, args)]
        self._pending = []
        self.stats["round_trips"] += 1
        self.stats["commands"] += len(batch)
        self._push((PROTOCOL_VERSION, batch, True))
        return self._await_reply()

    # ---- frame transport hooks (overridden by the socket channel) ----------
    def _push(self, frame: tuple) -> None:
        self.requests.put(frame)

    def _await_reply(self):
        """Wait for the single outstanding reply.  The timeout+`closed`
        re-check is the leak-free-teardown rule (DESIGN.md §6): a caller
        abandoned mid-call when the proxy shut down must not block
        forever."""
        while True:
            try:
                ok, val = self.responses.get(timeout=1.0)
                break
            except queue.Empty:
                if self.closed:
                    raise RuntimeError("proxy channel closed") from None
        if not ok:
            raise val
        return val

    def poll_miss_hint(self) -> bool:
        """True iff a non-blocking poll would DEFINITELY come back empty:
        nothing buffered to piggyback, and the transport's non-consuming
        peek says the inbox is empty.  The Iprobe-miss fast path returns
        on this without any cross-thread round trip (~50x cheaper than the
        queue ping-pong on this substrate).  A deferred send error, if
        any, still surfaces at the next replied call — Iprobe was never a
        reply barrier."""
        if self._pending or self.closed:
            return False
        peek = self.inbox_peek
        if peek is None:
            return False
        try:
            empty = peek() is False
        except Exception:            # transport stopping underneath us
            return False
        if empty:
            self.stats["peek_misses"] += 1
        return empty

    def poll_all_fast(self) -> Any:
        """Non-blocking bulk poll with an idle-channel fast path: when no
        sends are buffered the preallocated singleton frame goes out as-is,
        skipping batch construction here and the generic batch executor on
        the proxy (the Iprobe hot path — a miss is two queue hops and one
        transport poll, nothing else).  With buffered sends it degrades to
        a normal piggybacking call."""
        if self._pending:
            return self.call(CMD_POLL_ALL)
        if self.closed:
            raise RuntimeError("proxy channel closed")
        stats = self.stats
        stats["round_trips"] += 1
        stats["commands"] += 1
        self.requests.put(_POLL_ALL_FAST_FRAME)
        return self._await_reply()

    def flush(self) -> None:
        """Blocking sync barrier: returns once every queued command has
        executed; raises the deferred error if any async command failed."""
        self.call(CMD_FLUSH)

    def is_empty(self) -> bool:
        """True iff no command is buffered, queued, or awaiting pickup —
        the channel-empty-at-snapshot invariant (DESIGN.md §5)."""
        return (not self._pending and self.requests.empty()
                and self.responses.empty())


class ProxyCore:
    """The transport-owning half of the proxy, factored out of the serving
    loop: per-destination sequence numbers, comm-addressing tables, and the
    batch executor.  Two hosts drive it:

      * MPIProxy (below) — the thread-world proxy, fed by a ProxyChannel;
      * the per-rank endpoint thread of a PROCESS world
        (core/procworld.py) — fed the same versioned batches over a socket.

    Everything here is reconstructible from the admin log; none of it is
    ever serialized into a checkpoint."""

    def __init__(self, rank: int, transport: Transport):
        self.rank = rank
        self.transport = transport
        self._seq: Dict[int, int] = {}          # dst -> next seq
        self._comms: Dict[int, Tuple[int, ...]] = {}
        self._registered = False

    # ---- command handlers (executed on the serving thread) -----------------
    def register_rank(self, rank: int, n_ranks: int) -> None:
        self._registered = True

    def register_comm(self, vid: int, ranks: Tuple[int, ...]) -> None:
        self._comms[vid] = tuple(ranks)

    def unregister_comm(self, vid: int) -> None:
        self._comms.pop(vid, None)

    def _make_envelope(self, dst: int, tag: int, comm_vid: int, payload: bytes,
                       dtype: str, count: int) -> Envelope:
        seq = self._seq.get(dst, 0)
        self._seq[dst] = seq + 1
        return Envelope(src=self.rank, dst=dst, tag=tag, comm_vid=comm_vid,
                        seq=seq, payload=payload, dtype=dtype, count=count)

    def _do_poll(self) -> Optional[Envelope]:
        return self.transport.poll(self.rank)

    def _do_poll_all(self) -> List[Envelope]:
        return self.transport.poll_all(self.rank)

    def execute_batch(self, cmds: List[Tuple[str, tuple]]) -> Any:
        """Run a batch in order; consecutive sends coalesce into ONE
        transport.send_many call (the writev-style fast path).  Returns the
        last command's value; raises on the first failing command."""
        result: Any = None
        sends: List[Envelope] = []
        for cmd, args in cmds:
            if cmd == CMD_SEND:
                sends.append(self._make_envelope(*args))
                continue
            if sends:
                self.transport.send_many(sends)
                sends = []
            if cmd == CMD_POLL:
                result = self._do_poll()
            elif cmd == CMD_POLL_ALL:
                result = self._do_poll_all()
            elif cmd == CMD_POLL_WAIT:
                # the PROXY blocks on the transport (real OS wait); the
                # plugin thread meanwhile sleeps on the response queue —
                # nobody spins, nobody steals GIL time from busy ranks
                result = self.transport.poll_wait(self.rank, *args)
            elif cmd == CMD_FLUSH:
                result = None
            elif cmd == CMD_REGISTER_RANK:
                result = self.register_rank(*args)
            elif cmd == CMD_REGISTER_COMM:
                result = self.register_comm(*args)
            elif cmd == CMD_UNREGISTER_COMM:
                result = self.unregister_comm(*args)
            else:
                raise ValueError(f"unknown proxy command {cmd!r}")
        if sends:
            self.transport.send_many(sends)
        return result


class MPIProxy(threading.Thread):
    """Active-library process stand-in (thread; see DESIGN.md §2 assumption
    notes — the PROCESS world in core/procworld.py is the real-process
    variant).  Holds ONLY reconstructible state, all of it in the core."""

    def __init__(self, rank: int, transport: Transport, channel: ProxyChannel):
        super().__init__(daemon=True, name=f"mpi-proxy-{rank}")
        self.rank = rank
        self.transport = transport
        self.channel = channel
        self.core = ProxyCore(rank, transport)
        # hand the plugin side a non-consuming emptiness hint (the proxy
        # owns the transport; the channel exposes only this closure)
        channel.inbox_peek = (lambda: transport.peek(rank))
        self._deferred_error: Optional[Exception] = None

    def run(self) -> None:
        try:
            self._serve()
        finally:
            self.channel.closed = True

    def _serve(self) -> None:
        # aggregated batch spans (trace.BatchWindow): per-batch spans
        # would blow the CI overhead budget, the poll fast path below
        # stays completely untimed either way
        win = _trace.BatchWindow("proxy.batch", rank=self.rank)
        while True:
            req = self.channel.requests.get()
            if req is _POLL_ALL_FAST_FRAME and self._deferred_error is None:
                # idle-channel fast path: one transport poll, straight to
                # the response queue — no batch executor, no send coalescer
                try:
                    self.channel.responses.put(
                        (True, self.transport.poll_all(self.rank)))
                except Exception as e:
                    self.channel.responses.put((False, e))
                continue
            version, cmds, want_reply = req
            if version != PROTOCOL_VERSION:
                err: Exception = ProtocolError(
                    f"channel speaks v{version}, proxy v{PROTOCOL_VERSION}")
                if want_reply:
                    self.channel.responses.put((False, err))
                else:
                    self._deferred_error = self._deferred_error or err
                continue
            stop = any(c == CMD_STOP for c, _ in cmds)
            if stop:
                cmds = [c for c in cmds if c[0] != CMD_STOP]
            if want_reply and self._deferred_error is not None:
                # fail fast: an earlier fire-and-forget command died; the
                # plugin learns at its next replied call, commands dropped
                err, self._deferred_error = self._deferred_error, None
                self.channel.responses.put((False, err))
                if stop:
                    return
                continue
            try:
                if _trace.ENABLED:
                    t0 = time.monotonic()
                    result = self.core.execute_batch(cmds)
                    win.add(time.monotonic() - t0, len(cmds))
                else:
                    result = self.core.execute_batch(cmds)
                if want_reply:
                    self.channel.responses.put((True, result))
            except Exception as e:  # surfaced now or at the next reply
                if want_reply:
                    self.channel.responses.put((False, e))
                else:
                    self._deferred_error = self._deferred_error or e
            if stop:
                win.flush()
                return

    def stop(self) -> None:
        """Fire-and-forget shutdown: replied STOP would race with a rank
        thread mid-call (two waiters on one response queue steal each
        other's replies).  The runtime joins the thread instead; any caller
        still blocked unparks via the channel's `closed` flag.  No flush
        here — `_pending` belongs to the plugin thread and touching it from
        the stopping thread would race `send_async`."""
        self.channel.requests.put((PROTOCOL_VERSION, [(CMD_STOP, ())], False))
