"""Pluggable transports — the "MPI implementations" of the reproduction.

Three deliberately different mechanisms prove implementation-agnosticism
(paper §1, §7):

  * ShmTransport — in-process SimpleQueues (the "shared-memory MPI").
  * TcpTransport — real localhost sockets through a switchboard daemon
    (the "socket MPI"); frames are length-prefixed pickled Envelopes.
  * InprocTransport — a single shared condition variable over per-rank
    deques (the "third vendor": one lock for the whole fabric, batch
    appends under one acquisition).  Exists so elastic restarts can hop
    checkpoint-on-tcp → restart-on-inproc and back.

Both speak the batched fabric API: ``send_many`` ships a whole proxy batch
in one operation (one writev-style socket write for TCP) and ``poll_all``
drains every envelope available to a rank in one call — the transport half
of the proxy wire protocol (DESIGN.md §4).

Transports self-register into the ``TRANSPORTS`` registry via
``register_transport``; out-of-tree backends can plug in the same way.

The checkpoint NEVER serializes a transport: at restart the runtime builds
a FRESH transport (possibly of the other kind) and replays the admin log.
A checkpoint written under one transport restarting under the other is the
paper's future-work cross-implementation claim, validated in
tests/test_drain_restart.py::test_cross_transport_restart.
"""
from __future__ import annotations

import collections
import pickle
import queue
import socket
import struct
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Type

from repro_torch.core.messages import Envelope


# ------------------------------------------------------------ frame helpers
# One framing for every socket in the system: 8-byte big-endian length +
# body.  The switchboard and TcpTransport clients frame pickled Envelopes
# this way, and the PROCESS world (core/procworld.py) reuses the exact same
# framing for the child <-> per-rank-endpoint wire protocol batches.
#
# Two body encodings share that outer framing (DESIGN.md §12):
#
#   * plain pickle — what bufferless frames use.
#   * scatter-gather (SG) — bodies that begin with ``SG_MAGIC``: a pickle
#     protocol-5 HEAD with its out-of-band buffers laid flat after it.
#     Tensor payloads travel as raw buffers (no intermediate bytes
#     concatenation on either side); ``write_frame_parts`` ships header +
#     head + buffers with one writev-style ``sendmsg`` and
#     ``read_frame_mv`` lands the whole body in ONE preallocated writable
#     buffer via ``recv_into``, so received arrays are zero-concat views.
#
# ``loads_body`` dispatches on the magic, so SG-speaking endpoints accept
# plain-pickle peers unchanged (pickle bodies of protocol >= 2 start with
# b"\x80" — they can never alias the magic).

def read_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly `n` bytes; None on EOF/error (a torn or half-written
    frame — e.g. the peer was SIGKILLed mid-send — reads as EOF, never as
    a short garbage frame)."""
    buf = b""
    while len(buf) < n:
        try:
            chunk = conn.recv(n - len(buf))
        except socket.timeout:
            continue
        except (OSError, ConnectionError):
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


def read_frame(conn: socket.socket) -> Optional[bytes]:
    """One length-prefixed frame body, or None on EOF/torn frame."""
    hdr = read_exact(conn, 8)
    if hdr is None:
        return None
    (ln,) = struct.unpack("!q", hdr)
    return read_exact(conn, ln)


def write_frame(conn: socket.socket, body: bytes) -> None:
    conn.sendall(struct.pack("!q", len(body)) + body)


# --------------------------------------------- scatter-gather body encoding

SG_MAGIC = b"SGP5"

# chunk iovecs below the kernel's per-sendmsg limit; 1024 is the floor
# POSIX guarantees and far above any real batch here
_IOV_MAX = min(int(getattr(socket, "IOV_MAX", 1024)), 1024)


def dumps_parts(obj: Any) -> List[Any]:
    """Serialize `obj` into SG body parts ``[meta, head, *buffers]``.

    ``head`` is a pickle protocol-5 dump with every buffer-protocol payload
    (ndarrays, PickleBuffer-wrapped blobs) exported OUT-OF-BAND — the
    returned buffers are zero-copy views of the caller's data, so they must
    be shipped before the caller mutates them (senders pass private copies;
    see messages.pack).  ``meta`` carries the buffer table needed to split
    the flat body back apart."""
    pbufs: List[pickle.PickleBuffer] = []
    head = pickle.dumps(obj, protocol=5, buffer_callback=pbufs.append)
    if not pbufs:
        # no out-of-band payloads: the plain pickle IS the body (a pickle
        # can never lead with the magic, so readers stay unambiguous, and
        # pre-SG peers can still parse bufferless replies)
        return [head]
    raws: List[memoryview] = []
    for pb in pbufs:
        try:
            raws.append(pb.raw())
        except BufferError:                 # non-contiguous exporter
            raws.append(memoryview(bytes(pb)))
    meta = (SG_MAGIC + struct.pack("!iq", len(raws), len(head))
            + struct.pack("!%dq" % len(raws), *(r.nbytes for r in raws)))
    return [meta, head, *raws]


def split_body(body):
    """An SG body as ``(head, [buffer views])`` into `body`, or a plain
    pickle body as ``(body, None)``."""
    mv = memoryview(body)
    if mv.ndim != 1 or mv.format != "B":
        mv = mv.cast("B")
    if mv.nbytes >= 4 and bytes(mv[:4]) == SG_MAGIC:
        nbufs, head_len = struct.unpack_from("!iq", mv, 4)
        lens = struct.unpack_from("!%dq" % nbufs, mv, 16)
        off = 16 + 8 * nbufs
        head = mv[off:off + head_len]
        pos = off + head_len
        bufs = []
        for ln in lens:
            bufs.append(mv[pos:pos + ln])
            pos += ln
        return head, bufs
    return mv, None


def loads_body(body) -> Any:
    """Decode one frame body: SG when it leads with the magic, else plain
    pickle.  Out-of-band buffers are reconstructed as views INTO `body` —
    pass a writable buffer (``read_frame_mv``) to get writable arrays."""
    head, bufs = split_body(body)
    if bufs is None:
        return pickle.loads(head)
    return pickle.loads(head, buffers=bufs)


def frame_iov(parts: Sequence[Any]) -> List[memoryview]:
    """Length-prefix a parts list into an iovec (no concatenation): the
    8-byte total plus one memoryview per part, ready for ``sendmsg_all``."""
    views = []
    for p in parts:
        v = p if isinstance(p, memoryview) else memoryview(p)
        if v.ndim != 1 or v.format != "B":
            v = v.cast("B")
        views.append(v)
    total = sum(v.nbytes for v in views)
    return [memoryview(struct.pack("!q", total)), *views]


def sendmsg_all(conn: socket.socket, iov: Sequence[memoryview]) -> None:
    """``sendall`` semantics over an iovec: one gather write when the OS
    cooperates, looping over partial sends and IOV_MAX without ever
    building the concatenated frame."""
    bufs = [v for v in iov if v.nbytes]
    if not hasattr(conn, "sendmsg"):        # pragma: no cover - posix has it
        conn.sendall(b"".join(bufs))
        return
    i = 0
    while i < len(bufs):
        try:
            n = conn.sendmsg(bufs[i:i + _IOV_MAX])
        except socket.timeout:
            continue
        except InterruptedError:
            continue
        while n:
            take = min(n, bufs[i].nbytes)
            if take == bufs[i].nbytes:
                i += 1
            else:
                bufs[i] = bufs[i][take:]
            n -= take


def write_frame_parts(conn: socket.socket, parts: Sequence[Any]) -> None:
    """SG counterpart of ``write_frame``: frame = header + every part,
    shipped by gather write — zero intermediate concatenations."""
    sendmsg_all(conn, frame_iov(parts))


def read_frame_mv(conn: socket.socket) -> Optional[memoryview]:
    """SG counterpart of ``read_frame``: the whole body lands in one
    preallocated WRITABLE buffer via ``recv_into`` (no per-chunk bytes
    concatenation; arrays decoded from it by ``loads_body`` are writable
    views).  None on EOF/torn frame, like ``read_frame``."""
    hdr = read_exact(conn, 8)
    if hdr is None:
        return None
    (ln,) = struct.unpack("!q", hdr)
    if ln < 0:
        return None
    view = memoryview(bytearray(ln))
    got = 0
    while got < ln:
        try:
            k = conn.recv_into(view[got:])
        except socket.timeout:
            continue
        except (OSError, ConnectionError):
            return None
        if not k:
            return None
        got += k
    return view


class Transport:
    """Reliable, per-(src,dst)-ordered message fabric."""

    name = "abstract"

    def start(self, n_ranks: int) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError

    def send(self, env: Envelope) -> None:
        raise NotImplementedError

    def poll(self, rank: int) -> Optional[Envelope]:
        """Non-blocking: next envelope destined to `rank`, else None."""
        raise NotImplementedError

    def peek(self, rank: int) -> Optional[bool]:
        """NON-CONSUMING emptiness hint: False = definitely nothing queued
        for `rank` right now, True = something may be, None = backend can't
        tell.  Must be safe to call from a thread that is not the proxy
        (the Iprobe-miss fast path reads it without a channel round trip);
        a False may race with a concurrent send — callers treat it as
        'nothing had arrived yet', which is exactly Iprobe's contract."""
        return None

    # ---- batched fabric API (generic fallbacks; backends override) ---------
    def send_many(self, envs: Sequence[Envelope]) -> None:
        """Ship a batch.  Per-(src,dst) order within the batch is preserved."""
        for env in envs:
            self.send(env)

    def poll_all(self, rank: int) -> List[Envelope]:
        """Non-blocking: EVERY envelope currently available to `rank`."""
        out: List[Envelope] = []
        while True:
            env = self.poll(rank)
            if env is None:
                return out
            out.append(env)

    def poll_wait(self, rank: int, timeout: float) -> List[Envelope]:
        """Bulk poll that BLOCKS up to `timeout` seconds for the first
        envelope (then drains the rest).  Backends override with a real
        blocking wait so idle receivers burn no CPU."""
        deadline = time.monotonic() + timeout
        while True:
            out = self.poll_all(rank)
            if out or time.monotonic() >= deadline:
                return out
            time.sleep(0.0002)


# --------------------------------------------------------------- registry
TRANSPORTS: Dict[str, Type[Transport]] = {}


def register_transport(cls: Type[Transport]) -> Type[Transport]:
    """Class decorator/registration hook: ``TRANSPORTS[cls.name] = cls``."""
    if not (isinstance(getattr(cls, "name", None), str)
            and cls.name and cls.name != "abstract"):
        raise ValueError(f"{cls!r} needs a concrete `name` to register")
    TRANSPORTS[cls.name] = cls
    return cls


def available_transports() -> List[str]:
    return sorted(TRANSPORTS)


def make_transport(name: str) -> Transport:
    try:
        return TRANSPORTS[name]()
    except KeyError:
        raise ValueError(f"unknown transport {name!r}; "
                         f"available: {available_transports()}") from None


@register_transport
class ShmTransport(Transport):
    name = "shm"

    def start(self, n_ranks: int) -> None:
        self._queues: List[queue.SimpleQueue] = [
            queue.SimpleQueue() for _ in range(n_ranks)]

    def stop(self) -> None:
        self._queues = []

    def send(self, env: Envelope) -> None:
        self._queues[env.dst].put(env)

    def send_many(self, envs: Sequence[Envelope]) -> None:
        qs = self._queues
        for env in envs:
            qs[env.dst].put(env)

    def poll(self, rank: int) -> Optional[Envelope]:
        try:
            return self._queues[rank].get_nowait()
        except queue.Empty:
            return None

    def peek(self, rank: int) -> Optional[bool]:
        try:
            return not self._queues[rank].empty()
        except IndexError:        # stopped
            return None

    def poll_all(self, rank: int) -> List[Envelope]:
        q = self._queues[rank]
        out: List[Envelope] = []
        while True:
            try:
                out.append(q.get_nowait())
            except queue.Empty:
                return out

    def poll_wait(self, rank: int, timeout: float) -> List[Envelope]:
        q = self._queues[rank]
        try:
            out = [q.get(timeout=timeout)]    # real OS wait, no spinning
        except queue.Empty:
            return []
        while True:
            try:
                out.append(q.get_nowait())
            except queue.Empty:
                return out


@register_transport
class InprocTransport(Transport):
    """Third 'MPI implementation': per-rank deques under ONE shared
    condition variable.  send_many appends a whole batch under a single
    lock acquisition; poll_wait parks on the condition (no per-rank
    queue object, no sockets) — structurally unlike both shm and tcp,
    which is the point: a checkpoint must restore onto it unchanged."""

    name = "inproc"

    def start(self, n_ranks: int) -> None:
        self._cv = threading.Condition()
        self._boxes: List[Deque[Envelope]] = [
            collections.deque() for _ in range(n_ranks)]

    def stop(self) -> None:
        with self._cv:
            self._boxes = []
            self._cv.notify_all()

    def send(self, env: Envelope) -> None:
        with self._cv:
            self._boxes[env.dst].append(env)
            self._cv.notify_all()

    def send_many(self, envs: Sequence[Envelope]) -> None:
        if not envs:
            return
        with self._cv:
            boxes = self._boxes
            for env in envs:
                boxes[env.dst].append(env)
            self._cv.notify_all()

    def poll(self, rank: int) -> Optional[Envelope]:
        with self._cv:
            box = self._boxes[rank] if rank < len(self._boxes) else None
            return box.popleft() if box else None

    def peek(self, rank: int) -> Optional[bool]:
        # lock-free read: deque truthiness is atomic under the GIL, and a
        # racing append only turns a False into "arrived just after"
        boxes = self._boxes
        return bool(boxes[rank]) if rank < len(boxes) else None

    def poll_all(self, rank: int) -> List[Envelope]:
        with self._cv:
            if rank >= len(self._boxes):
                return []
            box = self._boxes[rank]
            out = list(box)
            box.clear()
            return out

    def poll_wait(self, rank: int, timeout: float) -> List[Envelope]:
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                if rank >= len(self._boxes):     # stopped
                    return []
                box = self._boxes[rank]
                if box:
                    out = list(box)
                    box.clear()
                    return out
                left = deadline - time.monotonic()
                if left <= 0:
                    return []
                self._cv.wait(left)


class _Switchboard(threading.Thread):
    """Routing daemon: accepts one connection per rank, forwards frames.

    Shutdown is deterministic: ``accept()`` runs with a short timeout and
    re-checks the stop flag, so ``shutdown()`` unblocks the thread even if
    fewer than `n` ranks ever connect; reader threads are joined by
    ``shutdown()`` (they exit once their sockets close)."""

    def __init__(self, n_ranks: int):
        super().__init__(daemon=True, name="mpi-switchboard")
        self.n = n_ranks
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(n_ranks)
        self.srv.settimeout(0.2)
        self.port = self.srv.getsockname()[1]
        self.conns: Dict[int, socket.socket] = {}
        self.lock = threading.Lock()
        self._halt = threading.Event()
        self._readers: List[threading.Thread] = []

    def run(self) -> None:
        while len(self.conns) < self.n and not self._halt.is_set():
            try:
                conn, _ = self.srv.accept()
            except socket.timeout:
                continue
            except OSError:          # server socket closed by shutdown()
                return
            hdr = read_exact(conn, 4)
            if hdr is None:
                conn.close()
                continue
            rank = struct.unpack("!i", hdr)[0]
            with self.lock:
                self.conns[rank] = conn
            t = threading.Thread(target=self._pump, args=(conn,), daemon=True)
            t.start()
            self._readers.append(t)

    def _pump(self, conn: socket.socket) -> None:
        try:
            while not self._halt.is_set():
                body = read_frame_mv(conn)
                if body is None:
                    return
                # decode only to route (payload buffers stay views into
                # `body`); forward the RECEIVED bytes verbatim by gather
                # write — the switchboard never reserializes or concats
                env = loads_body(body)
                with self.lock:
                    out = self.conns.get(env.dst)
                if out is not None:
                    hdr = memoryview(struct.pack("!q", body.nbytes))
                    with self.lock:
                        sendmsg_all(out, [hdr, body])
        except (OSError, ConnectionError):
            return



    def shutdown(self, join_timeout: float = 5.0) -> None:
        self._halt.set()
        try:
            self.srv.close()
        except OSError:
            pass
        with self.lock:
            conns = list(self.conns.values())
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self.join(join_timeout)
        for t in self._readers:
            t.join(join_timeout)


@register_transport
class TcpTransport(Transport):
    name = "tcp"

    def start(self, n_ranks: int) -> None:
        self.n = n_ranks
        self.board = _Switchboard(n_ranks)
        self.board.start()
        self._socks: List[socket.socket] = []
        self._inbox: List[queue.SimpleQueue] = [queue.SimpleQueue()
                                                for _ in range(n_ranks)]
        self._send_locks = [threading.Lock() for _ in range(n_ranks)]
        self._readers = []
        self._halt = threading.Event()
        for r in range(n_ranks):
            s = socket.create_connection(("127.0.0.1", self.board.port))
            s.sendall(struct.pack("!i", r))
            self._socks.append(s)
            t = threading.Thread(target=self._reader, args=(r, s), daemon=True)
            t.start()
            self._readers.append(t)
        # the switchboard registers connections asynchronously; a frame for
        # an unregistered rank would be DROPPED, so don't hand the transport
        # over until every rank's connection is routable
        deadline = time.monotonic() + 10.0
        while True:
            with self.board.lock:
                if len(self.board.conns) == n_ranks:
                    break
            if time.monotonic() > deadline:
                raise TimeoutError("switchboard did not register all ranks")
            time.sleep(0.001)

    def _reader(self, rank: int, s: socket.socket) -> None:
        while not self._halt.is_set():
            body = read_frame_mv(s)
            if body is None:
                return
            # arrays decoded here are writable zero-concat views into the
            # frame buffer (see read_frame_mv)
            self._inbox[rank].put(loads_body(body))

    def stop(self) -> None:
        self._halt.set()
        for s in self._socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        self.board.shutdown()
        for t in self._readers:
            t.join(5.0)

    def send(self, env: Envelope) -> None:
        iov = frame_iov(dumps_parts(env))
        with self._send_locks[env.src]:
            sendmsg_all(self._socks[env.src], iov)

    def send_many(self, envs: Sequence[Envelope]) -> None:
        """One gather write per source socket: every frame of the batch
        rides a single ``sendmsg`` under a single lock acquisition, tensor
        payloads as out-of-band buffers — zero concatenations."""
        if not envs:
            return
        by_src: Dict[int, List[memoryview]] = {}
        for env in envs:
            by_src.setdefault(env.src, []).extend(frame_iov(dumps_parts(env)))
        for src, iov in by_src.items():
            with self._send_locks[src]:
                sendmsg_all(self._socks[src], iov)

    def poll(self, rank: int) -> Optional[Envelope]:
        try:
            return self._inbox[rank].get_nowait()
        except queue.Empty:
            return None

    def peek(self, rank: int) -> Optional[bool]:
        try:
            return not self._inbox[rank].empty()
        except IndexError:        # stopped
            return None

    def poll_all(self, rank: int) -> List[Envelope]:
        q = self._inbox[rank]
        out: List[Envelope] = []
        while True:
            try:
                out.append(q.get_nowait())
            except queue.Empty:
                return out

    def poll_wait(self, rank: int, timeout: float) -> List[Envelope]:
        q = self._inbox[rank]
        try:
            out = [q.get(timeout=timeout)]
        except queue.Empty:
            return []
        while True:
            try:
                out.append(q.get_nowait())
            except queue.Empty:
                return out


@register_transport
class ProcTransport(ShmTransport):
    """Parent-side fabric of the PROCESS world (core/procworld.py).

    Selecting ``transport="proc"`` on an MPIJob runs every rank as a real
    OS process.  The cross-process hop is the child's socket to its
    per-rank proxy endpoint in the launcher process (SG frames via
    ``write_frame_parts``/``read_frame_mv`` above, exactly like
    TcpTransport frames); endpoint threads then route envelopes between
    ranks through THIS queue fabric.  Structurally: the child owns only
    the plugin, the launcher owns every transport byte — the paper's proxy
    split enforced by a real address-space boundary instead of a thread
    convention."""

    name = "proc"
    #: the runtime keys process-world behavior off this attribute (not the
    #: name), so ring-enabled subclasses inherit the whole launch path
    proc_world = True
    #: whether the ProcWorld should create a shared-memory tensor ring
    use_ring = False


@register_transport
class ShmRingTransport(ProcTransport):
    """Process world + the zero-copy shared-memory tensor ring
    (core/dataplane.py, DESIGN.md §12).

    Identical to ``proc`` except tensor payloads >= RING_PAYLOAD_MIN are
    parked in a pre-fork ``multiprocessing.shared_memory`` ring and the
    socket frames carry only descriptors (slot, length, generation stamp,
    dtype, shape) — the launcher-side endpoint and the receiving child never see
    the tensor bytes on the wire.  Falls back to inline SG frames
    payload-by-payload whenever the ring is full or unavailable, so
    results are bit-identical to ``proc``/``tcp`` by construction."""

    name = "shmring"
    use_ring = True
