"""Socket framing of the chunk service (copy of the frame helpers of
``repro.core.transport``; its ``Transport`` classes and ``Envelope`` are
the MPI substrate, which the port does not have).

One framing for every socket: an 8-byte big-endian length, then the
body.  Two body encodings share it:

  * plain pickle — what bufferless frames use;
  * scatter-gather (SG) — bodies that begin with ``SG_MAGIC``: a pickle
    protocol-5 HEAD with its out-of-band buffers laid flat after it.
    ``write_frame_parts`` ships header + head + buffers with one
    writev-style ``sendmsg`` and ``read_frame_mv`` lands the whole body in
    ONE preallocated writable buffer via ``recv_into``, so received blobs
    are zero-concat views.

``loads_body`` dispatches on the magic (pickle bodies of protocol >= 2
start with b"\\x80" and can never alias it).  The frames are byte for byte
the reference's, so either package's client talks to the other's server.
"""
from __future__ import annotations

import pickle
import socket
import struct
from typing import Any, List, Optional, Sequence


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
    be shipped before the caller mutates them.  ``meta`` carries the buffer
    table needed to split the flat body back apart."""
    pbufs: List[pickle.PickleBuffer] = []
    head = pickle.dumps(obj, protocol=5, buffer_callback=pbufs.append)
    if not pbufs:
        # no out-of-band payloads: the plain pickle IS the body
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
    preallocated WRITABLE buffer via ``recv_into``.  None on EOF/torn
    frame, like ``read_frame``."""
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
