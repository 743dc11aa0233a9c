"""Cross-host chunk service (copy of ``repro.checkpoint.chunkservice``):
the networked half of the checkpoint store.

A checkpoint is written against the ``ChunkStoreBackend`` interface, not
against a host's filesystem, so it can live behind a socket:

  * ``ChunkServer`` — serves a backing ``ChunkStore`` over sockets with
    the framing of ``core/transport.py`` (``write_frame_parts`` /
    ``read_frame_mv``: 8-byte length + scatter-gather pickle body) and
    versioned command batches.  Chunk blobs at or above ``_OOB_MIN``
    travel as pickle protocol-5 out-of-band buffers: a PUT gathers header
    + blob straight from the caller's buffer into ``sendmsg`` and a GET
    reply is decoded as a view over the one receive buffer.  Commands:
    HAS-many, PUT, GET(-many), REF, GC-live-set, LEASE, UNLEASE, LEASES,
    SIZE, LIST, STATS.  A request frame is read IN FULL before anything
    is applied, and the backing store commits with tmp-file + atomic
    rename — so a client SIGKILLed mid-upload (a torn frame, read as EOF)
    can never leave a partial chunk visible to ``has()``.
  * ``RemoteChunkStore`` — the client backend.  Connects lazily and
    re-connects after a fork, one request/reply cycle per call under a
    lock, connection-layer failures retried with backoff.
  * ``ShardedChunkStore`` — one ``RemoteChunkStore`` per server, the
    chunk namespace partitioned by digest: the content-addressed name IS
    the placement key, so the shard map is a pure function.  Each chunk
    is written to R consecutive shards (replicas); reads fail over along
    the same ring, so a killed server degrades the store instead of
    failing it (``health()`` says which shard is down).  Batched queries
    split per shard and fan out on a bounded pool.
  * ``CachingChunkStore`` — a local ``ChunkStore`` cache layered over a
    remote.  Saves upload only chunks the SERVER doesn't have (batched
    HAS before upload); restores fetch only chunks the CACHE doesn't
    have and pin them locally — a restore on a fresh host (empty cache
    dir) transfers exactly the missing bytes.

Coherence: chunks are immutable and content-addressed, so cache and
server can never disagree about a name's bytes.  ``has``/``has_many``
answer for the SERVER (the upload decision must be authoritative for
other hosts' restores), ``get``/``sizes`` answer cache-first.  ``gc``
collects the CACHE only — a server may back several writers whose live
sets the client can't see — and registers the caller's live set as a TTL
**lease** on the server; ``gc_remote`` and the server's optional
auto-sweep never collect a leased chunk, and the sweep also spares chunks
younger than a grace window (the upload→lease gap).  A server partitions
its root per namespace, so jobs sharing a server cannot observe each
other through dedup.

Spec grammar (``chunkstore.StoreSpec``):

    remote://HOST:PORT[/NAMESPACE][?cache=DIR]
    remote://H1:P1,H2:P2,H3:P3[/NAMESPACE][?cache=DIR&replicas=R]

Across the two packages: the frames, commands, namespaces, chunk names
and on-disk layout are the reference's, so the port's client drives the
reference's server and the reference's client drives the port's, and
both dedup against one store.  A server ships its own errors back as
``(False, exception)``; the one error class that is not a builtin is
``ChunkServiceError`` (a protocol-version mismatch), which pickles under
its package's module path.  The port's client decodes replies with
``_ReplyUnpickler``, which maps the reference's ``ChunkServiceError`` to
the port's own, so it never imports the reference.  The limit: the
reference's client decodes a port server's ``ChunkServiceError`` by
importing ``repro_torch``, and where that package is absent it fails
with ``ModuleNotFoundError`` instead.  A server started by the reference's
CLI pickles its error as ``__main__.ChunkServiceError``, which the
reference's own client cannot resolve; the port's client maps that name
too, and the port's CLI runs the server from the importable module so its
errors carry the module path.

Blobs handed to ``put`` must export the buffer protocol: ``bytes``, a
numpy array or a memoryview of one (a torch tensor does not, and is
refused with ``TypeError``).

Not copied: the reference's thread-local span parenting (``chunk.rpc``
spans are roots here).  Changed: ``CachingChunkStore.prefetch`` fetches a
name listed twice once, where the reference's fetches it again in each
later batch.
"""
from __future__ import annotations

import concurrent.futures as cf
import io
import os
import pickle
import random
import socket
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.checkpoint.chunkstore import (ChunkStore, ChunkStoreBackend,
                                               StoreSpec, check_token)
from repro_torch.core import trace as _trace
from repro_torch.core import tunables
from repro_torch.core.transport import (dumps_parts, loads_body,
                                        read_frame_mv, split_body,
                                        write_frame_parts)

#: versioned command batches: a request is
#: ``(CHUNK_PROTOCOL_VERSION, namespace, [(cmd, args), ...])`` and the
#: reply is ``(True, [result, ...])`` or ``(False, exception)``; the SG
#: body encoding is self-describing (``loads_body`` accepts both
#: plain-pickle and SG bodies)
CHUNK_PROTOCOL_VERSION = 1

#: blobs at least this large ride out-of-band (``pickle.PickleBuffer``)
#: in both directions; below it the plain in-band pickle is cheaper than
#: an extra iovec entry (REPRO_CHUNK_OOB_MIN)
_OOB_MIN = tunables.CHUNK_OOB_MIN


def _flat(blob):
    """`blob` as bytes or a flat byte memoryview, so ``len`` counts bytes
    (a memoryview of a 2-D array counts rows).  A torch tensor exports no
    buffer and raises ``TypeError`` here."""
    if isinstance(blob, bytes):
        return blob
    mv = memoryview(blob)
    return mv if mv.ndim == 1 and mv.format == "B" else mv.cast("B")


def _oob(blob) -> Any:
    """Large blobs as zero-copy out-of-band buffers, small ones as bytes.
    The receiving side sees a memoryview over its single receive buffer
    for the former — ``_as_bytes`` converts at the API boundary."""
    if len(blob) >= _OOB_MIN:
        return pickle.PickleBuffer(blob)
    return bytes(blob)


def _as_bytes(blob) -> bytes:
    return blob if isinstance(blob, bytes) else bytes(blob)


class ChunkServiceError(ConnectionError):
    """Chunk-service wire failure (torn reply, refused connection,
    protocol mismatch).  A ConnectionError subclass so every existing
    ``except OSError`` around restore/validate treats an unreachable
    server exactly like a missing local file."""


#: where the reference package's ``ChunkServiceError`` pickles: under its
#: module, or under ``__main__`` from a server its CLI started (the
#: reference runs ``_main`` in ``__main__``)
_REFERENCE_ERRORS = {("repro.checkpoint.chunkservice", "ChunkServiceError"),
                     ("__main__", "ChunkServiceError")}


class _ReplyUnpickler(pickle.Unpickler):
    """Reply decoder of the port's client: a reference server's
    ``ChunkServiceError`` becomes the port's, so decoding it never imports
    the reference package; every other global resolves as usual."""

    def find_class(self, module, name):
        if (module, name) in _REFERENCE_ERRORS:
            return ChunkServiceError
        return super().find_class(module, name)


def _loads_reply(body) -> Any:
    """``loads_body`` through ``_ReplyUnpickler``: out-of-band buffers
    stay views into `body`."""
    head, bufs = split_body(body)
    return _ReplyUnpickler(io.BytesIO(head), buffers=bufs).load()


#: chunk names, namespaces and lease ids are digest-shaped tokens;
#: anything else is rejected server-side (a name is used as a path
#: component).  One validator, shared with StoreSpec (chunkstore.py).
_check_token = check_token


def _split_endpoint(endpoint: str) -> Tuple[str, int]:
    host, _, port = endpoint.rpartition(":")
    return host, int(port)


def parse_spec(spec: str) -> Tuple[str, int, str, Optional[str]]:
    """Back-compat view of ``StoreSpec.parse`` for SINGLE-endpoint specs:
    ``remote://host:port[/ns][?cache=DIR]`` -> (host, port, ns, cache).
    Sharded (multi-endpoint) specs don't fit a 4-tuple — parse those with
    ``StoreSpec.parse`` and read ``.endpoints``/``.replicas``."""
    if not str(spec).startswith("remote://"):
        raise ValueError(f"not a remote chunk-store spec: {spec!r}")
    sp = StoreSpec.parse(spec)
    if sp.sharded:
        raise ValueError(
            f"parse_spec is single-endpoint; {spec!r} is sharded — "
            f"use StoreSpec.parse")
    host, port = _split_endpoint(sp.endpoints[0])
    return host, port, sp.namespace, sp.cache


def make_spec(host: str, port: int, namespace: str = "",
              cache: Optional[str | Path] = None) -> str:
    """Canonical single-endpoint spec string (``StoreSpec.canonical``)."""
    return StoreSpec(scheme="remote", endpoints=(f"{host}:{int(port)}",),
                     namespace=namespace,
                     cache=str(cache) if cache else None).canonical()


def store_from_spec(spec: str | StoreSpec) -> ChunkStoreBackend:
    """Build the client backend a remote ``StoreSpec`` describes: one
    ``RemoteChunkStore`` per endpoint — behind a ``ShardedChunkStore``
    when there are several — wrapped in a ``CachingChunkStore`` when the
    spec carries a cache directory."""
    sp = StoreSpec.parse(spec)
    if sp.scheme != "remote":
        raise ValueError(f"not a remote chunk-store spec: {spec!r}")
    if sp.sharded:
        remote: ChunkStoreBackend = ShardedChunkStore(
            sp.endpoints, namespace=sp.namespace, replicas=sp.replicas)
    else:
        host, port = _split_endpoint(sp.endpoints[0])
        remote = RemoteChunkStore(host, port, namespace=sp.namespace)
    if sp.cache is None:
        return remote
    return CachingChunkStore(sp.cache, remote)


# =========================================================================
# server
# =========================================================================

class ChunkServer:
    """Serve a directory of content-addressed chunks over sockets.

    One accept thread + one thread per connection (client processes, writer
    pools and restore pools each hold their own connection).  The backing
    ``ChunkStore`` is thread-safe and its writes are atomic renames, so
    concurrent PUTs of the same digest collapse to one file — the same
    idempotence the local store gives racing processes.

    GC LEASES: clients register their live chunk sets under named TTL
    leases (``lease``/``unlease`` commands; renewed automatically by every
    client-side gc round).  The GC-live-set command then treats the union
    of unexpired leases as live IN ADDITION to the caller's set, so one
    writer's reclamation can never collect another's chunks — and a
    caller may pin a streamed-but-uncommitted set under its own
    lease.  With ``auto_gc_interval`` set, the server also sweeps on its
    own: a chunk is collected only when NO unexpired lease covers it AND
    it is older than ``gc_grace`` seconds (the grace spares the
    upload→lease gap of an in-flight save).
    """

    def __init__(self, root: str | Path, host: str = "127.0.0.1",
                 port: int = 0, advertise_host: Optional[str] = None,
                 auto_gc_interval: Optional[float] = None,
                 gc_grace: float = 60.0):
        self.root = Path(root)
        self.auto_gc_interval = auto_gc_interval
        self.gc_grace = gc_grace
        self._stores: Dict[str, ChunkStore] = {}
        #: {namespace: {lease_id: (monotonic expiry, frozenset(names))}}
        self._leases: Dict[str, Dict[str, Tuple[float, frozenset]]] = {}
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self._srv.settimeout(0.2)
        bound_host, self.port = self._srv.getsockname()[:2]
        # specs must carry an address CLIENTS can dial: a wildcard bind
        # ("0.0.0.0"/"::") is not one — cross-host deployments pass the
        # reachable name via advertise_host
        self.host = advertise_host or bound_host
        if self.host in ("0.0.0.0", "::"):
            self.host = socket.gethostname()
        self._halt = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._accept: Optional[threading.Thread] = None
        self._sweeper: Optional[threading.Thread] = None

    @property
    def spec(self) -> str:
        return make_spec(self.host, self.port)

    def spec_for(self, namespace: str = "",
                 cache: Optional[str | Path] = None) -> str:
        return make_spec(self.host, self.port, namespace, cache)

    def backing(self, namespace: str = "") -> ChunkStore:
        """The per-namespace backing store (the server's own view — tests
        and ops poke it directly)."""
        if namespace:
            _check_token(namespace, "namespace")
        with self._lock:
            st = self._stores.get(namespace)
            if st is None:
                st = ChunkStore(self.root / namespace if namespace
                                else self.root)
                self._stores[namespace] = st
        return st

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ChunkServer":
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="chunk-server")
        self._accept.start()
        if self.auto_gc_interval:
            self._sweeper = threading.Thread(target=self._sweep_loop,
                                             daemon=True,
                                             name="chunk-server-gc")
            self._sweeper.start()
        return self

    def stop(self, join_timeout: float = 5.0) -> None:
        self._halt.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._accept is not None:
            self._accept.join(join_timeout)
        if self._sweeper is not None:
            self._sweeper.join(join_timeout)
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            if t is not threading.current_thread():
                t.join(join_timeout)

    def __enter__(self) -> "ChunkServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- serving
    def _accept_loop(self) -> None:
        while not self._halt.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:          # server socket closed by stop()
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True, name="chunk-server-conn")
            with self._lock:
                self._conns.append(conn)
                self._threads.append(t)
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        """One connection: read a WHOLE request frame, apply, reply.  A
        torn frame (client died mid-send) reads as EOF — the half-shipped
        PUT is dropped on the floor, never applied."""
        try:
            while not self._halt.is_set():
                blob = read_frame_mv(conn)
                if blob is None:
                    return
                try:
                    version, ns, cmds = loads_body(blob)
                    if version != CHUNK_PROTOCOL_VERSION:
                        raise ChunkServiceError(
                            f"client speaks chunk protocol v{version}, "
                            f"server v{CHUNK_PROTOCOL_VERSION}")
                    store = self.backing(ns)
                    with _trace.span(
                            "chunkserver.req", cat="chunkservice",
                            args={"ns": ns, "n": len(cmds),
                                  "cmd": cmds[0][0] if cmds else None}):
                        results = [self._execute(ns, store, cmd, args)
                                   for cmd, args in cmds]
                    reply = (True, results)
                except Exception as e:      # noqa: BLE001 - shipped back
                    reply = (False, e)
                write_frame_parts(conn, dumps_parts(reply))
        except (OSError, pickle.PickleError):
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass
            # prune: a long-lived server sheds each disconnected client
            # (one socket per client process / pool — they come and go)
            me = threading.current_thread()
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
                if me in self._threads:
                    self._threads.remove(me)

    # --------------------------------------------------------------- leases
    def _lease_union(self, namespace: str) -> Set[str]:
        """Union of chunk names covered by unexpired leases in the
        namespace; expired leases are pruned as a side effect."""
        now = time.monotonic()
        out: Set[str] = set()
        with self._lock:
            table = self._leases.get(namespace)
            if not table:
                return out
            for lid in [k for k, (exp, _) in table.items() if exp < now]:
                del table[lid]
            for _, names in table.values():
                out.update(names)
        return out

    def sweep(self, grace: Optional[float] = None) -> int:
        """Server-initiated reclamation across every namespace touched so
        far: remove chunks covered by NO unexpired lease and older than
        ``grace`` seconds (file mtime).  The grace window protects chunks
        a client has uploaded but not yet covered with a lease or a
        committed manifest — mid-save state.
        Runs periodically when ``auto_gc_interval`` is set; callable
        directly for deterministic tests/ops."""
        grace = self.gc_grace if grace is None else grace
        cutoff = time.time() - grace
        removed_total = 0
        with self._lock:
            spaces = list(self._stores.items())
        for ns, store in spaces:
            protected = self._lease_union(ns)
            removed = 0
            for name in store.list_chunks():
                if name in protected:
                    continue
                p = store.root / name
                try:
                    if p.stat().st_mtime > cutoff:
                        continue
                    p.unlink()
                    removed += 1
                except OSError:
                    continue
            if removed:
                with store._lock:
                    store.stats["chunks_removed"] += removed
            removed_total += removed
        return removed_total

    def _sweep_loop(self) -> None:
        while not self._halt.wait(self.auto_gc_interval):
            try:
                self.sweep()
            except Exception:       # noqa: BLE001 - sweep must never die
                pass

    def _execute(self, ns: str, store: ChunkStore, cmd: str,
                 args: tuple) -> Any:
        if cmd == "has_many":
            (names,) = args
            out: Dict[str, int] = {}
            for n in names:
                _check_token(n, "chunk name")
                if store.has(n):
                    out[n] = store.size(n)
            return out
        if cmd == "put":
            name, blob, raw = args
            _check_token(name, "chunk name")
            # blob may be a memoryview over the request's receive buffer
            # (out-of-band PUT); the store writes any buffer object
            return store.put(name, blob, raw_bytes=raw)
        if cmd == "get":
            (name,) = args
            _check_token(name, "chunk name")
            return _oob(store.get(name))
        if cmd == "get_many":
            (names,) = args
            out = {}
            for n in names:
                _check_token(n, "chunk name")
                if store.has(n):
                    out[n] = _oob(store.get(n))
            return out
        if cmd == "ref":
            name, raw = args
            store.ref(name, raw)
            return None
        if cmd == "gc":
            # the caller's live set PLUS every unexpired lease: explicit
            # reclamation by one writer can never collect chunks another
            # client has registered as live
            (live,) = args
            return store.gc(set(live) | self._lease_union(ns))
        if cmd == "lease":
            lease_id, names, ttl = args
            _check_token(lease_id, "lease id")
            names = frozenset(names)
            for n in names:
                _check_token(n, "chunk name")
            with self._lock:
                self._leases.setdefault(ns, {})[lease_id] = (
                    time.monotonic() + float(ttl), names)
            return len(names)
        if cmd == "unlease":
            (lease_id,) = args
            with self._lock:
                table = self._leases.get(ns, {})
                return table.pop(lease_id, None) is not None
        if cmd == "leases":
            now = time.monotonic()
            with self._lock:
                table = dict(self._leases.get(ns, {}))
            return {lid: {"ttl": exp - now, "chunks": len(names)}
                    for lid, (exp, names) in table.items() if exp >= now}
        if cmd == "size":
            (name,) = args
            _check_token(name, "chunk name")
            return store.size(name)
        if cmd == "list":
            return sorted(store.list_chunks())
        if cmd == "stats":
            return dict(store.stats)
        raise ValueError(f"unknown chunk-service command {cmd!r}")


# =========================================================================
# client backends
# =========================================================================

class RemoteChunkStore(ChunkStoreBackend):
    """Socket client to a ``ChunkServer`` — a pure remote backend.

    Fork-safe by construction: the connection is opened lazily and keyed
    to the owning pid, so a forked child that inherited this object
    transparently opens its OWN socket instead of interleaving frames on
    the parent's.  One request/reply cycle at a time under a lock (the
    writer pool serializes here; the server side fans out per
    connection, so parallel clients scale, parallel calls on ONE client
    pipeline through one socket).

    Connection-layer failures (dial refused, torn write/read, EOF
    mid-reply) are retried up to ``REPRO_CHUNK_RETRIES`` attempts with
    doubling, jittered backoff from ``REPRO_CHUNK_RETRY_BASE_S`` — a
    chunk server bounced under the client (crash + restart, rolling
    upgrade) costs a short stall instead of a failed checkpoint.  Whole
    requests are replayed: every command is idempotent (content-addressed
    PUT, read-only GET/HAS, set-valued REF/LEASE), so a reply lost on the
    wire re-executes safely.  Errors the SERVER raised are never retried
    — those arrive on a healthy round trip and retrying cannot change
    them."""

    wants_batched_has = True
    root = None

    #: default TTL for the client's automatic live-set lease — long
    #: enough to bridge several save/gc rounds, short enough that a dead
    #: client's pin drains away on its own (REPRO_CHUNK_LEASE_TTL_S)
    DEFAULT_LEASE_TTL = tunables.CHUNK_LEASE_TTL_S

    def __init__(self, host: str, port: int, namespace: str = "",
                 connect_timeout: float = 10.0):
        self.host, self.port = host, int(port)
        self.namespace = namespace
        if namespace:
            _check_token(namespace, "namespace")
        self.connect_timeout = connect_timeout
        self._sock: Optional[socket.socket] = None
        self._pid: Optional[int] = None
        self._lease_pid: Optional[int] = None
        self._lease_name: Optional[str] = None
        self._lock = threading.RLock()
        self.stats = {"chunks_written": 0, "chunks_referenced": 0,
                      "bytes_written": 0, "bytes_referenced": 0,
                      "chunks_removed": 0,
                      "bytes_uploaded": 0, "bytes_fetched": 0,
                      "round_trips": 0, "reconnects": 0}

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def spec_obj(self) -> StoreSpec:
        return StoreSpec(scheme="remote", endpoints=(self.endpoint,),
                         namespace=self.namespace)

    # --------------------------------------------------------------- wire
    def _conn(self) -> socket.socket:
        if self._sock is None or self._pid != os.getpid():
            try:
                s = socket.create_connection(
                    (self.host, self.port), timeout=self.connect_timeout)
            except OSError as e:
                raise ChunkServiceError(
                    f"chunk server {self.host}:{self.port} unreachable: "
                    f"{e}") from None
            s.settimeout(None)
            self._sock, self._pid = s, os.getpid()
        return self._sock

    def _request(self, cmds: Sequence[tuple]) -> list:
        attempts = max(1, int(tunables.CHUNK_RETRIES))
        # one chunk.rpc span per request, retries included
        with _trace.span("chunk.rpc", cat="chunk",
                         args={"n": len(cmds),
                               "cmd": cmds[0][0] if cmds else None}), \
                self._lock:
            for attempt in range(attempts):
                try:
                    blob = self._attempt(cmds)
                except ChunkServiceError:
                    # connection-layer failure — socket already closed by
                    # the attempt; re-dial after a jittered backoff
                    if attempt + 1 >= attempts:
                        raise
                    delay = tunables.CHUNK_RETRY_BASE_S * (2 ** attempt)
                    time.sleep(delay * (0.5 + random.random()))
                    self.stats["reconnects"] += 1
                    continue
                self.stats["round_trips"] += 1
                ok, payload = _loads_reply(blob)
                if not ok:
                    raise payload    # server-raised: healthy wire, no retry
                return payload

    def _attempt(self, cmds: Sequence[tuple]):
        s = self._conn()
        try:
            write_frame_parts(s, dumps_parts(
                (CHUNK_PROTOCOL_VERSION, self.namespace, list(cmds))))
            blob = read_frame_mv(s)
        except OSError as e:
            self.close()
            raise ChunkServiceError(
                f"chunk server {self.host}:{self.port} request "
                f"failed: {e}") from None
        if blob is None:
            self.close()
            raise ChunkServiceError(
                f"chunk server {self.host}:{self.port} closed the "
                f"connection mid-reply")
        return blob

    def _call(self, cmd: str, *args) -> Any:
        return self._request([(cmd, args)])[0]

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                self._pid = None

    # ------------------------------------------------------------ backend
    def has(self, name: str) -> bool:
        return name in self._call("has_many", [name])

    def has_many(self, names: Sequence[str]) -> Dict[str, int]:
        return self._call("has_many", list(names))

    def size(self, name: str) -> int:
        return self._call("size", name)

    def sizes(self, names: Sequence[str]) -> Dict[str, Optional[int]]:
        present = self.has_many(names)
        return {n: present.get(n) for n in names}

    def get(self, name: str) -> bytes:
        # out-of-band replies arrive as a memoryview over the receive
        # buffer; the public API promises bytes
        blob = _as_bytes(self._call("get", name))
        self.stats["bytes_fetched"] += len(blob)
        return blob

    def get_many(self, names: Sequence[str]) -> Dict[str, bytes]:
        out = {n: _as_bytes(b)
               for n, b in self._call("get_many", list(names)).items()}
        self.stats["bytes_fetched"] += sum(len(b) for b in out.values())
        return out

    def put(self, name: str, blob: bytes, raw_bytes: int = 0) -> bool:
        blob = _flat(blob)
        wrote = self._call("put", name, _oob(blob), raw_bytes)
        raw = raw_bytes or len(blob)
        if wrote:
            self.stats["chunks_written"] += 1
            self.stats["bytes_written"] += raw
            self.stats["bytes_uploaded"] += len(blob)
        else:
            self.stats["chunks_referenced"] += 1
            self.stats["bytes_referenced"] += raw
        return wrote

    def ref(self, name: str, raw_bytes: int) -> None:
        self._call("ref", name, raw_bytes)
        self.stats["chunks_referenced"] += 1
        self.stats["bytes_referenced"] += raw_bytes

    def list_chunks(self) -> Set[str]:
        return set(self._call("list"))

    def gc(self, live: Iterable[str]) -> int:
        """Removes nothing server-side (returns 0): a namespace may back
        several writers whose live sets this client cannot see, so the
        AUTOMATIC per-save gc a CheckpointManager runs must never unlink
        on the server.  It DOES register `live` as this client's TTL
        lease, so server reclamation — another writer's ``gc_remote`` or
        the server's auto-sweep — is safe without coordination.
        Best-effort: an outage mid-renewal is swallowed (the previous
        lease and the sweep grace window keep protecting until the
        server is back)."""
        try:
            self.lease(live)
        except (ChunkServiceError, OSError):
            pass
        return 0

    def gc_remote(self, live: Iterable[str]) -> int:
        """Explicit server-side GC-live-set — caller asserts it owns the
        namespace.  The server extends `live` with every unexpired lease,
        so even this cannot collect chunks other clients registered."""
        removed = self._call("gc", sorted(set(live)))
        self.stats["chunks_removed"] += removed
        return removed

    # -------------------------------------------------------------- leases
    def _lease_id(self) -> str:
        # pid-qualified and regenerated after fork: a forked child must
        # renew ITS OWN lease, not clobber the parent's live set
        if self._lease_name is None or self._lease_pid != os.getpid():
            self._lease_pid = os.getpid()
            self._lease_name = (
                f"client-{os.getpid()}-{os.urandom(3).hex()}")
        return self._lease_name

    def lease(self, names: Iterable[str], ttl: Optional[float] = None,
              lease_id: Optional[str] = None) -> int:
        """Register/renew a TTL lease over `names`: until expiry no
        server-side gc (explicit or auto-sweep) may collect them.  A
        caller may pin a set under its own ``lease_id``."""
        return self._call("lease", lease_id or self._lease_id(),
                          sorted(set(names)),
                          self.DEFAULT_LEASE_TTL if ttl is None else ttl)

    def unlease(self, lease_id: Optional[str] = None) -> bool:
        return self._call("unlease", lease_id or self._lease_id())

    def leases(self) -> dict:
        return self._call("leases")

    def server_stats(self) -> dict:
        return self._call("stats")


class ShardedChunkStore(ChunkStoreBackend):
    """Digest-space sharding + replication across N ``ChunkServer``s —
    the scale-out tier of the store.

    PLACEMENT is a pure function of the content-addressed name: the hex
    digest prefix mod the shard count picks the HOME shard, and a chunk's
    replica set is the R consecutive shards starting there (a ring walk).
    blake2b output is uniform, so shards stay balanced with no directory
    service, no rebalancer, and no extra metadata — any client that
    knows the endpoint list (the StoreSpec) can compute where every
    chunk lives.  The endpoint ORDER is the shard map: permuting it is a
    different store.

    WRITE path: ``put`` offers the blob to each replica in ring order; a
    put succeeds when at least ONE replica accepts (``degraded_puts``
    counts saves that landed under-replicated).  Each shard client keeps
    the retry/backoff ladder, so a bounced server stalls briefly
    and a dead one is marked DOWN for ``REPRO_SHARD_RETRY_S`` — later
    ops skip it (one probe re-tests after the cooldown) instead of
    re-paying the ladder per chunk.

    READ path: ``get`` walks the same ring and fails over past dead or
    chunk-less replicas (``failover_reads``); batched ``has_many`` /
    ``get_many`` split the name list per shard and fan out on a bounded
    pool (``REPRO_SHARD_FANOUT``) — a restore working set streams over N
    sockets concurrently, which is where the wire-time win comes from.

    SEMANTICS under partial outage follow the gc-safety rule: presence
    queries (``has_many``, the upload decision) treat an unreachable
    shard as "not holding anything" — the worst case is a redundant
    idempotent re-upload — while ``sizes`` (the validate/restore view)
    RAISES when a name is unresolved and any of its replicas was
    unreachable, because "can't tell" must never read as "definitely
    missing".  Leases and gc fan out to every shard; ``gc`` stays
    lease-only like the single-server client.

    Fork-safe like ``RemoteChunkStore``: each shard client re-dials
    after a fork, and the fan-out pool is lazily rebuilt per pid."""

    wants_batched_has = True
    root = None

    def __init__(self, endpoints: Sequence[str], namespace: str = "",
                 replicas: Optional[int] = None,
                 connect_timeout: float = 10.0):
        self.endpoints = tuple(endpoints)
        if not self.endpoints:
            raise ValueError("sharded store needs at least one endpoint")
        self.namespace = namespace
        want = tunables.SHARD_REPLICAS if replicas is None else int(replicas)
        self.replicas = max(1, min(want, len(self.endpoints)))
        self.shards = [
            RemoteChunkStore(*_split_endpoint(ep), namespace=namespace,
                             connect_timeout=connect_timeout)
            for ep in self.endpoints]
        #: {shard idx: monotonic time it was marked down}
        self._down: Dict[int, float] = {}
        self._probing: Set[int] = set()
        self._lock = threading.Lock()
        self._exec: Optional[cf.ThreadPoolExecutor] = None
        self._exec_pid: Optional[int] = None
        self.stats = {"chunks_written": 0, "chunks_referenced": 0,
                      "bytes_written": 0, "bytes_referenced": 0,
                      "chunks_removed": 0,
                      "bytes_uploaded": 0, "bytes_fetched": 0,
                      "degraded_puts": 0, "failover_reads": 0,
                      "shard_errors": 0, "shards_down": 0,
                      "shards": len(self.endpoints),
                      "replicas": self.replicas}

    @property
    def spec_obj(self) -> StoreSpec:
        # resolved (explicit, clamped) replica count: a manifest written
        # under REPRO_REPLICAS=3 must restore identically elsewhere
        return StoreSpec(scheme="remote", endpoints=self.endpoints,
                         namespace=self.namespace, replicas=self.replicas)

    def close(self) -> None:
        for sh in self.shards:
            sh.close()
        with self._lock:
            if self._exec is not None:
                self._exec.shutdown(wait=False)
                self._exec = None
                self._exec_pid = None

    # ---------------------------------------------------------- placement
    def _home(self, name: str) -> int:
        stem = name.split(".", 1)[0]
        try:
            return int(stem[:15], 16) % len(self.shards)
        except ValueError:
            # non-digest name (shouldn't happen on the save path, but
            # reads of foreign names must still route deterministically)
            return zlib.crc32(name.encode()) % len(self.shards)

    def _replica_ids(self, name: str) -> List[int]:
        h, n = self._home(name), len(self.shards)
        return [(h + k) % n for k in range(self.replicas)]

    # ----------------------------------------------------- shard plumbing
    def _usable(self, i: int) -> bool:
        """False while shard `i` is inside its mark-down cooldown.  After
        the cooldown ONE caller gets a True (the probe); everyone else
        keeps skipping until the probe's verdict lands."""
        with self._lock:
            t = self._down.get(i)
            if t is None:
                return True
            if (time.monotonic() - t >= tunables.SHARD_RETRY_S
                    and i not in self._probing):
                self._probing.add(i)
                return True
            return False

    def _mark_up(self, i: int) -> None:
        with self._lock:
            self._down.pop(i, None)
            self._probing.discard(i)
            self.stats["shards_down"] = len(self._down)

    def _mark_down(self, i: int) -> None:
        with self._lock:
            self._down[i] = time.monotonic()
            self._probing.discard(i)
            self.stats["shard_errors"] += 1
            self.stats["shards_down"] = len(self._down)

    def _try(self, i: int, fn, *args):
        """One shard call with health accounting: a connection-layer
        failure (the client's whole retry ladder exhausted) marks the
        shard down; any answer — including a server-raised error —
        marks it up (the wire is healthy)."""
        try:
            out = fn(*args)
        except ChunkServiceError:
            self._mark_down(i)
            raise
        except Exception:
            self._mark_up(i)
            raise
        self._mark_up(i)
        return out

    def _pool(self) -> cf.ThreadPoolExecutor:
        with self._lock:
            if self._exec is None or self._exec_pid != os.getpid():
                # a forked child must not share the parent's pool threads
                self._exec = cf.ThreadPoolExecutor(
                    max_workers=max(1, min(tunables.SHARD_FANOUT,
                                           len(self.shards))),
                    thread_name_prefix="shard-fanout")
                self._exec_pid = os.getpid()
            return self._exec

    def _fanout(self, jobs: List[tuple]) -> List[tuple]:
        """Run ``[(shard idx, fn, args), ...]`` concurrently (each shard
        client still serializes on its own socket); returns
        ``[(idx, result-or-exception), ...]``."""
        if len(jobs) <= 1:
            out = []
            for i, fn, args in jobs:
                try:
                    out.append((i, self._try(i, fn, *args)))
                except Exception as e:      # noqa: BLE001 - sorted by caller
                    out.append((i, e))
            return out
        pool = self._pool()
        futs = [(i, pool.submit(self._try, i, fn, *args))
                for i, fn, args in jobs]
        out = []
        for i, f in futs:
            try:
                out.append((i, f.result()))
            except Exception as e:          # noqa: BLE001 - sorted by caller
                out.append((i, e))
        return out

    def _group_by_replicas(self, names: Sequence[str]) -> Dict[int, List[str]]:
        groups: Dict[int, List[str]] = {}
        for n in names:
            for i in self._replica_ids(n):
                groups.setdefault(i, []).append(n)
        return groups

    # ------------------------------------------------------------ presence
    def _presence(self, names: Sequence[str]):
        """({name: size} union over reachable replicas,
        {unreachable shard ids})."""
        groups = self._group_by_replicas(names)
        jobs, unreachable = [], set()
        for i, batch in groups.items():
            if self._usable(i):
                jobs.append((i, self.shards[i].has_many, (batch,)))
            else:
                unreachable.add(i)
        present: Dict[str, int] = {}
        for i, res in self._fanout(jobs):
            if isinstance(res, ChunkServiceError):
                unreachable.add(i)
            elif isinstance(res, Exception):
                raise res
            else:
                for n, sz in res.items():
                    present.setdefault(n, sz)
        return present, unreachable

    def has(self, name: str) -> bool:
        return name in self.has_many([name])

    def has_many(self, names: Sequence[str]) -> Dict[str, int]:
        # a chunk is present if ANY replica has it; an unreachable shard
        # contributes nothing — the upload decision then errs toward
        # re-uploading, which is idempotent and safe
        present, _ = self._presence(list(names))
        return present

    def size(self, name: str) -> int:
        sz = self.sizes([name]).get(name)
        if sz is None:
            raise FileNotFoundError(name)
        return sz

    def sizes(self, names: Sequence[str]) -> Dict[str, Optional[int]]:
        names = list(names)
        present, unreachable = self._presence(names)
        out = {n: present.get(n) for n in names}
        if unreachable:
            at_risk = [n for n in names if out[n] is None
                       and any(i in unreachable
                               for i in self._replica_ids(n))]
            if at_risk:
                eps = ",".join(self.shards[i].endpoint
                               for i in sorted(unreachable))
                raise ChunkServiceError(
                    f"cannot resolve {len(at_risk)} chunk(s): replica "
                    f"shard(s) {eps} unreachable")
        return out

    # --------------------------------------------------------------- reads
    def get(self, name: str) -> bytes:
        order = self._replica_ids(name)
        live = [i for i in order if self._usable(i)]
        down = [i for i in order if i not in live]
        last: Optional[Exception] = None
        # marked-down replicas go last: better one retry-ladder stall
        # against a possibly-stale mark than a false "unavailable"
        for i in live + down:
            try:
                blob = self._try(i, self.shards[i].get, name)
            except (OSError, KeyError) as e:
                last = e
                continue
            blob = _as_bytes(blob)
            with self._lock:
                self.stats["bytes_fetched"] += len(blob)
                if i != order[0]:
                    self.stats["failover_reads"] += 1
            return blob
        raise last if last is not None else FileNotFoundError(name)

    def get_many(self, names: Sequence[str]) -> Dict[str, bytes]:
        names = list(names)
        # primary assignment: each name to its first LIVE replica, so the
        # batches are disjoint and stream over N sockets concurrently
        usable: Dict[int, bool] = {}
        batches: Dict[int, List[str]] = {}
        for n in names:
            for i in self._replica_ids(n):
                if i not in usable:
                    usable[i] = self._usable(i)
                if usable[i]:
                    batches.setdefault(i, []).append(n)
                    break
        out: Dict[str, bytes] = {}
        jobs = [(i, self.shards[i].get_many, (batch,))
                for i, batch in batches.items()]
        for i, res in self._fanout(jobs):
            if isinstance(res, Exception):
                if not isinstance(res, (OSError, KeyError)):
                    raise res
                continue        # whole batch fails over below
            for n, b in res.items():
                b = _as_bytes(b)
                out[n] = b
                with self._lock:
                    self.stats["bytes_fetched"] += len(b)
        # failover: anything a primary didn't deliver (shard died
        # mid-call, or holds no copy) walks the per-name replica ladder;
        # names absent EVERYWHERE are omitted, like the server command
        for n in names:
            if n not in out:
                try:
                    out[n] = self.get(n)
                except (OSError, KeyError):
                    pass
        return out

    # -------------------------------------------------------------- writes
    def put(self, name: str, blob, raw_bytes: int = 0) -> bool:
        blob = _flat(blob)
        raw = raw_bytes or len(blob)
        order = self._replica_ids(name)
        live = [i for i in order if self._usable(i)]
        down = [i for i in order if i not in live]
        wrote_n = 0
        landed = 0          # replicas holding the bytes after this call
        referenced = False
        errors: List[Exception] = []
        for i in live:
            try:
                if self._try(i, self.shards[i].put, name, blob, raw_bytes):
                    wrote_n += 1
                else:
                    referenced = True
                landed += 1
            except (ChunkServiceError, OSError) as e:
                errors.append(e)
        if landed == 0:
            # nothing landed on a live replica: probe the marked-down
            # ones before declaring the save degraded past saving
            for i in down:
                try:
                    if self._try(i, self.shards[i].put,
                                 name, blob, raw_bytes):
                        wrote_n += 1
                    else:
                        referenced = True
                    landed += 1
                    break
                except (ChunkServiceError, OSError) as e:
                    errors.append(e)
        if landed == 0:
            # ZERO replicas hold the bytes — the save must not claim this
            # chunk is stored; surface the outage like any unreachable
            # store (the caller's retry/abort policy applies)
            raise errors[-1] if errors else ChunkServiceError(
                f"no reachable replica for {name!r}")
        with self._lock:
            if landed < self.replicas or errors or down:
                self.stats["degraded_puts"] += 1
            self.stats["bytes_uploaded"] += len(blob) * wrote_n
            if referenced:
                # the content already existed somewhere: this save is an
                # incremental reference (any extra copies were repair)
                self.stats["chunks_referenced"] += 1
                self.stats["bytes_referenced"] += raw
            else:
                self.stats["chunks_written"] += 1
                self.stats["bytes_written"] += raw
        return not referenced

    def ref(self, name: str, raw_bytes: int) -> None:
        with self._lock:
            self.stats["chunks_referenced"] += 1
            self.stats["bytes_referenced"] += raw_bytes
        # forward to ONE replica for server-side accounting, best-effort
        for i in self._replica_ids(name):
            if not self._usable(i):
                continue
            try:
                self._try(i, self.shards[i].ref, name, raw_bytes)
                return
            except (ChunkServiceError, OSError):
                continue

    # ------------------------------------------------------------- admin
    def list_chunks(self) -> Set[str]:
        out: Set[str] = set()
        jobs = [(i, sh.list_chunks, ())
                for i, sh in enumerate(self.shards) if self._usable(i)]
        for i, res in self._fanout(jobs):
            if isinstance(res, Exception):
                if not isinstance(res, (OSError, KeyError)):
                    raise res
                continue
            out.update(res)
        return out

    def gc(self, live: Iterable[str]) -> int:
        """Lease-only, like the single-server client: renew this
        client's live-set lease on EVERY shard (each protects its own
        replica copies), remove nothing.  Best-effort per shard."""
        live = set(live)
        for i, sh in enumerate(self.shards):
            if not self._usable(i):
                continue
            try:
                self._try(i, sh.lease, live)
            except (ChunkServiceError, OSError):
                pass
        return 0

    def gc_remote(self, live: Iterable[str]) -> int:
        """Explicit server-side reclamation on every shard.  All shards
        are attempted (even marked-down ones — an admin op should not
        silently skip a shard and leave garbage); the first failure is
        re-raised after the sweep so partial progress still happens."""
        live = sorted(set(live))
        removed = 0
        errors: List[Exception] = []
        for i, res in self._fanout([(i, sh.gc_remote, (live,))
                                    for i, sh in enumerate(self.shards)]):
            if isinstance(res, Exception):
                errors.append(res)
            else:
                removed += res
        with self._lock:
            self.stats["chunks_removed"] += removed
        if errors:
            raise errors[0]
        return removed

    def lease(self, names: Iterable[str], ttl: Optional[float] = None,
              lease_id: Optional[str] = None) -> int:
        """Register/renew the lease on every shard; raises only when NO
        shard accepted it (then nothing protects the chunks)."""
        count: Optional[int] = None
        last: Optional[Exception] = None
        for i, res in self._fanout([(i, sh.lease, (names, ttl, lease_id))
                                    for i, sh in enumerate(self.shards)]):
            if isinstance(res, Exception):
                last = res
            else:
                count = res
        if count is None:
            raise last if last is not None else ChunkServiceError(
                "no shard accepted the lease")
        return count

    def unlease(self, lease_id: Optional[str] = None) -> bool:
        any_dropped = False
        for i, res in self._fanout([(i, sh.unlease, (lease_id,))
                                    for i, sh in enumerate(self.shards)]):
            if not isinstance(res, Exception) and res:
                any_dropped = True
        return any_dropped

    def leases(self) -> dict:
        out: dict = {}
        for i, res in self._fanout([(i, sh.leases, ())
                                    for i, sh in enumerate(self.shards)]):
            if not isinstance(res, Exception):
                out.update(res)
        return out

    def server_stats(self) -> dict:
        """{endpoint: backing-store stats} for every reachable shard."""
        out: dict = {}
        for i, res in self._fanout([(i, sh.server_stats, ())
                                    for i, sh in enumerate(self.shards)]):
            if not isinstance(res, Exception):
                out[self.shards[i].endpoint] = res
        return out

    # ------------------------------------------------------------- health
    def health(self) -> List[dict]:
        """Per-shard health (``CheckpointManager.store_health``): endpoint,
        up/down, remaining cooldown, and the shard client's wire
        counters."""
        now = time.monotonic()
        with self._lock:
            down = dict(self._down)
        out = []
        for i, sh in enumerate(self.shards):
            t = down.get(i)
            out.append({
                "endpoint": sh.endpoint,
                "up": t is None,
                "cooldown_s": (0.0 if t is None else
                               max(0.0, tunables.SHARD_RETRY_S
                                   - (now - t))),
                "round_trips": sh.stats["round_trips"],
                "reconnects": sh.stats["reconnects"],
                "bytes_uploaded": sh.stats["bytes_uploaded"],
                "bytes_fetched": sh.stats["bytes_fetched"],
            })
        return out


class CachingChunkStore(ChunkStoreBackend):
    """A local chunk cache layered over a remote backend — a single
    ``RemoteChunkStore`` or a ``ShardedChunkStore`` (the cache is
    placement-blind: it only sees names and bytes).

    SAVE: ``has``/``has_many`` are answered by the SERVER (authoritative
    — another host's restore must be able to fetch every referenced
    chunk), one batched round trip per save; only missing chunks upload
    (``bytes_uploaded``), present ones are referenced
    (``bytes_referenced_remote``, server-side wire bytes).  Every put
    also lands in the cache, so the writing host restores locally.

    RESTORE: ``get`` is cache-first; a miss fetches from the server AND
    pins the blob into the cache (``bytes_fetched``), so the next restore
    of an overlapping manifest moves only what changed — the incremental
    property, now across hosts.  ``prefetch`` pulls a whole working set
    of cache-misses down in batched ``get_many`` calls first — over a
    sharded remote each batch arrives from N servers concurrently.

    GC collects the CACHE only (see module docstring for why); use
    ``gc_remote`` to reclaim the server when the caller owns the
    namespace."""

    wants_batched_has = True

    def __init__(self, cache_root: str | Path,
                 remote: "RemoteChunkStore | ShardedChunkStore"):
        self.cache = ChunkStore(cache_root)
        self.remote = remote
        self.root = self.cache.root
        self._lock = threading.Lock()
        #: {name: server clen} for names the server is KNOWN to hold, and
        #: the set it is known NOT to hold (as of the last query) — both
        #: primed by has_many so the per-chunk puts/refs of a save ride
        #: the ONE batched round trip save_shards already paid.  A stale
        #: negative only costs a redundant idempotent upload; a positive
        #: stays valid as long as this client's live-set lease is renewed
        #: (chunks are immutable and leased chunks are never collected;
        #: gc_remote clears both memos).
        self._known_remote: Dict[str, int] = {}
        self._known_absent: set = set()
        self.stats = {"chunks_written": 0, "chunks_referenced": 0,
                      "bytes_written": 0, "bytes_referenced": 0,
                      "chunks_removed": 0,
                      "bytes_uploaded": 0, "bytes_referenced_remote": 0,
                      "bytes_fetched": 0, "bytes_read": 0,
                      "cache_hits": 0, "cache_misses": 0,
                      "chunks_prefetched": 0}

    @property
    def spec_obj(self) -> StoreSpec:
        return self.remote.spec_obj.with_cache(self.cache.root)

    def close(self) -> None:
        self.remote.close()

    def health(self) -> Optional[List[dict]]:
        """Per-shard health when the remote tier is sharded, else None."""
        fn = getattr(self.remote, "health", None)
        return fn() if fn is not None else None

    # -------------------------------------------------- presence (server)
    def _presence(self, name: str) -> Optional[int]:
        with self._lock:
            if name in self._known_remote:
                return self._known_remote[name]
            if name in self._known_absent:
                return None
        got = self.remote.has_many([name])
        with self._lock:
            self._known_remote.update(got)
            if name not in got:
                self._known_absent.add(name)
        return got.get(name)

    def has(self, name: str) -> bool:
        return self._presence(name) is not None

    def has_many(self, names: Sequence[str]) -> Dict[str, int]:
        with self._lock:
            known = {n: self._known_remote[n] for n in names
                     if n in self._known_remote}
            unknown = [n for n in names
                       if n not in known and n not in self._known_absent]
        if unknown:
            got = self.remote.has_many(unknown)
            with self._lock:
                self._known_remote.update(got)
                self._known_absent.update(n for n in unknown
                                          if n not in got)
            known.update(got)
        return known

    # ----------------------------------------------------- reads (cache)
    def size(self, name: str) -> int:
        if self.cache.has(name):
            return self.cache.size(name)
        clen = self._presence(name)
        if clen is None:
            raise FileNotFoundError(name)
        return clen

    def sizes(self, names: Sequence[str]) -> Dict[str, Optional[int]]:
        out: Dict[str, Optional[int]] = {}
        misses = []
        for n in names:
            if self.cache.has(n):
                out[n] = self.cache.size(n)
            else:
                misses.append(n)
        if misses:
            # the VALIDATION view goes to remote.sizes, not has_many: a
            # sharded remote raises there when a name is unresolved and a
            # replica shard was unreachable ("can't tell" must never read
            # as "definitely missing" — gc deletes on the latter)
            got = self.remote.sizes(misses)
            with self._lock:
                self._known_remote.update(
                    {n: sz for n, sz in got.items() if sz is not None})
            out.update(got)
        return {n: out.get(n) for n in names}

    def prefetch(self, names: Sequence[str]) -> int:
        """Pin every cache-missing name in `names` into the cache via
        batched ``get_many`` round trips (``REPRO_CHUNK_PREFETCH_BATCH``
        names each — bounds any one reply buffer); over a sharded remote
        each batch fans out per shard, so the restore working set rides N
        sockets at once.  Returns the wire bytes fetched.  Names the
        remote doesn't hold are left for the per-chunk ``get`` ladder."""
        # once each: a name listed twice (leaves with equal bytes) would
        # otherwise be fetched again by a later batch
        miss = [n for n in dict.fromkeys(names) if not self.cache.has(n)]
        fetched = 0
        step = max(1, int(tunables.CHUNK_PREFETCH_BATCH))
        for k in range(0, len(miss), step):
            got = self.remote.get_many(miss[k:k + step])
            for n, blob in got.items():
                self.cache.put(n, blob)
                fetched += len(blob)
                with self._lock:
                    self._known_remote.setdefault(n, len(blob))
                    self.stats["chunks_prefetched"] += 1
        if fetched:
            with self._lock:
                self.stats["bytes_fetched"] += fetched
        return fetched

    def get(self, name: str) -> bytes:
        if self.cache.has(name):
            blob = self.cache.get(name)
            with self._lock:
                self.stats["cache_hits"] += 1
                self.stats["bytes_read"] += len(blob)
            return blob
        blob = self.remote.get(name)
        self.cache.put(name, blob)          # pin: next restore is local
        with self._lock:
            self._known_remote.setdefault(name, len(blob))
            self.stats["cache_misses"] += 1
            self.stats["bytes_fetched"] += len(blob)
            self.stats["bytes_read"] += len(blob)
        return blob

    # ---------------------------------------------------- writes (server)
    def put(self, name: str, blob: bytes, raw_bytes: int = 0) -> bool:
        blob = _flat(blob)
        raw = raw_bytes or len(blob)
        if not self.cache.has(name):
            self.cache.put(name, blob, raw_bytes=raw)
        clen = self._presence(name)
        if clen is not None:
            with self._lock:
                self.stats["chunks_referenced"] += 1
                self.stats["bytes_referenced"] += raw
                self.stats["bytes_referenced_remote"] += clen
            return False
        self.remote.put(name, blob, raw_bytes=raw)
        with self._lock:
            self._known_remote[name] = len(blob)
            self._known_absent.discard(name)
            self.stats["chunks_written"] += 1
            self.stats["bytes_written"] += raw
            self.stats["bytes_uploaded"] += len(blob)
        return True

    def ref(self, name: str, raw_bytes: int) -> None:
        # counters only — no wire: a 13-of-16 incremental save must not
        # pay 13 round trips to bump a server-side stat (pure
        # RemoteChunkStore clients still forward REF; server stats then
        # describe their traffic)
        clen = self._presence(name)
        with self._lock:
            self.stats["chunks_referenced"] += 1
            self.stats["bytes_referenced"] += raw_bytes
            self.stats["bytes_referenced_remote"] += clen or 0

    # -------------------------------------------------------------- admin
    def list_chunks(self) -> Set[str]:
        return self.cache.list_chunks() | self.remote.list_chunks()

    def gc(self, live: Iterable[str]) -> int:
        """Collect the CACHE only, and renew this client's server-side
        lease over `live` (best-effort — see RemoteChunkStore.gc)."""
        live = set(live)
        removed = self.cache.gc(live)
        try:
            self.remote.lease(live)
        except (ChunkServiceError, OSError):
            pass
        with self._lock:
            self.stats["chunks_removed"] += removed
        return removed

    def gc_remote(self, live: Iterable[str]) -> int:
        removed = self.remote.gc_remote(live)
        with self._lock:
            self._known_remote = {}
            self._known_absent = set()
        return removed

    def lease(self, names: Iterable[str], ttl: Optional[float] = None,
              lease_id: Optional[str] = None) -> int:
        return self.remote.lease(names, ttl, lease_id)

    def unlease(self, lease_id: Optional[str] = None) -> bool:
        return self.remote.unlease(lease_id)


# =========================================================================
# CLI: serve one shard
# =========================================================================

def _main(argv=None):
    """``python -m repro_torch.checkpoint.chunkservice DIR [--port P]`` —
    serve one chunk directory over a socket.  Run N of these and list
    every ``host:port`` in one StoreSpec to form a shard set."""
    import argparse
    ap = argparse.ArgumentParser(
        description="Serve a content-addressed chunk directory over a "
                    "socket — one shard of a remote:// endpoint list.")
    ap.add_argument("root", help="backing directory for this shard")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (default 127.0.0.1)")
    ap.add_argument("--port", type=int, default=0,
                    help="port to listen on (0 picks a free one)")
    ap.add_argument("--advertise-host", default=None,
                    help="dialable name to print when binding a wildcard")
    ap.add_argument("--auto-gc-interval", type=float, default=None,
                    help="server-side lease-aware gc sweep period, seconds")
    args = ap.parse_args(argv)
    srv = ChunkServer(args.root, host=args.host, port=args.port,
                      advertise_host=args.advertise_host,
                      auto_gc_interval=args.auto_gc_interval).start()
    print(f"chunkserver: {args.root} on {srv.host}:{srv.port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()


if __name__ == "__main__":
    # run the importable module's copy, so that the classes this server
    # pickles into its replies (ChunkServiceError) are named by their
    # module path and not by ``__main__``, which no client can resolve
    from repro_torch.checkpoint.chunkservice import _main as _run
    _run()
