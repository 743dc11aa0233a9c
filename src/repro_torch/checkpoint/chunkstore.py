"""Content-addressed chunk store (copy of
``repro.checkpoint.chunkstore``).

A chunk is an immutable file named by the digest of its UNCOMPRESSED
content: ``<store root>/<digest>.<ext>`` (the extension records the codec).
Checkpoint manifests reference chunks by name, so two checkpoints whose
leaves did not change between saves share the same chunk files on disk and
the second save writes nothing for them.  Deletion is refcounting over
live manifests: a chunk is removed only when no remaining manifest
references it (``gc``).

Because the name IS the content digest (blake2b, 16 bytes, as in the
reference), chunks are self-validating, and a store written by either
package dedups against the other: the same bytes get the same name.

Writes are atomic (tmp file + rename) and idempotent: two writers racing
on the same digest produce byte-identical content, so whichever rename
lands last is indistinguishable from the first.

Every consumer writes against the ``ChunkStoreBackend`` interface, and
``open_store`` resolves a spec to a backend.  The ``StoreSpec`` grammar is
the reference's:

    /path/to/chunks                                   (local directory)
    remote://host:port[/ns][?cache=DIR]               (one chunk server)
    remote://h1:p1,h2:p2,h3:p3[/ns][?cache=DIR&replicas=2]   (sharded)

A local spec opens a ``ChunkStore`` (below); a remote one opens the
chunk-service client of ``checkpoint/chunkservice.py`` — a
``RemoteChunkStore`` for one endpoint, a ``ShardedChunkStore`` for several,
behind a ``CachingChunkStore`` when the spec names a cache directory.  An
unreachable server raises; nothing falls back to a local store.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import threading
import urllib.parse
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Set, Tuple


def content_digest(buf) -> str:
    """Digest of a bytes-like/buffer (memoryviews welcome — no copy)."""
    return hashlib.blake2b(buf, digest_size=16).hexdigest()


#: chunk names, namespaces and lease ids are digest-shaped tokens;
#: anything else is rejected (a name is used as a path component).
#: Shared with the chunk service, which enforces it server-side.
SAFE_TOKEN = re.compile(r"^[A-Za-z0-9._-]+$")


def check_token(tok: str, what: str) -> str:
    # fullmatch (a trailing newline must not slip past a $-anchor) and no
    # dot-only tokens: namespace "." would alias a server's default
    # namespace and break cross-job isolation
    if (not SAFE_TOKEN.fullmatch(tok) or ".." in tok
            or set(tok) == {"."}):
        raise ValueError(f"illegal {what} {tok!r}")
    return tok


_ENDPOINT = re.compile(r"^[A-Za-z0-9._\-\[\]]+:\d+$")


@dataclass(frozen=True)
class StoreSpec:
    """Structured description of a chunk store (DESIGN.md §15).

    One object replaces the ad-hoc strings that used to thread through
    ``open_store``/``spec()``:

      * ``scheme``     — ``"local"`` (a directory) or ``"remote"`` (one
        or more chunk servers);
      * ``endpoints``  — ``("host:port", ...)`` for remote stores; more
        than one endpoint means a digest-space-sharded store and the
        ORDER is the shard map (two specs with permuted endpoints are
        different stores);
      * ``path``       — the root directory for local stores;
      * ``namespace``  — server-side isolation unit (empty = default);
      * ``replicas``   — how many endpoints each chunk is written to;
        ``None`` means "the store default" (``REPRO_REPLICAS``, clamped
        to ``len(endpoints)`` at open time), an explicit int is obeyed
        (also clamped) and survives the round trip;
      * ``cache``      — local cache directory layered over a remote
        (``CachingChunkStore``).

    ``canonical()`` and ``parse()`` round-trip exactly; the canonical
    string is what manifests record and what process-world children are
    handed, so it must stay stable across processes and hosts."""

    scheme: str = "local"
    endpoints: Tuple[str, ...] = ()
    path: Optional[str] = None
    namespace: str = ""
    replicas: Optional[int] = None
    cache: Optional[str] = None

    def __post_init__(self):
        # normalize Path-typed fields so equality/round-trip are exact
        if self.path is not None and not isinstance(self.path, str):
            object.__setattr__(self, "path", str(self.path))
        if self.cache is not None and not isinstance(self.cache, str):
            object.__setattr__(self, "cache", str(self.cache))
        if not isinstance(self.endpoints, tuple):
            object.__setattr__(self, "endpoints", tuple(self.endpoints))
        if self.scheme == "local":
            if not self.path:
                raise ValueError("local StoreSpec needs a path")
            if self.endpoints or self.cache or self.replicas is not None:
                raise ValueError(
                    "local StoreSpec takes no endpoints/cache/replicas")
        elif self.scheme == "remote":
            if not self.endpoints:
                raise ValueError("remote StoreSpec needs endpoints")
            for ep in self.endpoints:
                if not _ENDPOINT.fullmatch(ep):
                    raise ValueError(f"endpoint needs host:port, got {ep!r}")
            if len(set(self.endpoints)) != len(self.endpoints):
                raise ValueError(
                    f"duplicate endpoints in {self.endpoints!r}")
            if self.replicas is not None and self.replicas < 1:
                raise ValueError(f"replicas must be >= 1, "
                                 f"got {self.replicas}")
        else:
            raise ValueError(f"unknown store scheme {self.scheme!r}")
        if self.namespace:
            check_token(self.namespace, "namespace")

    # ------------------------------------------------------------- parse
    @classmethod
    def parse(cls, spec) -> "StoreSpec":
        """Resolve any accepted spec shape — a ``StoreSpec`` (returned
        as-is), a ``remote://`` string (old single-endpoint strings
        included), or a local path string/Path."""
        if isinstance(spec, cls):
            return spec
        text = str(spec)
        if not text.startswith("remote://"):
            return cls(scheme="local", path=text)
        rest = text[len("remote://"):]
        cache: Optional[str] = None
        replicas: Optional[int] = None
        if "?" in rest:
            rest, query = rest.split("?", 1)
            for kv in query.split("&"):
                k, _, v = kv.partition("=")
                if k == "cache" and v:
                    # percent-decoded: cache dirs are user paths and may
                    # legally contain ``?``/``&`` (canonical() quotes)
                    cache = urllib.parse.unquote(v)
                elif k == "replicas" and v.isdigit():
                    replicas = int(v)
                else:
                    raise ValueError(
                        f"unknown spec parameter {kv!r} in {text!r}")
        ns = ""
        if "/" in rest:
            rest, ns = rest.split("/", 1)
        endpoints = tuple(e for e in rest.split(",") if e)
        if not endpoints:
            raise ValueError(f"spec needs host:port, got {text!r}")
        return cls(scheme="remote", endpoints=endpoints, namespace=ns,
                   replicas=replicas, cache=cache)

    # --------------------------------------------------------- canonical
    def canonical(self) -> str:
        """The one string form of this spec; ``parse(canonical())`` is
        the identity.  Local specs stay plain paths (manifests written
        before StoreSpec remain byte-identical); remote specs list
        endpoints in shard order with query keys in canonical
        (alphabetical) order."""
        if self.scheme == "local":
            return self.path
        out = "remote://" + ",".join(self.endpoints)
        if self.namespace:
            out += f"/{self.namespace}"
        params = []
        if self.cache:
            params.append(
                f"cache={urllib.parse.quote(self.cache, safe='/')}")
        if self.replicas is not None:
            params.append(f"replicas={self.replicas}")
        if params:
            out += "?" + "&".join(params)
        return out

    def __str__(self) -> str:
        return self.canonical()

    # ------------------------------------------------------- composition
    def with_cache(self, cache: Optional[str | Path]) -> "StoreSpec":
        """The same store seen through a local cache directory (the
        migration destination / fresh-host shape)."""
        return dataclasses.replace(
            self, cache=str(cache) if cache is not None else None)

    def without_cache(self) -> "StoreSpec":
        """The portable form third-party readers use for fetch-on-miss —
        what manifests record (another host must not try to create/pin
        into the writer's cache path)."""
        return dataclasses.replace(self, cache=None)

    def with_namespace(self, namespace: str) -> "StoreSpec":
        return dataclasses.replace(self, namespace=namespace)

    def with_replicas(self, replicas: Optional[int]) -> "StoreSpec":
        return dataclasses.replace(self, replicas=replicas)

    @property
    def sharded(self) -> bool:
        return len(self.endpoints) > 1


def _fresh_stats() -> Dict[str, int]:
    return {"chunks_written": 0, "chunks_referenced": 0,
            "bytes_written": 0, "bytes_referenced": 0,
            "chunks_removed": 0}


class ChunkStoreBackend:
    """The storage interface both checkpoint layers write against.

    Implementations: ``ChunkStore`` (one local directory — below),
    ``RemoteChunkStore`` (a socket client to a ``ChunkServer``),
    ``ShardedChunkStore`` (several servers, replicated) and
    ``CachingChunkStore`` (local cache over a remote, fetch-on-miss) in
    checkpoint/chunkservice.py.  All must be thread-safe: ``put`` runs
    concurrently from writer-pool threads.

    ``stats`` carries at least the counters in ``_fresh_stats`` —
    ``bytes_written``/``bytes_referenced`` are in RAW (uncompressed)
    bytes, the currency of ``delta_write_fraction``; networked backends
    add wire-byte counters (``bytes_uploaded`` etc.) on top.
    """

    #: save pipelines group shard digests into ONE has_many round trip
    #: before compressing/uploading when this is True (networked stores);
    #: a local store answers has() with a stat call and skips the barrier
    wants_batched_has = False

    #: local directory the chunks land in, when there is one (used for the
    #: manifest's relative ``chunk_dir``); None for a pure remote store
    root: Optional[Path] = None

    @property
    def spec_obj(self) -> StoreSpec:
        """Structured description of this store; ``spec``/``fetch_spec``
        are derived canonical strings."""
        raise NotImplementedError

    @property
    def spec(self) -> str:
        """Round-trippable canonical description of this store:
        ``open_store(spec)`` in ANOTHER PROCESS builds an equivalent
        backend (the process world hands it to rank children)."""
        return self.spec_obj.canonical()

    @property
    def fetch_spec(self) -> str:
        """The spec a THIRD-PARTY reader should use for fetch-on-miss —
        what manifests record.  For a caching store this strips the
        writer-host-local cache directory (another host must not try to
        create/pin into the writer's path); defaults to ``spec``."""
        return self.spec_obj.without_cache().canonical()

    def has(self, name: str) -> bool:
        raise NotImplementedError

    def size(self, name: str) -> int:
        raise NotImplementedError

    def get(self, name: str) -> bytes:
        raise NotImplementedError

    def put(self, name: str, blob: bytes, raw_bytes: int = 0) -> bool:
        raise NotImplementedError

    def ref(self, name: str, raw_bytes: int) -> None:
        raise NotImplementedError

    def list_chunks(self) -> Set[str]:
        raise NotImplementedError

    def gc(self, live: Iterable[str]) -> int:
        raise NotImplementedError

    # ---- batched queries (backends override with one-round-trip versions)
    def has_many(self, names: Sequence[str]) -> Dict[str, int]:
        """{name: stored size} for every name PRESENT — the upload
        decision ("do I need to ship these bytes?")."""
        out: Dict[str, int] = {}
        for n in names:
            if self.has(n):
                out[n] = self.size(n)
        return out

    def sizes(self, names: Sequence[str]) -> Dict[str, Optional[int]]:
        """{name: readable size or None} — the validation view ("can a
        restore through THIS store read the chunk?"); for a caching store
        this consults the cache first, then the remote."""
        return {n: (self.size(n) if self.has(n) else None) for n in names}

    def close(self) -> None:
        """Release any connection this backend holds (no-op for local)."""


def open_store(spec, default=None) -> "ChunkStoreBackend":
    """The resolution point from a spec to a backend:

      * an existing ``ChunkStoreBackend`` passes through untouched;
      * a ``StoreSpec`` (or any ``remote://`` string ``StoreSpec.parse``
        accepts) builds the matching client: ``RemoteChunkStore`` for one
        endpoint, ``ShardedChunkStore`` for several, wrapped in a
        ``CachingChunkStore`` when the spec carries a cache dir;
      * anything else is a local directory -> ``ChunkStore``.

    ``default`` is used when `spec` is None.
    """
    if spec is None:
        spec = default
    if spec is None:
        raise ValueError("no chunk store spec and no default")
    if isinstance(spec, ChunkStoreBackend):
        return spec
    sp = StoreSpec.parse(spec)
    if sp.scheme == "remote":
        # lazy: chunkservice imports this module
        from repro_torch.checkpoint.chunkservice import store_from_spec
        return store_from_spec(sp)
    return ChunkStore(sp.path)


class ChunkReader:
    """Chunk access for ONE checkpoint manifest, in preference order:

      1. an explicit ``store`` backend (a CheckpointManager's, or the
         ``ckpt_store`` handed to an elastic restart) — covers
         cache-then-fetch for caching backends;
      2. the manifest's local ``chunk_dir`` (fast path: plain file io) —
         ALSO consulted when the explicit store misses, so a
         self-contained checkpoint written before a shared store was
         adopted stays restorable;
      3. on a miss everywhere else, a backend opened lazily from the
         manifest's recorded ``store`` spec (fetch-on-miss: a reader on a
         host that never saw this checkpoint pulls exactly the chunks it
         lacks).

    Works for BOTH manifest layers (tensor leaves and rank images) —
    each records the same ``chunk_dir`` / ``store`` keys.
    """

    def __init__(self, ckpt_dir, man: dict,
                 store: Optional[ChunkStoreBackend] = None):
        self.dir = Path(ckpt_dir)
        self.chunk_dir = man.get("chunk_dir", "chunks")
        self.store = store
        self._spec = man.get("store")
        self._fallback: Optional[ChunkStoreBackend] = None

    def _spec_store(self) -> Optional[ChunkStoreBackend]:
        if self._fallback is None and self._spec:
            self._fallback = open_store(self._spec)
        return self._fallback

    def path(self, name: str) -> Path:
        return self.dir / self.chunk_dir / name

    def get(self, name: str) -> bytes:
        unreachable: Optional[ConnectionError] = None
        if self.store is not None:
            try:
                return self.store.get(name)
            except ConnectionError as e:
                unreachable = e    # try local before giving up
            except (OSError, KeyError):
                pass       # fall through to the checkpoint's own chunks
        try:
            return self.path(name).read_bytes()
        except FileNotFoundError:
            if unreachable is not None:
                # absent locally AND the store couldn't be asked: report
                # the outage, not a phantom "chunk does not exist"
                raise unreachable
            fb = self._spec_store()
            if fb is None:
                raise
            return fb.get(name)

    def prefetch(self, names: Sequence[str]) -> int:
        """Pull the restore working set down in bulk BEFORE the per-chunk
        ``get`` calls: names that are neither locally present nor already
        cached are fetched through the backend's batched ``get_many``
        fan-out (one round trip per shard for a sharded store) and pinned
        into its cache.  Returns the wire bytes fetched; 0 when the
        backend has no ``prefetch`` (local stores) or is unreachable —
        the per-chunk ladder in ``get`` remains the authority, so a
        failed prefetch degrades to the old path instead of failing the
        restore."""
        store = self.store
        fn = getattr(store, "prefetch", None)
        if fn is None and self._spec:
            store = self._spec_store()
            fn = getattr(store, "prefetch", None)
        if fn is None:
            return 0
        miss = [n for n in names if not self.path(n).is_file()]
        if not miss:
            return 0
        try:
            return fn(miss)
        except ConnectionError:
            return 0

    def sizes(self, names: Sequence[str]) -> Dict[str, Optional[int]]:
        """{name: readable size or None}; one batched query against the
        backend, the local directory covering whatever it misses (and
        vice versa), the manifest's spec store last.  Raises
        ConnectionError when a name is locally absent AND the backend
        that should know about it is unreachable — "can't tell" must
        never read as "definitely missing" (gc deletes on the latter)."""
        out: Dict[str, Optional[int]] = {}
        unreachable: Optional[ConnectionError] = None
        if self.store is not None:
            try:
                out = dict(self.store.sizes(names))
            except ConnectionError as e:
                unreachable = e
        misses = []
        for n in names:
            if out.get(n) is not None:
                continue
            try:
                out[n] = self.path(n).stat().st_size
            except OSError:
                misses.append(n)
        if misses:
            fb = self._spec_store()     # last resort, like get()
            if fb is not None:
                out.update(fb.sizes(misses))
                misses = [n for n in misses if out.get(n) is None]
        if misses and unreachable is not None:
            raise unreachable
        return {n: out.get(n) for n in names}


class ChunkStore(ChunkStoreBackend):
    """One flat directory of content-addressed chunk files.

    Thread-safe: ``put`` may be called concurrently from writer-pool
    threads (and from several rank threads sharing one store); stats
    updates are lock-protected, file writes are atomic renames.
    """

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self._lock = threading.Lock()
        self.stats = _fresh_stats()

    @property
    def spec_obj(self) -> StoreSpec:
        return StoreSpec(scheme="local", path=str(self.root))

    # ------------------------------------------------------------------ io
    def path(self, name: str) -> Path:
        return self.root / name

    def has(self, name: str) -> bool:
        return (self.root / name).is_file()

    def size(self, name: str) -> int:
        return (self.root / name).stat().st_size

    def ref(self, name: str, raw_bytes: int) -> None:
        """Count an incremental reference: the chunk already exists and this
        save points at it instead of rewriting it."""
        with self._lock:
            self.stats["chunks_referenced"] += 1
            self.stats["bytes_referenced"] += raw_bytes

    def put(self, name: str, blob: bytes, raw_bytes: int = 0) -> bool:
        """Store `blob` under `name` unless present.  Returns True when this
        call wrote the chunk, False when it was already stored (a reference,
        the incremental fast path).  `raw_bytes` is the uncompressed payload
        size, credited to the written/referenced byte counters."""
        p = self.root / name
        if p.is_file():
            self.ref(name, raw_bytes or len(blob))
            return False
        self.root.mkdir(parents=True, exist_ok=True)
        # tmp name must be unique per WRITER, and writers can now live in
        # different processes (process-world rank children share one store):
        # thread idents alone collide across forked children — same main
        # thread address — so qualify with the pid too
        tmp = p.with_name(
            p.name + f".tmp{os.getpid()}-{threading.get_ident()}")
        tmp.write_bytes(blob)
        os.replace(tmp, p)
        with self._lock:
            self.stats["chunks_written"] += 1
            self.stats["bytes_written"] += raw_bytes or len(blob)
        return True

    def get(self, name: str) -> bytes:
        return (self.root / name).read_bytes()

    # ------------------------------------------------------------------ gc
    def list_chunks(self) -> Set[str]:
        if not self.root.is_dir():
            return set()
        return {p.name for p in self.root.iterdir()
                if p.is_file() and ".tmp" not in p.name}

    def gc(self, live: Iterable[str]) -> int:
        """Remove every chunk NOT in `live` (the union of chunk names
        referenced by all manifests the caller intends to keep).  Returns
        the number removed.  Stale tmp files are always collected."""
        live = set(live)
        removed = 0
        if not self.root.is_dir():
            return 0
        for p in list(self.root.iterdir()):
            if not p.is_file():
                continue
            if ".tmp" in p.name or p.name not in live:
                try:
                    p.unlink()
                    removed += 1
                except OSError:
                    pass
        with self._lock:
            self.stats["chunks_removed"] += removed
        return removed
