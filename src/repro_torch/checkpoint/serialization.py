"""Per-shard checkpoint serialization over a content-addressed chunk
store: the reference's format (``repro.checkpoint.serialization``, manifest
v3) over torch tensors.

Each leaf of the state tree is written as one chunk per shard (a plain
tensor: one shard; a DTensor: the windows its ranks hold, each once),
named by the digest of its uncompressed bytes and
stored through a ``ChunkStoreBackend``; a JSON manifest holds the tree
structure as ``/``-joined leaf keys, global shapes, numpy-style dtype
strings (``"float32"``, ``"bfloat16"``) and shard index maps, and
references chunks BY NAME.  Keys, dtype strings, codecs, chunk names and
the byte-shuffle filter are the reference's, so a step directory written
by either package restores in the other bit for bit, and identical bytes
get identical chunk names (the two packages dedup against each other).

The write path is the reference's pipelined writer: shard jobs
(hash → store-hit check → probe → compress → atomic write) on a thread
pool, reading memoryviews of the host snapshot.  Multi-byte float shards
are byte-transposed (shuffle filter) before the probe when that wins.
The restore path fetches and decompresses a bounded pool of leaves ahead
of the consumer.

What differs from the reference is only what JAX did there:

  * numpy has no bfloat16 without ``ml_dtypes`` (a JAX dependency), so a
    bf16 leaf's host copy is its raw ``uint16`` words; the logical dtype
    string travels beside them (``HostArray.dtype``), and the shuffle
    width comes from that string, not from the host array;
  * ``load_leaf`` reads a bf16 leaf as ``uint16`` words; the restore loop
    views them as ``torch.bfloat16``;
  * trees are the port's dicts, lists and tuples (``_leaf_paths`` gives the
    keys ``jax.tree_util.tree_flatten_with_path`` gives the reference).
"""
from __future__ import annotations

import json
import os
import re
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import chunkstore
from repro_torch.checkpoint.chunkstore import (ChunkReader, ChunkStoreBackend,
                                               content_digest)
from repro_torch.distributed.sharding import is_dtensor, window

try:                                    # zstandard is optional: fall back to
    import zstandard                    # zlib so the core C/R path has no
    HAVE_ZSTD = True                    # dependency beyond the stdlib
except ImportError:                     # pragma: no cover - env dependent
    zstandard = None
    HAVE_ZSTD = False


class _ZlibCompressor:
    def compress(self, data) -> bytes:
        return zlib.compress(data, 6)


class _ZlibDecompressor:
    def decompress(self, blob: bytes) -> bytes:
        return zlib.decompress(blob)


def _codec_pair(codec: str):
    """(compressor, decompressor) for a manifest codec name."""
    if codec == "zstd":
        if not HAVE_ZSTD:
            raise RuntimeError(
                "checkpoint written with zstd but zstandard is not installed")
        return zstandard.ZstdCompressor(level=3), zstandard.ZstdDecompressor()
    if codec == "zlib":
        return _ZlibCompressor(), _ZlibDecompressor()
    raise ValueError(f"unknown checkpoint codec {codec!r}")


DEFAULT_CODEC = "zstd" if HAVE_ZSTD else "zlib"

#: default writer-pool width; compression releases the GIL so threads give
#: real parallelism.  Kept modest: past the storage bandwidth more threads
#: only add contention.  The restore pool mirrors this.
DEFAULT_WORKERS = min(8, os.cpu_count() or 1)

#: adaptive compression: probe-compress a sample of a chunk first, and if
#: the probe stays above INCOMPRESSIBLE_RATIO store the chunk RAW (ext
#: ``.raw``) — trained float32/bf16 weights are near-random bytes, and
#: running deflate over them costs ~40ms/MB to save a few percent.  The
#: chunk name (content digest of the UNCOMPRESSED bytes) is unchanged, so
#: integrity and incremental dedup work identically for raw chunks.
#:
#: The sample is BOTH capped (INCOMPRESSIBLE_SAMPLE) and fractional
#: (1/PROBE_FRACTION of the chunk, floored at PROBE_MIN_SAMPLE): a flat
#: 64 KiB cap alone means a chunk of exactly that size pays a FULL
#: deflate pass just to decide "store raw".  Chunks at or below
#: PROBE_MIN_SAMPLE are still probed whole, so a compressible small chunk
#: keeps the probe-is-the-payload single pass.  These constants decide the
#: chunk names, so they must stay equal to the reference's.
INCOMPRESSIBLE_SAMPLE = 1 << 16
INCOMPRESSIBLE_RATIO = 0.9
PROBE_MIN_SAMPLE = 1 << 13
PROBE_FRACTION = 8

#: byte-shuffle probe economics, three gates in increasing cost:
#:
#:   1. TOP_BYTES — the filter's entire win is a low-entropy top
#:      (sign+exponent) byte plane, so count distinct top bytes over the
#:      sample (~20us) first; wide-range floats (many exponents in play:
#:      unit-variance float32 weights measure 12-15 distinct) skip the
#:      compression probe entirely and keep the raw path's zero cost.
#:   2. the shuffled probe runs on a SMALLER sample (an eighth of the
#:      plain one — the plane structure shows at any size);
#:   3. the shuffled path is taken only when it beats the plain ratio by
#:      a clear MARGIN — it costs a strided full-buffer copy plus a
#:      compression pass over data the plain probe may have stored raw
#:      for free.  Near-constant-exponent payloads (uniform/narrow-range
#:      floats, most float64) probe 0.05-0.07+ better and pay off.
BYTE_SHUFFLE_SAMPLE = 1 << 13
BYTE_SHUFFLE_MARGIN = 0.04
BYTE_SHUFFLE_TOP_BYTES = 8


def _codec_ext(codec: str) -> str:
    return "zst" if codec == "zstd" else "zz"


#: chunk extensions are authoritative at read time — a store can hold the
#: same digest under several encodings and every one decodes to the same
#: bytes.  Plain: ``zst``/``zz``; shuffled carries its byte width IN THE
#: NAME (``zsts4``/``zzs8``), so a store hit can never be decoded with a
#: width other than the one it was written with (the unshuffle inverts
#: the writer's permutation and yields the original bytes whatever dtype
#: the READER reassembles them into).
_EXT_PLAIN = {"zst": "zstd", "zz": "zlib"}
_EXT_SHUF = re.compile(r"^(zst|zz)s(\d+)$")


# ------------------------------------------------------ byte-shuffle filter

#: manifest dtype string -> (numpy storage dtype, torch dtype).  The
#: strings are numpy's names, as the reference writes them; bfloat16 is
#: stored as its raw 16-bit words.  uint32 is the reference TrainState's
#: rng key (``jax.random.PRNGKey``, uint32[2]).
DTYPES = {name: (np.dtype("uint16" if name == "bfloat16" else name),
                 getattr(torch, name))
          for name in ("float64", "float32", "float16", "bfloat16", "int64",
                       "int32", "int16", "int8", "uint64", "uint32", "uint16",
                       "uint8", "bool")}


_NAMES = {t: name for name, (_, t) in DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's manifest string: ``torch.bfloat16`` -> "bfloat16"."""
    if dtype not in _NAMES:
        raise TypeError(f"no checkpoint dtype for {dtype}")
    return _NAMES[dtype]


def _shuffle_itemsize(dtype: str) -> int:
    """Element width when the byte-transpose filter applies (multi-byte
    floats: sign/exponent bytes repeat across elements and compress well
    once grouped; mantissa bytes stay random but now sit together), else
    0.  Taken from the LOGICAL dtype string: a bf16 leaf's host copy is
    uint16 words, which must shuffle as the reference's bfloat16 does."""
    if dtype == "bfloat16":
        return 2
    dt = np.dtype(dtype)
    return dt.itemsize if dt.kind == "f" and dt.itemsize > 1 else 0


def _shuffled(buf, itemsize: int) -> bytes:
    """Byte transpose: [e0b0 e0b1 e1b0 e1b1 ...] -> [all b0s][all b1s].
    One copy, the same cost class as the ``tobytes`` the writer already
    avoids elsewhere — paid only when the probe says it wins."""
    a = np.frombuffer(buf, dtype=np.uint8)
    return a.reshape(-1, itemsize).T.tobytes()


def _unshuffled(raw: bytes, itemsize: int) -> bytes:
    a = np.frombuffer(raw, dtype=np.uint8)
    return a.reshape(itemsize, -1).T.tobytes()


def _top_plane_narrow(buf, itemsize: int) -> bool:
    """Cheap shuffle-probe gate: True when the top (sign+exponent on
    little-endian) byte plane of the sample holds few distinct values —
    the precondition for the transpose to win (BYTE_SHUFFLE_TOP_BYTES)."""
    top = np.frombuffer(buf, dtype=np.uint8)[itemsize - 1::itemsize]
    return np.unique(top).size <= BYTE_SHUFFLE_TOP_BYTES


def decode_chunk(name: str, blob: bytes, codec: str) -> bytes:
    """Chunk file bytes -> original uncompressed bytes, keyed by the chunk
    extension (``raw``/``bin`` = stored as-is; ``zsts<N>``/``zzs<N>`` =
    compressed, byte-shuffled with width N).  `codec` is only the
    fallback for extensions outside the map (v3 manifests written before
    the map)."""
    ext = name.rsplit(".", 1)[-1]
    if ext in ("raw", "bin"):
        return blob
    shuf = _EXT_SHUF.match(ext)
    base = (_EXT_PLAIN[shuf.group(1)] if shuf
            else _EXT_PLAIN.get(ext, codec))
    _, dctx = _codec_pair(base)
    raw = dctx.decompress(blob)
    if shuf:
        raw = _unshuffled(raw, int(shuf.group(2)))
    return raw


class HostArray:
    """Synchronous device->host copy of a tensor, taken BEFORE the async
    writer runs, so the next in-place update (the serving cache is written
    in place by every decode step) can't corrupt the checkpoint.

    A CUDA tensor is copied to the host after its device synchronizes; a
    CPU tensor is cloned (``.cpu()`` of a CPU tensor is the same storage).
    A plain tensor is one shard covering the whole tensor, recorded with
    the device id the reference records: the CUDA index, or 0 for the CPU
    (a JAX array on the CPU is on device 0).  A DTensor is this rank's
    window (from its placements and the rank's mesh coordinate), recorded
    with the global rank as its device; replicas are deduplicated by
    window BEFORE the copy, as the reference's are: only the rank at
    coordinate 0 on every mesh dim the layout replicates copies and writes
    the window, so a window replicated over N ranks costs one host copy
    and one upload, not N.  ``dtype`` is the numpy-style string; a bf16
    tensor's host array holds its raw ``uint16`` words."""

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        self.shape = tuple(t.shape)
        self.dtype = dtype_name(t.dtype)
        if not is_dtensor(t):
            self.shards = [([[0, d] for d in self.shape], _host(t),
                             t.device.index or 0)]
            return
        mesh, places = t.device_mesh, t.placements
        if any(p.is_partial() for p in places):
            raise ValueError(f"a Partial DTensor has no window to save: "
                             f"{places}")
        coord = mesh.get_coordinate()
        writer = all(c == 0 for c, p in zip(coord, places)
                     if p.is_replicate())
        self.shards = ([(window(places, self.shape, tuple(mesh.shape), coord),
                         _host(t.to_local()),
                         dist.get_rank() if dist.is_initialized() else 0)]
                       if writer else [])


def _host(t: torch.Tensor) -> np.ndarray:
    """A contiguous host copy of `t` as numpy (a bf16 tensor's raw uint16
    words)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    host = t.to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


def _walk(tree, fn, path=()):
    """The port's tree (dicts, lists, tuples; ``None`` an empty subtree, as
    ``jax.tree`` treats it) rebuilt with ``fn(path, leaf)`` at every leaf,
    dict keys visited in sorted order as ``jax.tree`` flattens them."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(tree[k], fn, path + (k,)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(x, fn, path + (i,))
                          for i, x in enumerate(tree))
    return fn(path, tree)


def snapshot_to_host(tree):
    """Tensor leaves -> HostArray; everything else -> np copy."""
    def conv(_, x):
        if isinstance(x, torch.Tensor):
            return HostArray(x)
        return np.asarray(x).copy()
    return _walk(tree, conv)


def _leaf_paths(tree) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` in flattening order; the key joins dict keys and
    sequence indices with ``/``, as the reference's keys do."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, lambda path, leaf: out.append(
        ("/".join(str(k) for k in path), leaf)))
    return out


def _unflatten(template, values: Sequence):
    """``values``, in ``_leaf_paths(template)`` order, in the template's
    structure."""
    it = iter(values)
    return _walk(template, lambda _, __: next(it))


def to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A restored host array (``load_leaf``'s) as a CPU tensor of the
    manifest's dtype; shares its memory."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _atomic_write(path: Path, data: bytes) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def _as_buffer(data: np.ndarray):
    """Flat byte memoryview of an array — compression and hashing read the
    host snapshot in place instead of through a ``tobytes()`` copy."""
    if not data.flags.c_contiguous:
        data = np.ascontiguousarray(data)
    if data.ndim == 0:           # 0-d arrays: one scalar, copy is free
        return memoryview(data.tobytes())
    try:
        return data.data.cast("B")
    except (ValueError, BufferError):
        # dtypes outside the buffer protocol (bfloat16 etc.): reinterpret
        # the same memory as raw bytes — still no copy
        return data.view(np.uint8).data


# ------------------------------------------------------------ write pipeline

def _hit_candidates(digest: str, ext: str, itemsize: int) -> List[str]:
    """Every name a previous save could have stored this content under
    (order = preference).  The digest covers the UNSHUFFLED uncompressed
    bytes, so all encodings of one content share one digest."""
    names = [f"{digest}.{ext}s{itemsize}"] if itemsize else []
    return names + [f"{digest}.{ext}", f"{digest}.raw"]


def _shard_codec(name: str) -> Optional[str]:
    """Per-chunk manifest codec record (e.g. ``"zstd+shuf4"``) for
    filtered chunks; None when the manifest-level codec fully describes
    the chunk.  Derived from the extension, which is authoritative."""
    shuf = _EXT_SHUF.match(name.rsplit(".", 1)[-1])
    return (f"{_EXT_PLAIN[shuf.group(1)]}+shuf{shuf.group(2)}"
            if shuf else None)


def _hash_shard(data: np.ndarray):
    t0 = time.perf_counter()
    buf = _as_buffer(data)
    digest = content_digest(buf)
    return buf, digest, time.perf_counter() - t0


def _finish_shard(store: ChunkStoreBackend, codec: str, ext: str,
                  buf, digest: str, itemsize: int, idx: list, dev: int,
                  presence: Optional[Dict[str, int]] = None
                  ) -> Tuple[dict, tuple]:
    """Store-hit check -> (probe ->) compress -> write for one hashed
    shard.  `presence` ({name: clen}, from one batched has_many covering
    the whole save) replaces per-chunk store.has round trips when the
    backend is networked; None falls back to per-call checks."""
    def entry(name: str, clen: int) -> dict:
        e = {"chunk": name, "index": idx, "device": dev,
             "clen": clen, "raw": buf.nbytes}
        codec_rec = _shard_codec(name)
        if codec_rec:
            e["codec"] = codec_rec
        return e

    t1 = time.perf_counter()
    for name in _hit_candidates(digest, ext, itemsize):
        clen = (presence.get(name) if presence is not None
                else (store.size(name) if store.has(name) else None))
        if clen is not None:             # incremental hit: reference only
            store.ref(name, buf.nbytes)
            t2 = t3 = time.perf_counter()
            return entry(name, clen), (0.0, t2 - t1, t3 - t2)
    # compressor per job, created only when actually compressing: a
    # ZstdCompressor wraps one native context and is NOT safe for
    # concurrent use across pool threads (zlib's module function is)
    cctx, _ = _codec_pair(codec)
    probe_len = min(INCOMPRESSIBLE_SAMPLE,
                    max(PROBE_MIN_SAMPLE, buf.nbytes // PROBE_FRACTION))
    sample = buf[:probe_len] if buf.nbytes > probe_len else buf
    probe = cctx.compress(sample)
    shuf_ratio = None
    if itemsize and buf.nbytes % itemsize == 0:
        aligned = min(sample.nbytes, BYTE_SHUFFLE_SAMPLE)
        aligned -= aligned % itemsize
        if aligned and _top_plane_narrow(sample[:aligned], itemsize):
            shuf_probe = cctx.compress(_shuffled(sample[:aligned],
                                                 itemsize))
            shuf_ratio = len(shuf_probe) / aligned
    plain_ratio = len(probe) / sample.nbytes
    whole = sample.nbytes == buf.nbytes
    if (shuf_ratio is not None
            and shuf_ratio < plain_ratio - BYTE_SHUFFLE_MARGIN
            and shuf_ratio < INCOMPRESSIBLE_RATIO):
        name = f"{digest}.{ext}s{itemsize}"
        blob = cctx.compress(_shuffled(buf, itemsize))
    elif plain_ratio >= INCOMPRESSIBLE_RATIO:
        name, blob = f"{digest}.raw", buf          # store uncompressed
    elif whole:
        name, blob = f"{digest}.{ext}", probe      # probe WAS the payload
    else:
        name, blob = f"{digest}.{ext}", cctx.compress(buf)
    t2 = time.perf_counter()
    store.put(name, blob, raw_bytes=buf.nbytes)
    if presence is not None:
        # a later duplicate-digest shard IN THIS SAVE references instead
        # of re-compressing/re-uploading (the snapshot was pre-save)
        presence[name] = len(blob)
    t3 = time.perf_counter()
    return entry(name, len(blob)), (0.0, t2 - t1, t3 - t2)


def _write_shard(store: ChunkStoreBackend, codec: str, ext: str,
                 data: np.ndarray, idx: list, dev: int,
                 itemsize: int) -> Tuple[dict, tuple]:
    """One single-pass pipeline job (local stores): hash -> store-hit
    check -> (probe ->) compress -> write.  Runs on a pool thread;
    returns (manifest shard entry, stage timings)."""
    buf, digest, dh = _hash_shard(data)
    ent, (_, dc, dio) = _finish_shard(store, codec, ext, buf, digest,
                                      itemsize, idx, dev)
    return ent, (dh, dc, dio)


def save_shards(ckpt_dir: Path, state, meta: Optional[dict] = None,
                codec: Optional[str] = None,
                store: Optional[ChunkStoreBackend] = None,
                workers: Optional[int] = None,
                stats: Optional[dict] = None) -> dict:
    """Write every shard of every leaf into the chunk store and commit a v3
    manifest (LAST, for atomicity).  Returns the manifest.  The arguments
    are ``write_chunks``'."""
    manifest = write_chunks(ckpt_dir, state, meta, codec, store, workers,
                            stats)
    commit_manifest(ckpt_dir, manifest)
    return manifest


def commit_manifest(ckpt_dir: Path, manifest: dict) -> None:
    """Write the manifest, atomically: the step exists from here on."""
    _atomic_write(ckpt_dir / "MANIFEST.json",
                  json.dumps(manifest, indent=1).encode())


def merge_leaves(parts: Sequence[dict]) -> dict:
    """One manifest's ``leaves`` from the ``leaves`` each rank's
    ``write_chunks`` gave, in rank order: every leaf's shards of all
    ranks, one per index window (the first rank's where two ranks wrote
    the same window, as every rank does for a plain tensor)."""
    out: Dict[str, Any] = {}
    for leaves in parts:
        for key, entry in leaves.items():
            have = out.setdefault(key, {"shape": entry["shape"],
                                        "dtype": entry["dtype"],
                                        "shards": []})
            seen = {json.dumps(s["index"]) for s in have["shards"]}
            have["shards"].extend(s for s in entry.get("shards", ())
                                  if json.dumps(s["index"]) not in seen)
    return out


def write_chunks(ckpt_dir: Path, state, meta: Optional[dict] = None,
                 codec: Optional[str] = None,
                 store: Optional[ChunkStoreBackend] = None,
                 workers: Optional[int] = None,
                 stats: Optional[dict] = None) -> dict:
    """Write every shard this process holds of every leaf into the chunk
    store; returns the v3 manifest for them, not yet committed.

    `store` defaults to ``ckpt_dir/chunks`` (a self-contained checkpoint);
    a CheckpointManager passes its root-level store so consecutive steps
    share unchanged chunks — possibly a remote/caching backend, whose spec
    the manifest records for fetch-on-miss readers.  Against a store that
    ``wants_batched_has`` the per-shard hit checks become one ``has_many``
    round trip between the hash and compress stages.  `workers` sizes the
    compress/write pool (<=1 runs inline).  `stats`, when given,
    accumulates per-stage timings (hash_s/compress_s/io_s).
    """
    codec = codec or DEFAULT_CODEC
    _codec_pair(codec)                   # fail fast on an unknown codec
    ext = _codec_ext(codec)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if store is None:
        store = chunkstore.open_store(None, default=ckpt_dir / "chunks")
    workers = DEFAULT_WORKERS if workers is None else workers
    root = getattr(store, "root", None)
    spec = getattr(store, "fetch_spec", "")
    leaves = _leaf_paths(state)
    manifest: Dict[str, Any] = {"version": 3, "codec": codec,
                                "leaves": {}, "meta": meta or {}}
    if root is not None:
        manifest["chunk_dir"] = os.path.relpath(root, ckpt_dir)
    if isinstance(spec, str) and spec.startswith("remote://"):
        # fetch-on-miss: a reader without the writer's disk can rebuild
        # chunk access from the manifest alone
        manifest["store"] = spec

    shards: List[tuple] = []        # (leaf_key, data, idx, dev, itemsize)
    for key, leaf in leaves:
        arr = leaf
        if isinstance(arr, torch.Tensor):
            arr = HostArray(arr)
        entry: Dict[str, Any] = {}
        if isinstance(arr, HostArray):
            entry["shape"] = list(arr.shape)
            entry["dtype"] = arr.dtype
            itemsize = _shuffle_itemsize(arr.dtype)
            for idx, data, dev in arr.shards:
                shards.append((key, data, idx, dev, itemsize))
        else:
            data = np.asarray(arr)
            entry["shape"] = list(data.shape)
            entry["dtype"] = str(data.dtype)
            shards.append((key, data, [[0, d] for d in data.shape], -1,
                           _shuffle_itemsize(entry["dtype"])))
        manifest["leaves"][key] = entry

    pool = ThreadPoolExecutor(max_workers=workers,
                              thread_name_prefix="ckpt-compress") \
        if workers > 1 else None
    jobs: List[Tuple[str, Any]] = []     # (leaf_key, future-or-result)
    try:
        if getattr(store, "wants_batched_has", False):
            # two-phase: hash everything (pool), ONE has_many round trip
            # for every candidate name this save could reference, then
            # compress/upload only the misses (pool again)
            def hashed(data, itemsize):
                buf, digest, dh = _hash_shard(data)
                return buf, digest, itemsize, dh
            hs = [(key, (pool.submit(hashed, data, itemsize) if pool
                         else hashed(data, itemsize)), idx, dev)
                  for key, data, idx, dev, itemsize in shards]
            hs = [(key, h if isinstance(h, tuple) else h.result(), idx, dev)
                  for key, h, idx, dev in hs]
            names: List[str] = []
            for _, (buf, digest, itemsize, _dh), _, _ in hs:
                names.extend(_hit_candidates(digest, ext, itemsize))
            presence = store.has_many(names)
            for key, (buf, digest, itemsize, dh), idx, dev in hs:
                if stats is not None:
                    stats["hash_s"] = stats.get("hash_s", 0.0) + dh
                args = (store, codec, ext, buf, digest, itemsize, idx, dev,
                        presence)
                jobs.append((key, pool.submit(_finish_shard, *args) if pool
                             else _finish_shard(*args)))
        else:
            for key, data, idx, dev, itemsize in shards:
                args = (store, codec, ext, data, idx, dev, itemsize)
                jobs.append((key, pool.submit(_write_shard, *args) if pool
                             else _write_shard(*args)))
        # collect in submission order so manifests are deterministic
        per_leaf: Dict[str, List[dict]] = {}
        for key, job in jobs:
            ent, (dh, dc, dio) = job if isinstance(job, tuple) \
                else job.result()
            per_leaf.setdefault(key, []).append(ent)
            if stats is not None:
                stats["hash_s"] = stats.get("hash_s", 0.0) + dh
                stats["compress_s"] = stats.get("compress_s", 0.0) + dc
                stats["io_s"] = stats.get("io_s", 0.0) + dio
        for key, entry in manifest["leaves"].items():
            entry["shards"] = per_leaf.get(key, [])
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    return manifest


def load_manifest(ckpt_dir: Path) -> dict:
    return json.loads((ckpt_dir / "MANIFEST.json").read_text())


def manifest_chunks(man: dict) -> List[str]:
    """Every chunk name a v3 manifest references (refcount-gc input).
    Empty for v1 manifests (their blobs live inside the step dir)."""
    if man.get("version", 1) < 3:
        return []
    return [s["chunk"] for e in man.get("leaves", {}).values()
            for s in e.get("shards", ())]


# --------------------------------------------------------------- chunk reads

def _shard_path(ckpt_dir: Path, man_or_chunk_dir, s: dict) -> Path:
    """Resolve a shard entry to its file: v3 entries name a chunk in the
    manifest's chunk_dir; v1 entries name a file inside the step dir."""
    if "chunk" in s:
        chunk_dir = (man_or_chunk_dir.get("chunk_dir", "chunks")
                     if isinstance(man_or_chunk_dir, dict)
                     else man_or_chunk_dir)
        return ckpt_dir / chunk_dir / s["chunk"]
    return ckpt_dir / s["file"]


def load_leaf(ckpt_dir: Path, entry: dict, verify: bool = True,
              codec: Optional[str] = None,
              chunk_dir: str = "chunks",
              reader: Optional[ChunkReader] = None,
              stats: Optional[dict] = None) -> np.ndarray:
    """Reassemble one logical array from its shard chunks.  `codec` must be
    the manifest's — pass ``manifest.get("codec", "zstd")`` (pre-codec
    manifests were always zstd; per-shard ``codec`` records override it
    for filtered chunks, and the chunk extension is authoritative).
    `reader` routes chunk reads (explicit store / local dir /
    fetch-on-miss); without one, reads are local files under `chunk_dir`.
    `stats` accumulates restore_io_s / restore_decompress_s."""
    if codec is None:
        raise ValueError(
            'pass the manifest codec: manifest.get("codec", "zstd")')
    shape = tuple(entry["shape"])
    if entry["dtype"] not in DTYPES:
        raise TypeError(f"no torch dtype for checkpoint dtype "
                        f"{entry['dtype']!r}")
    # bfloat16 is read as its raw 16-bit words (uint16)
    jdt = DTYPES[entry["dtype"]][0]
    out = np.zeros(shape, dtype=jdt)
    for s in entry["shards"]:
        t0 = time.perf_counter()
        if "chunk" in s and reader is not None:
            blob = reader.get(s["chunk"])
        else:
            blob = _shard_path(ckpt_dir, chunk_dir, s).read_bytes()
        t1 = time.perf_counter()
        if verify and "file" in s and zlib.crc32(blob) != s["crc32"]:
            raise IOError(f"{s['file']}: crc mismatch")
        if "chunk" in s:
            raw = decode_chunk(s["chunk"], blob, codec)
            if verify:
                # chunks are self-validating: the name IS the digest of
                # the unshuffled uncompressed content
                if content_digest(raw) != s["chunk"].split(".")[0]:
                    raise IOError(f"{s['chunk']}: content digest mismatch")
        else:
            raw = _codec_pair(codec)[1].decompress(blob)
        t2 = time.perf_counter()
        if stats is not None:
            stats["restore_io_s"] = stats.get("restore_io_s", 0.0) \
                + (t1 - t0)
            stats["restore_decompress_s"] = \
                stats.get("restore_decompress_s", 0.0) + (t2 - t1)
        idx = tuple(slice(a, b) for a, b in s["index"])
        window = out[idx].shape if idx else ()
        chunk = np.frombuffer(raw, dtype=jdt).reshape(window or shape)
        if idx:
            out[idx] = chunk
        else:
            out = chunk.reshape(shape).copy()
    return out


def iter_restored_leaves(ckpt_dir: Path, man: dict, keys: Sequence[str],
                         verify: bool = True,
                         store: Optional[ChunkStoreBackend] = None,
                         workers: Optional[int] = None,
                         stats: Optional[dict] = None
                         ) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield ``(key, host array)`` in `keys` order, fetching and
    decompressing up to a bounded window of leaves AHEAD on a thread pool
    that mirrors the writer pool — the consumer's device_put of leaf k
    overlaps io+decompress of leaves k+1.. (the restore half of the
    DESIGN.md §9 pipeline).  ``workers<=1`` restores serially."""
    workers = DEFAULT_WORKERS if workers is None else workers
    codec = man.get("codec", "zstd")
    chunk_dir = man.get("chunk_dir", "chunks")
    reader = ChunkReader(ckpt_dir, man, store)

    # restore working set: one batched prefetch pins every cache-missing
    # chunk BEFORE the per-leaf gets — over a sharded store the set
    # arrives from N servers concurrently (one get_many per shard per
    # batch) instead of serializing on a single socket.  No-op for local
    # stores; a failed prefetch degrades to the per-chunk ladder.
    want = []
    for key in keys:
        for s in man["leaves"][key].get("shards", ()):
            if "chunk" in s:
                want.append(s["chunk"])
    if want:
        t0 = time.perf_counter()
        fetched = reader.prefetch(want)
        if stats is not None and fetched:
            stats["restore_prefetch_bytes"] = (
                stats.get("restore_prefetch_bytes", 0) + fetched)
            stats["restore_prefetch_s"] = (
                stats.get("restore_prefetch_s", 0.0)
                + (time.perf_counter() - t0))

    def one(key: str):
        # per-job stats dict: pool threads must not race on the shared one
        st: dict = {}
        arr = load_leaf(ckpt_dir, man["leaves"][key], verify, codec=codec,
                        chunk_dir=chunk_dir, reader=reader, stats=st)
        return arr, st

    def merge(st: dict) -> None:
        if stats is not None:
            for k, v in st.items():
                stats[k] = stats.get(k, 0.0) + v

    if workers <= 1 or len(keys) <= 1:
        for key in keys:
            arr, st = one(key)
            merge(st)
            yield key, arr
        return
    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="ckpt-restore") as pool:
        window: deque = deque()
        ahead = max(2, workers * 2)          # bound host-memory in flight
        pending = iter(keys)
        for key in pending:
            window.append((key, pool.submit(one, key)))
            if len(window) >= ahead:
                k, fut = window.popleft()
                arr, st = fut.result()
                merge(st)
                yield k, arr
        while window:
            k, fut = window.popleft()
            arr, st = fut.result()
            merge(st)
            yield k, arr


def restore_tree(ckpt_dir: Path, template, verify: bool = True,
                 store: Optional[ChunkStoreBackend] = None,
                 workers: Optional[int] = None,
                 stats: Optional[dict] = None):
    """Restore into the structure of `template` as CPU tensors (template
    values ignored: its keys select the leaves; dtypes come from the
    manifest).  Leaves stream through the bounded restore pool; `store`
    routes chunk reads."""
    man = load_manifest(ckpt_dir)
    keys = [k for k, _ in _leaf_paths(template)]
    missing = [k for k in keys if k not in man["leaves"]]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}")
    vals = [to_tensor(arr, man["leaves"][k]["dtype"])
            for k, arr in iter_restored_leaves(
                ckpt_dir, man, keys, verify, store=store, workers=workers,
                stats=stats)]
    return _unflatten(template, vals)


def validate(ckpt_dir: Path, deep: bool = False,
             store: Optional[ChunkStoreBackend] = None,
             raise_unreachable: bool = False) -> bool:
    """Checkpoint-dir validity.

    v3 fast path (the default): parse the manifest and check every
    referenced chunk's existence + recorded compressed length in ONE
    batched query (local stats, or one has_many round trip against a
    networked store) — no blob is read or decompressed, so
    ``latest_valid`` over a long history is manifest-only.  ``deep=True``
    additionally decompresses every chunk and re-derives its content
    digest (what restore enforces anyway).  v1 dirs always get the full
    crc32 read (their manifests carry no sizes).

    An UNREACHABLE chunk service normally reads as invalid (callers fall
    back to older checkpoints / fresh starts); pass
    ``raise_unreachable=True`` where invalid triggers DELETION (gc) so a
    transient outage can never be mistaken for corruption."""
    try:
        man = load_manifest(ckpt_dir)
        reader = ChunkReader(ckpt_dir, man, store)
        chunk_shards = []
        for entry in man["leaves"].values():
            for s in entry["shards"]:
                if "chunk" in s:
                    chunk_shards.append((entry, s))
                else:
                    path = _shard_path(ckpt_dir, man, s)
                    if zlib.crc32(path.read_bytes()) != s["crc32"]:
                        return False
        sizes = reader.sizes([s["chunk"] for _, s in chunk_shards])
        for entry, s in chunk_shards:
            if sizes.get(s["chunk"]) != s["clen"]:
                return False
        if deep:
            for entry, s in chunk_shards:
                try:
                    blob = reader.get(s["chunk"])
                    raw = decode_chunk(s["chunk"], blob,
                                       man.get("codec", "zstd"))
                except ConnectionError:
                    raise                # re-routed to the outer handler
                except Exception:        # any corruption-shaped failure
                    return False
                if content_digest(raw) != s["chunk"].split(".")[0]:
                    return False
        return True
    except (OSError, KeyError, json.JSONDecodeError, ValueError,
            RuntimeError) as e:
        if raise_unreachable and isinstance(e, ConnectionError):
            raise
        return False
