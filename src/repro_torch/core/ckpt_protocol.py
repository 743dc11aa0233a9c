"""Per-rank checkpoint images + job manifest (paper §3/§4, DESIGN.md §9).

An image contains ONLY application-boundary state: app payload, drained
message cache, admin log, virtual-id tables, counters.  No transport, no
proxy, no sockets, no thread state — grep this file for 'transport': the
only hit is the manifest's *informational* record of which transport was in
use (never required at restore).

Since manifest v3 an image is stored as content-addressed PARTS — the MPI
snapshot and the opaque app payload each hashed and written once into a
chunk store.  A rank whose payload did not change between checkpoints (or
ranks sharing a replicated payload within one checkpoint) reference the
same chunk instead of rewriting it — the same incremental scheme the
tensor layer uses (checkpoint/chunkstore.py).

Write protocol: tmp file + atomic rename per chunk; the manifest commits
last so a crash mid-checkpoint leaves the previous checkpoint valid.
Chunks are self-validating (filename == content digest); fast validation
is manifest-only (existence + size), deep validation re-derives digests.
v2 manifests (monolithic ``rank_*.img`` + crc32) are still readable.
"""
from __future__ import annotations

import json
import os
import pickle
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Set

from repro_torch.checkpoint import chunkstore
from repro_torch.checkpoint.chunkstore import (ChunkStore, ChunkStoreBackend,
                                         content_digest)
from repro_torch.core.messages import dumps_wire, loads_wire
from repro_torch.core.migrate import join_state


@dataclass
class RankImage:
    rank: int
    n_ranks: int
    step_idx: int
    mpi_state: dict              # api.MPI.snapshot()
    app_state: bytes             # pickled user state (opaque)
    app_obj: Any = field(default=None, compare=False)
    # ^ live user-state object, populated only by load_rank_image(); a
    # leaf-split image materialises it from the joined leaves so callers
    # restoring INTO memory skip a redundant re-pickle/re-unpickle pass —
    # the hot-join pause is bounded by one traversal of the state, not
    # three.  Never serialised (to_bytes drops it).

    def to_bytes(self) -> bytes:
        # the reference's class name (core/messages.py: wire names), so a
        # v2 image written here loads in either package
        return dumps_wire(
            RankImage(self.rank, self.n_ranks, self.step_idx,
                      self.mpi_state, self.app_state))

    def state_obj(self, fresh: bool = False) -> Any:
        """The app payload as a live object — the materialised leaves when
        present (no re-pickle round-trip), else unpickled app_state.
        `fresh` forces a private copy: a caller cloning ONE image onto
        several ranks must not hand them aliases of the same arrays
        (unpickling app_state is already a copy each time)."""
        if self.app_obj is not None:
            if fresh:
                return pickle.loads(pickle.dumps(
                    self.app_obj, protocol=pickle.HIGHEST_PROTOCOL))
            return self.app_obj
        return loads_wire(self.app_state)

    @staticmethod
    def from_bytes(b: bytes) -> "RankImage":
        return loads_wire(b)


def _atomic_write(path: Path, data: bytes) -> None:
    tmp = path.with_suffix(".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def save_rank_image(ckpt_dir: Path, image: RankImage,
                    store: Optional[ChunkStoreBackend] = None,
                    app_leaves: Optional[Dict[str, bytes]] = None) -> dict:
    """Write one rank's image as content-addressed parts.  `store` defaults
    to ``ckpt_dir/chunks`` (self-contained); the runtime passes a shared
    store — possibly a caching/remote backend, so a rank's unchanged
    payload is never re-uploaded — so consecutive checkpoints (and
    replicated payloads across ranks) skip unchanged parts.  Returns the
    manifest entry.

    `app_leaves` (migration final, DESIGN.md §13): the app payload
    pre-split into named leaf pickles (core/migrate.split_state) — each
    leaf becomes its own ``app/<leaf>`` part, so leaves already streamed
    by pre-copy rounds are store references and the stop-the-world save
    ships only the final dirty delta.  gc/validation need no special
    casing: leaf parts are ordinary entries in ``parts``."""
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if store is None:
        store = ChunkStore(ckpt_dir / "chunks")
    items = [("mpi", pickle.dumps(image.mpi_state,
                                  protocol=pickle.HIGHEST_PROTOCOL))]
    if app_leaves is not None:
        items += [(f"app/{leaf}", blob)
                  for leaf, blob in sorted(app_leaves.items())]
    else:
        items.append(("app", image.app_state))
    parts: Dict[str, dict] = {}
    total = 0
    for part, blob in items:
        name = f"{content_digest(blob)}.bin"
        store.put(name, blob)
        parts[part] = {"chunk": name, "bytes": len(blob)}
        total += len(blob)
    return {"rank": image.rank, "n_ranks": image.n_ranks,
            "step_idx": image.step_idx, "parts": parts, "bytes": total}


def commit_manifest(ckpt_dir: Path, entries: Dict[int, dict],
                    meta: Optional[dict] = None,
                    generation: int = 0,
                    chunk_dir: Optional[str] = "chunks",
                    store_spec: Optional[str] = None) -> None:
    """`n_ranks` is the SOURCE world; `generation` the membership epoch the
    job ran in — both are what an elastic restart (and its tests) read to
    report a topology change (DESIGN.md §8).  `chunk_dir` locates the
    content-addressed store relative to `ckpt_dir` (None for a rootless
    remote store); a ``remote://`` `store_spec` is recorded so a reader
    on another host can fetch the chunks it lacks."""
    manifest = {
        "version": 3,
        "time": time.time(),
        "n_ranks": len(entries),
        "generation": generation,
        "ranks": {str(r): e for r, e in sorted(entries.items())},
        "meta": meta or {},
    }
    if chunk_dir is not None:
        manifest["chunk_dir"] = chunk_dir
    if store_spec and store_spec.startswith("remote://"):
        manifest["store"] = store_spec
    _atomic_write(ckpt_dir / "MANIFEST.json",
                  json.dumps(manifest, indent=1).encode())


def load_manifest(ckpt_dir: Path) -> dict:
    return json.loads((ckpt_dir / "MANIFEST.json").read_text())


def manifest_chunks(man: dict) -> Set[str]:
    """Every chunk name a v3 manifest references (refcount-gc input)."""
    if man.get("version", 1) < 3:
        return set()
    return {p["chunk"] for e in man["ranks"].values()
            for p in e.get("parts", {}).values()}


def live_chunks(ckpt_dirs: Iterable[Path]) -> Set[str]:
    """Union of chunk references across checkpoint dirs — pass the dirs you
    intend to KEEP, then ``store.gc(live_chunks(dirs))`` removes everything
    only dead checkpoints referenced."""
    live: Set[str] = set()
    for d in ckpt_dirs:
        try:
            live |= manifest_chunks(load_manifest(Path(d)))
        except (OSError, ValueError, KeyError):
            continue
    return live


def _read_part(reader: chunkstore.ChunkReader, part: dict,
               verify: bool) -> bytes:
    blob = reader.get(part["chunk"])
    if verify and content_digest(blob) != part["chunk"].split(".")[0]:
        raise IOError(f"{part['chunk']}: content digest mismatch")
    return blob


def load_rank_image(ckpt_dir: Path, rank: int, verify: bool = True,
                    store: Optional[ChunkStoreBackend] = None) -> RankImage:
    """`store` routes part reads (an elastic restart passes its
    ``ckpt_store`` so a fresh host fetches only the parts its cache
    lacks); without one, reads go local-dir-then-manifest-spec."""
    man = load_manifest(ckpt_dir)
    ent = man["ranks"][str(rank)]
    if "parts" in ent:                        # v3: content-addressed parts
        reader = chunkstore.ChunkReader(ckpt_dir, man, store)
        # working set first: a leaf-split image on a cold cache fetches
        # all its parts in batched get_many calls (per-shard fan-out for
        # a sharded store) instead of one round trip per part
        reader.prefetch([p["chunk"] for p in ent["parts"].values()])
        mpi = _read_part(reader, ent["parts"]["mpi"], verify)
        leaf_parts = {k[len("app/"):]: p for k, p in ent["parts"].items()
                      if k.startswith("app/")}
        app, obj = b"", None
        if leaf_parts:                       # migration-final leaf split
            blobs = {leaf: _read_part(reader, p, verify)
                     for leaf, p in leaf_parts.items()}
            # materialise the object instead of re-pickling the joined
            # dict: every consumer restores INTO memory, and the hot-join
            # pause should pay one traversal of the state, not three
            obj = join_state(blobs)
            if obj is None:      # a literal-None payload: app_obj can't
                app = pickle.dumps(None)     # signal it, so fall back
        else:
            app = _read_part(reader, ent["parts"]["app"], verify)
        return RankImage(rank=ent["rank"], n_ranks=ent["n_ranks"],
                         step_idx=ent["step_idx"],
                         mpi_state=loads_wire(mpi), app_state=app,
                         app_obj=obj)
    blob = (ckpt_dir / ent["file"]).read_bytes()    # v2: monolithic image
    if verify and zlib.crc32(blob) != ent["crc32"]:
        raise IOError(f"rank {rank} image failed crc32 validation")
    return RankImage.from_bytes(blob)


def checkpoint_valid(ckpt_dir: Path, deep: bool = False,
                     store: Optional[ChunkStoreBackend] = None) -> bool:
    """Fast path (default): manifest parses and every referenced chunk
    exists with its recorded size — one batched query, no payload reads.
    ``deep=True`` re-derives every content digest (v3) / crc32 (v2).
    `store` routes chunk access like ``load_rank_image``."""
    try:
        man = load_manifest(ckpt_dir)
        reader = chunkstore.ChunkReader(ckpt_dir, man, store)
        parts = []
        for r, ent in man["ranks"].items():
            if "parts" in ent:
                parts.extend(ent["parts"].values())
            else:
                blob = (ckpt_dir / ent["file"]).read_bytes()
                if zlib.crc32(blob) != ent["crc32"]:
                    return False
        sizes = reader.sizes([p["chunk"] for p in parts])
        for part in parts:
            if sizes.get(part["chunk"]) != part["bytes"]:
                return False
            if deep and (content_digest(reader.get(part["chunk"]))
                         != part["chunk"].split(".")[0]):
                return False
        return True
    except (OSError, KeyError, json.JSONDecodeError, ValueError):
        return False
