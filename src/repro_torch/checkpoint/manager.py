"""Checkpoint manager (torch twin of ``repro.checkpoint.manager``): the
paper's protocol over a tree of tensors.

  drain    = ``torch.cuda.synchronize()`` on every CUDA device the state
             touches (all queued work complete) + wait for the previous
             async write
  snapshot = synchronous device->host copy of every tensor (a CPU tensor
             is cloned), handed to a background writer that touches only
             host arrays, never CUDA (the storage 'proxy'; the caller never
             blocks on the filesystem)
  commit   = content-addressed chunks + v3 manifest, atomic rename;
             unchanged chunks are REFERENCED, not rewritten (incremental)
  restore  = newest VALID checkpoint (corrupt/partial ones skipped,
             manifest-only fast validation), every leaf onto one device
             or laid out on the current mesh, whatever mesh wrote it

Manifests, chunk names and the store layout are the reference's, so
either package restores what the other wrote.

Layout: <root>/chunks/<digest>.<ext>  — shared, content-addressed
        <root>/step_<N>/MANIFEST.json — references chunks by name

GC is refcounting over live manifests: step dirs beyond `keep` (and
corrupt ones) are removed first, then every chunk no remaining manifest
references; the last remaining valid checkpoint is never removed.
"""
from __future__ import annotations

import re
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import chunkstore
from repro_torch.checkpoint import serialization as ser
from repro_torch.checkpoint.resharding import (derive_shardings,
                                               leaf_layouts,
                                               restore_resharded)
from repro_torch.core import metrics as _metrics
from repro_torch.core import trace as _trace
from repro_torch.device import resolve_device

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, root: str | Path, keep: int = 3,
                 async_write: bool = True, generation: int = 0,
                 writer_threads: Optional[int] = None,
                 store=None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        #: membership generation (elastic restart epoch) stamped into every
        #: manifest, as the reference stamps it
        self.generation = generation
        #: content-addressed store shared by every step this manager
        #: writes: a backend instance, a ``StoreSpec``, any spec string
        #: ``StoreSpec.parse`` accepts (``remote://`` single or sharded),
        #: or a path (default: a local directory under the manager root).
        #: With a caching backend, saves upload only chunks the server
        #: lacks and restores fetch only chunks the cache lacks.
        self.store = chunkstore.open_store(store,
                                           default=self.root / "chunks")
        #: compress/write pool width (<=1 disables the parallel pipeline)
        self.writer_threads = (ser.DEFAULT_WORKERS if writer_threads is None
                               else writer_threads)
        self._pending: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        #: dirs already validated: checkpoints are immutable once the
        #: manifest commits (and gc protects every retained manifest's
        #: chunks), so _gc never re-validates a known-valid dir
        self._known_valid: set = set()
        #: metrics group with the reference's keys: tests index it,
        #: serialization.py read-modify-writes stage timings into it, every
        #: mutation is atomic under the group lock
        self.stats = _metrics.MetricGroup(
            "ckpt_manager",
            {"saves": 0, "drain_s": 0.0, "snapshot_s": 0.0,
             "write_s": 0.0, "gc_removed": 0,
             # pipeline stage timings (summed across pool threads)
             "hash_s": 0.0, "compress_s": 0.0, "io_s": 0.0,
             # incremental accounting, cumulative and per-save
             "bytes_written": 0, "bytes_referenced": 0,
             "last_bytes_written": 0, "last_bytes_referenced": 0,
             "chunks_gc_removed": 0,
             # cross-host transfer accounting (networked stores;
             # zero for local): wire bytes actually shipped vs
             # wire bytes the server already held
             "last_bytes_uploaded": 0,
             "last_bytes_referenced_remote": 0,
             # restore pipeline stage timings
             "restores": 0, "restore_io_s": 0.0,
             "restore_decompress_s": 0.0, "restore_device_s": 0.0})

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, meta: Optional[dict] = None) -> Path:
        """Drain -> host snapshot -> async commit.  Returns the ckpt dir.
        The manifest meta records the SOURCE world (the world's size across
        ranks; in a 1-rank world the CUDA device count when the state is on
        CUDA, else 1) and the membership generation, as the reference's
        does.  A caller's own ``world`` wins.

        In a world of several ranks every rank calls ``save`` with its
        DTensors: each writes its own windows' chunks into the shared
        store, and rank 0 gathers the shard entries and commits the one
        manifest after every rank's chunks are in.  That gather is a
        collective on the default group, which a background thread must
        not interleave with the caller's own, so such a save commits before
        it returns, on every rank."""
        save_span = _trace.begin("ckptmgr.save", cat="ckpt",
                                 args={"step": step,
                                       "generation": self.generation})
        cuda = _cuda_devices(state)
        t0 = time.time()
        with _trace.span("ckptmgr.drain", parent=save_span, cat="ckpt"):
            for dev in cuda:                  # drain queued device work
                torch.cuda.synchronize(dev)
            self.wait()                       # drain the previous async write
        self.stats["drain_s"] += time.time() - t0

        t0 = time.time()
        with _trace.span("ckptmgr.snapshot", parent=save_span, cat="ckpt"):
            host_state = ser.snapshot_to_host(state)  # sync: donation-safe
        self.stats["snapshot_s"] += time.time() - t0

        ckpt_dir = self.root / f"step_{step:010d}"
        ranks = dist.get_world_size() if dist.is_initialized() else 1
        meta = dict(meta or {}, step=step, time=time.time())
        meta.setdefault("world", {"n_devices": ranks if ranks > 1 else
                                  torch.cuda.device_count() if cuda else 1})
        meta.setdefault("generation", self.generation)
        if ranks > 1:
            self.stats["saves"] += 1
            self._save_across_ranks(ckpt_dir, host_state, meta, save_span)
            return ckpt_dir

        def _write():
            t1 = time.time()
            w0 = self.store.stats["bytes_written"]
            r0 = self.store.stats["bytes_referenced"]
            u0 = self.store.stats.get("bytes_uploaded", 0)
            rr0 = self.store.stats.get("bytes_referenced_remote", 0)
            try:
                # context-manager span: runs on the ckpt-writer thread, so
                # the explicit parent handle (not the spawning thread's
                # stack) links it under the save — and chunk-store RPC
                # spans inside save_shards nest under it in turn
                with _trace.span("ckptmgr.write", parent=save_span,
                                 cat="ckpt", args={"step": step}):
                    ser.save_shards(ckpt_dir, host_state, meta=meta,
                                    store=self.store,
                                    workers=self.writer_threads,
                                    stats=self.stats)
            except BaseException as e:  # surfaced on next wait()
                # NO gc: it would run against a partial dir, and must not
                # get a chance to touch the previous valid checkpoint
                self._last_error = e
                self.stats["write_s"] += time.time() - t1
                save_span.end(outcome="failed", error=type(e).__name__)
                return
            self.stats["write_s"] += time.time() - t1
            # last_* deltas describe the last COMPLETED save only — a
            # failed partial write must not overwrite them
            self.stats["last_bytes_written"] = \
                self.store.stats["bytes_written"] - w0
            self.stats["last_bytes_referenced"] = \
                self.store.stats["bytes_referenced"] - r0
            self.stats["bytes_written"] = self.store.stats["bytes_written"]
            self.stats["bytes_referenced"] = \
                self.store.stats["bytes_referenced"]
            self.stats["last_bytes_uploaded"] = \
                self.store.stats.get("bytes_uploaded", 0) - u0
            self.stats["last_bytes_referenced_remote"] = \
                self.store.stats.get("bytes_referenced_remote", 0) - rr0
            try:
                self._gc()
            except BaseException as e:
                self._last_error = e
            save_span.end(
                outcome="ok",
                bytes_written=self.stats["last_bytes_written"],
                bytes_referenced=self.stats["last_bytes_referenced"])

        self.stats["saves"] += 1
        if self.async_write:
            self._pending = threading.Thread(target=_write, daemon=True,
                                             name="ckpt-writer")
            self._pending.start()
        else:
            _write()
            self._raise_pending()
        return ckpt_dir

    def _save_across_ranks(self, ckpt_dir: Path, host_state, meta: dict,
                           save_span) -> None:
        """Every rank writes its chunks; rank 0 gathers the entries and
        commits the manifest LAST; then every rank learns the outcome, so
        none returns before the commit and a failure on any rank raises on
        all (none waits forever in the gather)."""
        t1 = time.time()
        w0 = self.store.stats["bytes_written"]
        r0 = self.store.stats["bytes_referenced"]
        try:
            with _trace.span("ckptmgr.write", parent=save_span, cat="ckpt",
                             args={"step": meta["step"]}):
                man = ser.write_chunks(ckpt_dir, host_state, meta=meta,
                                       store=self.store,
                                       workers=self.writer_threads,
                                       stats=self.stats)
            part = man["leaves"]
        except Exception as e:     # reported to every rank, raised below
            man, part = None, f"rank {dist.get_rank()}: {e!r}"
        rank = dist.get_rank()
        parts = [None] * dist.get_world_size() if rank == 0 else None
        dist.gather_object(part, parts, dst=0)
        outcome = [None]
        if rank == 0:
            errors = [p for p in parts if isinstance(p, str)]
            if errors:
                outcome = ["; ".join(errors)]
            else:
                man["leaves"] = ser.merge_leaves(parts)
                try:
                    ser.commit_manifest(ckpt_dir, man)
                    self._gc()
                except Exception as e:   # reported to every rank
                    outcome = [f"rank 0: {e!r}"]
        dist.broadcast_object_list(outcome, src=0)
        self.stats["write_s"] += time.time() - t1
        self.stats["last_bytes_written"] = \
            self.store.stats["bytes_written"] - w0
        self.stats["last_bytes_referenced"] = \
            self.store.stats["bytes_referenced"] - r0
        self.stats["bytes_written"] = self.store.stats["bytes_written"]
        self.stats["bytes_referenced"] = self.store.stats["bytes_referenced"]
        if outcome[0] is not None:
            save_span.end(outcome="failed")
            raise RuntimeError(f"checkpoint save across ranks failed: "
                               f"{outcome[0]}")
        save_span.end(outcome="ok",
                      bytes_written=self.stats["last_bytes_written"],
                      bytes_referenced=self.stats["last_bytes_referenced"])

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise RuntimeError("async checkpoint write failed") from err

    def delta_write_fraction(self) -> float:
        """Bytes written / bytes handled for the LAST completed save — the
        observable incremental ratio (1.0 = full rewrite, ~0.0 = everything
        referenced)."""
        total = (self.stats["last_bytes_written"]
                 + self.stats["last_bytes_referenced"])
        return self.stats["last_bytes_written"] / total if total else 1.0

    def remote_transfer_fraction(self) -> float:
        """Wire bytes uploaded / wire bytes handled for the LAST completed
        save against a networked store (1.0 = the server had nothing,
        ~0.0 = everything was already there).  1.0 for local stores, which
        never transfer."""
        total = (self.stats["last_bytes_uploaded"]
                 + self.stats["last_bytes_referenced_remote"])
        return self.stats["last_bytes_uploaded"] / total if total else 1.0

    def store_health(self) -> Optional[list]:
        """Per-shard health when the store is a sharded tier (endpoint,
        up/down, cooldown, wire counters — DESIGN.md §15); None for
        local and single-server stores."""
        fn = getattr(self.store, "health", None)
        return fn() if fn is not None else None

    # ---------------------------------------------------------------- restore
    def list_steps(self) -> List[int]:
        out = []
        for p in self.root.iterdir() if self.root.exists() else []:
            m = _STEP_RE.match(p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_valid(self) -> Optional[Path]:
        """Newest restorable checkpoint.  v3 validation is manifest-only
        (parse + stat every referenced chunk) — no blob reads, so scanning
        a long history costs milliseconds, not a full re-read."""
        for step in reversed(self.list_steps()):
            d = self.root / f"step_{step:010d}"
            if ser.validate(d, store=self.store):
                return d
        return None

    def restore(self, template, shardings=None,
                ckpt_dir: Optional[Path] = None, *, mesh=None, rules=None,
                device="cuda"):
        """Restore the newest valid checkpoint.  Layouts come from
        `shardings` (a tree of ``sharding.Layout``), or are derived for
        `mesh` (+ optional `rules`) when given (the elastic cross-topology
        path): every leaf is then a DTensor on the mesh's device.
        Otherwise every leaf lands on `device` (resolved by
        ``resolve_device``: asking for CUDA without a card raises; pass
        ``"cpu"`` to restore on the CPU).  `template` gives the tree
        structure.  Returns (state, meta) or (None, None) if nothing valid
        exists.

        Because fast validation is manifest-only, a size-preserving bit
        flip is first caught by the digest check DURING the restore read;
        when auto-picking, such a dir is skipped and the next older valid
        checkpoint is served (the pre-chunk-store 'corrupt ones skipped'
        guarantee).  An explicit `ckpt_dir` still raises."""
        if shardings is None and mesh is not None:
            shardings = derive_shardings(template, mesh, rules)
        if shardings is None:
            device = resolve_device(device)
        else:
            leaf_layouts(template, shardings)      # a caller's error raises

        def one(d: Path):
            with _trace.span("ckptmgr.restore", cat="ckpt",
                             args={"dir": d.name}):
                return restore_resharded(d, template, shardings,
                                         device=device,
                                         store=self.store,
                                         workers=self.writer_threads,
                                         stats=self.stats)
        if ckpt_dir is not None:
            state = one(ckpt_dir)
            self.stats["restores"] += 1
            return state, ser.load_manifest(ckpt_dir).get("meta", {})
        for step in reversed(self.list_steps()):
            d = self.root / f"step_{step:010d}"
            if not ser.validate(d, store=self.store):
                continue
            try:
                state = one(d)
            except torch.cuda.OutOfMemoryError:
                raise                 # the device, not the checkpoint
            except (OSError, zlib.error, RuntimeError, ValueError):
                # payload-level corruption the fast validate can't see
                # (digest mismatch, truncated codec stream): skip this dir
                self._known_valid.discard(d.name)
                continue
            self.stats["restores"] += 1
            return state, ser.load_manifest(d).get("meta", {})
        return None, None

    # --------------------------------------------------------------------- gc
    def _gc(self) -> None:
        """Two-phase refcounting gc.

        Phase 1 (step dirs): corrupt/partial dirs are ALWAYS removed (they
        can never be restored and used to accumulate forever); of the valid
        ones, the newest `keep` are retained — and the last remaining valid
        checkpoint is never removed, whatever `keep` says.

        Phase 2 (chunks): the union of chunk names referenced by every
        RETAINED manifest is the live set; everything else in the store is
        unlinked.  A chunk shared by a removed and a retained step survives
        (that is the point of content addressing)."""
        dirs = [self.root / f"step_{s:010d}" for s in self.list_steps()]
        try:
            valid = [d for d in dirs
                     if d.name in self._known_valid
                     or ser.validate(d, store=self.store,
                                     raise_unreachable=True)]
        except ConnectionError:
            # the chunk service can't be asked: every un-cached dir would
            # read "invalid" and be DELETED on a transient outage — skip
            # gc entirely this round (conservative, like an unreadable
            # manifest below)
            return
        self._known_valid = {d.name for d in valid}
        invalid = [d for d in dirs if d not in valid]
        excess = valid[:-self.keep] if self.keep else []
        for d in invalid + excess:
            shutil.rmtree(d, ignore_errors=True)
            self._known_valid.discard(d.name)
            self.stats["gc_removed"] += 1
        live: set = set()
        for d in valid:
            if d in excess:
                continue
            try:
                live.update(ser.manifest_chunks(ser.load_manifest(d)))
            except (OSError, ValueError, KeyError):
                # unreadable manifest in a dir we chose to keep: be
                # conservative and skip chunk gc entirely this round
                return
        try:
            self.stats["chunks_gc_removed"] += self.store.gc(live)
        except ConnectionError:
            pass    # service outage mid-gc: chunks persist, retry next round


def _cuda_devices(tree) -> set:
    """The CUDA devices the tensors of `tree` live on."""
    out: set = set()

    def visit(_, x):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            out.add(x.device)
    ser._walk(tree, visit)
    return out
