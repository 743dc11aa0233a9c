"""Restore onto the current device (the single-device half of
``repro.checkpoint.resharding``).

The manifest stores LOGICAL arrays (shard chunks + index windows); this
module reassembles them and puts each leaf on one device, whatever the
saving side was: a JAX array on a TPU or CPU, or a tensor of the port.
Restoring onto a mesh (``shardings``/``mesh``, and the reference's
``derive_shardings``) waits for the port's multi-device layouts
(ROADMAP.md, Queue 1, item 6).
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from repro_torch.checkpoint.serialization import (_leaf_paths, _unflatten,
                                                  iter_restored_leaves,
                                                  load_manifest, to_tensor)
from repro_torch.device import resolve_device, synchronize


def restore_resharded(ckpt_dir: Path, template, *, device, verify=True,
                      store=None, workers=None, stats=None, shardings=None,
                      mesh=None):
    """Restore a `template`-shaped tree with every leaf on `device` (the
    template gives only the structure and the keys; dtypes come from the
    manifest).  Leaves stream through the bounded restore pool: the copy
    of leaf k to the device overlaps fetch+decompress of the next leaves.
    `stats` accumulates restore_io_s/restore_decompress_s/
    restore_device_s; on CUDA the device clock is read after a
    synchronize."""
    if shardings is not None or mesh is not None:
        raise NotImplementedError(
            "restoring onto a mesh waits for the port's multi-device "
            "layouts (ROADMAP.md, Queue 1, item 6)")
    dev = resolve_device(device)
    man = load_manifest(ckpt_dir)
    keys = [k for k, _ in _leaf_paths(template)]
    vals = []
    for k, host in iter_restored_leaves(ckpt_dir, man, keys, verify,
                                        store=store, workers=workers,
                                        stats=stats):
        t0 = time.perf_counter()
        vals.append(to_tensor(host, man["leaves"][k]["dtype"]).to(dev))
        synchronize(dev)
        if stats is not None:
            stats["restore_device_s"] = \
                stats.get("restore_device_s", 0.0) \
                + (time.perf_counter() - t0)
    return _unflatten(template, vals)


def _dtype_bytes(dtype: str) -> int:
    if dtype == "bfloat16":
        return 2
    try:
        return int(np.dtype(dtype).itemsize)
    except TypeError:
        return 4


def plan_summary(ckpt_dir: Path) -> dict:
    """What a restore would move: leaves, shard chunks, bytes, and where the
    checkpoint came from (source world + membership generation).  For v3
    manifests also reports the content-addressed view: distinct chunks vs
    shard references (replicas and unchanged leaves collapse onto the same
    chunk) and the compressed footprint."""
    man = load_manifest(ckpt_dir)
    total = 0
    n_shards = 0
    chunks = {}
    for e in man["leaves"].values():
        n = 1
        for d in e["shape"]:
            n *= d
        total += n * _dtype_bytes(e["dtype"])
        n_shards += len(e.get("shards", ()))
        for s in e.get("shards", ()):
            if "chunk" in s:
                chunks[s["chunk"]] = s.get("clen", 0)
    meta = man.get("meta", {})
    out = {"n_leaves": len(man["leaves"]), "n_shards": n_shards,
           "approx_bytes": total, "meta": meta,
           "source_world": meta.get("world"),
           "generation": meta.get("generation", 0)}
    if chunks:
        out["n_chunks"] = len(chunks)
        out["compressed_bytes"] = sum(chunks.values())
    return out
