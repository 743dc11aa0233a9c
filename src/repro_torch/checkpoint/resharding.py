"""Cross-topology restore (torch twin of ``repro.checkpoint.resharding``):
a checkpoint written under mesh A, restored under mesh B (the paper §7
'checkpoint on MPICH, restart on OpenMPI', at the tensor level).

The manifest stores LOGICAL arrays (shard chunks + index windows); this
module reassembles them and lays them out for the CURRENT mesh, whatever
the saving side was: a JAX array on a TPU mesh or on one CPU, a port
tensor on one card, or the DTensors of a port world of any size.  Without
a layout every leaf lands whole on one device.
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from repro_torch.checkpoint.serialization import (_leaf_paths, _unflatten,
                                                  _walk, iter_restored_leaves,
                                                  load_manifest, to_tensor)
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed.sharding import (Layout, lay_out,
                                              param_shardings, replicated)
from repro_torch.launch.mesh import mesh_device
from repro_torch.models.params import is_pm


def restore_resharded(ckpt_dir: Path, template, shardings=None, *,
                      device="cuda", verify=True, mesh=None, rules=None,
                      store=None, workers=None, stats=None):
    """Restore a `template`-shaped tree (the template gives only the
    structure and the keys; dtypes come from the manifest).  If
    `shardings` (a matching tree of ``Layout``) is given, every leaf is a
    DTensor with its NEW layout; pass `mesh` (e.g. from
    ``elastic.choose_mesh``) plus the ``ShardingRules`` in `rules` instead
    and the layout is DERIVED per leaf for that mesh.  Each rank
    assembles the logical array from the windows and keeps its own: the
    saving mesh is irrelevant, only index windows matter.  Without either,
    every leaf lands whole on `device`.

    Leaves stream through the bounded restore pool: the copy of leaf k to
    the device overlaps fetch+decompress of the next leaves.  `stats`
    accumulates restore_io_s/restore_decompress_s/restore_device_s; on
    CUDA the device clock is read after a synchronize."""
    if shardings is None and mesh is not None:
        shardings = derive_shardings(template, mesh, rules)
    man = load_manifest(ckpt_dir)
    keys = [k for k, _ in _leaf_paths(template)]
    by_key = dict(zip(keys, leaf_layouts(template, shardings)
                      if shardings is not None else [None] * len(keys)))
    dev = resolve_device(device) if shardings is None else None
    vals = []
    for k, host in iter_restored_leaves(ckpt_dir, man, keys, verify,
                                        store=store, workers=workers,
                                        stats=stats):
        t0 = time.perf_counter()
        t = to_tensor(host, man["leaves"][k]["dtype"])
        lay = by_key[k]
        if lay is None:
            vals.append(t.to(dev))
            synchronize(dev)
        else:
            vals.append(lay_out(t, lay))
            synchronize(mesh_device(lay.mesh))
        if stats is not None:
            stats["restore_device_s"] = \
                stats.get("restore_device_s", 0.0) \
                + (time.perf_counter() - t0)
    return _unflatten(template, vals)


def leaf_layouts(template, shardings) -> list:
    """The ``Layout`` of each of `template`'s leaves, in order, from a
    matching `shardings` tree; anything else raises ``TypeError`` here,
    before a checkpoint is read (a restore must not take a caller's error
    for a corrupt checkpoint)."""
    layouts = [x for _, x in _leaf_paths(shardings)]
    n = len(_leaf_paths(template))
    if len(layouts) != n or not all(isinstance(x, Layout) for x in layouts):
        raise TypeError(
            f"shardings must be a tree of Layout matching the template's "
            f"{n} leaves, got {type(shardings).__name__} (the checkpoint "
            f"dir is restore's third argument, as the reference's)")
    return layouts


def derive_shardings(template, mesh, rules=None):
    """``Layout`` tree for an arbitrary NEW mesh: Pm leaves resolve their
    logical axes through `rules` (delegated to the one canonical resolver,
    ``sharding.param_shardings``, so elastic restores can never drift from
    training layouts); other leaves replicate (the safe layout on a world
    whose shape the checkpoint never saw)."""
    whole = replicated(mesh)

    def one(_, leaf):
        if rules is not None and is_pm(leaf):
            return param_shardings(leaf, mesh, rules)
        return whole
    return _walk(template, one)


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
