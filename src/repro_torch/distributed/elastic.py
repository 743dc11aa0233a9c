"""Elastic scaling (torch twin of ``repro.distributed.elastic``): adapt
the mesh and layouts to whatever world exists now, and restore any
checkpoint onto it (cross-topology restart).

A checkpoint's manifest stores the world that wrote it as
*informational* metadata; restore ignores it and rebuilds for the CURRENT
world, the whole point of the proxy boundary.

``atomic_reshape`` is the single reshape entry point: the tensor state
(``elastic_restore`` + CheckpointManager) moves to the new world shape
under ONE ``Membership.bump``.  The reference also reshapes the rank world
(``MPIJob.restart``) under that same bump; the port has no copy of that
runtime yet (ROADMAP.md, Queue 1)."""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional, Sequence, Tuple

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import make_mesh, world_size


def choose_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
                *, device="cuda"):
    """Largest (data, model) mesh for the current world size: `model`
    steps down until it divides the world."""
    n = n_devices or world_size()
    model = model_parallel
    while n % model:
        model -= 1
    return make_mesh((n // model, model), ("data", "model"), device=device)


def elastic_restore(mgr: CheckpointManager, template, mesh,
                    rules: ShardingRules, state_shardings=None):
    """Restore the newest valid checkpoint onto the CURRENT mesh (layouts
    derived from mesh+rules when `state_shardings` is not given).  Returns
    (state, meta): meta reports the topology change, the SOURCE world the
    manifest recorded, the world restored onto, whether they differ, and
    the membership generation the checkpoint was written in."""
    state, meta = mgr.restore(template, state_shardings, mesh=mesh,
                              rules=rules)
    if state is None:
        return None, None
    meta = dict(meta or {})
    now = {"devices": mesh.size(),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    source = meta.get("world")
    meta["restored_onto"] = now
    meta["source_world"] = source
    meta["generation"] = meta.get("generation", 0)
    meta["topology_changed"] = bool(
        source and source.get("n_devices") not in (None, now["devices"]))
    return state, meta


@dataclass
class ReshapeReport:
    """What one atomic reshape did: the single post-bump generation, the
    adopted world size, and whichever layers were restored."""
    generation: int
    world_size: int
    dead_ranks: Tuple[int, ...]
    state: Any = None            # mesh tensor state (mgr layer), or None
    meta: Optional[dict] = None  # elastic_restore's topology report
    layers: Tuple[str, ...] = field(default=())


def atomic_reshape(membership, dead: Sequence[int] = (),
                   world_size: Optional[int] = None,
                   *,
                   mgr: Optional[CheckpointManager] = None,
                   template=None, mesh=None,
                   rules: Optional[ShardingRules] = None,
                   state_shardings=None,
                   ckpt_dir: Optional[str | Path] = None) -> ReshapeReport:
    """One reshape, one generation bump.

    Bumps `membership` past `dead` to `world_size` exactly once, then
    restores the tensor layer onto the NEW epoch when `mgr` is given (+
    `template`/`mesh`/`rules` as ``elastic_restore`` takes them): the
    manager's stamped generation is set to the bumped epoch before the
    restore, so the next manifest it writes records that generation.
    The rank-world layer (`ckpt_dir`, the reference's ``MPIJob.restart``)
    is refused before anything is bumped.  Returns a ``ReshapeReport``."""
    if ckpt_dir is not None:
        raise NotImplementedError(
            "the rank-world layer of atomic_reshape (MPIJob.restart) waits "
            "for the port's copy of the core runtime (ROADMAP.md, Queue 1, "
            "item 6c)")
    dead = tuple(sorted({int(r) for r in dead}))
    gen = membership.bump(dead, world_size=world_size)
    report = ReshapeReport(generation=gen,
                           world_size=membership.world_size,
                           dead_ranks=dead)
    if mgr is not None:
        mgr.generation = gen
        report.state, report.meta = elastic_restore(
            mgr, template, mesh, rules, state_shardings)
        report.layers = ("mesh",)
    return report
