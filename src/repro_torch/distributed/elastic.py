"""Elastic scaling (torch twin of ``repro.distributed.elastic``): adapt
the mesh and layouts to whatever world exists now, and restore any
checkpoint onto it (cross-topology restart).

A checkpoint's manifest stores the world that wrote it as
*informational* metadata; restore ignores it and rebuilds for the CURRENT
world, the whole point of the proxy boundary.

``atomic_reshape`` is the single reshape entry point: the tensor state
(``elastic_restore`` + CheckpointManager) and the rank world
(``core.runtime.MPIJob.restart``) move to the new world shape under ONE
``Membership.bump``."""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional, Sequence, Tuple

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.runtime import MPIJob
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
    job: Any = None              # reshaped MPIJob (rank-world layer), or None
    layers: Tuple[str, ...] = field(default=())


def atomic_reshape(membership, dead: Sequence[int] = (),
                   world_size: Optional[int] = None,
                   *,
                   mgr: Optional[CheckpointManager] = None,
                   template=None, mesh=None,
                   rules: Optional[ShardingRules] = None,
                   state_shardings=None,
                   ckpt_dir: Optional[str | Path] = None,
                   step_fn=None, init_fn=None, transport: str = "shm",
                   ckpt_store=None, heartbeat_timeout: float = 5.0,
                   coord_timeout: float = 60.0) -> ReshapeReport:
    """One reshape, one generation bump, every layer (DESIGN.md §8).

    Bumps `membership` past `dead` to `world_size` exactly once, then
    restores whichever layers the caller drives onto the NEW epoch:

      * tensor layer — pass `mgr` (+ `template`/`mesh`/`rules` as
        ``elastic_restore`` takes them): the manager's stamped generation
        is set to the bumped epoch before the restore, so the next
        manifest it writes records the same generation the rank world
        rejects stale messages against;
      * rank world — pass `ckpt_dir` (+ `step_fn`/`init_fn`/...):
        ``MPIJob.restart`` reshapes the world with THIS membership, whose
        bump already happened here — the job performs none of its own.
        A rank checkpoint written by either package restarts here.

    Either layer alone is fine; passing both is the lockstep case the
    name promises.  Returns a ``ReshapeReport``."""
    dead = tuple(sorted({int(r) for r in dead}))
    gen = membership.bump(dead, world_size=world_size)
    report = ReshapeReport(generation=gen,
                           world_size=membership.world_size,
                           dead_ranks=dead)
    layers = []
    if mgr is not None:
        mgr.generation = gen
        report.state, report.meta = elastic_restore(
            mgr, template, mesh, rules, state_shardings)
        layers.append("mesh")
    if ckpt_dir is not None:
        report.job = MPIJob.restart(
            ckpt_dir, step_fn, init_fn, transport=transport,
            world_size=membership.world_size, dead_ranks=dead,
            membership=membership, heartbeat_timeout=heartbeat_timeout,
            coord_timeout=coord_timeout, ckpt_store=ckpt_store)
        layers.append("world")
    report.layers = tuple(layers)
    return report
