"""TrainState: the COMPLETE application-side checkpoint payload (torch
twin of ``repro.train.state``).

The same tree as the reference's, with the same keys and dtypes: params,
optimizer moments, step counter, RNG key, data-pipeline cursor, and
nothing implementation-specific, so a TrainState saved by either package
restores in the other (DESIGN.md §2).  ``abstract_train_state`` is the
tree on the ``meta`` device (the dry-run's stand-in), ``state_shardings``
its ``Layout`` on a mesh by the sharding rules, and ``lay_out_state``
lays a real tree (made here, or the reference's from numpy) out by them.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (lay_out, param_shardings,
                                              replicated)
from repro_torch.models.params import (abstract_params, init_params,
                                       params_from_numpy, tree_leaves,
                                       tree_map, tree_map_pm, tree_unflatten)
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import init_opt_state


def make_train_state(cfg, generator: torch.Generator, max_seq: int,
                     master_fp32: bool = False, device="cuda"):
    """Real, initialized state on ``device`` (``generator`` lives there).

    master_fp32=True: params stored bf16, with the fp32 master copy inside
    opt state.  ``rng`` is the reference's ``jax.random.PRNGKey(0)``,
    uint32[2] zeros: the port draws nothing from it, and carries it so that
    the tree is the reference's."""
    dev = resolve_device(device)
    params = init_params(get_api(cfg).param_defs(cfg, max_seq), generator,
                         dev)
    opt = init_opt_state(params)
    if master_fp32:
        opt["master"] = params
        params = tree_map(lambda p: p.to(torch.bfloat16), params)
    return {
        "params": params,
        "opt": opt,
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "rng": torch.zeros((2,), dtype=torch.uint32, device=dev),
        "data_cursor": torch.zeros((), dtype=torch.int32, device=dev),
    }


def abstract_train_state(cfg, max_seq: int, master_fp32: bool = False):
    """The TrainState as ``meta`` tensors of the real tree's shapes and
    dtypes, nothing allocated (the reference's ``ShapeDtypeStruct``
    stand-in)."""
    params = abstract_params(get_api(cfg).param_defs(cfg, max_seq))
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    scalar = lambda: torch.empty((), dtype=torch.int32, device="meta")
    opt = {"m": tree_map(f32, params), "v": tree_map(f32, params),
           "count": scalar()}
    if master_fp32:
        opt["master"] = tree_map(f32, params)
        params = tree_map(lambda p: torch.empty(
            p.shape, dtype=torch.bfloat16, device="meta"), params)
    return {"params": params, "opt": opt, "step": scalar(),
            "rng": torch.empty((2,), dtype=torch.uint32, device="meta"),
            "data_cursor": scalar()}


def state_shardings(cfg, max_seq: int, mesh, rules,
                    master_fp32: bool = False):
    """``Layout`` tree matching {abstract_,make_}train_state: the params,
    ``m``, ``v`` and ``master`` by ``param_shardings``; the counters and
    the rng key whole on every rank."""
    pshard = param_shardings(get_api(cfg).param_defs(cfg, max_seq), mesh,
                             rules)
    rep = replicated(mesh)
    opt = {"m": pshard, "v": pshard, "count": rep}
    if master_fp32:
        opt["master"] = pshard
    return {"params": pshard, "opt": opt, "step": rep, "rng": rep,
            "data_cursor": rep}


def lay_out_state(state, shardings):
    """A whole TrainState (every rank holds all of it: ``make_train_state``
    from one seed, or ``train_state_from_numpy``) as DTensors laid out by
    ``shardings`` (``state_shardings``'s tree): each rank keeps its
    windows, no collective."""
    return tree_unflatten(state, [lay_out(t, lay) for t, lay in zip(
        tree_leaves(state), tree_leaves(shardings))])


def train_state_template(cfg, max_seq: int, master_fp32: bool = False):
    """The TrainState tree with a placeholder at every leaf and no tensor:
    the structure (and so the keys) that a restore reads."""
    params = tree_map_pm(lambda p: 0, get_api(cfg).param_defs(cfg, max_seq))
    opt = {"m": params, "v": params, "count": 0}
    if master_fp32:
        opt["master"] = params
    return {"params": params, "opt": opt, "step": 0, "rng": 0,
            "data_cursor": 0}


# The reference's TrainState as numpy arrays
# (``jax.tree.map(np.asarray, state)``) -> the port's, same tree, every
# leaf bit for bit (bfloat16 as raw words, the uint32 rng key included).
train_state_from_numpy = params_from_numpy
