"""TrainState: the COMPLETE application-side checkpoint payload (torch
twin of ``repro.train.state``).

The same tree as the reference's, with the same keys and dtypes: params,
optimizer moments, step counter, RNG key, data-pipeline cursor, and
nothing implementation-specific, so a TrainState saved by either package
restores in the other (DESIGN.md §2).  ``abstract_train_state`` and
``state_shardings`` wait for the port's dry-run and multi-device layouts
(ROADMAP.md, Queue 1, items 6-7).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.params import (init_params, params_from_numpy,
                                       tree_map, tree_map_pm)
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
