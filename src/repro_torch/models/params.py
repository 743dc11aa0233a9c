"""Declarative parameter system (torch twin of ``repro.models.params``).

A model declares each parameter once as a ``Pm`` (shape + *logical* axis
names + init).  Trees are plain dicts and lists with ``Pm`` leaves; layer
stacks prepend an L dim (``stack_defs``) that the model indexes in a
Python loop where the reference scans.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class Pm:
    """One parameter (or state tensor) declaration."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | lecun
    dtype: Any = torch.float32
    scale: float = 1.0          # multiplier on the init std

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def is_pm(x) -> bool:
    return isinstance(x, Pm)


def tree_map(fn, tree, is_leaf=None):
    """Map ``fn`` over the leaves of a dict/list/tuple tree.  Dict keys are
    visited in sorted order, as ``jax.tree`` flattens them."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, is_leaf) for x in tree)
    return fn(tree)


def tree_leaves(tree, is_leaf=None) -> list:
    out = []
    tree_map(out.append, tree, is_leaf)
    return out


def tree_unflatten(tree, values):
    """``values``, in ``tree_leaves(tree)`` order, in ``tree``'s structure."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def tree_map_pm(fn, defs):
    return tree_map(fn, defs, is_leaf=is_pm)


def stack_defs(defs, n: int):
    """Prepend a stacked-layers dim (looped over; never sharded)."""
    return tree_map_pm(
        lambda p: Pm((n,) + p.shape, ("layers",) + p.logical, p.init,
                     p.dtype, p.scale),
        defs)


def init_params(defs, generator: torch.Generator, device="cuda",
                compute=None):
    """Real tensors on ``device``; ``generator`` must live on that device.
    Same distribution as the reference (std = scale/sqrt(fan_in),
    fan_in = shape[-2]), not the same bits: jax.random and torch draw
    different streams.

    With ``compute`` (a dtype), each leaf of two or more dims is cast to it
    as soon as it is drawn, as ``Policy.cast_params`` casts such leaves
    after: the same values, with the fp32 tree never alive beside its
    cast (qwen2-moe-a2.7b's is 57.3 GB).  Each leaf is scaled in place, so
    building a tree takes its own size plus one fp32 leaf."""
    dev = resolve_device(device)

    def one(p: Pm):
        dtype = (compute if compute is not None and len(p.shape) >= 2
                 else p.dtype)
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=dev)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = p.scale / math.sqrt(max(fan_in, 1))
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x.mul_(std).to(dtype)

    return tree_map_pm(one, defs)


def params_from_numpy(tree, device="cuda"):
    """The reference's parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> the port's tree, same
    structure: {"embed", "pos"?, "prefix", "units" (leading L), "tail",
    "final"}.  bfloat16 arrays cross as raw 16-bit words."""
    dev = resolve_device(device)

    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))       # a writable copy
        return t.to(dev)

    return tree_map(one, tree)


def param_count(defs) -> int:
    return sum(int(np.prod(p.shape)) for p in tree_leaves(defs, is_leaf=is_pm))
