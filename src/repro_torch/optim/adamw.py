"""AdamW with global-norm clipping, decoupled weight decay, fp32 moments
(torch twin of ``repro.optim.adamw``).

Plain functions on trees of tensors, as the reference's, and not
``torch.optim.AdamW``, which rounds its decay and eps in another order.
Every scalar the reference computes on the device (the clip scale, the
bias corrections ``1 - b ** count``, the schedule's value) is an fp32
tensor here too, and every division by a constant divides by a tensor: on
CUDA, PyTorch divides by a Python scalar as a product with its reciprocal.
Those constant tensors are made once per (value, device) (``const_f32``): a
copy from the host cannot be captured into a CUDA graph, so a captured
step reads the ones its first, eager run made.

``adamw_update`` is pure, as the reference's.  ``adamw_update_`` computes
the same expressions through the same ``upd`` and writes the results into
the params, moments and count it was given: the in-place step that a
captured train step replays (the counterpart of the reference's donated
state).  No fused or in-place arithmetic, which would round otherwise.

On a mesh the params, gradients and moments are DTensors of one layout
(the params'; the step brings each gradient to it first).  The update is
elementwise, so it runs on each rank's own shards (``to_local``) and
gives each leaf back in its layout: the same expressions on the same
values, and nothing gathered.  The clip scale needs the whole tree's
norm: ``global_norm`` sums each leaf's squares over the ranks that split
it, so the norm, the scale and every other scalar are one value, the same
on every rank, plain 0-d tensors.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import is_dtensor, local
from repro_torch.models.params import (tree_leaves, tree_map,
                                      tree_unflatten)


@dataclass(frozen=True)
class AdamWCfg:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


@functools.lru_cache(maxsize=None)
def _const(x: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def const_f32(x, like):
    """``x`` as an fp32 0-d tensor on ``like``'s device, made once per
    (value, device); read-only."""
    return _const(float(x), like.device)


def _like(x, t):
    """The local tensor ``x`` as a DTensor laid out as ``t``; plain as it
    is when ``t`` is plain."""
    if not is_dtensor(t):
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def init_opt_state(params):
    """Zero fp32 moments in the params' layouts (a DTensor param's
    moments are DTensors of its placements, each rank allocating its
    window), and the count."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    leaf = tree_leaves(params)[0]
    count = torch.zeros((), dtype=torch.int32, device=local(leaf).device)
    if is_dtensor(leaf):
        from torch.distributed.tensor import DTensor, Replicate
        count = DTensor.from_local(count, leaf.device_mesh,
                                   [Replicate()] * leaf.device_mesh.ndim,
                                   run_check=False)
    return {"m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "count": count}


def _split_dims(t) -> tuple:
    """The mesh dims of size > 1 that split the DTensor ``t`` (none for a
    plain tensor).  A partial sum has no norm yet: it is refused."""
    if not is_dtensor(t):
        return ()
    if any(p.is_partial() for p in t.placements):
        raise ValueError("global_norm of a partial sum: reduce the "
                         "gradient to its param's layout first")
    mesh = t.device_mesh
    return tuple(i for i, p in enumerate(t.placements)
                 if p.is_shard() and mesh.size(i) > 1)


def global_norm(tree):
    """sqrt of the sum of every leaf's squares, summed in leaf order.  A
    DTensor leaf's sum over its own shard is summed over the ranks that
    split it, one all-reduce per set of mesh dims: the norm is the same
    value on every rank (a plain 0-d tensor)."""
    leaves = tree_leaves(tree)
    sums = [torch.sum(torch.square(local(t).float())) for t in leaves]
    groups: dict = {}
    for i, t in enumerate(leaves):
        dims = _split_dims(t)
        if dims:
            groups.setdefault(dims, ([], t.device_mesh))[0].append(i)
    for dims, (idx, mesh) in groups.items():
        part = torch.stack([sums[i] for i in idx])
        for d in dims:
            dist.all_reduce(part, group=mesh.get_group(d))
        for j, i in enumerate(idx):
            sums[i] = part[j]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _update_fn(grads, opt_state, cfg: AdamWCfg, lr):
    """The clipped, bias-corrected update of one leaf, ``upd(p, g, m, v) ->
    (new_p, new_m, new_v)``, with the new count and the metrics."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(
        const_f32(cfg.clip_norm, gnorm) / (gnorm + 1e-12), 1.0)
    count = local(opt_state["count"]) + 1
    b1c = 1.0 - torch.pow(const_f32(cfg.b1, gnorm), count.float())
    b2c = 1.0 - torch.pow(const_f32(cfg.b2, gnorm), count.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        del g                           # a leaf's worth of memory, freed
        step = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        p32 = p.float()
        p2 = p32 - lr * (step + cfg.weight_decay * p32)
        return p2.to(p.dtype), m2, v2

    return upd, count, {"grad_norm": gnorm, "clip_scale": scale}


def _flat(params, grads, opt_state):
    """(param, grad, m, v) of each leaf, each rank's own shards."""
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        if is_dtensor(p) and not (g.placements == m.placements
                                  == v.placements == p.placements):
            raise ValueError("AdamW's gradient and moments must be laid "
                             "out as their param")
        yield local(p), local(g), local(m), local(v)


def adamw_update(params, grads, opt_state, lr, cfg: AdamWCfg = AdamWCfg()):
    """Returns (new_params, new_opt_state, metrics).  ``lr`` is a float or
    an fp32 0-d tensor (``cosine_schedule``'s)."""
    with torch.no_grad():
        upd, count, metrics = _update_fn(grads, opt_state, cfg, lr)
        out = [upd(p, g, m, v) for p, g, m, v in _flat(params, grads,
                                                       opt_state)]
    leaves = tree_leaves(params)
    new_p = tree_unflatten(params, [_like(o[0], t)
                                    for o, t in zip(out, leaves)])
    new_m = tree_unflatten(params, [_like(o[1], t)
                                    for o, t in zip(out, leaves)])
    new_v = tree_unflatten(params, [_like(o[2], t)
                                    for o, t in zip(out, leaves)])
    count = _like(count, opt_state["count"])
    return new_p, {"m": new_m, "v": new_v, "count": count}, metrics


def adamw_update_(params, grads, opt_state, lr, cfg: AdamWCfg = AdamWCfg()):
    """``adamw_update`` written into its inputs: each leaf of ``params``
    and of ``opt_state``'s ``m`` and ``v`` gets its new value, bit for bit
    the pure update's, and ``opt_state["count"]`` the new count.  Returns
    the metrics."""
    with torch.no_grad():
        upd, count, metrics = _update_fn(grads, opt_state, cfg, lr)
        for p, g, m, v in _flat(params, grads, opt_state):
            p2, m2, v2 = upd(p, g, m, v)
            p.copy_(p2)
            m.copy_(m2)
            v.copy_(v2)
            del p2, m2, v2              # before the next leaf's update
        local(opt_state["count"]).copy_(count)
    return metrics


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """``lr(step)`` for an int tensor ``step``, as an fp32 0-d tensor."""
    def lr(step):
        s = step.float()
        # (s+1)/warmup: step 0 trains at base_lr/warmup, not at 0
        warm = base_lr * torch.clamp_max(
            (s + 1.0) / const_f32(max(warmup, 1), s), 1.0)
        prog = torch.clamp((s - warmup) / const_f32(max(total - warmup, 1), s),
                           0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, base_lr * cos)
    return lr
