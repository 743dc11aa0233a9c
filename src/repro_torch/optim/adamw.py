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
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

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


def init_opt_state(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    leaf = tree_leaves(params)[0]
    return {"m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def global_norm(tree):
    leaves = [torch.sum(torch.square(t.float())) for t in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _update_fn(grads, opt_state, cfg: AdamWCfg, lr):
    """The clipped, bias-corrected update of one leaf, ``upd(p, g, m, v) ->
    (new_p, new_m, new_v)``, with the new count and the metrics."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(
        const_f32(cfg.clip_norm, gnorm) / (gnorm + 1e-12), 1.0)
    count = opt_state["count"] + 1
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
    return zip(tree_leaves(params), tree_leaves(grads),
               tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"]))


def adamw_update(params, grads, opt_state, lr, cfg: AdamWCfg = AdamWCfg()):
    """Returns (new_params, new_opt_state, metrics).  ``lr`` is a float or
    an fp32 0-d tensor (``cosine_schedule``'s)."""
    with torch.no_grad():
        upd, count, metrics = _update_fn(grads, opt_state, cfg, lr)
        out = [upd(p, g, m, v) for p, g, m, v in _flat(params, grads,
                                                       opt_state)]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
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
        opt_state["count"].copy_(count)
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
