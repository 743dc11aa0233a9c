"""Mixture-of-Experts FFN (torch twin of ``repro.models.moe``): routed
experts with grouped capacity-based dispatch (GShard/Mesh-TF style) +
optional shared experts.

Tokens are split into GROUPS of ``GROUP_SIZE`` along the sequence;
capacity is per group, so the dispatch/combine tensors are
(B, n_g, G_s, E, C_g) with C_g ~ G_s*top_k/E.  The top-k dimension is
summed into per-expert gates BEFORE any capacity expansion, so K never
multiplies ExC.

Every shape is static and nothing reads a value back to the host (no
``.item()``, no ``nonzero``, no boolean-mask indexing; ``one_hot`` is given
its class count), so a step through it can be captured as a CUDA graph.
At decode (S = 1) the capacity is 1 and the expert products run every
expert over the token, as the reference's do.

On a mesh the params and activations are DTensors and the reference's
four ``shard_act`` sites lay them out: the routing mask and the combine
weights, and the dispatched tokens before and after the experts, split
over experts (or ``moe_groups``) on the model axis, so each rank runs its
own experts' products.  The router's softmax and top-k read whole expert
rows, so the routing is the one-device forward's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import shard_act
from repro_torch.models.layers import DEFAULT_POLICY, Pm, _act, apply_mlp, mlp_defs

GROUP_SIZE = 256


def moe_defs(cfg: ArchConfig):
    e = cfg.moe
    d = cfg.d_model
    defs = {
        "router": Pm((d, e.n_routed), ("embed", "experts"), scale=0.1),
        "wi": Pm((e.n_routed, d, e.d_expert), ("experts", "embed", "expert_ff")),
        "wg": Pm((e.n_routed, d, e.d_expert), ("experts", "embed", "expert_ff")),
        "wo": Pm((e.n_routed, e.d_expert, d), ("experts", "expert_ff", "embed")),
    }
    if e.n_shared:
        defs["shared"] = mlp_defs(cfg, d_ff=e.n_shared * e.d_expert)
        if e.shared_gate:
            defs["shared_gate"] = Pm((d, 1), ("embed", None), scale=0.1)
    return defs


def _group_capacity(gs: int, e) -> int:
    cap = int(gs * e.top_k * e.capacity_factor / e.n_routed) + 1
    return max(min(cap, gs), 1)


def route(cfg: ArchConfig, p, xg, policy=DEFAULT_POLICY):
    """The router over grouped tokens xg (B,n,G,D): fp32 probs (B,n,G,E),
    the top-k expert indices (B,n,G,K), each expert's gate and 0/1 mask
    with K folded away (B,n,G,E), and ``keep`` = mask * (position in
    expert < capacity), positions by cumsum in token order."""
    e = cfg.moe
    cap = _group_capacity(xg.shape[2], e)
    logits = (xg @ policy.c(p["router"])).float()              # (B,n,G,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, e.top_k, dim=-1)  # (B,n,G,K)
    onehot = F.one_hot(expert_idx, num_classes=e.n_routed).float()
    mask = torch.sum(onehot, dim=3)                             # 0/1 (B,n,G,E)
    gates_e = torch.sum(onehot * gate_vals[..., None], dim=3)  # (B,n,G,E)
    mask = shard_act(mask, ("batch", "moe_groups", None, "experts"))
    pos = torch.cumsum(mask, dim=2) - 1.0                       # (B,n,G,E)
    keep = mask * (pos < cap)
    return {"probs": probs, "expert_idx": expert_idx, "mask": mask,
            "gates": gates_e, "pos": pos, "keep": keep, "cap": cap}


def apply_moe(cfg: ArchConfig, p, x, policy=DEFAULT_POLICY):
    """x (B,S,D) -> (y (B,S,D), aux_loss fp32 scalar)."""
    e = cfg.moe
    c = policy.c
    b, s, d = x.shape
    gs = min(GROUP_SIZE, s)
    ng = s // gs
    assert ng * gs == s, (s, gs)
    xg = x.reshape(b, ng, gs, d)
    r = route(cfg, p, xg, policy)
    cap, keep = r["cap"], r["keep"]
    posi = torch.clamp(r["pos"], 0, cap - 1).long()

    slots = F.one_hot(posi, num_classes=cap).to(policy.compute)  # (B,n,G,E,C)
    combine = slots * (keep * r["gates"]).to(policy.compute)[..., None]
    combine = shard_act(combine,
                        ("batch", "moe_groups", None, "experts", "expert_cap"))
    dispatch = slots * keep.to(policy.compute)[..., None]

    xin = torch.einsum("bngec,bngd->bnecd", dispatch, xg)        # (B,n,E,C,D)
    xin = shard_act(xin, ("batch", "moe_groups", "experts", None, "embed"))
    h = torch.einsum("bnecd,edf->bnecf", xin, c(p["wi"]))
    g = torch.einsum("bnecd,edf->bnecf", xin, c(p["wg"]))
    h = _act(cfg, g) * h
    out = torch.einsum("bnecf,efd->bnecd", h, c(p["wo"]))
    out = shard_act(out, ("batch", "moe_groups", "experts", None, "embed"))
    y = torch.einsum("bngec,bnecd->bngd", combine, out).reshape(b, s, d)

    if e.n_shared:
        sh = apply_mlp(cfg, p["shared"], x, policy)
        if e.shared_gate:
            sh = sh * torch.sigmoid(
                (x @ c(p["shared_gate"])).float()).to(sh.dtype)
        y = y + sh

    # load-balance aux (Switch): E * sum_e f_e * P_e
    f = torch.mean(r["mask"], dim=(0, 1, 2))
    pmean = torch.mean(r["probs"], dim=(0, 1, 2))
    aux = e.aux_coef * e.n_routed * torch.sum(f * pmean)
    return y, aux
