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

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (ctx_mesh, fake_strided_split,
                                              local_map, placements,
                                              shard_act)
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


def _routed(cfg, policy, xg, router, wi, wg, wo):
    """The routed experts over grouped tokens xg (B,n,G,D): route,
    dispatch to each expert's capacity slots, run every expert's FFN over
    its slots and combine.  Returns y (B,n,G,D) and the routing mask and
    probs (B,n,G,E) the aux loss reads."""
    r = route(cfg, {"router": router}, xg, policy)
    cap, keep = r["cap"], r["keep"]
    posi = torch.clamp(r["pos"], 0, cap - 1).long()

    slots = F.one_hot(posi, num_classes=cap).to(policy.compute)  # (B,n,G,E,C)
    combine = slots * (keep * r["gates"]).to(policy.compute)[..., None]
    combine = shard_act(combine,
                        ("batch", "moe_groups", None, "experts", "expert_cap"))
    dispatch = slots * keep.to(policy.compute)[..., None]

    xin = torch.einsum("bngec,bngd->bnecd", dispatch, xg)        # (B,n,E,C,D)
    xin = shard_act(xin, ("batch", "moe_groups", "experts", None, "embed"))
    h = torch.einsum("bnecd,edf->bnecf", xin, wi)
    g = torch.einsum("bnecd,edf->bnecf", xin, wg)
    h = _act(cfg, g) * h
    out = torch.einsum("bnecf,efd->bnecd", h, wo)
    out = shard_act(out, ("batch", "moe_groups", "experts", None, "embed"))
    y = torch.einsum("bngec,bnecd->bngd", combine, out)
    return y, r["mask"], r["probs"]


def _token_split(x, combine_shape):
    """The mesh dims splitting the combine weights' (of
    ``combine_shape``) batch and groups, where ``fake_strided_split``
    runs the routed experts on each rank's own tokens: fake tokens `x`
    whose groups take the model axis (not a decode step's one group,
    where the experts take it).  Otherwise None."""
    return fake_strided_split(
        x, ("batch", "moe_groups", None, "experts", "expert_cap"),
        combine_shape, "moe")


def _on_local_tokens(routed, args, spec):
    """``routed(xg, router, wi, wg, wo)`` on each rank's own tokens
    through ``local_map``, split over the mesh dims ``spec``
    (``_token_split``'s; with None, ``routed`` runs on the arguments as
    they are): each rank then holds all the experts of its own groups, so
    the router and expert weights enter whole (their split gathered) and
    their gradients come back as partial sums over the mesh dims that
    split the tokens."""
    if spec is None:
        return routed(*args)
    from torch.distributed.tensor import Partial, Replicate
    mesh = ctx_mesh()
    tok = placements(tuple(spec) + (None, None), mesh)
    whole = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if p.is_shard() else Replicate() for p in tok)
    return local_map(routed, args, (tok,) + (whole,) * 4, out_like=(0, 0, 0),
                     grad_placements={i: part for i in range(1, 5)})


def apply_moe(cfg: ArchConfig, p, x, policy=DEFAULT_POLICY):
    """x (B,S,D) -> (y (B,S,D), aux_loss fp32 scalar)."""
    e = cfg.moe
    c = policy.c
    b, s, d = x.shape
    gs = min(GROUP_SIZE, s)
    ng = s // gs
    assert ng * gs == s, (s, gs)
    xg = x.reshape(b, ng, gs, d)
    split = _token_split(x, (b, ng, gs, e.n_routed,
                             _group_capacity(gs, e)))
    y, mask, probs = _on_local_tokens(
        functools.partial(_routed, cfg, policy),
        (xg, c(p["router"]), c(p["wi"]), c(p["wg"]), c(p["wo"])), split)
    y = y.reshape(b, s, d)
    if split is not None:
        # each rank holds its own groups' tokens: gathered back to the
        # layout of a block's output before the shared experts' output
        # joins them, so no product downstream sees a split sequence
        y = shard_act(y, ("batch", "seq", "embed"))

    if e.n_shared:
        sh = apply_mlp(cfg, p["shared"], x, policy)
        if split is not None:
            # the row-parallel product's partial sums reduced, as a
            # block's output, before they join y laid out so: left
            # partial, DTensor may reduce-scatter them over the sequence
            sh = shard_act(sh, ("batch", "seq", "embed"))
        if e.shared_gate:
            sh = sh * torch.sigmoid(
                (x @ c(p["shared_gate"])).float()).to(sh.dtype)
        y = y + sh

    # load-balance aux (Switch): E * sum_e f_e * P_e
    f = torch.mean(mask, dim=(0, 1, 2))
    pmean = torch.mean(probs, dim=(0, 1, 2))
    aux = e.aux_coef * e.n_routed * torch.sum(f * pmean)
    return y, aux
