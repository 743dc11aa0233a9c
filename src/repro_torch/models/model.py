"""Generic LM composition (torch twin of ``repro.models.model``), for
every block kind: "attn", "local_attn", "moe", "rglru", "mlstm" and
"slstm".  That is the dense decoder stacks, the MoE stacks (qwen2-moe;
deepseek-v2-lite, whose attention is MLA and whose first layer is a dense
prefix block), the RG-LRU + local-attention hybrid (recurrentgemma) and
xLSTM (units of 7 mLSTM and 1 sLSTM).  The encoder-decoder is
``models/whisper.py``.

Every arch is expressed as prefix blocks (list) + a repeated unit (params
stacked along a leading L dim) + tail.  The reference scans the stacked
units; here a Python loop indexes the L dim.

Params / cache trees, as in the reference:
  {"embed":…, "pos"?:…, "prefix":[…], "units": stacked, "tail":[…], "final":…}

Under ``sharding_ctx(mesh, rules)`` with DTensor params and cache (the
sharded forward) the same code runs on DTensors: the token ids are split
over the batch before the vocab-parallel lookup, activations are laid
out at the reference's ``shard_act`` sites (the embedded input, a
block's output, the unit carry, the logits), each residual add reduces
its row-parallel product (``layers.residual``), and an FSDP-split
layer is gathered for its use (``sharding.gather_fsdp``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (gather_fsdp, in_this_ctx,
                                              replicate, shard_act)
from repro_torch.models import attention as att
from repro_torch.models import rglru as rg
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (DEFAULT_POLICY, Pm, apply_mlp,
                                       apply_norm, embed_defs, embed_tokens,
                                       lm_logits, mlp_defs, norm_defs,
                                       residual)
from repro_torch.models.moe import apply_moe, moe_defs
from repro_torch.models.params import stack_defs

#: The recurrent kinds: (defs, apply, decode, state defs) of each.  Their
#: full apply returns the carry state, which is their decode cache.
_RECURRENT = {
    "rglru": (rg.rglru_defs, rg.rglru_apply, rg.rglru_decode,
              rg.rglru_state_defs),
    "mlstm": (xl.mlstm_defs, xl.mlstm_apply, xl.mlstm_decode,
              xl.mlstm_state_defs),
    "slstm": (xl.slstm_defs, xl.slstm_apply, xl.slstm_decode,
              xl.slstm_state_defs),
}


def _check_kind(cfg: ArchConfig, kind: str) -> None:
    if kind not in ("attn", "local_attn", "moe") and kind not in _RECURRENT:
        raise KeyError(kind)


# --------------------------------------------------------------------------
# Stack plan
# --------------------------------------------------------------------------

def stack_plan(cfg: ArchConfig) -> Tuple[Tuple[str, ...], Tuple[str, ...], int,
                                         Tuple[str, ...]]:
    """(prefix_kinds, unit_kinds, n_units, tail_kinds)."""
    if cfg.moe is not None:
        k = cfg.moe.first_k_dense
        return (("attn",) * k, ("moe",), cfg.n_layers - k, ())
    if cfg.block_pattern:
        unit = cfg.block_pattern
        tail = cfg.pattern_tail
        n = (cfg.n_layers - len(tail)) // len(unit)
        return ((), unit, n, tail)
    return ((), ("attn",), cfg.n_layers, ())


# --------------------------------------------------------------------------
# Block dispatch
# --------------------------------------------------------------------------

def _window(cfg, kind) -> int:
    return cfg.window if kind == "local_attn" else 0


def _dense_ff(cfg):
    if cfg.moe is not None and cfg.moe.dense_ff:
        return cfg.moe.dense_ff
    return cfg.d_ff


def _ff(cfg, kind, p, h, policy):
    """The block's feed-forward half, the MoE's aux loss dropped (serving
    steps do not read it)."""
    if kind == "moe":
        return apply_moe(cfg, p, h, policy)[0]
    return apply_mlp(cfg, p, h, policy)


def block_defs(cfg: ArchConfig, kind: str):
    _check_kind(cfg, kind)
    if kind in _RECURRENT:
        return _RECURRENT[kind][0](cfg)
    adefs = att.mla_defs(cfg) if cfg.mla is not None else att.attn_defs(cfg)
    ff = (moe_defs(cfg) if kind == "moe"
          else mlp_defs(cfg, d_ff=_dense_ff(cfg)))
    return {"ln1": norm_defs(cfg), "attn": adefs,
            "ln2": norm_defs(cfg), "mlp": ff}


def _act_out(x):
    """A block's output, laid out as the reference's ``model.py:104``: the
    row-parallel products' partial sums reduced, the batch split."""
    return shard_act(x, ("batch", "seq", "embed"))


def apply_block(cfg, kind, p, x, positions, policy=DEFAULT_POLICY):
    """Training/prefill-style full-sequence block.  Returns (x, aux, cache);
    the cache is the recurrent carry state, None for attention kinds, and
    aux the MoE load-balance loss (0 for the other kinds)."""
    _check_kind(cfg, kind)
    p = gather_fsdp(p)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in _RECURRENT:
        x, state = _RECURRENT[kind][1](cfg, p, x, policy)
        return _act_out(x), aux, state
    h = apply_norm(cfg, p["ln1"], x, policy)
    if cfg.mla is not None:
        a = att.mla_forward(cfg, p["attn"], h, positions, policy=policy)
    else:
        a = att.attn_forward(cfg, p["attn"], h, positions,
                             window=_window(cfg, kind), policy=policy)
    x = residual(x, a)
    h = apply_norm(cfg, p["ln2"], x, policy)
    if kind == "moe":
        m, aux = apply_moe(cfg, p["mlp"], h, policy)
    else:
        m = apply_mlp(cfg, p["mlp"], h, policy)
    return _act_out(residual(x, m)), aux, None


def block_cache_defs(cfg, kind, batch: int, max_seq: int,
                     dtype=torch.bfloat16):
    _check_kind(cfg, kind)
    if kind in _RECURRENT:
        return _RECURRENT[kind][3](cfg, batch, dtype)
    if cfg.mla is not None and kind != "local_attn":
        return att.mla_cache_defs(cfg, batch, max_seq, dtype)
    return att.kv_cache_defs(cfg, batch, max_seq, dtype)  # window-clipped


def _write_state(buffers, state):
    """Copy a recurrent block's new state into its cache buffers (a
    buffer the block already updated in place is left as it is)."""
    for key, t in state.items():
        if t is not buffers[key]:
            buffers[key].copy_(t)
    return buffers


def decode_block(cfg, kind, p, x, cache, pos, policy=DEFAULT_POLICY):
    """One-token decode.  Returns (x, cache); the cache is updated in place
    (a recurrent block's new state is copied into its buffers, or written
    there by the block: mlstm)."""
    _check_kind(cfg, kind)
    p = gather_fsdp(p)
    if kind in _RECURRENT:
        x, state = _RECURRENT[kind][2](cfg, p, x, cache, policy)
        return x, _write_state(cache, state)
    h = apply_norm(cfg, p["ln1"], x, policy)
    decode = att.mla_decode if cfg.mla is not None else att.attn_decode
    a, cache = decode(cfg, p["attn"], h, cache, pos, policy=policy)
    x = residual(x, a)
    h = apply_norm(cfg, p["ln2"], x, policy)
    return residual(x, _ff(cfg, kind, p["mlp"], h, policy)), cache


def prefill_block(cfg, kind, p, x, positions, max_cache: int,
                  policy=DEFAULT_POLICY, into=None):
    """Full-sequence block that also materializes its decode cache, into
    the buffers ``into`` where given."""
    _check_kind(cfg, kind)
    p = gather_fsdp(p)
    if kind in _RECURRENT:
        # the full apply already returns the carry state = decode cache
        x, _, cache = apply_block(cfg, kind, p, x, positions, policy)
        return x, cache if into is None else _write_state(into, cache)
    h = apply_norm(cfg, p["ln1"], x, policy)
    if cfg.mla is not None:
        a, cache = att.mla_prefill(cfg, p["attn"], h, positions, max_cache,
                                   policy=policy, into=into)
    else:
        a, cache = att.attn_prefill(cfg, p["attn"], h, positions, max_cache,
                                    window=_window(cfg, kind), policy=policy,
                                    into=into)
    x = residual(x, a)
    h = apply_norm(cfg, p["ln2"], x, policy)
    return residual(x, _ff(cfg, kind, p["mlp"], h, policy)), cache


# --------------------------------------------------------------------------
# Whole-model param / cache defs
# --------------------------------------------------------------------------

def lm_param_defs(cfg: ArchConfig, max_seq: int):
    prefix, unit, n_units, tail = stack_plan(cfg)
    defs = {"embed": embed_defs(cfg)}
    if cfg.pos_emb == "learned":
        defs["pos"] = Pm((max_seq, cfg.d_model), ("seq", "embed"), scale=0.02)
    defs["prefix"] = [block_defs(cfg, k) for k in prefix]
    unit_defs = {f"b{i}": block_defs(cfg, k) for i, k in enumerate(unit)}
    defs["units"] = stack_defs(unit_defs, n_units)
    defs["tail"] = [block_defs(cfg, k) for k in tail]
    defs["final"] = norm_defs(cfg)
    return defs


def lm_cache_defs(cfg: ArchConfig, batch: int, max_seq: int,
                  dtype=torch.bfloat16):
    """The decode cache; ``dtype`` is the compute dtype it holds (k, v, the
    MLA c_kv and k_rope, and the rglru and mlstm conv windows; the
    recurrent states are fp32), which the prefill's own cache has."""
    prefix, unit, n_units, tail = stack_plan(cfg)

    def one(k):
        return block_cache_defs(cfg, k, batch, max_seq, dtype)

    return {"prefix": [one(k) for k in prefix],
            "units": stack_defs({f"b{i}": one(k) for i, k in enumerate(unit)},
                                n_units),
            "tail": [one(k) for k in tail]}


# --------------------------------------------------------------------------
# Forward / prefill / decode
# --------------------------------------------------------------------------

def _unstack(tree, n: int):
    """A stacked tree -> ``n`` per-layer trees of views into the L dim, by
    one ``unbind`` a leaf.  Under autograd, indexing the L dim once per
    layer would make a zero gradient of the whole stack for every layer;
    ``unbind``'s backward stacks the per-layer gradients once."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _stack(trees):
    """Per-layer trees -> one tree with a leading L dim."""
    if isinstance(trees[0], dict):
        return {key: _stack([t[key] for t in trees]) for key in trees[0]}
    return torch.stack(trees)


def _tokens_in(tokens):
    """Token ids as the model reads them: on a mesh, a DTensor split over
    the batch axes before the lookup, so the vocab-parallel lookup's
    partial sums are reduced over the model axis alone."""
    return shard_act(replicate(tokens), ("batch", "seq"))


def _positions(b: int, s: int, device):
    return replicate(torch.arange(s, device=device)[None].expand(b, s))


def _embed_in(cfg, params, tokens, extras, policy):
    # the vocab-parallel lookup's partial sums reduced before anything is
    # spliced in: DTensor cannot lay a replicated tensor out as the
    # lookup's masked partial sum under autograd
    x = shard_act(embed_tokens(cfg, gather_fsdp(params["embed"]), tokens,
                               policy), ("batch", "seq", "embed"))
    if cfg.family == "vlm" and extras and "vision_embeds" in extras:
        v = shard_act(replicate(policy.c(extras["vision_embeds"])),
                      ("batch", "seq", "embed"))
        x = torch.cat([v, x[:, v.shape[1]:]], dim=1)
    if cfg.pos_emb == "learned":
        x = x + policy.c(params["pos"][:tokens.shape[1]])
    return shard_act(x, ("batch", "seq", "embed"))


def lm_forward(cfg: ArchConfig, params, batch, policy=DEFAULT_POLICY,
               remat: bool = True):
    """batch: tokens (B,S) [+ vision_embeds].  Returns (logits, aux).

    With ``remat`` and autograd recording, each unit runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
    unit body): the backward recomputes the unit's forward, the flash
    kernel included, so a training step launches it twice a layer.  It
    stashes no RNG state (``preserve_rng_state=False``): no forward of the
    port draws a random number, and a CUDA graph's capture of the step
    need not read the generator's state.  The recompute runs under the
    forward's sharding context (``sharding.in_this_ctx``)."""
    prefix, unit, n_units, tail = stack_plan(cfg)
    tokens = _tokens_in(batch["tokens"])
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _embed_in(cfg, params, tokens, batch, policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    for k, p in zip(prefix, params["prefix"]):
        x, a, _ = apply_block(cfg, k, p, x, positions, policy)
        aux = aux + a

    def unit_body(x, unit_p):
        a_tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, k in enumerate(unit):
            x, a, _ = apply_block(cfg, k, unit_p[f"b{i}"], x, positions, policy)
            a_tot = a_tot + a
        return x, a_tot

    for unit_p in _unstack(params["units"], n_units):
        x = shard_act(x, ("batch", "seq_saves", "embed"))
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(in_this_ctx(unit_body), x, unit_p,
                              use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = unit_body(x, unit_p)
        aux = aux + a
    for k, p in zip(tail, params["tail"]):
        x, a, _ = apply_block(cfg, k, p, x, positions, policy)
        aux = aux + a

    x = apply_norm(cfg, gather_fsdp(params["final"]), x, policy)
    logits = lm_logits(cfg, gather_fsdp(params["embed"]), x, policy)
    return shard_act(logits, ("batch", "seq", "vocab")), aux


def lm_prefill(cfg: ArchConfig, params, tokens, extras, max_cache: int,
               policy=DEFAULT_POLICY, cache=None):
    """Prompt pass.  Returns (last-token logits (B,V), cache).

    With ``cache`` (buffers of ``lm_cache_defs(cfg, B, max_cache,
    policy.compute)``'s tree and shapes) every block writes its cache into
    them, through per-layer views of the stacked units, and that tree is
    returned: nothing of the cache is allocated, so a captured prefill
    writes where a captured decode reads.  The values are the same."""
    prefix, unit, n_units, tail = stack_plan(cfg)
    b, s = tokens.shape
    tokens = _tokens_in(tokens)
    positions = _positions(b, s, tokens.device)
    x = _embed_in(cfg, params, tokens, extras, policy)
    if cache is None:
        out_prefix, out_units, out_tail = ([None] * len(prefix),
                                           [{}] * n_units, [None] * len(tail))
    else:
        out_prefix, out_units, out_tail = (
            cache["prefix"], _unstack(cache["units"], n_units), cache["tail"])

    pc = []
    for k, p, o in zip(prefix, params["prefix"], out_prefix):
        x, c = prefill_block(cfg, k, p, x, positions, max_cache, policy, o)
        pc.append(c)
    per_layer = []
    for unit_p, unit_o in zip(_unstack(params["units"], n_units), out_units):
        caches = {}
        for i, k in enumerate(unit):
            x, caches[f"b{i}"] = prefill_block(
                cfg, k, unit_p[f"b{i}"], x, positions, max_cache, policy,
                unit_o.get(f"b{i}"))
        per_layer.append(caches)
    tc = []
    for k, p, o in zip(tail, params["tail"], out_tail):
        x, c = prefill_block(cfg, k, p, x, positions, max_cache, policy, o)
        tc.append(c)

    x = apply_norm(cfg, gather_fsdp(params["final"]), x[:, -1:], policy)
    logits = shard_act(lm_logits(cfg, gather_fsdp(params["embed"]), x,
                                 policy)[:, 0],
                       ("batch", "vocab"))
    if cache is not None:
        return logits, cache
    return logits, {"prefix": pc, "units": _stack(per_layer), "tail": tc}


def lm_decode(cfg: ArchConfig, params, cache, token, pos,
              policy=DEFAULT_POLICY):
    """One-token step.  token (B,1) int, pos (B,) absolute positions.
    Returns (logits (B,V), cache); the cache is updated in place (its
    stacked unit buffers through per-layer views)."""
    prefix, unit, n_units, tail = stack_plan(cfg)
    token, pos = _tokens_in(token), replicate(pos)
    x = embed_tokens(cfg, gather_fsdp(params["embed"]), token, policy)
    if cfg.pos_emb == "learned":
        x = x + policy.c(params["pos"][pos])[:, None]
    x = shard_act(x, ("batch", "seq", "embed"))

    for k, p, c0 in zip(prefix, params["prefix"], cache["prefix"]):
        x, _ = decode_block(cfg, k, p, x, c0, pos, policy)
    for unit_p, unit_c in zip(_unstack(params["units"], n_units),
                              _unstack(cache["units"], n_units)):
        for i, k in enumerate(unit):
            x, _ = decode_block(cfg, k, unit_p[f"b{i}"], x, unit_c[f"b{i}"],
                                pos, policy)
    for k, p, c0 in zip(tail, params["tail"], cache["tail"]):
        x, _ = decode_block(cfg, k, p, x, c0, pos, policy)

    x = apply_norm(cfg, gather_fsdp(params["final"]), x, policy)
    logits = shard_act(lm_logits(cfg, gather_fsdp(params["embed"]), x,
                                 policy)[:, 0],
                       ("batch", "vocab"))
    return logits, cache
