"""Whisper-style encoder-decoder backbone (torch twin of
``repro.models.whisper``; arXiv:2212.04356).

The conv audio frontend is a stub, as in the reference: ``frames``
(B, n_frames, d_model) precomputed embeddings arrive as inputs.  The
encoder adds fixed sinusoidal positions and runs non-causal blocks; the
decoder runs causal self-attention + cross-attention blocks with learned
positions.  Shapes interpret seq_len as the decoder length.  The reference
scans the stacked blocks; here a Python loop indexes their L dim.  On a
mesh the params, the frames and the cache are DTensors: the frames are
laid out at the reference's ``shard_act`` of the encoder input and the
logits at that of the forward's output, each residual add reduces its
row-parallel product (``layers.residual``), and an FSDP-split block is
gathered for its use.

The cache holds, per decoder block, the self-attention K/V (written by
the prefill, updated in place by each decode step) and the cross K/V of
the encoder memory (written by the prefill, read-only after).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (gather_fsdp, in_this_ctx,
                                              replicate, shard_act)
from repro_torch.models import attention as att
from repro_torch.models.layers import (DEFAULT_POLICY, Pm, apply_mlp,
                                       apply_norm, embed_defs, embed_tokens,
                                       lm_logits, mlp_defs, norm_defs,
                                       residual, sincos_table)
from repro_torch.models.model import (_positions, _stack, _tokens_in,
                                     _unstack)
from repro_torch.models.params import stack_defs


def _enc_block_defs(cfg):
    return {"ln1": norm_defs(cfg), "attn": att.attn_defs(cfg),
            "ln2": norm_defs(cfg), "mlp": mlp_defs(cfg)}


def _dec_block_defs(cfg):
    return {"ln1": norm_defs(cfg), "self_attn": att.attn_defs(cfg),
            "lnx": norm_defs(cfg), "cross_attn": att.attn_defs(cfg),
            "ln2": norm_defs(cfg), "mlp": mlp_defs(cfg)}


def whisper_param_defs(cfg: ArchConfig, max_seq: int):
    return {
        "embed": embed_defs(cfg),
        "pos": Pm((max_seq, cfg.d_model), ("seq", "embed"), scale=0.02),
        "enc_blocks": stack_defs(_enc_block_defs(cfg), cfg.encoder.n_layers),
        "enc_final": norm_defs(cfg),
        "dec_blocks": stack_defs(_dec_block_defs(cfg), cfg.n_layers),
        "final": norm_defs(cfg),
    }


def encode(cfg: ArchConfig, params, frames, policy=DEFAULT_POLICY):
    """frames (B,F,D) stub embeddings -> encoder memory (B,F,D)."""
    f = frames.shape[1]
    x = policy.c(replicate(frames)) + policy.c(replicate(
        sincos_table(f, cfg.d_model, frames.device)))
    x = shard_act(x, ("batch", "frames", "embed"))
    positions = replicate(torch.arange(f, device=frames.device))
    for p in _unstack(params["enc_blocks"], cfg.encoder.n_layers):
        p = gather_fsdp(p)
        h = apply_norm(cfg, p["ln1"], x, policy)
        x = residual(x, att.attn_forward(cfg, p["attn"], h, positions,
                                         policy=policy, causal=False,
                                         q_chunk=min(1024, f)))
        h = apply_norm(cfg, p["ln2"], x, policy)
        x = residual(x, apply_mlp(cfg, p["mlp"], h, policy))
    return apply_norm(cfg, gather_fsdp(params["enc_final"]), x, policy)


def _dec_in(cfg, params, tokens, policy):
    x = embed_tokens(cfg, gather_fsdp(params["embed"]), tokens, policy)
    x = x + policy.c(gather_fsdp(params["pos"])[:tokens.shape[1]])
    return shard_act(x, ("batch", "seq", "embed"))


def _logits(cfg, params, x, policy):
    x = apply_norm(cfg, gather_fsdp(params["final"]), x, policy)
    return lm_logits(cfg, gather_fsdp(params["embed"]), x, policy)


def _dec_block(cfg, p, x, positions, mem, policy):
    p = gather_fsdp(p)
    h = apply_norm(cfg, p["ln1"], x, policy)
    x = residual(x, att.attn_forward(cfg, p["self_attn"], h, positions,
                                     policy=policy))
    h = apply_norm(cfg, p["lnx"], x, policy)
    x = residual(x, att.cross_attn_forward(cfg, p["cross_attn"], h, mem,
                                           policy=policy))
    h = apply_norm(cfg, p["ln2"], x, policy)
    return residual(x, apply_mlp(cfg, p["mlp"], h, policy))


def whisper_forward(cfg: ArchConfig, params, batch, policy=DEFAULT_POLICY,
                    remat: bool = True):
    """batch: frames (B,F,D), tokens (B,S).  Returns (logits, aux=0).  With
    ``remat`` and autograd recording, each decoder block runs under
    ``torch.utils.checkpoint``, as the reference checkpoints its body (no
    RNG state stashed: nothing here draws one, as ``lm_forward`` says)."""
    mem = encode(cfg, params, batch["frames"], policy)
    tokens = _tokens_in(batch["tokens"])
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _dec_in(cfg, params, tokens, policy)
    for p in _unstack(params["dec_blocks"], cfg.n_layers):
        if remat and torch.is_grad_enabled():
            x = checkpoint(in_this_ctx(_dec_block), cfg, p, x, positions,
                           mem, policy, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _dec_block(cfg, p, x, positions, mem, policy)
    logits = shard_act(_logits(cfg, params, x, policy),
                       ("batch", "seq", "vocab"))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def whisper_cache_defs(cfg: ArchConfig, batch: int, max_seq: int,
                       dtype=torch.bfloat16):
    """The decode cache, in the compute ``dtype``: per decoder block the
    self K/V at ``max_seq`` and the cross K/V over the encoder's frames."""
    kv, hd, f = cfg.n_kv_heads, cfg.hd, cfg.encoder.n_frames
    self_kv = att.kv_cache_defs(cfg, batch, max_seq, dtype)
    cross = {
        "k": Pm((batch, f, kv, hd), ("batch", "frames", "kv_heads", "head_dim"),
                init="zeros", dtype=dtype),
        "v": Pm((batch, f, kv, hd), ("batch", "frames", "kv_heads", "head_dim"),
                init="zeros", dtype=dtype),
    }
    return {"dec": stack_defs({"self": self_kv, "cross": cross}, cfg.n_layers)}


def whisper_prefill(cfg: ArchConfig, params, tokens, extras, max_cache: int,
                    policy=DEFAULT_POLICY, cache=None):
    """Encoder over ``extras["frames"]``, then the decoder over the prompt.
    Returns (last-token logits (B,V), cache).  With ``cache`` (buffers of
    ``whisper_cache_defs(cfg, B, max_cache, policy.compute)``) every block
    writes its self and cross K/V into them, and that tree is returned, as
    ``lm_prefill`` does."""
    c = policy.c
    mem = encode(cfg, params, extras["frames"], policy)
    tokens = _tokens_in(tokens)
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _dec_in(cfg, params, tokens, policy)
    n = cfg.n_layers
    outs = [None] * n if cache is None else _unstack(cache["dec"], n)
    caches = []
    for p, o in zip(_unstack(params["dec_blocks"], n), outs):
        p = gather_fsdp(p)
        h = apply_norm(cfg, p["ln1"], x, policy)
        a, self_cache = att.attn_prefill(cfg, p["self_attn"], h, positions,
                                         max_cache, policy=policy,
                                         into=None if o is None else o["self"])
        x = residual(x, a)
        h = apply_norm(cfg, p["lnx"], x, policy)
        x = residual(x, att.cross_attn_forward(cfg, p["cross_attn"], h, mem,
                                               policy=policy))
        ck = torch.einsum("bfd,dhk->bfhk", mem,
                          c(p["cross_attn"]["wk"])).to(x.dtype)
        cv = torch.einsum("bfd,dhk->bfhk", mem,
                          c(p["cross_attn"]["wv"])).to(x.dtype)
        if o is not None:
            ck, cv = o["cross"]["k"].copy_(ck), o["cross"]["v"].copy_(cv)
        h = apply_norm(cfg, p["ln2"], x, policy)
        x = residual(x, apply_mlp(cfg, p["mlp"], h, policy))
        caches.append({"self": self_cache, "cross": {"k": ck, "v": cv}})
    logits = shard_act(_logits(cfg, params, x[:, -1:], policy)[:, 0],
                       ("batch", "vocab"))
    if cache is not None:
        return logits, cache
    return logits, {"dec": _stack(caches)}


def _cross_decode(cfg, p, x, cross, policy):
    """Read-only cross-attention for one query token."""
    c = policy.c
    q = torch.einsum("bsd,dhk->bshk", x, c(p["wq"]))
    qf = att._fold_gqa(q, cfg.n_kv_heads)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf.float(),
                     cross["k"].float()) * (cfg.hd ** -0.5)
    pr = att._softmax_fp32(s).to(x.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", pr, cross["v"])
    o = o.reshape(x.shape[0], 1, cfg.n_heads, cfg.hd)
    return torch.einsum("bshk,hkd->bsd", o, c(p["wo"]))


def whisper_decode(cfg: ArchConfig, params, cache, token, pos,
                   policy=DEFAULT_POLICY):
    """One-token step.  token (B,1), pos (B,).  Returns (logits (B,V),
    cache); each block's self K/V is updated in place, its cross K/V only
    read."""
    token, pos = _tokens_in(token), replicate(pos)
    x = embed_tokens(cfg, gather_fsdp(params["embed"]), token, policy)
    x = x + policy.c(F.embedding(pos, gather_fsdp(params["pos"])))[:, None]
    x = shard_act(x, ("batch", "seq", "embed"))
    n = cfg.n_layers
    for p, cc in zip(_unstack(params["dec_blocks"], n),
                     _unstack(cache["dec"], n)):
        p = gather_fsdp(p)
        h = apply_norm(cfg, p["ln1"], x, policy)
        a, _ = att.attn_decode(cfg, p["self_attn"], h, cc["self"], pos,
                               policy=policy)
        x = residual(x, a)
        h = apply_norm(cfg, p["lnx"], x, policy)
        x = residual(x, _cross_decode(cfg, p["cross_attn"], h, cc["cross"],
                                      policy))
        h = apply_norm(cfg, p["ln2"], x, policy)
        x = residual(x, apply_mlp(cfg, p["mlp"], h, policy))
    logits = shard_act(_logits(cfg, params, x, policy)[:, 0],
                       ("batch", "vocab"))
    return logits, cache
