"""Attention (torch twin of ``repro.models.attention``): full and
local-window GQA for prefill, KV-cache decode, and Multi-head Latent
Attention (DeepSeek-V2) with its absorbed decode over the compressed cache.

Prefill attention is q-chunked (scores never materialize beyond
(B, KV, G, q_chunk, S)) unless the "flash" backend is selected and the
shapes meet the kernel's contract; then it goes through
``kernels.ops.flash_attention`` (the hand-written kernel on CUDA, its plain
version on the CPU).  The chunked path splits q into ``Sq // q_chunk``
chunks with ``torch.chunk``, so it also accepts a length that chunk count
does not divide (the chunks are then unequal), where the reference, which
reshapes into equal chunks, raises.

MLA's q and k have head dim 192 and its v 128, so the flash kernel does
not take it: its prefill goes through the chunked path, as the
reference's does.

Whisper's cross-attention (``cross_attn_forward``) is non-causal over
the encoder memory; at 1500 frames its keys are no multiple of 128, so it
takes the chunked path, as the reference's does.

GQA layout choice (sharding-aware, as the reference's): folding H ->
(KV, G) is only tensor-parallel-compatible when KV divides the model
axis.  Under a ``sharding_ctx`` where q-heads shard but kv-heads don't,
the chunked prefill and the decode instead EXPAND k/v to H heads and keep
scores H-major.  Outside a context ``ctx_divisible`` is True, so the
single-device paths always fold.

On a mesh (the sharded forward) q, k and v are DTensors split over their
heads.  The flash kernel is reached through ``sharding.local_map``: each
rank folds its own heads into rows (B·H/m of them; k and v expanded to
the query heads first where the kv heads do not split), so nothing is
gathered around the kernel.  The chunked path keeps the reference's
``shard_act`` sites.  A cache write is local to each rank's window of
the DTensor cache (``_write_slots``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (ctx_divisible, ctx_mesh,
                                              fake_strided_split, local_map,
                                              placements, replicate,
                                              shard_act, window)
from repro_torch.models.layers import (DEFAULT_POLICY, Pm, apply_rope,
                                       rms_head_norm, rope_cos_sin, rope_qk)

NEG_INF = -1e30

#: "chunked" (plain torch, q-chunked; default) or "flash" (the kernel on
#: CUDA, its plain version on the CPU).  Falls back to chunked when the
#: shapes don't meet the kernel's tiling contract.
_BACKEND = "chunked"


def set_attention_backend(name: str) -> None:
    global _BACKEND
    assert name in ("chunked", "flash"), name
    _BACKEND = name


def get_attention_backend() -> str:
    return _BACKEND


def _flash_ok(q, k, v, q_positions, causal) -> bool:
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if hd != v.shape[-1] or hd not in (64, 128, 256):
        return False
    if sq % 128 or sk % 128:
        return False
    if causal and sq != sk:
        return False
    return True


# --------------------------------------------------------------------------
# Param defs
# --------------------------------------------------------------------------

def attn_defs(cfg: ArchConfig):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    defs = {
        "wq": Pm((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": Pm((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Pm((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Pm((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = Pm((hd,), ("head_dim",), init="ones")
        defs["k_norm"] = Pm((hd,), ("head_dim",), init="ones")
    return defs


def mla_defs(cfg: ArchConfig):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": Pm((d, h, qk_dim), ("embed", "heads", "head_dim")),
        "wkv_a": Pm((d, m.kv_lora_rank + m.qk_rope_head_dim),
                    ("embed", "kv_lora")),
        "kv_norm": Pm((m.kv_lora_rank,), ("kv_lora",), init="ones"),
        "w_uk": Pm((m.kv_lora_rank, h, m.qk_nope_head_dim),
                   ("kv_lora", "heads", "head_dim")),
        "w_uv": Pm((m.kv_lora_rank, h, m.v_head_dim),
                   ("kv_lora", "heads", "head_dim")),
        "wo": Pm((h, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }


# --------------------------------------------------------------------------
# Core chunked softmax attention (GQA; causal or local window)
# --------------------------------------------------------------------------

def _flash(q, k, v, *, causal, window):
    """The flash kernel over plain (B, S, H|KV, hd) tensors, heads folded
    into rows."""
    from repro_torch.kernels import ops as kops
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    # contiguous: at B=1 the reshape alone returns a strided view
    qt = q.transpose(1, 2).contiguous().view(b * h, sq, hd)
    kt = k.transpose(1, 2).contiguous().view(b * kvh, k.shape[1], hd)
    vt = v.transpose(1, 2).contiguous().view(b * kvh, v.shape[1], hd)
    ot = kops.flash_attention(qt, kt, vt, causal, window)
    return ot.reshape(b, h, sq, hd).transpose(1, 2)


def _fold_gqa(q, n_kv):
    """(B,S,H,hd) -> (B,S,KV,G,hd)."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def _expand(kvh: int, h: int) -> bool:
    """Expand k/v to the q heads (the reference's condition): under a
    sharding context where q-heads shard over the model axis and kv-heads
    do not."""
    return (kvh < h and not ctx_divisible("kv_heads", kvh)
            and ctx_divisible("heads", h))


def _mask_bias(q_pos, k_pos, window: int):
    """(Q,K) additive mask: causal, optionally local-window."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    return torch.where(ok, 0.0, NEG_INF)


def _softmax_fp32(s):
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e / torch.sum(e, dim=-1, keepdim=True)


def gqa_attention(q, k, v, *, q_positions, k_positions, window: int = 0,
                  q_chunk: int = 1024, causal: bool = True):
    """q (B,Sq,H,hd); k,v (B,Sk,KV,hd).  fp32 softmax; q-chunked (default)
    or the flash kernel when enabled + shape-compatible."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    if _BACKEND == "flash" and _flash_ok(q, k, v, q_positions, causal):
        kv_axes = ("batch", None, "kv_heads", None)
        if _expand(kvh, h):
            g = h // kvh
            k = shard_act(k.repeat_interleave(g, dim=2),
                          ("batch", None, "heads", None))
            v = shard_act(v.repeat_interleave(g, dim=2),
                          ("batch", None, "heads", None))
            kv_axes = ("batch", None, "heads", None)
        # each rank folds its own heads: the kernel sees B·H/m rows
        return local_map(functools.partial(_flash, causal=causal,
                                           window=window),
                         (q, k, v), (("batch", None, "heads", None),
                                     kv_axes, kv_axes), out_like=(0,))

    scale = hd ** -0.5
    hd_v = v.shape[-1]
    n_chunks = max(sq // q_chunk, 1)
    ql = sq // n_chunks
    if _expand(kvh, h):
        g = h // kvh
        ke = shard_act(k.repeat_interleave(g, dim=2).float(),
                       ("batch", None, "heads", None))
        ve = shard_act(v.repeat_interleave(g, dim=2),
                       ("batch", None, "heads", None))

        def chunk_e(qc, qpos_c, ke, ve, k_positions):
            s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), ke) * scale
            s = shard_act(s, ("batch", "heads", "seq", "kv_seq"))
            if causal:
                s = s + _mask_bias(qpos_c, k_positions, window)[None, None]
            p = _softmax_fp32(s)
            return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), ve)

        def core_e(q, ke, ve, q_positions, k_positions):
            outs = [chunk_e(qc, pc, ke, ve, k_positions) for qc, pc in
                    zip(q.chunk(n_chunks, dim=1),
                        q_positions.chunk(n_chunks))]
            return outs[0] if n_chunks == 1 else torch.cat(outs, dim=1)

        return _on_local_heads(
            core_e, (q, ke, ve, q_positions, k_positions),
            _head_specs(q, ("batch", "heads", "seq", "kv_seq"),
                        (b, h, ql, k.shape[1])))

    def chunk(qc, qpos_c, kf, v, k_positions):
        # fp32 scores (the reference's preferred_element_type=float32)
        s = torch.einsum("bqkgd,bskd->bkgqs", qc.float(), kf) * scale
        s = shard_act(s, ("batch", "kv_heads", "heads", "seq", "kv_seq"))
        if causal:
            s = s + _mask_bias(qpos_c, k_positions, window)[None, None, None]
        p = _softmax_fp32(s)
        return torch.einsum("bkgqs,bskd->bqkgd", p.to(q.dtype), v)

    def core(q, kf, v, q_positions, k_positions):
        qf = _fold_gqa(q, kf.shape[2])                # (B,Sq,KV,G,hd)
        outs = [chunk(qc, pc, kf, v, k_positions) for qc, pc in
                zip(qf.chunk(n_chunks, dim=1), q_positions.chunk(n_chunks))]
        out = outs[0] if n_chunks == 1 else torch.cat(outs, dim=1)
        return out.reshape(q.shape[0], sq, q.shape[2], hd_v)

    return _on_local_heads(
        core, (q, k.float(), v, q_positions, k_positions),
        _head_specs(q, ("batch", "kv_heads", "heads", "seq", "kv_seq"),
                    (b, kvh, h // kvh, ql, k.shape[1])))


def _head_specs(q, s_axes, s_shape):
    """The specs that run an attention core on each rank's own rows and
    heads where its scores (logical ``s_axes`` (batch, heads or kv_heads,
    ...), shape ``s_shape``) are laid out as ``fake_strided_split``
    allows: q and k/v (B, S, H|KV, hd) split as the scores split their
    dims 0 and 1, the positions ((S,)) whole and the masks ((B, S)) by
    the batch.  Otherwise None, and the core runs on DTensors (or plain
    tensors) as they are."""
    split = fake_strided_split(q, s_axes, s_shape, "attention")
    if split is None:
        return None
    sb, sh = split
    return {"qkv": (sb, None, sh, None), "pos": (None,), "rows": (sb, None)}


def _on_local_heads(core, args, specs, kinds=("qkv", "qkv", "qkv", "pos",
                                              "pos")):
    """``core(*args)`` (the scores, their softmax and the weighted values)
    on each rank's own batch rows and heads through ``local_map``, each
    argument laid out by the entry of ``specs`` its kind names, the result
    laid out as q.  With ``specs`` None, ``core`` runs on the arguments as
    they are."""
    if specs is None:
        return core(*args)
    mesh = ctx_mesh()
    return local_map(core, args, tuple(placements(specs[k], mesh)
                                       for k in kinds), out_like=(0,))


# --------------------------------------------------------------------------
# Train / prefill
# --------------------------------------------------------------------------

def _qkv(cfg: ArchConfig, p, x, positions, policy):
    """Projections, optional q/k norm and rotary.  positions (B?,S)."""
    c = policy.c
    q = torch.einsum("bsd,dhk->bshk", x, c(p["wq"]))
    k = torch.einsum("bsd,dhk->bshk", x, c(p["wk"]))
    v = torch.einsum("bsd,dhk->bshk", x, c(p["wv"]))
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    if cfg.pos_emb == "rope":
        rot = int(cfg.hd * cfg.rope_pct) // 2 * 2
        pos2d = positions if positions.ndim == 2 else positions[None]
        q, k = rope_qk(q, k, pos2d, rot, cfg.rope_theta)
    return q, k, v


def attn_forward(cfg: ArchConfig, p, x, positions, *, window: int = 0,
                 policy=DEFAULT_POLICY, q_chunk: int = 1024,
                 causal: bool = True):
    """Self-attention over x (B,S,D) with per-token positions (B?,S)."""
    q, k, v = _qkv(cfg, p, x, positions, policy)
    pos1d = positions[0] if positions.ndim == 2 else positions
    out = gqa_attention(q, k, v, q_positions=pos1d, k_positions=pos1d,
                        window=window, q_chunk=q_chunk, causal=causal)
    return torch.einsum("bshk,hkd->bsd", out, policy.c(p["wo"]))


def cross_attn_forward(cfg: ArchConfig, p, x, mem, *, policy=DEFAULT_POLICY):
    """Cross-attention (whisper decoder): queries from x (B,Sq,D), keys and
    values from the encoder memory mem (B,Sk,D); non-causal."""
    c = policy.c
    q = torch.einsum("bsd,dhk->bshk", x, c(p["wq"]))
    k = torch.einsum("bsd,dhk->bshk", mem, c(p["wk"]))
    v = torch.einsum("bsd,dhk->bshk", mem, c(p["wv"]))
    sq, sk = x.shape[1], mem.shape[1]
    out = gqa_attention(q, k, v,
                        q_positions=replicate(torch.arange(sq,
                                                           device=x.device)),
                        k_positions=replicate(torch.arange(sk,
                                                           device=x.device)),
                        causal=False, q_chunk=min(1024, sq))
    return torch.einsum("bshk,hkd->bsd", out, c(p["wo"]))


# --------------------------------------------------------------------------
# Decode with KV cache
# --------------------------------------------------------------------------

def kv_cache_defs(cfg: ArchConfig, batch: int, max_seq: int,
                  dtype=torch.bfloat16):
    kv, hd = cfg.n_kv_heads, cfg.hd
    s = min(max_seq, cfg.window) if cfg.window else max_seq
    return {"k": Pm((batch, s, kv, hd), ("batch", "kv_seq", "kv_heads", "head_dim"),
                    init="zeros", dtype=dtype),
            "v": Pm((batch, s, kv, hd), ("batch", "kv_seq", "kv_heads", "head_dim"),
                    init="zeros", dtype=dtype)}


def _write_slots(cache, new, slots):
    """cache (B, S, ...) <- new (B, n, ...) at the slots (B, n), in place;
    returns ``cache``.  On a mesh each rank writes its own window of the
    DTensor cache from its own rows of ``new`` (laid out as the cache,
    seq aside), with no collective.  Where the cache's seq dim is split,
    a rank drops the slots outside its window."""
    s_all, off = cache.shape[1], 0
    mesh = ctx_mesh()
    like = rows = None
    if mesh is not None:
        from torch.distributed.tensor import Replicate, Shard
        places = cache.placements
        off = window(places, tuple(cache.shape), tuple(mesh.shape),
                     mesh.get_coordinate())[1][0]
        # new: the cache's layout with its seq dim whole; the slot table
        # (B, n): its rows split as the cache's
        like = tuple(Replicate() if p.is_shard(1) else p for p in places)
        rows = tuple(Shard(0) if p.is_shard(0) else Replicate()
                     for p in places)

    def write(c, n, sl):
        r = torch.arange(c.shape[0], device=c.device)[:, None]
        if c.shape[1] == s_all:
            c[r, sl] = n
            return
        ls = sl - off
        ok = (ls >= 0) & (ls < c.shape[1])
        # slots outside the window go to a spare slot that is then dropped
        spare = torch.cat([c, c[:, :1]], dim=1)
        spare[r, torch.where(ok, ls, c.shape[1])] = n
        c.copy_(spare[:, :c.shape[1]])

    local_map(write, (cache, new, slots), ("local", like, rows))
    return cache


def _cache_update(cache, new, slot):
    """cache (B,S,KV,hd) <- new (B,1,KV,hd) at per-batch slot (B,).
    Writes IN PLACE (the reference returns an updated copy and donates the
    old buffer; here the old contents are not needed either) and returns
    ``cache``."""
    return _write_slots(cache, new, slot[:, None])


def attn_decode(cfg: ArchConfig, p, x, cache, pos, *, policy=DEFAULT_POLICY):
    """One-token decode.  x (B,1,D); pos (B,) absolute position of the new
    token; cache dict{k,v} (B,S(,window),KV,hd), updated in place.
    Returns (y, cache)."""
    q, k, v = _qkv(cfg, p, x, pos[:, None], policy)

    s_cache = cache["k"].shape[1]
    slot = torch.remainder(pos, s_cache) if cfg.window else pos  # ring buffer
    ck = _cache_update(cache["k"], k.to(cache["k"].dtype), slot)
    cv = _cache_update(cache["v"], v.to(cache["v"].dtype), slot)

    kvh, hd = cfg.n_kv_heads, cfg.hd
    idx = replicate(torch.arange(s_cache, device=pos.device))
    if cfg.window:
        valid = (idx[None] <= slot[:, None]) | (pos[:, None] >= s_cache)
    else:
        valid = idx[None] <= pos[:, None]                     # (B,S)

    h, b = cfg.n_heads, x.shape[0]
    if _expand(kvh, h):
        g = h // kvh
        cke = shard_act(ck.repeat_interleave(g, dim=2),
                        ("batch", "kv_seq", "heads", None))
        cve = shard_act(cv.repeat_interleave(g, dim=2),
                        ("batch", "kv_seq", "heads", None))

        def core_e(q, cke, cve, valid):
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(), cke.float()) * (hd ** -0.5)
            s = shard_act(s, ("batch", "heads", None, "kv_seq"))
            s = torch.where(valid[:, None, None], s, NEG_INF)
            pr = _softmax_fp32(s).to(x.dtype)
            return torch.einsum("bhqk,bkhd->bqhd", pr, cve)

        o = _on_local_heads(core_e, (q, cke, cve, valid), _head_specs(
            q, ("batch", "heads", None, "kv_seq"), (b, h, 1, s_cache)),
            ("qkv", "qkv", "qkv", "rows"))
    else:
        def core(q, ck, cv, valid):
            qf = _fold_gqa(q, ck.shape[2])                    # (B,1,KV,G,hd)
            s = torch.einsum("bqkgd,bskd->bkgqs", qf.float(), ck.float()) * (hd ** -0.5)
            s = shard_act(s, ("batch", "kv_heads", "heads", None, "kv_seq"))
            s = torch.where(valid[:, None, None, None], s, NEG_INF)
            pr = _softmax_fp32(s).to(x.dtype)
            o = torch.einsum("bkgqs,bskd->bqkgd", pr, cv)
            return o.reshape(q.shape[0], 1, q.shape[2], hd)

        o = _on_local_heads(core, (q, ck, cv, valid), _head_specs(
            q, ("batch", "kv_heads", "heads", None, "kv_seq"),
            (b, kvh, h // kvh, 1, s_cache)),
            ("qkv", "qkv", "qkv", "rows"))
    o = o.reshape(x.shape[0], 1, cfg.n_heads, hd)
    y = torch.einsum("bshk,hkd->bsd", o, policy.c(p["wo"]))
    return y, {"k": ck, "v": cv}


def attn_prefill(cfg: ArchConfig, p, x, positions, max_cache: int, *,
                 window: int = 0, policy=DEFAULT_POLICY, q_chunk: int = 1024,
                 into=None):
    """Full-sequence attention that also materializes the decode KV cache
    (post-rope keys, ring-buffer slots for windowed layers).  With ``into``
    (dict{k,v} of (B, S(,window), KV, hd) buffers in the compute dtype) the
    cache is written into it, zeros included, and nothing is allocated
    for it."""
    q, k, v = _qkv(cfg, p, x, positions, policy)
    pos1d = positions[0] if positions.ndim == 2 else positions
    out = gqa_attention(q, k, v, q_positions=pos1d, k_positions=pos1d,
                        window=window, q_chunk=q_chunk)
    y = torch.einsum("bshk,hkd->bsd", out, policy.c(p["wo"]))

    b, s = x.shape[0], x.shape[1]
    s_cache = min(max_cache, window) if window else max_cache
    n_keep = min(s, s_cache)
    slots = (torch.arange(s - n_keep, s, device=x.device) % s_cache)
    slots = replicate(slots[None].expand(b, n_keep))
    cache_dt = x.dtype                      # cache dtype == compute dtype
    if into is None:
        ck = _zeros_like_rows(k, s_cache, cache_dt)
        cv = _zeros_like_rows(v, s_cache, cache_dt)
    else:
        ck, cv = into["k"].zero_(), into["v"].zero_()
    _write_slots(ck, k[:, s - n_keep:].to(cache_dt), slots)
    _write_slots(cv, v[:, s - n_keep:].to(cache_dt), slots)
    return y, {"k": ck, "v": cv}


def _zeros_like_rows(t, n: int, dtype):
    """Zeros of ``t``'s shape with dim 1 of size ``n``, laid out as ``t``
    (a DTensor's dim 1, the sequence, is never split here)."""
    if ctx_mesh() is None:
        return torch.zeros((t.shape[0], n) + tuple(t.shape[2:]), dtype=dtype,
                           device=t.device)
    from torch.distributed.tensor import DTensor
    local = t.to_local()
    z = torch.zeros((local.shape[0], n) + tuple(local.shape[2:]),
                    dtype=dtype, device=local.device)
    return DTensor.from_local(z, t.device_mesh, t.placements,
                              run_check=False)


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2): train/prefill expanded; decode absorbed over the
# compressed cache (the MLA serving path: the cache is (B,S,r)+(B,S,rope)).
# --------------------------------------------------------------------------

def mla_cache_defs(cfg: ArchConfig, batch: int, max_seq: int,
                   dtype=torch.bfloat16):
    m = cfg.mla
    return {"c_kv": Pm((batch, max_seq, m.kv_lora_rank),
                       ("batch", "kv_seq", "kv_lora"), init="zeros", dtype=dtype),
            "k_rope": Pm((batch, max_seq, m.qk_rope_head_dim),
                         ("batch", "kv_seq", "head_dim"), init="zeros",
                         dtype=dtype)}


def _mla_qkv(cfg, p, x, positions, policy):
    """Shared projections.  Returns q_nope (B,S,H,dn), q_rope (B,S,H,dr),
    c_kv (B,S,r) (fp32 RMS-normed, in the compute dtype) and k_rope
    (B,S,dr); rotary on the rope halves only."""
    c = policy.c
    m = cfg.mla
    q = torch.einsum("bsd,dhk->bshk", x, c(p["wq"]))
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    kv_a = x @ c(p["wkv_a"])                                  # (B,S,r+dr)
    c_kv, k_rope = kv_a[..., :m.kv_lora_rank], kv_a[..., m.kv_lora_rank:]
    ckf = c_kv.float()
    var = torch.mean(ckf * ckf, dim=-1, keepdim=True)
    c_kv = (ckf * torch.rsqrt(var + cfg.norm_eps) * p["kv_norm"]).to(x.dtype)
    pos2d = positions if positions.ndim == 2 else positions[None]
    cos, sin = rope_cos_sin(pos2d, m.qk_rope_head_dim, cfg.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_expanded(cfg, p, x, positions, policy, q_chunk):
    """Expand the compressed kv to per-head k, v; standard MHA.  Returns
    (y, c_kv, k_rope)."""
    c = policy.c
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, positions, policy)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, c(p["w_uk"]))
    v = torch.einsum("bsr,rhk->bshk", c_kv, c(p["w_uv"]))
    b, s, h = x.shape[0], x.shape[1], cfg.n_heads
    k_rope_h = k_rope[:, :, None, :].expand(b, s, h, k_rope.shape[-1])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    pos1d = positions[0] if positions.ndim == 2 else positions
    out = gqa_attention(q, k, v, q_positions=pos1d, k_positions=pos1d,
                        q_chunk=q_chunk)
    return torch.einsum("bshk,hkd->bsd", out, c(p["wo"])), c_kv, k_rope


def mla_forward(cfg: ArchConfig, p, x, positions, *, policy=DEFAULT_POLICY,
                q_chunk: int = 1024):
    """Train/prefill: expand compressed kv to per-head k,v; standard MHA."""
    return _mla_expanded(cfg, p, x, positions, policy, q_chunk)[0]


def mla_prefill(cfg: ArchConfig, p, x, positions, max_cache: int, *,
                policy=DEFAULT_POLICY, q_chunk: int = 1024, into=None):
    """Full-sequence MLA that also fills the compressed decode cache.  With
    ``into`` (dict{c_kv, k_rope} of (B, max_cache, r|dr) buffers in the
    compute dtype) the cache is written into it, zeros included, and
    nothing is allocated for it."""
    m = cfg.mla
    y, c_kv, k_rope = _mla_expanded(cfg, p, x, positions, policy, q_chunk)
    b, s = x.shape[0], x.shape[1]
    cache_dt = x.dtype
    if into is None:
        ckv = _zeros_like_rows(c_kv, max_cache, cache_dt)
        ckr = _zeros_like_rows(k_rope, max_cache, cache_dt)
    else:
        ckv, ckr = into["c_kv"].zero_(), into["k_rope"].zero_()
    ckv[:, :s] = c_kv.to(cache_dt)
    ckr[:, :s] = k_rope.to(cache_dt)
    return y, {"c_kv": ckv, "k_rope": ckr}


def mla_decode(cfg: ArchConfig, p, x, cache, pos, *, policy=DEFAULT_POLICY):
    """Absorbed decode: score and combine directly in the r-dim latent
    space.  x (B,1,D); pos (B,); cache dict{c_kv, k_rope}, updated in
    place.  Returns (y, cache)."""
    c = policy.c
    m = cfg.mla
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(cfg, p, x, pos[:, None],
                                                    policy)
    ckv, ckr = cache["c_kv"], cache["k_rope"]
    _write_slots(ckv, c_kv_new.to(ckv.dtype), pos[:, None])
    _write_slots(ckr, k_rope_new.to(ckr.dtype), pos[:, None])

    # absorb: q' = q_nope @ w_uk -> (B,1,H,r); fp32 scores vs the cache
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, c(p["w_uk"]))
    s = torch.einsum("bshr,btr->bhst", q_abs.float(), ckv.float())
    s = s + torch.einsum("bshk,btk->bhst", q_rope.float(), ckr.float())
    s = s * (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s = shard_act(s, ("batch", "heads", None, "kv_seq"))
    valid = replicate(torch.arange(ckv.shape[1], device=x.device))[None] \
        <= pos[:, None]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    pr = _softmax_fp32(s).to(x.dtype)
    ctx = torch.einsum("bhst,btr->bshr", pr, ckv)             # (B,1,H,r)
    out = torch.einsum("bshr,rhk->bshk", ctx, c(p["w_uv"]))
    y = torch.einsum("bshk,hkd->bsd", out, c(p["wo"]))
    return y, {"c_kv": ckv, "k_rope": ckr}
