"""xLSTM blocks (torch twin of ``repro.models.xlstm``): mLSTM (matrix
memory, chunkwise-parallel form) and sLSTM (scalar memory, recurrent scan)
-- arXiv:2405.04517.

Both blocks are self-contained (carry their own up/down projections; the
config sets d_ff=0).  A full sequence runs the stabilized chunkwise mLSTM
(intra-chunk attention-like products + the inter-chunk carried state) as a
Python loop over chunks of ``min(CHUNK, S)``, where the reference scans
them; decode is the O(1) recurrent update.  The sLSTM is a loop over time
in both, as in the reference's ``lax.scan``.  No TPU kernel computes
either, so both are plain torch.

State shapes (per layer):
  mlstm: conv (B,cw-1,di)  C (B,H,hd,hd)  n (B,H,hd)  m (B,H)
  slstm: c,n,h,m (B,H,hd)
The conv window is held in the compute dtype, the rest in fp32.

``mlstm_decode`` updates its state in place (C is (B, 4, 1024, 1024)
fp32 a layer at full width: a new one a step would be a copy of it);
``slstm_decode`` returns a new state, as ``rglru_decode`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (is_dtensor, local_map,
                                              replicate, shard_act)
from repro_torch.models.layers import (DEFAULT_POLICY, Pm, apply_norm,
                                       norm_defs, residual)

CHUNK = 256


def _di(cfg):          # mLSTM inner width
    return int(cfg.proj_factor * cfg.d_model)


def _hd(cfg):          # per-head inner dim
    return _di(cfg) // cfg.n_heads


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def mlstm_defs(cfg: ArchConfig):
    d, di, h = cfg.d_model, _di(cfg), cfg.n_heads
    cw = cfg.conv_width
    return {
        "norm": norm_defs(cfg),
        "wup": Pm((d, 2 * di), ("embed", "ffn")),
        "wconv": Pm((cw, di), ("window", "ffn")),
        # block-diagonal per-head qkv, as the reference's
        "wq": Pm((h, _hd(cfg), _hd(cfg)), ("heads", None, None)),
        "wk": Pm((h, _hd(cfg), _hd(cfg)), ("heads", None, None)),
        "wv": Pm((h, _hd(cfg), _hd(cfg)), ("heads", None, None)),
        "wgate": Pm((di, 2 * h), ("ffn", "heads"), scale=0.1),
        "hnorm": Pm((di,), ("ffn",), init="ones"),
        "wdown": Pm((di, d), ("ffn", "embed")),
    }


def _causal_conv(u, w, state=None):
    """Depthwise causal conv. u (B,S,F), w (cw,F). state (B,cw-1,F) or None."""
    cw = w.shape[0]
    # zeros_like: on a mesh the pad is laid out as u
    pad = state if state is not None else torch.zeros_like(
        u[:, :1]).expand(-1, cw - 1, -1)
    up = torch.cat([pad, u], dim=1)
    out = sum(up[:, i:i + u.shape[1]] * w[i] for i in range(cw))
    return out, up[:, -(cw - 1):]                    # (B,S,F), new state


def _logsigmoid(x):
    """``F.logsigmoid``; on a DTensor elementwise on each rank's shard
    (``local_map``): DTensor has no sharding rule for its backward."""
    if not is_dtensor(x):
        return F.logsigmoid(x)
    from torch.distributed.tensor import Replicate
    places = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return local_map(F.logsigmoid, (x,), (places,), out_like=(0,))


def _heads(x, h):
    b, s, di = x.shape
    return x.reshape(b, s, h, di // h)


def _mlstm_gates(cfg, p, xc, policy):
    g = (xc @ policy.c(p["wgate"])).float()                  # (B,S,2H)
    h = cfg.n_heads
    return g[..., :h], _logsigmoid(g[..., h:])              # logi, logf


def _mlstm_in(cfg, p, x, conv_state, policy):
    """Norm, up-projection, conv and the per-head q, k, v and gates.
    Returns (q, k, v (B,S,H,hd), logi, logf (B,S,H) fp32, z, new conv)."""
    c = policy.c
    h, hd = cfg.n_heads, _hd(cfg)
    xi = apply_norm(cfg, p["norm"], x, policy)
    up = xi @ c(p["wup"])
    xm, z = up[..., :_di(cfg)], up[..., _di(cfg):]
    xc, new_conv = _causal_conv(xm, c(p["wconv"]), conv_state)
    xc = F.silu(xc)
    xch, xmh = _heads(xc, h), _heads(xm, h)
    q = torch.einsum("bshd,hde->bshe", xch, c(p["wq"])) * (hd ** -0.5)
    k = torch.einsum("bshd,hde->bshe", xch, c(p["wk"]))
    v = torch.einsum("bshd,hde->bshe", xmh, c(p["wv"]))
    logi, logf = _mlstm_gates(cfg, p, xc, policy)
    return q, k, v, logi, logf, z, new_conv


def _mlstm_out(cfg, p, x, hout, z, policy):
    """hout (B,S,H*hd) in the compute dtype -> the block's output."""
    hn = hout.float()
    var = torch.mean(hn * hn, dim=-1, keepdim=True)
    hout = (hn * torch.rsqrt(var + cfg.norm_eps) * p["hnorm"]).to(
        policy.compute)
    return residual(x, (hout * F.silu(z)) @ policy.c(p["wdown"]))


def _chunk_step(C, n, m, qc, kc, vc, li, lf):
    """One chunk of the stabilized chunkwise form (the reference's
    ``chunk_step``).  qc, kc, vc (B,L,H,hd); li, lf (B,L,H) fp32; the
    carry C (B,H,hd,hd), n (B,H,hd), m (B,H) fp32.  Returns the new carry
    and the chunk's output (B,L,H,hd) fp32."""
    L = qc.shape[1]
    Fc = torch.cumsum(lf, dim=1)                             # inclusive
    # decay of (k_j, v_j) arriving at i: F_i - F_j + li_j (j <= i)
    Dij = Fc[:, :, None] - Fc[:, None, :] + li[:, None, :]   # (B,L,L,H)
    causal = replicate(torch.tril(torch.ones(
        (L, L), dtype=torch.bool, device=qc.device)))[None, :, :, None]
    Dij = torch.where(causal, Dij, -torch.inf)
    m_intra = torch.amax(Dij, dim=2)                         # (B,L,H)
    m_inter = Fc + m[:, None]
    mi = torch.maximum(m_intra, m_inter)
    qf, kf, vf = qc.float(), kc.float(), vc.float()
    # fp32 scores (the reference's preferred_element_type=float32)
    sc = torch.einsum("blhd,bjhd->bljh", qf, kf)
    w = sc * torch.exp(torch.where(torch.isfinite(Dij), Dij, -1e30)
                       - mi[:, :, None])
    w = torch.where(causal, w, 0.0)
    inter_scale = torch.exp(m_inter - mi)                    # (B,L,H)
    h_intra = torch.einsum("bljh,bjhd->blhd", w, vf)
    h_inter = torch.einsum("blhd,bhdk->blhk", qf, C) * inter_scale[..., None]
    norm_intra = torch.sum(w, dim=2)
    norm_inter = torch.einsum("blhd,bhd->blh", qf, n) * inter_scale
    denom = torch.maximum(torch.abs(norm_intra + norm_inter), torch.exp(-mi))
    hout = (h_intra + h_inter) / denom[..., None]
    # the carry into the next chunk
    Ftot = Fc[:, -1]                                         # (B,H)
    m_next = torch.maximum(Ftot + m, torch.amax(Ftot[:, None] - Fc + li,
                                                dim=1))
    scale_old = torch.exp(Ftot + m - m_next)
    wj = torch.exp(Ftot[:, None] - Fc + li - m_next[:, None])   # (B,L,H)
    C_new = C * scale_old[..., None, None] + torch.einsum(
        "bjhd,bjhk->bhdk", kf * wj[..., None], vf)
    n_new = n * scale_old[..., None] + torch.einsum("bjhd,bjh->bhd", kf, wj)
    return C_new, n_new, m_next, hout


def mlstm_apply(cfg: ArchConfig, p, x, policy=DEFAULT_POLICY, state=None):
    """Full-sequence mLSTM block.  Returns (y, new_state).  S must be at
    most CHUNK or a multiple of it, as the reference asserts."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, _hd(cfg)
    q, k, v, logi, logf, z, new_conv = _mlstm_in(
        cfg, p, x, None if state is None else state["conv"], policy)
    if state is None:
        # zeros_like: on a mesh the carry is laid out as q's heads
        n = torch.zeros_like(q[:, 0], dtype=torch.float32)          # (B,H,hd)
        C = n[..., None].expand(-1, -1, -1, hd).contiguous()
        m = torch.full_like(n[..., 0], -1e30)
    else:
        C, n, m = state["C"], state["n"], state["m"]

    L = min(CHUNK, s)
    assert s % L == 0, (s, L)
    hs = []
    for i in range(0, s, L):
        C, n, m, hout = _chunk_step(C, n, m, q[:, i:i + L], k[:, i:i + L],
                                    v[:, i:i + L], logi[:, i:i + L],
                                    logf[:, i:i + L])
        hs.append(hout)
    hseq = torch.cat(hs, dim=1).reshape(b, s, h * hd).to(policy.compute)
    y = _mlstm_out(cfg, p, x, hseq, z, policy)
    return y, {"conv": new_conv, "C": C, "n": n, "m": m}


def mlstm_decode(cfg: ArchConfig, p, x, state, policy=DEFAULT_POLICY):
    """One-token recurrent update; x (B,1,D).  The state's tensors are
    updated in place and returned: C is scaled and takes the new outer
    product where it lies, as the reference's donated cache would."""
    b = x.shape[0]
    h, hd = cfg.n_heads, _hd(cfg)
    q, k, v, logi, logf, z, new_conv = _mlstm_in(cfg, p, x, state["conv"],
                                                 policy)
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    li, lf = logi[:, 0], logf[:, 0]                          # (B,H)
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    fp = torch.exp(lf + m - m_new)[..., None]
    ip = torch.exp(li - m_new)[..., None]
    C.mul_(fp[..., None]).addcmul_((ip * k)[..., None], v[:, :, None, :])
    n.mul_(fp).add_(ip * k)
    m.copy_(m_new)
    state["conv"].copy_(new_conv)
    num = torch.einsum("bhd,bhdk->bhk", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)),
                        torch.exp(-m_new))
    hout = (num / den[..., None]).reshape(b, 1, h * hd).to(policy.compute)
    return _mlstm_out(cfg, p, x, hout, z, policy), state


def mlstm_state_defs(cfg: ArchConfig, batch: int, dtype=torch.bfloat16):
    """The carry: the conv window in the compute ``dtype``, C, n and m in
    fp32, m initialised to zeros as the reference's (``mlstm_apply`` with
    no state starts from m = -1e30 instead)."""
    di, h, hd, cw = _di(cfg), cfg.n_heads, _hd(cfg), cfg.conv_width
    return {
        "conv": Pm((batch, cw - 1, di), ("batch", None, "ffn"),
                   init="zeros", dtype=dtype),
        "C": Pm((batch, h, hd, hd), ("batch", "heads", None, None),
                init="zeros", dtype=torch.float32),
        "n": Pm((batch, h, hd), ("batch", "heads", None),
                init="zeros", dtype=torch.float32),
        "m": Pm((batch, h), ("batch", "heads"), init="zeros",
                dtype=torch.float32),
    }


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def slstm_defs(cfg: ArchConfig):
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    f = int(d * 4 / 3) // 2 * 2
    return {
        "norm": norm_defs(cfg),
        "wx": Pm((d, 4 * d), ("embed", "ffn")),
        "r": Pm((4, h, hd, hd), (None, "heads", None, None), scale=0.5),
        "hnorm": Pm((d,), ("embed",), init="ones"),
        "norm2": norm_defs(cfg),
        "ffn_wi": Pm((d, f), ("embed", "ffn")),
        "ffn_wg": Pm((d, f), ("embed", "ffn")),
        "ffn_wo": Pm((f, d), ("ffn", "embed")),
    }


def _r_heads(r):
    """The recurrent weights r (4,H,hd,hd) laid out once as (H, hd, 4*hd)
    fp32, so that each step's recurrent product is one batched matmul
    over the heads.  (An einsum over r in its own layout copies all of r,
    16 MiB at full width, into that layout on every step.)"""
    g, h, hd, _ = r.shape
    return r.float().permute(1, 2, 0, 3).reshape(h, hd, g * hd)


def _slstm_cell(gx, state, rr):
    """gx (B,4,H,hd) fp32 input gates; state dict; rr the recurrent
    weights as ``_r_heads`` lays them out.  The reference's cell, its
    recurrent einsum ``bhd,ghde->bghe`` as a matmul over the heads."""
    cs, ns, hs, ms = state["c"], state["n"], state["h"], state["m"]
    b, h, hd = hs.shape
    rec = torch.matmul(hs.transpose(0, 1), rr)              # (H,B,4*hd)
    g = gx + rec.view(h, b, 4, hd).permute(1, 2, 0, 3)      # (B,4,H,hd)
    gi, gf, gz, go = g.unbind(1)
    logf = _logsigmoid(gf)
    m_new = torch.maximum(logf + ms, gi)
    ip = torch.exp(gi - m_new)
    fp = torch.exp(logf + ms - m_new)
    c_new = fp * cs + ip * torch.tanh(gz)
    n_new = torch.clamp_min(fp * ns + ip, 1e-6)
    h_new = torch.sigmoid(go) * (c_new / n_new)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_apply(cfg: ArchConfig, p, x, policy=DEFAULT_POLICY, state=None):
    """Full-sequence sLSTM block, a loop over time, then its gated FFN.
    Returns (y, new_state)."""
    c = policy.c
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    xi = apply_norm(cfg, p["norm"], x, policy)
    gx = (xi @ c(p["wx"])).reshape(b, s, 4, h, hd).float()
    # on a mesh wx's split of 4·d lands on the gate dim: each rank takes
    # all four gates of its own heads, as its recurrent weights are split
    gx = shard_act(gx, ("batch", None, None, "heads", None))
    if state is None:
        zero = torch.zeros_like(gx[:, 0, 0])        # (B,H,hd), laid as gx
        state = {"c": zero, "n": zero + 1e-6, "h": zero,
                 "m": torch.full_like(zero, -1e30)}
    rr = _r_heads(p["r"])
    hs = []
    for t in range(s):
        state = _slstm_cell(gx[:, t], state, rr)
        hs.append(state["h"])
    hseq = torch.stack(hs, dim=1).reshape(b, s, d)
    hn = hseq * torch.rsqrt(torch.mean(hseq * hseq, dim=-1, keepdim=True)
                            + cfg.norm_eps)
    y = residual(x, (hn * p["hnorm"]).to(policy.compute))
    # gated FFN (4/3), GELU in jax.nn.gelu's default tanh form
    xj = apply_norm(cfg, p["norm2"], y, policy)
    ff = (F.gelu(xj @ c(p["ffn_wg"]), approximate="tanh")
          * (xj @ c(p["ffn_wi"]))) @ c(p["ffn_wo"])
    return residual(y, ff), state


def slstm_decode(cfg: ArchConfig, p, x, state, policy=DEFAULT_POLICY):
    return slstm_apply(cfg, p, x, policy, state)


def slstm_state_defs(cfg: ArchConfig, batch: int, dtype=torch.bfloat16):
    """c, n, h, m in fp32 whatever ``dtype`` (taken for the signature of
    the other ``*_state_defs``); n initialised to ones and m to zeros, as
    the reference's (``slstm_apply`` with no state starts from n = 1e-6
    and m = -1e30 instead)."""
    h = cfg.n_heads
    hd = cfg.d_model // h

    def mk(init):
        return Pm((batch, h, hd), ("batch", "heads", None), init=init,
                  dtype=torch.float32)

    return {"c": mk("zeros"), "n": mk("ones"), "h": mk("zeros"),
            "m": mk("zeros")}
