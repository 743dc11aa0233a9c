"""The two configured architectures in plain float32 PyTorch.

``llama`` (SmolLM-135M): RMSNorm, rotary embeddings on the whole head
(the half-split rotation of HF's ``rotate_half``), grouped-query causal
attention (query head h reads key/value head h // (H / KV)), a SwiGLU
MLP, the embedding tied to the head.

``deepseek_v2`` (DeepSeek-V2-Lite): MLA without a query LoRA (q = x Wq;
the latent c = RMSNorm(x W_kv_a[:r]); k = [c W_uk, rope(x W_kv_a[r:])]
with the rope part shared by every head; v = c W_uv; scale
(d_nope + d_rope)^-1/2), the first layer a dense SwiGLU MLP, every other
layer a MoE: softmax router, greedy top-k, the top-k probabilities as the
gates (not renormalised), two shared experts as one MLP of twice the
expert width, and GShard capacity per group of tokens: within each group
of one call's tokens, a token keeps an expert while fewer than
``capacity`` earlier tokens of the group chose it, ``capacity = min(g,
max(1, int(g k f / E) + 1))`` for a group of g tokens and the capacity
factor f.  The rope dims are rotated half-split; HF's interleaved layout
is the same map with the rope columns of Wq and W_kv_a permuted, which
random weights do not tell apart.

Departures, each set in the configuration file: no YaRN scaling
(``rope_scaling`` null), the capacity factor.  The weights are the tree
the benchmark drew (``system.make_weights``), read by its keys.

``Prec("fp8")`` is the control: every product's two inputs rounded to
float8 e4m3 with one scale a tensor (its largest magnitude over 448)
before the float32 product, and in training the gradient that reaches
each of them rounded to e5m2 the same way (the fp8 training recipe).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _round(x, dtype, top):
    """``x`` rounded to the float8 ``dtype`` under one per-tensor scale (its
    largest magnitude maps to ``top``), back in float32."""
    s = x.abs().amax().clamp_min(1e-30) / top
    return (x / s).to(dtype).float() * s


class _Fp8(torch.autograd.Function):
    """Forward: e4m3 (the activations' and weights' format of fp8
    training); backward: the incoming gradient in e5m2 (the gradients'
    format), each under its own per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _round(x.float(), torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g.float(), torch.float8_e5m2, 57344.0)


def q8(x):
    """``x`` rounded as fp8 training rounds a product's input."""
    return _Fp8.apply(x)


class Prec:
    """float32 products, or (``"fp8"``) products of fp8-rounded inputs."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(name)
        self.fp8 = name == "fp8"

    def _in(self, *xs):
        return [q8(x) if self.fp8 else x.float() for x in xs]

    def mm(self, a, b):
        a, b = self._in(a, b)
        return a @ b

    def ein(self, eq, a, b):
        a, b = self._in(a, b)
        return torch.einsum(eq, a, b)


FP32 = Prec("fp32")


def rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x (R, S, H, d) at positions pos (S,): half-split rotation."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                       device=x.device) / half)
    ang = pos.double()[:, None] * inv[None]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, scale, prec):
    """q, k (R, S, H, dk), v (R, S, H, dv) -> (R, S, H, dv)."""
    s = prec.ein("rqhd,rkhd->rhqk", q, k) * scale
    n = q.shape[1]
    keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return prec.ein("rhqk,rkhd->rqhd", p, v)


def mlp(w, x, prec):
    return prec.mm(F.silu(prec.mm(x, w["wg"])) * prec.mm(x, w["wi"]),
                   w["wo"])


def gqa(hf, w, x, pos, prec):
    r, s, d = x.shape
    h, kv = hf["num_attention_heads"], hf["num_key_value_heads"]
    hd = hf.get("head_dim") or d // h
    q = prec.mm(x, w["wq"].reshape(d, -1)).view(r, s, h, hd)
    k = prec.mm(x, w["wk"].reshape(d, -1)).view(r, s, kv, hd)
    v = prec.mm(x, w["wv"].reshape(d, -1)).view(r, s, kv, hd)
    q, k = rope(q, pos, hf["rope_theta"]), rope(k, pos, hf["rope_theta"])
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    o = causal_attention(q, k, v, hd ** -0.5, prec)
    return prec.mm(o.reshape(r, s, h * hd), w["wo"].reshape(h * hd, d))


def mla(hf, w, x, pos, prec):
    r, s, d = x.shape
    h = hf["num_attention_heads"]
    dn, dr = hf["qk_nope_head_dim"], hf["qk_rope_head_dim"]
    dv, lr = hf["v_head_dim"], hf["kv_lora_rank"]
    q = prec.mm(x, w["wq"].reshape(d, -1)).view(r, s, h, dn + dr)
    kv = prec.mm(x, w["wkv_a"])
    c = rms(kv[..., :lr], w["kv_norm"], hf["rms_norm_eps"])
    k_rope = rope(kv[..., lr:][:, :, None, :], pos, hf["rope_theta"])
    q_rope = rope(q[..., dn:], pos, hf["rope_theta"])
    k_nope = prec.mm(c, w["w_uk"].reshape(lr, -1)).view(r, s, h, dn)
    v = prec.mm(c, w["w_uv"].reshape(lr, -1)).view(r, s, h, dv)
    qf = torch.cat([q[..., :dn], q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(r, s, h, dr)], dim=-1)
    o = causal_attention(qf, kf, v, (dn + dr) ** -0.5, prec)
    return prec.mm(o.reshape(r, s, h * dv), w["wo"].reshape(h * dv, d))


def capacity(g: int, hf: dict) -> int:
    e, k = hf["n_routed_experts"], hf["num_experts_per_tok"]
    return max(min(int(g * k * hf["capacity_factor"] / e) + 1, g), 1)


def moe(hf, w, x, groups, prec, routes=None):
    """x (R, S, D); ``groups``: (start, length) of each group of positions
    (the same for every row).  Appends the top-k indices (R, S, k) to
    ``routes``."""
    r, s, d = x.shape
    e, k = hf["n_routed_experts"], hf["num_experts_per_tok"]
    xt = x.reshape(-1, d)
    probs = torch.softmax(prec.mm(xt, w["router"]), dim=-1)
    gv, gi = torch.topk(probs, k, dim=-1)
    if routes is not None:
        routes.append(gi.view(r, s, k).detach())
    chosen = torch.zeros_like(probs).scatter_(1, gi, 1.0)
    keep = chosen.clone().view(r, s, e)
    for s0, g in groups:
        ahead = torch.cumsum(chosen.view(r, s, e)[:, s0:s0 + g], dim=1) - 1
        keep[:, s0:s0 + g] *= (ahead < capacity(g, hf)).float()
    gates = torch.zeros_like(probs).scatter(1, gi, gv) * keep.view(-1, e)
    y = torch.zeros_like(xt)
    for j in range(e):
        idx = torch.nonzero(keep.view(-1, e)[:, j])[:, 0]
        if idx.numel() == 0:
            continue
        xe = xt[idx]
        out = prec.mm(F.silu(prec.mm(xe, w["wg"][j])) * prec.mm(xe, w["wi"][j]),
                      w["wo"][j])
        y = y.index_add(0, idx, out * gates[idx, j:j + 1])
    y = y + mlp(w["shared"], xt, prec)
    return y.view(r, s, d)


def layers(params):
    """Each block's weights in order: ``(is_moe, tree)``; a stacked
    layer's leaves are views of its slice (one ``unbind`` a leaf, so that
    autograd stacks the layers' gradients once)."""
    units = params["units"]["b0"]
    is_moe = "router" in units["mlp"]
    return ([(False, b) for b in params.get("prefix", [])]
            + [(is_moe, u) for u in _unstack(units)])


def _unstack(tree):
    if isinstance(tree, dict):
        per = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(tree.unbind(0))


def as_f32(tree):
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    return tree.float()


def block(hf, w, x, pos, groups, prec, is_moe, routes=None):
    """One pre-norm block over x (R, S, D), float32 weights ``w``."""
    eps = hf["rms_norm_eps"]
    attn = mla if hf["model_type"] == "deepseek_v2" else gqa
    x = x + attn(hf, w["attn"], rms(x, w["ln1"]["scale"], eps), pos, prec)
    h = rms(x, w["ln2"]["scale"], eps)
    if is_moe:
        return x + moe(hf, w["mlp"], h, groups, prec, routes)
    return x + mlp(w["mlp"], h, prec)


def head(hf, params, x, prec):
    x = rms(x, params["final"]["scale"].float(), hf["rms_norm_eps"])
    emb = params["embed"]
    w = (emb["embedding"].float().T if hf.get("tie_word_embeddings")
         else emb["lm_head"].float())
    return prec.mm(x, w)


def logits_at(hf, params, tokens, at, groups, *, prec=FP32, rows=8,
              routes=None):
    """Logits (R, len(at), V) at positions ``at`` of the sequences
    ``tokens`` (R, S), under no autograd; layer by layer (each layer's
    weights made float32 once) and ``rows`` sequences at a time.
    ``routes``, a list, gets each MoE layer's top-k indices (R, S, k)."""
    with torch.no_grad():
        tokens = tokens.long()
        r, s = tokens.shape
        pos = torch.arange(s, device=tokens.device)
        x = params["embed"]["embedding"][tokens].float()
        for is_moe, w in layers(params):
            w = as_f32(w)
            got = []
            for r0 in range(0, r, rows):
                x[r0:r0 + rows] = block(hf, w, x[r0:r0 + rows], pos, groups,
                                        prec, is_moe, got if is_moe else None)
            if is_moe and routes is not None:
                routes.append(torch.cat(got))
            del w
        at = torch.as_tensor(at, device=tokens.device)
        return torch.cat([head(hf, params, x[r0:r0 + rows][:, at], prec)
                          for r0 in range(0, r, rows)])


def groups(hf, s: int) -> list:
    """The MoE capacity groups (start, length) of one call of ``s`` tokens,
    as the program splits them: groups of the configuration's
    ``moe_group_size`` tokens, or one of the whole call where that is
    shorter or the model has no experts."""
    g = min(hf.get("moe_group_size") or s, s)
    return [(g0, g) for g0 in range(0, s, g)]


def loss(hf, params, tokens, targets, *, prec=FP32):
    """Mean token cross-entropy of (R, S) ``tokens`` against ``targets``,
    float32, differentiable in ``params`` (float32 leaves)."""
    tokens = tokens.long()
    s = tokens.shape[1]
    pos = torch.arange(s, device=tokens.device)
    groups_ = groups(hf, s)
    x = params["embed"]["embedding"][tokens]
    for is_moe, w in layers(params):
        x = block(hf, w, x, pos, groups_, prec, is_moe)
    lg = head(hf, params, x, prec)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           targets.long().reshape(-1))


def gap(logits, token):
    """How far each served ``token``'s logit lies below the row's best."""
    return logits.max(dim=-1).values - logits.gather(
        -1, token.long()[..., None])[..., 0]

