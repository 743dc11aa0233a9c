"""Shared neural-net layers (torch twin of ``repro.models.layers``).

Conventions:
  * params stored fp32 (Pm.dtype), compute in ``policy.compute`` (bf16),
    normalization/softmax statistics in fp32.
  * all ops take/return (B, S, ...) activations.
Biases are omitted, as in the reference.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import replicate, shard_act
from repro_torch.models.params import Pm, tree_map


@dataclass(frozen=True)
class Policy:
    compute: torch.dtype = torch.bfloat16
    param: torch.dtype = torch.float32

    def c(self, x):
        return x.to(self.compute)

    def cast_params(self, params):
        """Cast once, at load, every leaf that the model only reads through
        ``c`` (the matmul weights and embeddings: every leaf of two or more
        dims).  ``c`` is then a no-op on them and gives the same values.
        Norm scales (1-D) enter fp32 statistics and stay as stored."""
        return tree_map(lambda x: self.c(x) if x.ndim >= 2 else x, params)


DEFAULT_POLICY = Policy()


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def norm_defs(cfg: ArchConfig, d: int | None = None):
    d = d or cfg.d_model
    if cfg.norm == "rms":
        return {"scale": Pm((d,), ("embed",), init="ones")}
    return {"scale": Pm((d,), ("embed",), init="ones"),
            "bias": Pm((d,), ("embed",), init="zeros")}


def apply_norm(cfg: ArchConfig, p, x, policy=DEFAULT_POLICY):
    xf = x.float()
    if cfg.norm == "rms":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * p["scale"] + p["bias"]
    return y.to(policy.compute)


def rms_head_norm(x, scale, eps=1e-5):
    """Per-head q/k norm (stablelm-2): normalize over head_dim."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings, computed on the fly from positions
# --------------------------------------------------------------------------

def rope_cos_sin(positions, rot_dim: int, theta: float):
    """positions (...,) int -> cos/sin (..., rot_dim//2) fp32."""
    half = rot_dim // 2
    exponent = replicate(torch.arange(half, dtype=torch.float32,
                                      device=positions.device)) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, hd_rot); cos/sin broadcastable (..., S, 1, hd_rot//2).
    NeoX-style half-split rotation."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    o1 = xf1 * cos - xf2 * sin
    o2 = xf2 * cos + xf1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


def rope_qk(q, k, positions, rot_dim, theta):
    """Apply partial rotary to q,k given per-token positions (B,S)."""
    cos, sin = rope_cos_sin(positions, rot_dim, theta)   # (B,S,half)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]    # broadcast heads
    if rot_dim == q.shape[-1]:
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    q_rot = apply_rope(q[..., :rot_dim], cos, sin)
    k_rot = apply_rope(k[..., :rot_dim], cos, sin)
    q = torch.cat([q_rot, q[..., rot_dim:]], dim=-1)
    k = torch.cat([k_rot, k[..., rot_dim:]], dim=-1)
    return q, k


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def residual(x, y):
    """``x + y``, ``y`` a row-parallel product's output (an attention or
    MLP output projection): on a mesh its partial sums are reduced first,
    so the residual stream stays whole on every model rank.  (Added as it
    comes, DTensor would carry the sum partial and reduce it again at
    every later read.)"""
    return x + shard_act(y, ("batch", "seq", "embed"))


def mlp_defs(cfg: ArchConfig, d_ff: int | None = None, ff_axis: str = "ffn"):
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    if cfg.mlp in ("swiglu", "geglu"):
        return {"wi": Pm((d, f), ("embed", ff_axis)),
                "wg": Pm((d, f), ("embed", ff_axis)),
                "wo": Pm((f, d), (ff_axis, "embed"))}
    return {"wi": Pm((d, f), ("embed", ff_axis)),
            "wo": Pm((f, d), (ff_axis, "embed"))}


def _act(cfg: ArchConfig, x):
    if cfg.act == "gelu" or cfg.mlp in ("gelu", "geglu"):
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    return F.silu(x)


def apply_mlp(cfg: ArchConfig, p, x, policy=DEFAULT_POLICY):
    c = policy.c
    h = x @ c(p["wi"])
    if cfg.mlp in ("swiglu", "geglu"):
        h = _act(cfg, x @ c(p["wg"])) * h
    else:
        h = _act(cfg, h)
    return h @ c(p["wo"])


# --------------------------------------------------------------------------
# Embedding / LM head
# --------------------------------------------------------------------------

def embed_defs(cfg: ArchConfig):
    d = {"embedding": Pm((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                         scale=1.0)}
    if not cfg.tie_embeddings:
        d["lm_head"] = Pm((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return d


def embed_tokens(cfg, p, tokens, policy=DEFAULT_POLICY):
    """The reference's ``jnp.take``.  ``F.embedding`` is the same gather;
    on a vocab-sharded table it stays vocab-parallel (each rank looks up
    the tokens in its rows, the rest is summed in by ``shard_act``), where
    indexing would gather the whole table."""
    return policy.c(F.embedding(tokens, p["embedding"]))


def lm_logits(cfg, p, x, policy=DEFAULT_POLICY):
    w = p["embedding"].T if cfg.tie_embeddings else p["lm_head"]
    return x @ policy.c(w)


@functools.lru_cache(maxsize=8)
def sincos_table(n: int, d: int, device=None):
    """Fixed sinusoidal embeddings (whisper encoder), (n, d) fp32: computed
    in numpy float64 and then cast, as the reference's.  Kept per (n, d,
    device): a captured prefill reads the table its warm-up copied to the
    card (a copy from the host cannot be captured).  Read-only."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(table.astype(np.float32), device=device)
