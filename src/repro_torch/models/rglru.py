"""RG-LRU recurrent block (torch twin of ``repro.models.rglru``;
RecurrentGemma / Griffin, arXiv:2402.19427).

Layer = pre-norm recurrent mixer (causal conv + gated linear recurrence)
+ pre-norm GeGLU MLP, both residual.  Prefill computes the recurrence with
the selected backend; decode is the O(1) update.

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t),
a_t = exp(-c * softplus(L) * r_t),  r/i = sigmoid(linear(u_t)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import local_map, shard_act
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ref_rglru
from repro_torch.models.layers import (DEFAULT_POLICY, Pm, apply_mlp,
                                       apply_norm, mlp_defs, norm_defs,
                                       residual)
from repro_torch.models.xlstm import _causal_conv

RG_C = 8.0

#: "scan" (plain torch, log-depth; default, as the reference always scans)
#: or "kernel" (``kernels.ops.rglru``: the hand-written kernel on CUDA, its
#: plain version on the CPU).  The reference never calls its recurrence
#: kernel from the model; this switch is where the port does.
_BACKEND = "scan"


def set_recurrence_backend(name: str) -> None:
    global _BACKEND
    assert name in ("scan", "kernel"), name
    _BACKEND = name


def get_recurrence_backend() -> str:
    return _BACKEND


def _dr(cfg):
    return cfg.d_rnn or cfg.d_model


def rglru_defs(cfg: ArchConfig):
    d, dr, cw = cfg.d_model, _dr(cfg), cfg.conv_width
    return {
        "norm": norm_defs(cfg),
        "wx": Pm((d, dr), ("embed", "d_rnn")),
        "wg": Pm((d, dr), ("embed", "d_rnn")),
        "wconv": Pm((cw, dr), ("window", "d_rnn")),
        "w_r": Pm((dr, dr), (None, "d_rnn"), scale=0.5),
        "w_i": Pm((dr, dr), (None, "d_rnn"), scale=0.5),
        "lam": Pm((dr,), ("d_rnn",), init="ones"),
        "wo": Pm((dr, d), ("d_rnn", "embed")),
        "norm2": norm_defs(cfg),
        "mlp": mlp_defs(cfg),
    }


def _softplus(x):
    """jax.nn.softplus: log(1 + e^x) with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(cfg, p, u, policy):
    """u (B,S,dr) conv output -> log_a (fp32), scaled input.  The gate
    products contract over all of d_rnn: on a mesh u is gathered for
    them once."""
    uw = shard_act(u, ("batch", "seq", None))
    r = torch.sigmoid((uw @ policy.c(p["w_r"])).float())
    i = torch.sigmoid((uw @ policy.c(p["w_i"])).float())
    log_a = -RG_C * _softplus(p["lam"].float()) * r
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * u.float())
    return log_a, b


def _recurrence(a, bterm, h0):
    """The scan over each rank's own ``d_rnn`` channels: it is per
    channel, so no collective."""
    scan = ops.rglru if _BACKEND == "kernel" else ref_rglru
    io = ("batch", None, "d_rnn")
    return local_map(scan, (a, bterm, h0), (io, io, ("batch", "d_rnn")),
                     out_like=(0, 2))


def rglru_apply(cfg: ArchConfig, p, x, policy=DEFAULT_POLICY, state=None):
    """Full-sequence block.  Returns (y, new_state)."""
    c = policy.c
    xi = apply_norm(cfg, p["norm"], x, policy)
    u0 = xi @ c(p["wx"])
    conv_state = None if state is None else state["conv"]
    u, new_conv = _causal_conv(u0, c(p["wconv"]), conv_state)
    log_a, bterm = _gates(cfg, p, u, policy)
    a = torch.exp(log_a)
    # the carried h enters as h0: a_0 * h0 + x_0, the reference's fold
    h0 = (torch.zeros_like(a[:, 0]) if state is None
          else state["h"].float().contiguous())
    h, h_last = _recurrence(a, bterm, h0)
    gate = F.gelu(xi @ c(p["wg"]), approximate="tanh")
    y = (h.to(policy.compute) * gate) @ c(p["wo"])
    x = residual(x, y)
    xj = apply_norm(cfg, p["norm2"], x, policy)
    x = residual(x, apply_mlp(cfg, p["mlp"], xj, policy))
    return x, {"conv": new_conv, "h": h_last}


def rglru_decode(cfg: ArchConfig, p, x, state, policy=DEFAULT_POLICY):
    """x (B,1,D) one-token update.  Returns (y, new_state)."""
    c = policy.c
    xi = apply_norm(cfg, p["norm"], x, policy)
    u0 = xi @ c(p["wx"])
    u, new_conv = _causal_conv(u0, c(p["wconv"]), state["conv"])
    log_a, bterm = _gates(cfg, p, u, policy)
    h = torch.exp(log_a[:, 0]) * state["h"] + bterm[:, 0]      # (B,dr)
    gate = F.gelu(xi @ c(p["wg"]), approximate="tanh")
    y = (h[:, None].to(policy.compute) * gate) @ c(p["wo"])
    x = residual(x, y)
    xj = apply_norm(cfg, p["norm2"], x, policy)
    x = residual(x, apply_mlp(cfg, p["mlp"], xj, policy))
    return x, {"conv": new_conv, "h": h}


def rglru_state_defs(cfg: ArchConfig, batch: int, dtype=torch.bfloat16):
    """The carry: the conv window in the compute ``dtype``, h in fp32."""
    dr, cw = _dr(cfg), cfg.conv_width
    return {
        "conv": Pm((batch, cw - 1, dr), ("batch", None, "d_rnn"),
                   init="zeros", dtype=dtype),
        "h": Pm((batch, dr), ("batch", "d_rnn"), init="zeros",
                dtype=torch.float32),
    }
