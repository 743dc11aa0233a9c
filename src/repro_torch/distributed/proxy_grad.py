"""Data-parallel training over the paper's proxy-MPI core.

Each MPI rank holds a full model replica (pure numpy); gradients are
averaged with the RING allreduce implemented on MPI_Send/MPI_Recv through
the proxies (repro_torch.core.api.Allreduce) — so a checkpoint can land while
gradient chunks are mid-ring, exercising the paper's in-flight drain on a
REAL training workload.  Optional int8 gradient compression with error
feedback halves ring traffic (compressed chunks travel the ring;
reduction happens in fp32 after dequantize).

Pure numpy on purpose, as in the reference: rank applications run as
FORKED OS processes in the process world, and a CUDA context does not
survive a fork — the analytic gradient of this 2-layer MLP is exact,
bitwise deterministic across substrates, and bit-equal to the
reference's for the same seed.  This module imports no ``torch``.

This is the integration point between the paper's contribution and the
training framework: tests assert bitwise-identical resume, including
restarts onto the other transport AND onto the other execution substrate.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.api import MPI
from repro_torch.distributed.compression import (ErrorFeedback,
                                                 dequantize_int8,
                                                 quantize_int8)


def make_mlp_model(din: int, dh: int, dout: int):
    """Small reference model for DP training (pure functions, numpy state)."""

    def init(seed: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        return {
            "w1": (rng.standard_normal((din, dh)) / np.sqrt(din)).astype(np.float32),
            "w2": (rng.standard_normal((dh, dout)) / np.sqrt(dh)).astype(np.float32),
        }

    def loss_and_grad(params, batch):
        # forward: loss = mean((tanh(x@w1)@w2 - y)^2); backward by hand
        x, y = batch
        h = np.tanh(x @ params["w1"])
        p = h @ params["w2"]
        r = p - y
        loss = float(np.mean(r * r))
        gp = (np.float32(2.0) / np.float32(r.size)) * r
        gw2 = h.T @ gp
        gh = gp @ params["w2"].T
        gz = gh * (np.float32(1.0) - h * h)       # tanh' = 1 - tanh^2
        gw1 = x.T @ gz
        return loss, {"w1": gw1.astype(np.float32),
                      "w2": gw2.astype(np.float32)}

    return init, loss_and_grad


def sgd_update(params, grads, lr: float):
    return {k: params[k] - lr * grads[k] for k in params}


def make_batch(seed: int, step: int, rank: int, n: int, din: int, dout: int):
    """Deterministic per-(step, rank) batch — the DP shard of a global batch."""
    rng = np.random.default_rng((seed, step, rank))
    x = rng.standard_normal((n, din)).astype(np.float32)
    w = np.linspace(-1, 1, din * dout, dtype=np.float32).reshape(din, dout)
    y = (x @ w + np.float32(0.01)
         * rng.standard_normal((n, dout)).astype(np.float32))
    return x, y


def allreduce_grads(mpi: MPI, grads: Dict[str, np.ndarray],
                    ef: Optional[ErrorFeedback] = None) -> Dict[str, np.ndarray]:
    """Average gradients across ranks via the proxy ring; optionally int8."""
    n = mpi.Comm_size()
    out = {}
    for name in sorted(grads):
        g = np.asarray(grads[name])
        if ef is not None:
            # COMPRESSED payloads travel the ring (int8 + fp32 block scales
            # ~ 4x less traffic); reduction in fp32 after dequantize.
            q, s, shape = ef.compress(name, g)
            parts = mpi.Allgather((q, s))
            acc = np.zeros(shape, np.float32)
            for qi, si in parts:
                acc += dequantize_int8(qi, si, shape)
            out[name] = acc / n
        else:
            # pinned to the ring so the documented checkpoint-mid-ring
            # drain path is what training actually exercises
            out[name] = mpi.Allreduce(g, "sum", algo="ring") / n
    return out


def make_dp_app(din: int = 16, dh: int = 32, dout: int = 4,
                batch_per_rank: int = 8, lr: float = 0.05,
                seed: int = 0, compress: bool = False):
    """(init_fn, step_fn) for MPIJob: checkpointable DP training."""
    init_model, loss_and_grad = make_mlp_model(din, dh, dout)

    def init_fn(mpi: MPI):
        state = {"params": init_model(seed), "loss": None}
        if compress:
            state["ef"] = ErrorFeedback().snapshot()
        return state

    def step_fn(mpi: MPI, state, step: int):
        params = state["params"]
        batch = make_batch(seed, step, mpi.Comm_rank(), batch_per_rank,
                           din, dout)
        loss, grads = loss_and_grad(params, batch)
        ef = None
        if compress:
            ef = ErrorFeedback()
            ef.restore(state["ef"])
        grads = allreduce_grads(mpi, grads, ef)
        new = {"params": sgd_update(params, grads, lr),
               "loss": float(mpi.Allreduce(np.float64(loss), "sum")
                             / mpi.Comm_size())}
        if compress:
            new["ef"] = ef.snapshot()
        return new

    return init_fn, step_fn
