"""Gradient compression: blockwise int8 quantization with error feedback.

Used by the proxy-MPI data-parallel trainer to shrink ring-allreduce
traffic, in numpy on the host with the reference's arithmetic.  Error
feedback keeps the quantization residual locally and adds it to the next
step's gradient, preserving convergence (1-bit-Adam / EF-SGD lineage).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

BLOCK = 256


def quantize_int8(x: np.ndarray, block: int = BLOCK
                  ) -> Tuple[np.ndarray, np.ndarray, tuple]:
    """x (any shape) -> (q int8 (nb, block), scales fp32 (nb,), orig shape).
    Tail is zero-padded."""
    shape = x.shape
    flat = x.astype(np.float32).reshape(-1)
    pad = (-flat.size) % block
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, block)
    scales = np.maximum(np.abs(blocks).max(axis=1), 1e-12) / 127.0
    q = np.clip(np.rint(blocks / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales.astype(np.float32), shape


def dequantize_int8(q: np.ndarray, scales: np.ndarray,
                    shape: tuple) -> np.ndarray:
    flat = (q.astype(np.float32) * scales[:, None]).reshape(-1)
    n = int(np.prod(shape)) if shape else 1
    return flat[:n].reshape(shape)


class ErrorFeedback:
    """Per-tensor residual memory: compress(g + residual), keep the
    round-off locally."""

    def __init__(self):
        self.residual: Dict[str, np.ndarray] = {}

    def compress(self, name: str, g: np.ndarray):
        r = self.residual.get(name)
        eff = g if r is None else g + r
        q, s, shape = quantize_int8(eff)
        approx = dequantize_int8(q, s, shape)
        self.residual[name] = eff - approx
        return q, s, shape

    def snapshot(self) -> dict:
        return {k: v.copy() for k, v in self.residual.items()}

    def restore(self, snap: dict) -> None:
        self.residual = {k: np.asarray(v) for k, v in snap.items()}


def compression_ratio(q, scales, shape) -> float:
    orig = int(np.prod(shape)) * 4
    comp = q.size + scales.size * 4
    return orig / max(comp, 1)
