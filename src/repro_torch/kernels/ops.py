"""Public wrappers for the port's kernels (twin of ``repro.kernels.ops``).

A CPU tensor goes to the kernel's plain PyTorch version (``kernels/ref.py``);
a CUDA tensor goes to the hand-written kernel, or the call raises.  Nothing
falls back from one to the other.  The forward kernels are the
serving/prefill fast path.

Each counter counts launches of one kernel (and only those), so a run can
show that its path went through the kernel: ``FLASH_LAUNCHES``,
``RGLRU_LAUNCHES``, ``QUANT_LAUNCHES`` and ``DEQUANT_LAUNCHES``.

No gradient yet: the reference's custom_vjp becomes an
``autograd.Function`` with the training slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels.ref import (ref_dequantize_int8, ref_flash_attention,
                                     ref_quantize_int8, ref_rglru)

FLASH_LAUNCHES = 0
RGLRU_LAUNCHES = 0
QUANT_LAUNCHES = 0
DEQUANT_LAUNCHES = 0


def reset_launch_counts() -> None:
    global FLASH_LAUNCHES, RGLRU_LAUNCHES, QUANT_LAUNCHES, DEQUANT_LAUNCHES
    FLASH_LAUNCHES = RGLRU_LAUNCHES = QUANT_LAUNCHES = DEQUANT_LAUNCHES = 0


def _refuse_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward yet; it comes with the training slice "
            f"(ROADMAP.md, Queue 1: training).  Call it under "
            f"torch.inference_mode() or on tensors that do not require grad")


# ---------------------------------------------------------------- attention

def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q (BH, Sq, hd); k, v (BKV, Sk, hd).  GQA folded by the caller."""
    global FLASH_LAUNCHES
    _refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return ref_flash_attention(q, k, v, causal=causal, window=window)
    out = _fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    FLASH_LAUNCHES += 1
    return out


# ------------------------------------------------------------------- rg-lru

def rglru(a, x, h0):
    """h_t = a_t h_{t-1} + x_t over axis 1.  Returns (h_seq fp32, h_last)."""
    global RGLRU_LAUNCHES
    _refuse_grad("rglru", a, x, h0)
    if a.device.type == "cpu":
        return ref_rglru(a, x, h0)
    out = _rg.rglru_scan(a, x, h0)
    RGLRU_LAUNCHES += 1
    return out


# ----------------------------------------------------------------- quantize

def quantize_int8(x, block: int = 256):
    global QUANT_LAUNCHES
    if x.device.type == "cpu":
        return ref_quantize_int8(x, block=block)
    out = _q.quantize_int8(x, block=block)
    QUANT_LAUNCHES += 1
    return out


def dequantize_int8(q, scales):
    global DEQUANT_LAUNCHES
    if q.device.type == "cpu":
        return ref_dequantize_int8(q, scales)
    out = _q.dequantize_int8(q, scales)
    DEQUANT_LAUNCHES += 1
    return out
