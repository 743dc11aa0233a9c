"""Public wrappers for the port's kernels (twin of ``repro.kernels.ops``).

A CPU tensor goes to the kernel's plain PyTorch version (``kernels/ref.py``);
a CUDA tensor goes to the hand-written kernel, or the call raises.  Nothing
falls back from one to the other.  The forward kernel is the
serving/prefill fast path.

``FLASH_LAUNCHES`` counts launches of the flash-attention kernel (and only
those), so a run can show that its path went through the kernel.

No gradient yet: the reference's custom_vjp becomes an
``autograd.Function`` with the training slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels.ref import ref_flash_attention

FLASH_LAUNCHES = 0


def reset_launch_counts() -> None:
    global FLASH_LAUNCHES
    FLASH_LAUNCHES = 0


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q (BH, Sq, hd); k, v (BKV, Sk, hd).  GQA folded by the caller."""
    global FLASH_LAUNCHES
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet; it comes with the training "
            "slice (ROADMAP.md, Queue 1: training).  Call it under "
            "torch.inference_mode() or on tensors that do not require grad")
    if q.device.type == "cpu":
        return ref_flash_attention(q, k, v, causal=causal, window=window)
    out = _fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    FLASH_LAUNCHES += 1
    return out
