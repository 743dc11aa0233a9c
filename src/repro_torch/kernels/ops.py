"""Public wrappers for the port's kernels (twin of ``repro.kernels.ops``).

A CPU tensor goes to the kernel's plain PyTorch version (``kernels/ref.py``);
a CUDA tensor goes to the hand-written kernel, or the call raises.  Nothing
falls back from one to the other.  The forward kernels are the
serving/prefill fast path; the flash kernel is also the training
forward.

Each counter counts launches of one kernel (and only those), so a run can
show that its path went through the kernel: ``FLASH_LAUNCHES``,
``RGLRU_LAUNCHES``, ``QUANT_LAUNCHES`` and ``DEQUANT_LAUNCHES``.  A wrapper
counts when Python launches its kernel, so a CUDA graph would count its
capture and never its replays: ``capture_launches`` records what a capture
put into a graph (and takes it back off the counters: a capture runs
nothing), and ``CountedGraph.replay`` adds it again on every replay.
Launches inside ``uncounted()`` (a graph's warm-up) are set-up, not served
work, and are taken back off too.

``flash_attention`` and ``rglru`` take plain tensors and raise
``TypeError`` on a DTensor: on a mesh the model reaches them through
``distributed.sharding.local_map``, each rank on its own heads or
channels.  Every wrapper raises ``TypeError`` on a fake CUDA tensor (the
dry-run's), which has no storage for a kernel to read.

``flash_attention`` is an ``autograd.Function``, as the reference's is a
custom_vjp: the forward is the kernel (its plain version on the CPU), and
the backward is autograd through the plain version on the saved q, k, v,
recomputed (``repro.kernels.ops._fa_bwd``).  No TPU kernel has a backward
kernel, so neither does the port.  ``rglru`` has no backward, as the
reference's has no vjp (its model trains through the plain scan): it
raises on a tensor that requires grad.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed.sharding import is_dtensor, is_fake
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels.ref import (ref_dequantize_int8, ref_flash_attention,
                                     ref_quantize_int8, ref_rglru)

FLASH_LAUNCHES = 0
RGLRU_LAUNCHES = 0
QUANT_LAUNCHES = 0
DEQUANT_LAUNCHES = 0


_COUNTERS = ("FLASH_LAUNCHES", "RGLRU_LAUNCHES", "QUANT_LAUNCHES",
             "DEQUANT_LAUNCHES")


def reset_launch_counts() -> None:
    global FLASH_LAUNCHES, RGLRU_LAUNCHES, QUANT_LAUNCHES, DEQUANT_LAUNCHES
    FLASH_LAUNCHES = RGLRU_LAUNCHES = QUANT_LAUNCHES = DEQUANT_LAUNCHES = 0


def _counts() -> dict:
    return {name: globals()[name] for name in _COUNTERS}


def _add(launches: dict) -> None:
    for name, n in launches.items():
        globals()[name] += n


@contextlib.contextmanager
def uncounted():
    """Launches inside are taken back off the counters on exit."""
    before = _counts()
    try:
        yield
    finally:
        _add({name: before[name] - n for name, n in _counts().items()})


def capture_launches(capture) -> dict:
    """Runs ``capture()`` (a CUDA graph's capture) and returns the launches
    it counted, by counter name; the counters are left as they were."""
    with uncounted():
        before = _counts()
        capture()
        return {name: n - before[name] for name, n in _counts().items()
                if n != before[name]}


class CountedGraph:
    """A captured graph and the launches it holds: each ``replay()``
    replays it and adds them to the counters."""

    def __init__(self, graph, launches: dict):
        self.graph = graph
        self.launches = dict(launches)

    def replay(self) -> None:
        self.graph.replay()
        _add(self.launches)


def _refuse_dtensor(name: str, *tensors) -> None:
    """The kernels take plain tensors only: they read ``data_ptr`` and the
    global shape would not be this rank's.  A DTensor reaches them through
    ``distributed.sharding.local_map`` as its local shard; one that comes
    in whole is a missed ``local_map``, refused here rather than gathered
    or run through the plain version."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(
            f"{name} takes plain tensors: run it on this rank's shards "
            f"through repro_torch.distributed.sharding.local_map")


def _refuse_fake(name: str, *tensors) -> None:
    """A fake tensor (``FakeTensorMode``: shapes and a device, no storage)
    on CUDA would hand the kernel a pointer to nothing.  The dry-run
    traces with the reference's backends and reaches no kernel; a fake
    tensor that arrives here is refused, not run through the plain
    version."""
    if any(is_fake(t) for t in tensors):
        raise TypeError(
            f"{name} got a fake tensor: the CUDA kernels need storage.  "
            f"Trace with the \"chunked\" attention and \"scan\" recurrence "
            f"backends, as repro_torch.launch.dryrun does")


def _refuse_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward, as the reference's has no vjp; "
            f"training goes through the plain scan (the \"scan\" recurrence "
            f"backend).  Call it under torch.inference_mode() or on tensors "
            f"that do not require grad")


# ---------------------------------------------------------------- attention

def _flash_fwd(q, k, v, causal, window):
    global FLASH_LAUNCHES
    _refuse_dtensor("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return ref_flash_attention(q, k, v, causal=causal, window=window)
    _refuse_fake("flash_attention", q, k, v)
    out = _fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    FLASH_LAUNCHES += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _flash_fwd(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = ref_flash_attention(*qkv, causal=ctx.causal,
                                      window=ctx.window)
        dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q (BH, Sq, hd); k, v (BKV, Sk, hd).  GQA folded by the caller."""
    return _FlashAttention.apply(q, k, v, causal, window)


# ------------------------------------------------------------------- rg-lru

def rglru(a, x, h0):
    """h_t = a_t h_{t-1} + x_t over axis 1.  Returns (h_seq fp32, h_last)."""
    global RGLRU_LAUNCHES
    _refuse_dtensor("rglru", a, x, h0)
    _refuse_grad("rglru", a, x, h0)
    if a.device.type == "cpu":
        return ref_rglru(a, x, h0)
    _refuse_fake("rglru", a, x, h0)
    out = _rg.rglru_scan(a, x, h0)
    RGLRU_LAUNCHES += 1
    return out


# ----------------------------------------------------------------- quantize

def quantize_int8(x, block: int = 256):
    global QUANT_LAUNCHES
    if x.device.type == "cpu":
        return ref_quantize_int8(x, block=block)
    _refuse_fake("quantize_int8", x)
    out = _q.quantize_int8(x, block=block)
    QUANT_LAUNCHES += 1
    return out


def dequantize_int8(q, scales):
    global DEQUANT_LAUNCHES
    if q.device.type == "cpu":
        return ref_dequantize_int8(q, scales)
    _refuse_fake("dequantize_int8", q, scales)
    out = _q.dequantize_int8(q, scales)
    DEQUANT_LAUNCHES += 1
    return out
