"""Blockwise int8 quantize / dequantize on Hopper: binds and launches the
CUDA kernels in ``csrc/quantize_int8.cu`` (twin of
``repro.kernels.quantize``; the source's header says what bounds them and
how they are laid out).

The library is built by ``kernels/build.py`` at first use and loaded with
``ctypes``.  Nothing is compiled or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "quantize_int8.cu"
BLOCKS = (128, 256, 512, 1024)      # scale-block sizes the kernel takes
_lib = None


def _load():
    global _lib
    if _lib is None:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _lib = _build.load(SOURCE, {
            "quantize_int8": ([vp, vp, vp, cll, ci, vp], ci),
            "dequantize_int8": ([vp, vp, vp, cll, ci, vp], ci),
            "quantize_error_string": ([ci], ctypes.c_char_p)})
    return _lib


def _check(name, t, dtype, ndim, align) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor; it is on {t.device}")
    if t.dtype != dtype or t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D {dtype}, got "
                         f"{t.ndim}-D {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte aligned")


def _launch(fn: str, *args, device) -> None:
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} "
                           f"({lib.quantize_error_string(rc).decode()})")


def quantize_int8(x, *, block: int = 256):
    """x (N,) fp32 CUDA tensor, N a positive multiple of ``block`` ->
    (q (N // block, block) int8, scales (N // block,) fp32).  Launches the
    kernel or raises."""
    _check("x", x, torch.float32, 1, 16)
    n = x.shape[0]
    if block not in BLOCKS or n == 0 or n % block:
        raise ValueError(f"N={n} must be a positive multiple of block={block}, "
                         f"and block one of {BLOCKS}")
    nb = n // block
    q = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    scales = torch.empty((nb,), dtype=torch.float32, device=x.device)
    _launch("quantize_int8", x.data_ptr(), q.data_ptr(), scales.data_ptr(),
            nb, block, device=x.device)
    return q, scales


def dequantize_int8(q, scales):
    """(q (nb, block) int8, scales (nb,) fp32) CUDA tensors, block a
    multiple of 4 -> x (nb * block,) fp32.  Launches the kernel or raises."""
    _check("q", q, torch.int8, 2, 4)
    _check("scales", scales, torch.float32, 1, 4)
    nb, block = q.shape
    if nb == 0 or block % 4 or tuple(scales.shape) != (nb,):
        raise ValueError(f"q {tuple(q.shape)} needs nb > 0 and block % 4 == 0, "
                         f"and scales {tuple(scales.shape)} must be ({nb},)")
    if q.device != scales.device:
        raise ValueError(f"devices differ: {q.device}, {scales.device}")
    out = torch.empty((nb * block,), dtype=torch.float32, device=q.device)
    _launch("dequantize_int8", q.data_ptr(), scales.data_ptr(), out.data_ptr(),
            nb, block, device=q.device)
    return out
