"""RG-LRU linear recurrence on Hopper: binds and launches the CUDA kernel in
``csrc/rglru_scan.cu`` (twin of ``repro.kernels.rglru``; the source's
header says what bounds it and how it is laid out).

The library is built by ``kernels/build.py`` at first use and loaded with
``ctypes``.  Nothing is compiled or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "rglru_scan.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _load():
    global _lib
    if _lib is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        _lib = _build.load(SOURCE, {
            "rglru_scan": ([vp, vp, vp, vp, vp, ci, ci, ci, ci, vp], ci),
            "rglru_error_string": ([ci], ctypes.c_char_p)})
    return _lib


def _check(a, x, h0) -> None:
    for name, t in (("a", a), ("x", x), ("h0", h0)):
        if not t.is_cuda:
            raise ValueError(f"rglru_scan takes CUDA tensors; {name} is on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype not in _DTYPE_CODES or x.dtype != a.dtype:
        raise ValueError(f"a and x must share a dtype in "
                         f"{sorted(map(str, _DTYPE_CODES))}; got {a.dtype}, "
                         f"{x.dtype}")
    if h0.dtype != torch.float32:
        raise ValueError(f"h0 must be float32, got {h0.dtype}")
    if a.ndim != 3 or tuple(x.shape) != tuple(a.shape):
        raise ValueError(f"a {tuple(a.shape)} and x {tuple(x.shape)} must be "
                         f"one (B, S, D) shape")
    b, s, d = a.shape
    if tuple(h0.shape) != (b, d):
        raise ValueError(f"h0 {tuple(h0.shape)} must be (B, D) = {(b, d)}")
    if b * d == 0 or max(b, s, d) >= 2 ** 31:
        raise ValueError(f"(B, S, D) = {(b, s, d)}: B * D must be positive "
                         f"and each below 2**31")
    if not (a.device == x.device == h0.device):
        raise ValueError(f"devices differ: {a.device}, {x.device}, {h0.device}")


def rglru_scan(a, x, h0):
    """a, x (B, S, D) fp32 or bf16; h0 (B, D) fp32; CUDA tensors.  Returns
    (h_seq (B, S, D) fp32, h_last (B, D) fp32).  Launches the kernel on the
    current stream or raises; it never falls back."""
    _check(a, x, h0)
    b, s, d = a.shape
    lib = _load()
    h_seq = torch.empty((b, s, d), dtype=torch.float32, device=a.device)
    h_last = torch.empty((b, d), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rglru_scan(a.data_ptr(), x.data_ptr(), h0.data_ptr(),
                            h_seq.data_ptr(), h_last.data_ptr(),
                            _DTYPE_CODES[a.dtype], b, s, d, stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {rc} "
                           f"({lib.rglru_error_string(rc).decode()})")
    return h_seq, h_last
