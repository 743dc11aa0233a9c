"""Flash-attention forward on Hopper: builds, binds and launches the CUDA
kernels in ``csrc/flash_attention_fwd.cu`` (twin of
``repro.kernels.flash_attention``; the source's header says what bounds it
and how it is laid out).  One C entry point, two kernels chosen by dtype:
bf16 runs on the tensor cores (wgmma), fp32 on the CUDA cores in exact
fp32 FMA arithmetic (no mma, wgmma or TF32), both products tiled in
registers as SIMT GEMMs over 64-row q tiles and 64-key tiles.  Both kernels
copy 16-byte chunks, so every input must start on a 16-byte boundary.

The library is built by ``kernels/build.py`` at first use and loaded with
``ctypes``.  Nothing is compiled or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "flash_attention_fwd.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
#: Which kernel each dtype runs.
INSTANTIATIONS = {torch.bfloat16: "tensor cores (wgmma, bf16 in, fp32 acc)",
                  torch.float32: "CUDA cores (fp32 FMA, register-tiled)"}
#: (block_q, block_k) of the kernel each (dtype, head_dim) runs: Sq must be a
#: multiple of block_q and Sk of block_k.  The library reports its own
#: (``fa_block_q``/``fa_block_k``), which launches are checked against and
#: chip_smoke.py holds this table to.
TILES = {(torch.float32, 64): (64, 64), (torch.float32, 128): (64, 64),
         (torch.float32, 256): (64, 64),
         (torch.bfloat16, 64): (64, 64), (torch.bfloat16, 128): (128, 64),
         (torch.bfloat16, 256): (128, 64)}
_lib = None


def _load():
    global _lib
    if _lib is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        _lib = _build.load(SOURCE, {
            "fa_fwd": ([vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                        ctypes.c_float, ci, ci, vp], ci),
            "fa_block_q": ([ci, ci], ci),
            "fa_block_k": ([ci, ci], ci),
            "fa_error_string": ([ci], ctypes.c_char_p)})
    return _lib


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_fwd takes CUDA tensors; {name} "
                             f"is on {t.device}")
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name}.dtype {t.dtype} not in "
                             f"{sorted(map(str, _DTYPE_CODES))}")
        if t.ndim != 3:
            raise ValueError(f"{name} must be 3-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")
    bh, sq, hd = q.shape
    bkv, sk, hdk = k.shape
    if tuple(v.shape) != (bkv, sk, hdk) or hdk != hd:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (BH,Sq,hd),(BKV,Sk,hd)")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_HEAD_DIMS}")
    if bkv == 0 or bh % bkv or bh > 65535:
        raise ValueError(f"BH={bh} must be a multiple of BKV={bkv} and "
                         f"at most 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(the kernels copy 16-byte chunks)")


def library_tiles(dtype, hd: int) -> tuple:
    """(block_q, block_k) as the built library reports them."""
    lib, code = _load(), _DTYPE_CODES[dtype]
    return lib.fa_block_q(code, hd), lib.fa_block_k(code, hd)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """q (BH, Sq, hd); k, v (BKV, Sk, hd), BH = BKV * G; fp32 or bf16 CUDA
    tensors.  Returns (BH, Sq, hd) in q's dtype.  Launches the kernel on
    the current stream or raises; it never falls back."""
    _check(q, k, v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    bh, sq, hd = q.shape
    bkv, sk, _ = k.shape
    lib = _load()
    block_q, block_k = library_tiles(q.dtype, hd)
    if sq == 0 or sk == 0 or sq % block_q or sk % block_k:
        raise ValueError(f"Sq={sq} must be a positive multiple of {block_q} "
                         f"and Sk={sk} of {block_k}")
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), _DTYPE_CODES[q.dtype], bh, bkv, sq, sk,
                        hd, float(scale), int(bool(causal)), int(window),
                        stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{rc} ({lib.fa_error_string(rc).decode()})")
    return out
