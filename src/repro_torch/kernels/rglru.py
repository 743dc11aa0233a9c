"""RG-LRU linear recurrence on Hopper: binds and launches the CUDA kernel in
``csrc/rglru_scan.cu`` (twin of ``repro.kernels.rglru``).

The kernel is a single-pass, time-chunked scan with decoupled look-back:
persistent blocks take tiles of ``CHUNK`` steps x ``LANES`` lanes of one
batch row in chunk-major ticket order, copy each into shared memory, and
fold each tile's carry-in from the (product, local scan) pairs and
carry-outs that the tiles before it in the same column left in scratch.
It reads a and x once and writes h_seq once, so bytes bound it: 251.7 MB,
0.075 ms at 3.35 TB/s, at the (2, 2560, 4096) fp32 serving shape.  The
source's header says how it is laid out; ``rglru_plan`` is its tile plan
and scratch layout, the only copy of it, which every launch passes down.

The library is built by ``kernels/build.py`` at first use and loaded with
``ctypes``.  Nothing is compiled or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "rglru_scan.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: Time steps and lanes of a tile (``kChunk``/``kLanes`` of the source).
CHUNK = 64
LANES = 128
_lib = None


class RglruPlan(NamedTuple):
    """The kernel's tiles and scratch for one (B, S, D), passed to it field
    for field (its ``Plan``).  Tiles run in chunk-major order, ``tiles`` =
    ``n_chunks`` x B x ``lane_tiles``; the library launches as many
    persistent blocks as fit on the card, at most one a tile.  Scratch: a
    u32 ticket, from ``flags_offset`` one u32 flag a tile (the two end at
    ``flag_bytes``, which the launch zeroes on its stream), then from
    ``agg_offset`` an fp32 (A, X) pair and from ``incl_offset`` an fp32
    carry-out for each lane of every chunk but the last."""
    chunk: int
    lanes: int
    n_chunks: int
    lane_tiles: int
    tiles: int
    flags_offset: int
    flag_bytes: int
    agg_offset: int
    incl_offset: int
    scratch_bytes: int


@functools.lru_cache(maxsize=64)
def rglru_plan(b: int, s: int, d: int) -> RglruPlan:
    n_chunks = -(-s // CHUNK)
    lane_tiles = -(-d // LANES)
    tiles = n_chunks * b * lane_tiles
    flags_offset = 4
    flag_bytes = flags_offset + 4 * tiles
    carried = (n_chunks - 1) * b * d
    agg_offset = -(-flag_bytes // 256) * 256
    incl_offset = agg_offset + 8 * carried
    return RglruPlan(CHUNK, LANES, n_chunks, lane_tiles, tiles, flags_offset,
                     flag_bytes, agg_offset, incl_offset,
                     incl_offset + 4 * carried)


def scratch_traffic(plan: RglruPlan, b: int, d: int, counts) -> dict:
    """Bytes that one launch moved through its scratch, from the ``counts``
    it was given: every tile but the last of its column writes a carry-out
    a lane, the tiles whose look-back did not settle at once write an
    (A, X) pair a lane (``lanes_published``), every tile past the first
    reads one carry-out a lane and the pairs it folded (``lanes_folded``),
    and each poll reads 32 flags.  Flags are counted as two 4-byte writes a
    tile (an upper bound), the ticket as two atomics a tile."""
    folded, polls, published = (int(v) for v in counts.cpu())
    carried = (plan.n_chunks - 1) * b * d
    return {"written_bytes": 4 * carried + 8 * published + 8 * plan.tiles,
            "read_bytes": 4 * carried + 8 * folded + 128 * polls,
            "atomic_bytes": 8 * plan.tiles, "lanes_folded": folded,
            "lanes_published": published, "flag_polls": polls}


def _load():
    global _lib
    if _lib is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        _lib = _build.load(SOURCE, {
            "rglru_scan": ([vp] * 8 + [ci, ci, ci, ci, vp], ci),
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
    if min(b, s, d) < 1 or max(b, s, d) >= 2 ** 31:
        raise ValueError(f"(B, S, D) = {(b, s, d)}: each must be positive "
                         f"and below 2**31")
    if not (a.device == x.device == h0.device):
        raise ValueError(f"devices differ: {a.device}, {x.device}, {h0.device}")


def rglru_scan(a, x, h0, *, counts=None):
    """a, x (B, S, D) fp32 or bf16; h0 (B, D) fp32; CUDA tensors.  Returns
    (h_seq (B, S, D) fp32, h_last (B, D) fp32).  Launches the kernel on the
    current stream or raises; it never falls back.  The scratch is
    allocated for the call on that stream.

    ``counts``, an int64 tensor of 3 on the same device, makes the kernel
    add to it what ``scratch_traffic`` reads; the serving path passes none,
    and then the kernel counts nothing."""
    _check(a, x, h0)
    b, s, d = a.shape
    plan = rglru_plan(b, s, d)
    if plan.tiles >= 2 ** 31:
        raise ValueError(f"(B, S, D) = {(b, s, d)} needs {plan.tiles} "
                         f"tiles, more than the ticket counts")
    if counts is not None and (
            counts.dtype != torch.int64 or counts.device != a.device
            or tuple(counts.shape) != (3,) or not counts.is_contiguous()):
        raise ValueError(f"counts must be 3 contiguous int64 on {a.device}")
    lib = _load()
    h_seq = torch.empty((b, s, d), dtype=torch.float32, device=a.device)
    h_last = torch.empty((b, d), dtype=torch.float32, device=a.device)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rglru_scan(a.data_ptr(), x.data_ptr(), h0.data_ptr(),
                            h_seq.data_ptr(), h_last.data_ptr(),
                            scratch.data_ptr(),
                            None if counts is None else counts.data_ptr(),
                            (ctypes.c_longlong * len(plan))(*plan),
                            _DTYPE_CODES[a.dtype], b, s, d, stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {rc} "
                           f"({lib.rglru_error_string(rc).decode()})")
    return h_seq, h_last
