"""The port's flash-attention entry point against the JAX package.

On CPU tensors ``repro_torch.kernels.ops.flash_attention`` runs the
kernel's plain PyTorch version; it is held against the JAX oracle and the
Pallas kernel in interpret mode (as tests/test_kernels.py runs it), on the
same numpy inputs.  The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.flash_attention import flash_attention_fwd as jax_fa_fwd
from repro.kernels.ref import ref_flash_attention as jax_ref_fa
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops

# The reference's own tolerances (tests/test_kernels.py:36): fp32 sums in
# another order differ in the last digits; bf16 outputs differ by a rounding.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

SWEEP = [
    (4, 2, 256, 256, 64, True, 0),      # GQA g=2
    (2, 2, 128, 128, 128, True, 0),     # MHA hd=128
    (8, 2, 128, 128, 64, True, 0),      # GQA g=4
    (6, 2, 256, 256, 64, True, 64),     # local window (rgemma-style)
    (2, 2, 128, 384, 64, False, 0),     # cross-attention
    (2, 1, 512, 512, 256, True, 0),     # MQA, big head_dim
]


def _qkv(seed, bh, bkv, sq, sk, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, sq, hd), dtype=np.float32),
            rng.standard_normal((bkv, sk, hd), dtype=np.float32),
            rng.standard_normal((bkv, sk, hd), dtype=np.float32))


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,bkv,sq,sk,hd,causal,window", SWEEP)
def test_flash_attention_matches_jax(dtype, bh, bkv, sq, sk, hd, causal,
                                     window):
    arrays = _qkv(0, bh, bkv, sq, sk, hd)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrays)
    launches = ops.FLASH_LAUNCHES
    out = ops.flash_attention(tq, tk, tv, causal, window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert ops.FLASH_LAUNCHES == launches, "a CPU call launches no kernel"
    ref = jax_ref_fa(jq, jk, jv, causal=causal, window=window)
    ker = jax_fa_fwd(jq, jk, jv, causal=causal, window=window, block_q=64,
                     block_k=64, interpret=True)
    got = out.float().numpy()
    np.testing.assert_allclose(got, _np(ref), atol=TOL[dtype])
    np.testing.assert_allclose(got, _np(ker), atol=TOL[dtype])


def test_flash_attention_constant_v_property():
    """softmax rows sum to 1 => constant V must pass through (atol 1e-5,
    as tests/test_kernels.py:60)."""
    q, k, _ = _qkv(1, 2, 2, 128, 128, 64)
    v = np.full((2, 128, 64), 2.5, np.float32)
    out = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), 2.5, atol=1e-5)


@pytest.mark.parametrize("bh,bkv,s,hd,window", [
    (2, 2, 128, 64, 0),          # tests/test_kernels.py:63
    (6, 2, 256, 64, 64),         # GQA g=3 (smollm-135m's), local window
])
def test_flash_attention_grad_matches_jax(bh, bkv, s, hd, window):
    """Twin of tests/test_kernels.py:63 through the autograd.Function: the
    gradients of sum(out^2) against jax.grad through the reference's
    custom_vjp (the Pallas kernel's forward in interpret mode, the plain
    version's vjp), at its atol 2e-4.  A CPU call launches no kernel, in
    the forward or the backward."""
    arrays = _qkv(2, bh, bkv, s, s, hd)

    def loss_jax(q, k, v):
        return jnp.sum(jax_ops.flash_attention(q, k, v, True, window) ** 2)

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    qkv = [torch.from_numpy(a).requires_grad_() for a in arrays]
    launches = ops.FLASH_LAUNCHES
    (ops.flash_attention(*qkv, True, window) ** 2).sum().backward()
    assert ops.FLASH_LAUNCHES == launches
    for t, j in zip(qkv, want):
        np.testing.assert_allclose(t.grad.numpy(), _np(j), atol=2e-4)
    # without autograd the same entry point runs as before
    with torch.inference_mode():
        out = ops.flash_attention(*(t.detach() for t in qkv), True, window)
    assert not out.requires_grad


def test_kernel_wrapper_takes_only_cuda_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 2, 128, 128, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_fwd(q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_tiles_divide_every_length_flash_ok_admits(dtype, hd):
    """models/attention.py::_flash_ok sends the kernel Sq and Sk that are
    multiples of 128; every tile the wrapper declares must divide 128, so
    that no such prompt is refused.  chip_smoke.py holds this table to the
    built library's fa_block_q/fa_block_k."""
    assert set(tfa.TILES) == {(d, h) for d in tfa._DTYPE_CODES
                              for h in tfa._HEAD_DIMS}
    block_q, block_k = tfa.TILES[(dtype, hd)]
    assert block_q > 0 and 128 % block_q == 0
    assert block_k > 0 and 128 % block_k == 0
    assert dtype in tfa.INSTANTIATIONS


def _fp32_kernel_model(q, k, v, causal, window, block_q, block_k):
    """The fp32 CUDA kernel's algorithm (csrc/flash_attention_fwd.cu,
    simt::fa_fwd_kernel) on the CPU, tile by tile: its loop bounds, the mask
    only on the tiles its need_mask picks, raw scores and exp2((s - m)
    scale log2 e), the -1e30 mask value, the sum clamped at 1e-30.  Asserts
    on the way that the bounds skip only wholly masked tiles and that every
    tile left unmasked is wholly kept."""
    bh, sq, hd = q.shape
    bkv, sk, _ = k.shape
    kx, vx = (t.repeat_interleave(bh // bkv, 0) for t in (k, v))
    scale_log2 = hd ** -0.5 * math.log2(math.e)
    n_k = sk // block_k
    out = torch.empty_like(q)
    for q0 in range(0, sq, block_q):
        kt_end = min(n_k, (q0 + block_q - 1) // block_k + 1) if causal else n_k
        # C++ division truncates toward zero
        kt_begin = (max(0, int((q0 - window + 1) / block_k))
                    if causal and window else 0)
        qpos = q0 + torch.arange(block_q)[:, None]
        m = torch.full((bh, block_q), -1e30)
        l = torch.zeros(bh, block_q)
        acc = torch.zeros(bh, block_q, hd)
        for kt in range(n_k):
            k0 = kt * block_k
            kpos = k0 + torch.arange(block_k)[None, :]
            ok = torch.ones(block_q, block_k, dtype=torch.bool)
            if causal:
                ok = kpos <= qpos
                if window:
                    ok &= kpos > qpos - window
            if not kt_begin <= kt < kt_end:
                assert not ok.any(), (q0, k0)
                continue
            need_mask = causal and (k0 + block_k - 1 > q0 or (
                window > 0 and k0 <= q0 + block_q - 1 - window))
            assert need_mask or ok.all(), (q0, k0)
            s = torch.einsum("bqd,bkd->bqk", q[:, q0:q0 + block_q],
                             kx[:, k0:k0 + block_k])
            if need_mask:
                s = torch.where(ok, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - m_new) * scale_log2)
            p = torch.exp2((s - m_new[..., None]) * scale_log2)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vx[:, k0:k0 + block_k]
            m = m_new
        out[:, q0:q0 + block_q] = acc / l.clamp_min(1e-30)[..., None]
    return out


# The sweep, and cases for the fp32 kernel's 64 x 64 tiles: a window no
# tile divides (rows wholly masked in a q tile's first key tile), g = 8,
# and q, k x 8 on an integer grid (the running max jumps between tiles).
FP32_TILE_CASES = [c + (1,) for c in SWEEP] + [
    (4, 2, 256, 256, 64, True, 100, 1), (2, 1, 256, 256, 256, True, 100, 1),
    (16, 2, 256, 256, 128, True, 0, 1), (4, 2, 256, 256, 64, True, 0, 8),
    (2, 1, 512, 512, 256, True, 64, 8)]


@pytest.mark.parametrize("bh,bkv,sq,sk,hd,causal,window,mag", FP32_TILE_CASES)
def test_fp32_kernel_tile_schedule_matches_jax(bh, bkv, sq, sk, hd, causal,
                                               window, mag):
    q, k, v = _qkv(4, bh, bkv, sq, sk, hd)
    if mag > 1:
        q, k = np.round(q * mag), np.round(k * mag)
    block_q, block_k = tfa.TILES[(torch.float32, hd)]
    got = _fp32_kernel_model(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal, window, block_q, block_k)
    ref = jax_ref_fa(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                     window=window)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=TOL["float32"])


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


# -------------------------------------------------------------------- rg-lru

from hypothesis import given, settings                     # noqa: E402
from hypothesis import strategies as st                    # noqa: E402

from repro.distributed import compression as np_compression  # noqa: E402
from repro.kernels.quantize import dequantize_int8 as jax_dequant  # noqa: E402
from repro.kernels.quantize import quantize_int8 as jax_quant  # noqa: E402
from repro.kernels.ref import ref_dequantize_int8 as jax_ref_dequant  # noqa: E402
from repro.kernels.ref import ref_quantize_int8 as jax_ref_quant  # noqa: E402
from repro.kernels.ref import ref_rglru as jax_ref_rglru    # noqa: E402
from repro.kernels.rglru import rglru_scan as jax_rglru_scan  # noqa: E402
from repro_torch.kernels import quantize as tq              # noqa: E402
from repro_torch.kernels import rglru as trg                # noqa: E402
from repro_torch.kernels.ref import ref_rglru               # noqa: E402

# tests/test_kernels.py:84-89 and its tolerances (:99)
RGLRU_SWEEP = [(2, 256, 512, 128, 512), (1, 128, 1024, 64, 256),
               (3, 512, 256, 256, 256), (2, 128, 128, 128, 128)]
RGLRU_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _rglru_inputs(seed, b, s, d, a_scale=0.98):
    rng = np.random.default_rng(seed)
    a = a_scale / (1 + np.exp(-rng.standard_normal((b, s, d))))
    x = rng.standard_normal((b, s, d)) * 0.1
    h0 = rng.standard_normal((b, d))
    return a.astype(np.float32), x.astype(np.float32), h0.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,d,chunk,block_d", RGLRU_SWEEP)
def test_rglru_matches_jax(dtype, b, s, d, chunk, block_d):
    a, x, h0 = _rglru_inputs(0, b, s, d)
    ja, jx = (jnp.asarray(t).astype(dtype) for t in (a, x))
    ta, tx = (torch.from_numpy(t).to(getattr(torch, dtype)) for t in (a, x))
    launches = ops.RGLRU_LAUNCHES
    hs, hl = ops.rglru(ta, tx, torch.from_numpy(h0))
    assert ops.RGLRU_LAUNCHES == launches, "a CPU call launches no kernel"
    assert hs.dtype == hl.dtype == torch.float32
    assert hs.shape == (b, s, d) and hl.shape == (b, d)
    ker = jax_rglru_scan(ja, jx, jnp.asarray(h0), chunk=chunk,
                         block_d=block_d, interpret=True)
    ref = jax_ref_rglru(ja, jx, jnp.asarray(h0))
    for want in (ker, ref):
        np.testing.assert_allclose(hs.numpy(), _np(want[0]),
                                   atol=RGLRU_TOL[dtype])
        np.testing.assert_allclose(hl.numpy(), _np(want[1]),
                                   atol=RGLRU_TOL[dtype])


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 3), st.integers(1, 4))
def test_rglru_linearity_property(b, chunks):
    """Twin of tests/test_kernels.py:104: the recurrence is linear in x,
    h(x1) + h(x2) == h(x1 + x2) with h0 = 0 (atol 1e-4)."""
    s, d = chunks * 64, 128
    a, x1, _ = _rglru_inputs(b * 13 + chunks, b, s, d, a_scale=0.95)
    _, x2, _ = _rglru_inputs(b * 13 + chunks + 1, b, s, d)
    ta, t1, t2 = (torch.from_numpy(t) for t in (a, x1, x2))
    h0 = torch.zeros(b, d)
    h_a, _ = ops.rglru(ta, t1, h0)
    h_b, _ = ops.rglru(ta, t2, h0)
    h_ab, _ = ops.rglru(ta, t1 + t2, h0)
    np.testing.assert_allclose((h_a + h_b).numpy(), h_ab.numpy(), atol=1e-4)


def test_ref_rglru_matches_a_loop_over_time():
    """The doubling scan against the recurrence written as a loop, in
    float64: any S (here not a power of two) and a carried h0."""
    a, x, h0 = _rglru_inputs(3, 2, 37, 24)
    hs, hl = ref_rglru(*(torch.from_numpy(t) for t in (a, x, h0)))
    h = h0.astype(np.float64)
    want = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + x[:, t]
        want.append(h)
    np.testing.assert_allclose(hs.numpy(), np.stack(want, 1), atol=1e-6)
    np.testing.assert_allclose(hl.numpy(), want[-1], atol=1e-6)


# The kernel's tile plan (csrc/rglru_scan.cu): ragged S and D, S below a
# chunk, S = 1, the long-S stress shape and the two serving shapes.
RGLRU_PLAN_SHAPES = [(1, 1, 1), (3, 1, 300), (2, 63, 64), (2, 64, 512),
                     (2, 65, 512), (2, 300, 200), (1, 129, 1000),
                     (1, 16384, 256), (1, 2560, 4096), (2, 2560, 4096)]


def _plan_tile(plan, b, s, d, ticket):
    """Tile ``ticket`` as the kernel maps it: chunk-major over columns
    (batch row, lane tile).  Returns (b, t0, t1, d0, d1)."""
    columns = b * plan.lane_tiles
    chunk, column = divmod(ticket, columns)
    bi, tile = divmod(column, plan.lane_tiles)
    t0, d0 = chunk * plan.chunk, tile * plan.lanes
    return bi, t0, min(t0 + plan.chunk, s), d0, min(d0 + plan.lanes, d)


@pytest.mark.parametrize("b,s,d", RGLRU_PLAN_SHAPES)
def test_rglru_plan_tiles_cover_every_element_once(b, s, d):
    plan = trg.rglru_plan(b, s, d)
    assert (plan.chunk, plan.lanes) == (trg.CHUNK, trg.LANES)
    assert plan.n_chunks == -(-s // plan.chunk)
    assert plan.lane_tiles == -(-d // plan.lanes)
    assert plan.tiles == plan.n_chunks * b * plan.lane_tiles
    seen = np.zeros((b, s, d), np.int8)
    for ticket in range(plan.tiles):
        bi, t0, t1, d0, d1 = _plan_tile(plan, b, s, d, ticket)
        assert t0 < t1 and d0 < d1, "no tile is empty"
        seen[bi, t0:t1, d0:d1] += 1
        if t0 > 0:     # its predecessor in time holds an earlier ticket
            assert _plan_tile(plan, b, s, d, ticket - b * plan.lane_tiles) \
                == (bi, t0 - plan.chunk, t0, d0, d1)
    assert (seen == 1).all()
    # a u32 ticket and a flag a tile, zeroed per call; then an (A, X) pair
    # and a carry-out a lane for all chunks but the last
    carried = (plan.n_chunks - 1) * b * d
    assert plan.flags_offset == 4
    assert plan.flag_bytes == plan.flags_offset + 4 * plan.tiles
    assert plan.agg_offset % 256 == 0
    assert 0 <= plan.agg_offset - plan.flag_bytes < 256
    assert plan.incl_offset == plan.agg_offset + 8 * carried
    assert plan.scratch_bytes == plan.incl_offset + 4 * carried


def test_rglru_plan_at_the_serving_shape():
    """(2, 2560, 4096): 40 chunks x 64 columns; 3.8 MB of scratch, 1.5% of
    the 251.7 MB the kernel must move."""
    plan = trg.rglru_plan(2, 2560, 4096)
    assert plan[:5] == (64, 128, 40, 32, 2560)      # chunk, lanes, tiles
    assert (plan.flag_bytes, plan.agg_offset, plan.scratch_bytes) == (
        10_244, 10_496, 10_496 + 12 * 39 * 8192)
    assert trg.rglru_plan(1, 2560, 4096).tiles == 1280


def test_rglru_plan_passes_down_as_the_kernels_struct():
    """The launch hands the plan to the kernel as ten 64-bit integers in
    the order of its ``Plan`` struct (csrc/rglru_scan.cu)."""
    plan = trg.rglru_plan(2, 300, 200)
    assert trg.RglruPlan._fields == (
        "chunk", "lanes", "n_chunks", "lane_tiles", "tiles", "flags_offset",
        "flag_bytes", "agg_offset", "incl_offset", "scratch_bytes")
    struct = ("long long chunk, lanes, n_chunks, lane_tiles, tiles;\n"
              "  long long flags_offset, flag_bytes, agg_offset, incl_offset, "
              "scratch_bytes;")
    assert struct in trg.SOURCE.read_text()
    assert all(isinstance(v, int) and 0 <= v < 2 ** 63 for v in plan)


def test_rglru_scratch_traffic_from_the_counters():
    b, s, d = 2, 300, 200                 # 5 chunks x 2 lane tiles x 2 rows
    plan = trg.rglru_plan(b, s, d)
    counts = torch.tensor([1000, 30, 600])
    got = trg.scratch_traffic(plan, b, d, counts)
    carried = 4 * b * d                   # lanes of chunks 0..3
    assert got == {"written_bytes": 4 * carried + 8 * 600 + 8 * 20,
                   "read_bytes": 4 * carried + 8 * 1000 + 128 * 30,
                   "atomic_bytes": 8 * 20, "lanes_folded": 1000,
                   "lanes_published": 600, "flag_polls": 30}


def _chunked_rglru(a, x, h0, chunk):
    """The algebra the kernel implements, in plain torch fp32: per chunk the
    product A of its a_t and its scan X from h = 0; the carry into a chunk
    is the composition of every earlier chunk's (A, X) applied to h0, and
    the chunk's outputs are recomputed from that carry."""
    b, s, d = a.shape
    h_seq = torch.empty(b, s, d)
    carry = h0.clone()
    for t0 in range(0, s, chunk):
        prod, scan, h = torch.ones(b, d), torch.zeros(b, d), carry
        for t in range(t0, min(t0 + chunk, s)):
            scan = a[:, t] * scan + x[:, t]
            prod = prod * a[:, t]
            h = a[:, t] * h + x[:, t]
            h_seq[:, t] = h
        carry = prod * carry + scan
    return h_seq, carry


@pytest.mark.parametrize("b,s,d,pallas_chunk", [
    (2, 300, 200, 100), (1, 129, 1000, 129), (3, 1, 300, 1), (2, 63, 64, 63),
    (2, 65, 128, 65)])
def test_rglru_chunk_composition_matches_jax(b, s, d, pallas_chunk):
    """The chunk-aggregate composition (at the kernel's chunk) against the
    JAX oracle and the interpreted Pallas kernel, at 1e-5 in fp32, on
    ragged S and D, S below a chunk and S = 1."""
    a, x, h0 = _rglru_inputs(7, b, s, d)
    hs, hl = _chunked_rglru(*(torch.from_numpy(t) for t in (a, x, h0)),
                            trg.CHUNK)
    ker = jax_rglru_scan(*(jnp.asarray(t) for t in (a, x, h0)),
                         chunk=pallas_chunk, block_d=d, interpret=True)
    ref = jax_ref_rglru(*(jnp.asarray(t) for t in (a, x, h0)))
    for want in (ker, ref):
        np.testing.assert_allclose(hs.numpy(), _np(want[0]), atol=1e-5)
        np.testing.assert_allclose(hl.numpy(), _np(want[1]), atol=1e-5)


def test_rglru_refuses_grad():
    a, x, h0 = (torch.from_numpy(t) for t in _rglru_inputs(4, 1, 8, 16))
    with pytest.raises(NotImplementedError, match="training"):
        ops.rglru(a.requires_grad_(), x, h0)


# ----------------------------------------------------------------- quantize

QUANT_SIZES = [(4096, 256), (512, 128), (65536, 256)]   # test_kernels.py:49


@pytest.mark.parametrize("n,block", QUANT_SIZES)
def test_quantize_matches_jax_and_numpy(n, block):
    """Codes exact, scales rtol 1e-6, against the interpreted Pallas kernel,
    the JAX oracle and the numpy path of the proxy trainer."""
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32) * 3
    launches = (ops.QUANT_LAUNCHES, ops.DEQUANT_LAUNCHES)
    q, s = ops.quantize_int8(torch.from_numpy(x), block=block)
    assert q.dtype == torch.int8 and q.shape == (n // block, block)
    assert s.dtype == torch.float32 and s.shape == (n // block,)
    jq, js = jax_quant(jnp.asarray(x), block=block, interpret=True)
    rq, rs = jax_ref_quant(jnp.asarray(x), block=block)
    nq, ns, _ = np_compression.quantize_int8(x, block=block)
    for want_q, want_s in ((jq, js), (rq, rs), (nq, ns)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=1e-6)
    xr = ops.dequantize_int8(q, s)
    assert xr.dtype == torch.float32 and xr.shape == (n,)
    assert (ops.QUANT_LAUNCHES, ops.DEQUANT_LAUNCHES) == launches
    for want in (jax_dequant(jq, js, interpret=True),
                 jax_ref_dequant(rq, rs), np_compression.dequantize_int8(
                     nq, ns, (n,))):
        np.testing.assert_allclose(xr.numpy(), np.asarray(want), rtol=1e-6)


def test_quantize_codes_at_half_steps_round_to_even():
    """Values that land on .5 code steps: round half to even, as np.rint;
    the division by the scale (not a reciprocal product) keeps them exact."""
    x = (np.arange(256, dtype=np.float32) - 128) / 2
    x[0] = 127.0                                # scale 1.0 exactly
    q, s = ops.quantize_int8(torch.from_numpy(x))
    assert float(s[0]) == 1.0
    np.testing.assert_array_equal(q.numpy()[0], np.clip(np.rint(x), -127, 127))


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 16), st.floats(0.01, 100.0))
def test_quantize_error_bound_property(nblocks, scale_mag):
    """Twin of tests/test_kernels.py:63: |x - dequant(quant(x))| is at most
    half a quantization step per block."""
    n = nblocks * 256
    x = (np.random.default_rng(nblocks).standard_normal(n)
         * scale_mag).astype(np.float32)
    q, s = ops.quantize_int8(torch.from_numpy(x))
    xr = ops.dequantize_int8(q, s)
    err = (xr - torch.from_numpy(x)).abs().numpy().reshape(nblocks, 256)
    assert (err <= s.numpy()[:, None] * 0.5 + 1e-6).all()


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 5))
def test_quantize_idempotent_property(seed):
    """Twin of tests/test_kernels.py:77: quant(dequant(quant(x))) is a
    fixed point (atol 1e-5)."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        1024).astype(np.float32) * 2)
    x1 = ops.dequantize_int8(*ops.quantize_int8(x))
    x2 = ops.dequantize_int8(*ops.quantize_int8(x1))
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), atol=1e-5)


def test_new_kernel_wrappers_take_only_cuda_tensors():
    a, x, h0 = (torch.from_numpy(t) for t in _rglru_inputs(5, 1, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        trg.rglru_scan(a, x, h0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq.quantize_int8(torch.zeros(256))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq.dequantize_int8(torch.zeros((1, 256), dtype=torch.int8),
                           torch.ones(1))


def test_reset_launch_counts_resets_every_counter(monkeypatch):
    for name in ("FLASH_LAUNCHES", "RGLRU_LAUNCHES", "QUANT_LAUNCHES",
                 "DEQUANT_LAUNCHES"):
        monkeypatch.setattr(ops, name, 7)
    ops.reset_launch_counts()
    assert (ops.FLASH_LAUNCHES, ops.RGLRU_LAUNCHES, ops.QUANT_LAUNCHES,
            ops.DEQUANT_LAUNCHES) == (0, 0, 0, 0)
