"""The port's flash-attention entry point against the JAX package.

On CPU tensors ``repro_torch.kernels.ops.flash_attention`` runs the
kernel's plain PyTorch version; it is held against the JAX oracle and the
Pallas kernel in interpret mode (as tests/test_kernels.py runs it), on the
same numpy inputs.  The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def test_flash_attention_refuses_grad():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 2, 128, 128, 64))
    with pytest.raises(NotImplementedError, match="training"):
        ops.flash_attention(q.requires_grad_(), k, v)
    with torch.inference_mode():
        ops.flash_attention(q.detach(), k, v)


def test_kernel_wrapper_takes_only_cuda_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 2, 128, 128, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_fwd(q, k, v)


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
