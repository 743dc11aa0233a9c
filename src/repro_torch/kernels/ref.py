"""Plain PyTorch versions of the port's kernels (twins of
``repro.kernels.ref``).  The CPU path and the tests use them; on the card
``chip_smoke.py`` holds each kernel against them."""
from __future__ import annotations

import torch


def ref_flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """q (BH, Sq, hd); k, v (BKV, Sk, hd) with BH = BKV * G.
    fp32 softmax, GQA via head-group folding."""
    bh, sq, hd = q.shape
    bkv, sk, _ = k.shape
    g = bh // bkv
    scale = hd ** -0.5 if scale is None else scale
    qf = q.reshape(bkv, g, sq, hd).float()
    s = torch.einsum("bgqd,bkd->bgqk", qf, k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        ok = kpos <= qpos
        if window:
            ok &= kpos > (qpos - window)
        s = torch.where(ok[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqk,bkd->bgqd", p, v.float())
    return o.reshape(bh, sq, hd).to(q.dtype)


def ref_rglru(a, x, h0):
    """Linear recurrence h_t = a_t * h_{t-1} + x_t over axis 1.
    a, x (B, S, D); h0 (B, D).  Returns (h_seq (B,S,D) fp32, h_last).

    As the reference, a_0 * h0 is folded into x_0 and the sequence is
    scanned from zero.  The scan doubles its reach each step (log2 S
    shifted multiply-adds), close to the summation order of the
    reference's associative scan.  Every step builds a new tensor (no
    in-place write), so autograd differentiates it: the hybrid trains
    through it, as the reference trains through its associative scan."""
    a = a.float()
    x = x.float()
    h = torch.cat([x[:, :1] + a[:, :1] * h0.float()[:, None], x[:, 1:]],
                  dim=1)
    s = h.shape[1]
    off = 1
    while off < s:
        h = torch.cat([h[:, :off], h[:, off:] + a[:, off:] * h[:, :-off]],
                      dim=1)
        if off * 2 < s:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return h, h[:, -1]


def ref_quantize_int8(x, block: int = 256):
    """x (N,) (N % block == 0) -> (q int8 (N//block, block), scales fp32).
    ``torch.round`` rounds half to even, as ``jnp.round`` and ``np.rint``.
    The divisor 127 is a tensor: on CUDA, PyTorch divides by a Python
    scalar as a product with its reciprocal, which moves a scale by an ulp;
    a tensor divisor keeps IEEE division, as numpy and jnp do."""
    blocks = x.float().reshape(-1, block)
    amax = torch.clamp_min(blocks.abs().amax(dim=1), 1e-12)
    scales = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127)
    return q.to(torch.int8), scales


def ref_dequantize_int8(q, scales):
    return (q.float() * scales[:, None]).reshape(-1)
