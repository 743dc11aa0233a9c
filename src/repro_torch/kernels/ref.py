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
