"""Plain float32 training steps: cross-entropy, autograd, AdamW with
global-norm clipping and decoupled weight decay on every leaf, a linear
warm-up then cosine schedule; the batch in rows, each row's gradient
added in (every row has the same number of tokens, so the sum over rows
of each row's mean over R is the batch's mean).  And the token batches,
from the seed by the data pipeline's published rule."""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import model as ref


def token_batch(seed: int, index: int, vocab: int, batch: int, seq: int):
    """Batch ``index`` of the stream of ``seed``: (tokens, targets), each
    (batch, seq) int32, drawn by Philox(key=seed, counter=index) as
    ``batch`` rows of ``seq + 1`` uniform ids, targets shifted by one."""
    g = np.random.Generator(np.random.Philox(key=seed, counter=index))
    t = g.integers(0, vocab, size=(batch, seq + 1), dtype=np.int64)
    t = t.astype(np.int32)
    return t[:, :-1], t[:, 1:]


def lr_at(step: int, opt: dict) -> float:
    """The schedule's rate at ``step`` (0-based)."""
    base, warm, total = opt["lr"], opt["warmup"], opt["total_steps"]
    if step < warm:
        return base * min((step + 1.0) / max(warm, 1), 1.0)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    lo = opt.get("min_lr_frac", 0.1)
    return base * (lo + (1 - lo) * 0.5 * (1 + math.cos(math.pi * prog)))


def leaf_items(tree, prefix=""):
    """``(path, tensor)`` of each leaf, dict keys sorted, a stacked leaf
    (under ``units``) split into its layers."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += leaf_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            out += leaf_items(x, f"{prefix}{i}/")
    elif prefix.startswith("units/"):
        out += [(f"{prefix[:-1]}[{i}]", t) for i, t in
                enumerate(tree.unbind(0))]
    else:
        out.append((prefix[:-1], tree))
    return out


def norms(tree) -> dict:
    return {k: float(torch.linalg.vector_norm(t.float()))
            for k, t in leaf_items(tree)}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(tree[k], fn) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree):
    out = []
    _map(tree, out.append)
    return out


def train(hf, params0, batches, opt, *, prec=ref.FP32):
    """``len(batches)`` AdamW steps from ``params0`` (float32 tree, left
    as it is).  Returns the losses, the norms of each leaf's first
    gradient as the optimizer takes it (clipped) and of each leaf's change
    after the last step."""
    p = _map(params0, lambda t: t.detach().clone().float().requires_grad_())
    m = _map(p, torch.zeros_like)
    v = _map(p, torch.zeros_like)
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, first = [], None
    for t, (tok, tgt) in enumerate(batches):
        rows = tok.shape[0]
        total = 0.0
        for r in range(rows):
            part = ref.loss(hf, p, tok[r:r + 1], tgt[r:r + 1], prec=prec)
            (part / rows).backward()
            total += part.item() / rows
        losses.append(total)
        with torch.no_grad():
            leaves = _leaves(p)
            gnorm = math.sqrt(sum(float(torch.sum(x.grad * x.grad))
                                  for x in leaves))
            scale = min(opt["clip_norm"] / (gnorm + 1e-12), 1.0)
            c = t + 1
            b1c, b2c = 1.0 - b1 ** c, 1.0 - b2 ** c
            lr = lr_at(t, opt)
            for x, mx, vx in zip(leaves, _leaves(m), _leaves(v)):
                g = x.grad * scale
                mx.mul_(b1).add_((1 - b1) * g)
                vx.mul_(b2).add_((1 - b2) * g * g)
                step = (mx / b1c) / (torch.sqrt(vx / b2c) + eps)
                x.sub_(lr * (step + wd * x))
                x.grad = None
            if first is None:
                first = norms(_map(m, lambda mx: mx / (1 - b1)))
    with torch.no_grad():
        change = norms(_map2(p, params0, lambda a, b: a - b.float()))
    return {"losses": losses, "grads": first, "change": change}


def _map2(a, b, fn):
    if isinstance(a, dict):
        return {k: _map2(a[k], b[k], fn) for k in sorted(a)}
    if isinstance(a, (list, tuple)):
        return [_map2(x, y, fn) for x, y in zip(a, b)]
    return fn(a, b)
