"""The train step (torch twin of ``repro.train.step``).

The returned step function is a pure (state, batch) -> (state, metrics)
map over trees of tensors, as the reference's: it builds a new state and
leaves its input as it was.  The reference attaches shardings here; the
port runs on one device, so there is no mesh or rules argument (as in the
serve CLI), and ``make_serve_fns`` and ``dryrun_spec`` are left out:
serving goes through ``serve/engine.py``, and the dry-run is ROADMAP.md,
Queue 1, item 7.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.models.layers import DEFAULT_POLICY, Policy
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import AdamWCfg, adamw_update, cosine_schedule


def softmax_xent(logits, targets):
    """fp32 cross-entropy, mean over tokens.  logits (B,S,V) targets (B,S)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def default_accum(cfg: ArchConfig, shape: ShapeCfg) -> int:
    """Microbatching heuristic: bound activation memory for big models."""
    if shape.kind != "train":
        return 1
    n = cfg.n_params()
    if n > 2e10:
        return 8
    if n > 5e9:
        return 4
    if n > 5e8:
        return 2
    return 1


def loss_and_grads(cfg: ArchConfig, params, batch, *,
                   policy: Policy = DEFAULT_POLICY, remat: bool = True,
                   accum_steps: int = 1):
    """(loss, aux, grads) of the training objective at ``params``, the
    batch split into ``accum_steps`` microbatches whose fp32 gradients are
    summed and averaged, as the reference's ``lax.scan`` over microbatches.
    With one microbatch the gradients keep the params' dtypes, as
    ``jax.value_and_grad``'s."""
    api = get_api(cfg)

    def micro(mb):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        logits, aux = api.forward(cfg, p, mb, policy, remat)
        loss = softmax_xent(logits, mb["targets"])
        grads = torch.autograd.grad(loss + aux, tree_leaves(p))
        return loss.detach(), aux.detach(), tree_unflatten(params, grads)

    if accum_steps == 1:
        return micro(batch)
    a = accum_steps
    n = next(iter(batch.values())).shape[0] // a
    gsum = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                          device=t.device), params)
    dev = tree_leaves(params)[0].device
    lsum = torch.zeros((), dtype=torch.float32, device=dev)
    asum = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(a):
        l, x, g = micro({k: v[i * n:(i + 1) * n] for k, v in batch.items()})
        gsum = tree_unflatten(gsum, [s + d for s, d in
                                     zip(tree_leaves(gsum), tree_leaves(g))])
        lsum, asum = lsum + l, asum + x
    div = torch.tensor(float(a), dtype=torch.float32, device=dev)
    return lsum / div, asum / div, tree_map(lambda g: g / div, gsum)


def make_train_step(cfg: ArchConfig, *,
                    accum_steps: int = 1,
                    policy: Policy = DEFAULT_POLICY,
                    base_lr: float = 3e-4,
                    warmup: int = 100,
                    total_steps: int = 10000,
                    adamw: AdamWCfg = AdamWCfg(),
                    remat: bool = True,
                    master_fp32: bool = False,
                    max_seq: int = 4096):
    """Returns ``step_fn(state, batch) -> (state, metrics)``.  ``max_seq``
    is kept for the reference's signature (it sizes the state, which the
    caller builds).

    master_fp32: params live in bf16; AdamW updates the fp32 master in opt
    state and re-casts."""
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)

    def train_step(state, batch):
        params = state["params"]
        loss, aux, grads = loss_and_grads(cfg, params, batch, policy=policy,
                                          remat=remat,
                                          accum_steps=accum_steps)
        lr = lr_fn(state["step"])
        if master_fp32:
            opt = dict(state["opt"])
            master = opt.pop("master")
            new_master, new_opt, om = adamw_update(master, grads, opt, lr,
                                                   adamw)
            new_opt["master"] = new_master
            new_params = tree_map(lambda p: p.to(torch.bfloat16), new_master)
        else:
            new_params, new_opt, om = adamw_update(params, grads,
                                                   state["opt"], lr, adamw)
        new_state = dict(state, params=new_params, opt=new_opt,
                         step=state["step"] + 1,
                         data_cursor=state["data_cursor"] + 1)
        metrics = {"loss": loss, "aux_loss": aux, "lr": lr, **om}
        return new_state, metrics

    return train_step
