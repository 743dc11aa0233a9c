"""The train step (torch twin of ``repro.train.step``).

``make_train_step`` returns a pure (state, batch) -> (state, metrics) map
over trees of tensors, as the reference's: it builds a new state and
leaves its input as it was.  ``make_train_step_`` returns the same step
written into its state: every leaf of the TrainState gets its new value in
place, bit for bit the pure step's.  ``GraphedTrainStep`` captures that
in-place step as one CUDA graph and replays it, the counterpart of the
reference's ``jax.jit(step_fn, donate_argnums=(0,))``
(``repro/train/loop.py:64``).  The reference attaches shardings to its
train step here; the port's trains on one device (training on DTensors
is ROADMAP.md, Queue 1, item 6b-train), and ``dryrun_spec`` is item 7.
``make_serve_fns`` is the reference's: the prefill and decode with the
sharding context installed, the forward the engine runs on a mesh.
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed.sharding import ShardingRules, sharding_ctx
from repro_torch.kernels import ops
from repro_torch.models.attention import get_attention_backend
from repro_torch.models.layers import DEFAULT_POLICY, Policy
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.registry import get_api
from repro_torch.models.rglru import get_recurrence_backend
from repro_torch.optim.adamw import (AdamWCfg, adamw_update, adamw_update_,
                                     const_f32, cosine_schedule)


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
    div = const_f32(a, lsum)
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


def make_train_step_(cfg: ArchConfig, *,
                     accum_steps: int = 1,
                     policy: Policy = DEFAULT_POLICY,
                     base_lr: float = 3e-4,
                     warmup: int = 100,
                     total_steps: int = 10000,
                     adamw: AdamWCfg = AdamWCfg(),
                     remat: bool = True,
                     master_fp32: bool = False,
                     max_seq: int = 4096):
    """``make_train_step``'s step written into its state: returns
    ``step_(state, batch) -> metrics``.  The params, ``m``, ``v``,
    ``count``, ``master`` (under master_fp32), ``step`` and
    ``data_cursor`` get their new values in their own tensors, bit for bit
    the pure step's; the tree and its tensors stay the same objects.  It
    copies nothing from the host once its constants exist (its first run
    makes them), so it can be captured."""
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)

    def train_step_(state, batch):
        params, opt = state["params"], state["opt"]
        loss, aux, grads = loss_and_grads(cfg, params, batch, policy=policy,
                                          remat=remat,
                                          accum_steps=accum_steps)
        lr = lr_fn(state["step"])
        if master_fp32:
            om = adamw_update_(opt["master"], grads, opt, lr, adamw)
            with torch.no_grad():
                for p, m in zip(tree_leaves(params),
                                tree_leaves(opt["master"])):
                    p.copy_(m.to(torch.bfloat16))
        else:
            om = adamw_update_(params, grads, opt, lr, adamw)
        state["step"].add_(1)
        state["data_cursor"].add_(1)
        return {"loss": loss, "aux_loss": aux, "lr": lr, **om}

    return train_step_


def make_serve_fns(cfg: ArchConfig, mesh, rules: ShardingRules, *,
                   policy: Policy = DEFAULT_POLICY, max_cache: int = 0):
    """(prefill_fn, decode_fn) with the sharding context installed, as the
    reference's (``repro/train/step.py:135-149``): ``prefill(params,
    batch)`` with ``batch = {"tokens", **extras}`` and ``decode(params,
    cache, token, pos)``.  On a mesh the params and the cache are DTensors
    laid out by ``param_shardings`` (``ServeEngine`` lays them out so);
    the token ids, positions and extras may be plain, whole on every
    rank.  The logits come out split over the vocab."""
    api = get_api(cfg)

    def prefill(params, batch):
        with sharding_ctx(mesh, rules):
            tokens = batch["tokens"]
            extras = {k: v for k, v in batch.items() if k != "tokens"}
            return api.prefill(cfg, params, tokens, extras,
                               max_cache or tokens.shape[1], policy)

    def decode(params, cache, token, pos):
        with sharding_ctx(mesh, rules):
            return api.decode(cfg, params, cache, token, pos, policy)

    return prefill, decode


class GraphedTrainStep:
    """The train step as one CUDA graph over the caller's TrainState:
    ``step(state, batch) -> (state, metrics)``, the same ``state`` object,
    its tensors holding the new values.

    The first call of a key runs ``make_train_step_`` eagerly on a side
    stream (a real step: it builds the kernels, sets up cuBLAS on that
    stream and makes the step's constants; its launches count), then
    captures the same step on that stream, so that the autograd backward
    runs on the capture stream and its gradients live in the graph's
    pool.  The capture runs nothing: its launches are taken off the
    counters, and each replay adds them (``ops.CountedGraph``).  Later
    calls copy the batch into static buffers and replay.  ``metrics`` are
    the graph's static outputs: read them before the next call.

    The key is the batch's shapes and dtypes, the attention and recurrence
    backends and the deterministic-algorithms flag, and the graph holds
    the addresses of the state's leaves: a new key, or any leaf rebound (a
    restore, another state), drops the graph and captures again.  A
    capture that fails raises; nothing falls back to the eager step."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", **step_kw):
        self.device = resolve_device(device)
        self._step = make_train_step_(cfg, **step_kw)
        #: seconds spent capturing (the first, eager step not included)
        self.capture_s = 0.0
        self.captures = 0
        self._graph = None              # ops.CountedGraph
        self._key = None
        self._leaves = []
        self._batch = {}                # static inputs
        self._metrics = None            # static outputs
        self._stream = None

    def __call__(self, state, batch):
        leaves = tree_leaves(state)
        key = (tuple(sorted((k, tuple(v.shape), v.dtype)
                            for k, v in batch.items())),
               get_attention_backend(), get_recurrence_backend(),
               torch.are_deterministic_algorithms_enabled())
        if (self._graph is None or key != self._key
                or len(leaves) != len(self._leaves)
                or any(a is not b for a, b in zip(leaves, self._leaves))):
            return state, self._capture(state, batch, key, leaves)
        for k, v in batch.items():
            self._batch[k].copy_(v)
        self._graph.replay()
        return state, self._metrics

    @contextlib.contextmanager
    def _on_side_stream(self):
        """The block runs on the side stream, after the current stream's
        queued work and before its next (off CUDA: as it is)."""
        if self.device.type != "cuda":
            yield
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            yield
        current.wait_stream(self._stream)

    def _record(self, step):
        """``step`` captured into a new CUDA graph on the side stream:
        (graph, its outputs)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream):
            out = step()
        return graph, out

    def _capture(self, state, batch, key, leaves):
        # drop the old graph, its static tensors and its pool first
        self._graph = self._metrics = None
        self._batch = {k: v.clone() for k, v in batch.items()}
        self._key, self._leaves = key, leaves
        step = functools.partial(self._step, state, self._batch)
        with self._on_side_stream():
            metrics = step()                    # the first step, eagerly
        t0 = time.perf_counter()
        recorded = []
        launches = ops.capture_launches(
            lambda: recorded.extend(self._record(step)))
        synchronize(self.device)
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        graph, self._metrics = recorded
        self._graph = ops.CountedGraph(graph, launches)
        return metrics
