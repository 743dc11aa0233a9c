"""The train step (torch twin of ``repro.train.step``).

``make_train_step(cfg, mesh, rules)`` returns ``(step_fn, st_shard)``, as
the reference's: ``step_fn`` is a pure (state, batch) -> (state, metrics)
map over trees of tensors that builds a new state and leaves its input as
it was, and ``st_shard`` the state's ``Layout`` tree
(``train/state.py::state_shardings``).  On a mesh the state is DTensors
laid out by it, and the step runs under ``sharding_ctx(mesh, rules)``:
the forward on DTensors (the flash kernel on each rank's own heads
through ``sharding.local_map``), the loss over the vocab-split logits
without gathering them (``softmax_xent``), autograd back through
DTensor's ops, each gradient brought to its param's layout (the
data-parallel all-reduce, FSDP's reduce-scatter), and AdamW on each
rank's shards.  With ``mesh=None`` it trains plain tensors on one device
(``st_shard`` is None).

``make_train_step_`` returns the same step written into its state: every
leaf of the TrainState gets its new value in place, bit for bit the pure
step's.  ``GraphedTrainStep`` captures that in-place step as one CUDA
graph and replays it, the counterpart of the reference's
``jax.jit(step_fn, donate_argnums=(0,))`` (``repro/train/loop.py:64``).
``dryrun_spec`` gives a step with its abstract (``meta``) inputs and their
layouts.  ``make_serve_fns`` is the reference's: the prefill and decode
with the sharding context installed, the forward the engine runs on a
mesh.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.core import trace
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed.sharding import (ShardingRules, copy_into,
                                              is_dtensor, lay_out, layout_for,
                                              like_layout, local,
                                              microbatches, param_shardings,
                                              sharding_ctx, window)
from repro_torch.kernels import ops
from repro_torch.models.attention import get_attention_backend
from repro_torch.models.layers import DEFAULT_POLICY, Policy
from repro_torch.models.params import (abstract_params, tree_leaves,
                                       tree_map, tree_unflatten)
from repro_torch.models.registry import (batch_logical_axes, batch_specs,
                                         get_api)
from repro_torch.models.rglru import get_recurrence_backend
from repro_torch.optim.adamw import (AdamWCfg, adamw_update, adamw_update_,
                                     const_f32, cosine_schedule)
from repro_torch.train.state import abstract_train_state, state_shardings


def softmax_xent(logits, targets):
    """fp32 cross-entropy, mean over tokens.  logits (B,S,V) targets (B,S).

    DTensor logits (split over the vocab on a mesh, and over the batch)
    are never gathered: each rank works on its own rows and vocab window
    (``_VocabParallelXent``) and the loss is one value, the same on every
    rank, as a plain 0-d tensor."""
    if is_dtensor(logits):
        return _vocab_parallel_xent(logits, targets)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


class _VocabParallelXent(torch.autograd.Function):
    """``softmax_xent`` on one rank's block of the logits: x (b, s, v) fp32,
    the rows ``t`` (b, s) of its tokens and the vocab window starting at
    ``v0``.  The row maxima are all-reduced (max) over ``vocab_groups``,
    then the sums of exponentials and the gold logits (each target lies
    in one window; the others add zero) in one all-reduce; the tokens'
    sum is all-reduced over ``token_groups``: (b, s)-sized collectives and
    a scalar, never the logits.  The forward is ``torch.logsumexp``'s own
    sequence (max, shift, exp, sum, log, add) and the backward autograd's
    for ``softmax_xent`` (``grad · exp(x − lse)``, the gold's ``−grad``
    added at each target), so with no group (one rank) it is that
    function bit for bit; over split windows the sums are added in
    another order."""

    @staticmethod
    def forward(ctx, x, t, v0, vocab_groups, token_groups, n_tokens):
        m = torch.amax(x, dim=-1, keepdim=True)
        for g in vocab_groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        m.masked_fill_(m.abs() == float("inf"), 0)
        se = torch.sum(torch.exp(x - m), dim=-1)
        idx = t - v0
        mine = (idx >= 0) & (idx < x.shape[-1])
        idx = torch.where(mine, idx, torch.zeros_like(idx))
        gold = torch.gather(x, -1, idx[..., None])[..., 0]
        if vocab_groups:
            both = torch.stack([se, torch.where(mine, gold,
                                                torch.zeros_like(gold))])
            for g in vocab_groups:
                dist.all_reduce(both, group=g)
            se, gold = both[0], both[1]
        lse = torch.log(se) + m[..., 0]
        tok = lse - gold
        if token_groups:
            total = torch.sum(tok)
            for g in token_groups:
                dist.all_reduce(total, group=g)
            n = const_f32(n_tokens, total)
            loss = total / n
        else:
            n, loss = n_tokens, torch.mean(tok)
        ctx.save_for_backward(x, lse, idx, mine)
        ctx.n = n
        return loss

    @staticmethod
    def backward(ctx, g):
        x, lse, idx, mine = ctx.saved_tensors
        if isinstance(ctx.n, torch.Tensor):
            gt = (g / ctx.n).expand(lse.shape)       # (sum / n)'s backward
        else:
            gt = g.expand(lse.shape) / ctx.n         # mean's backward
        gx = gt[..., None] * torch.exp(x - lse[..., None])
        neg = torch.where(mine, -gt, torch.zeros_like(gt))
        gx = gx.scatter_add(-1, idx[..., None], neg[..., None])
        return gx, None, None, None, None, None


def _vocab_parallel_xent(logits, targets):
    """``softmax_xent`` of DTensor logits (B, S, V): each rank's block
    through ``_VocabParallelXent``, the targets taken at the logits'
    rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = logits.device_mesh
    if any(p.is_partial() for p in logits.placements):
        logits = logits.redistribute(mesh, [
            Replicate() if p.is_partial() else p for p in logits.placements])
    vocab, tokens, rows = [], [], []
    for i, p in enumerate(logits.placements):
        d = p.dim if p.is_shard() else None
        rows.append(Shard(d) if d in (0, 1) else Replicate())
        if d is not None and mesh.size(i) > 1:
            (vocab if d == 2 else tokens).append(mesh.get_group(i))
    if not is_dtensor(targets):
        targets = DTensor.from_local(targets, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
    t = targets.redistribute(mesh, rows).to_local().long()
    v0 = window(logits.placements, tuple(logits.shape), tuple(mesh.shape),
                mesh.get_coordinate())[2][0]
    n = logits.shape[0] * logits.shape[1]
    return _VocabParallelXent.apply(logits.to_local().float(), t, v0,
                                    vocab, tokens, n)


def _whole(x):
    """A scalar the loss adds (the MoE aux loss), as a plain tensor whole
    on every rank; differentiable."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh,
                          [Replicate()] * x.device_mesh.ndim).to_local()


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
    batch split into ``accum_steps`` microbatches (``sharding.
    microbatches``, the reference's reshape and layout) whose fp32
    gradients are summed and averaged, as the reference's ``lax.scan``
    over microbatches.  With one microbatch the gradients keep the params'
    dtypes, as ``jax.value_and_grad``'s.  Under a sharding context with
    DTensor params every gradient comes back in its param's layout and
    the loss and aux are plain 0-d tensors, the same on every rank."""
    api = get_api(cfg)
    leaves = tree_leaves(params)

    def micro(mb):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        logits, aux = api.forward(cfg, p, mb, policy, remat)
        loss, aux = softmax_xent(logits, mb["targets"]), _whole(aux)
        grads = torch.autograd.grad(loss + aux, tree_leaves(p))
        grads = [like_layout(g, t) for g, t in zip(grads, leaves)]
        return loss.detach(), aux.detach(), tree_unflatten(params, grads)

    if accum_steps == 1:
        return micro(batch)
    a = accum_steps
    mbs = {k: microbatches(v, a) for k, v in batch.items()}
    gsum = tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32),
                    params)
    dev = local(leaves[0]).device
    lsum = torch.zeros((), dtype=torch.float32, device=dev)
    asum = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(a):
        l, x, g = micro({k: v[i] for k, v in mbs.items()})
        gsum = tree_unflatten(gsum, [s + d for s, d in
                                     zip(tree_leaves(gsum), tree_leaves(g))])
        lsum, asum = lsum + l, asum + x
    div = const_f32(a, lsum)
    return lsum / div, asum / div, tree_map(lambda g: g / div, gsum)


def make_train_step(cfg: ArchConfig, mesh, rules: Optional[ShardingRules],
                    *,
                    accum_steps: int = 1,
                    policy: Policy = DEFAULT_POLICY,
                    base_lr: float = 3e-4,
                    warmup: int = 100,
                    total_steps: int = 10000,
                    adamw: AdamWCfg = AdamWCfg(),
                    remat: bool = True,
                    master_fp32: bool = False,
                    max_seq: int = 4096):
    """Returns ``(step_fn, state_shardings_tree)``; ``step_fn(state,
    batch) -> (state, metrics)``.  ``mesh=None`` trains plain tensors on
    one device and the tree is None.  On a mesh each batch input is
    whole on every rank or laid out by ``batch_logical_axes``.
    ``max_seq`` sizes the layouts (the caller builds the state).

    master_fp32: params live in bf16; AdamW updates the fp32 master in opt
    state and re-casts."""
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)

    def train_step(state, batch):
        params = state["params"]
        loss, aux, grads = loss_and_grads(cfg, params, batch,
                                          policy=policy, remat=remat,
                                          accum_steps=accum_steps)
        lr = lr_fn(local(state["step"]))
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

    def wrapped(state, batch):
        with sharding_ctx(mesh, rules):
            return train_step(state, batch)

    return wrapped, _state_layouts(cfg, mesh, rules, max_seq, master_fp32)


def _state_layouts(cfg, mesh, rules, max_seq, master_fp32):
    if mesh is None:
        return None
    return state_shardings(cfg, max_seq, mesh, rules,
                           master_fp32=master_fp32)


def make_train_step_(cfg: ArchConfig, mesh, rules: Optional[ShardingRules],
                     *,
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
    ``(step_(state, batch) -> metrics, state_shardings_tree)``.  The
    params, ``m``, ``v``, ``count``, ``master`` (under master_fp32),
    ``step`` and ``data_cursor`` get their new values in their own tensors
    (on a mesh, each rank in its own shards), bit for bit the pure step's;
    the tree and its tensors stay the same objects.  It copies nothing
    from the host once its constants exist (its first run makes them), so
    it can be captured."""
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)

    def train_step_(state, batch):
        params, opt = state["params"], state["opt"]
        loss, aux, grads = loss_and_grads(cfg, params, batch,
                                          policy=policy, remat=remat,
                                          accum_steps=accum_steps)
        lr = lr_fn(local(state["step"]))
        if master_fp32:
            om = adamw_update_(opt["master"], grads, opt, lr, adamw)
            with torch.no_grad():
                for p, m in zip(tree_leaves(params),
                                tree_leaves(opt["master"])):
                    local(p).copy_(local(m).to(torch.bfloat16))
        else:
            om = adamw_update_(params, grads, opt, lr, adamw)
        local(state["step"]).add_(1)
        local(state["data_cursor"]).add_(1)
        return {"loss": loss, "aux_loss": aux, "lr": lr, **om}

    def wrapped(state, batch):
        with sharding_ctx(mesh, rules):
            return train_step_(state, batch)

    return wrapped, _state_layouts(cfg, mesh, rules, max_seq, master_fp32)


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

    On a mesh (``mesh``, ``rules``: ``make_train_step``'s) the state is
    DTensors laid out by ``state_shardings`` (``self.state_shardings``),
    the step runs on the mesh's device, and the static batch buffers are
    DTensors laid out by ``batch_logical_axes``: a call's batch, whole on
    every rank or so laid out, is copied into each rank's windows.

    The key is the batch's shapes, dtypes and placements, the attention
    and recurrence backends and the deterministic-algorithms flag, and
    the graph holds the addresses of the state's leaves: a new key, or any
    leaf rebound (a restore, another state), drops the graph and captures
    again.  A capture that fails raises; nothing falls back to the eager
    step."""

    def __init__(self, cfg: ArchConfig, mesh,
                 rules: Optional[ShardingRules], *, device="cuda",
                 **step_kw):
        from repro_torch.launch.mesh import mesh_device
        self.device = (resolve_device(device) if mesh is None
                       else mesh_device(mesh))
        self.cfg, self.mesh, self.rules = cfg, mesh, rules
        self._step, self.state_shardings = make_train_step_(
            cfg, mesh, rules, **step_kw)
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
        key = (tuple(sorted((k, tuple(v.shape), v.dtype,
                             tuple(getattr(v, "placements", ())))
                            for k, v in batch.items())),
               get_attention_backend(), get_recurrence_backend(),
               torch.are_deterministic_algorithms_enabled())
        if (self._graph is None or key != self._key
                or len(leaves) != len(self._leaves)
                or any(a is not b for a, b in zip(leaves, self._leaves))):
            return state, self._capture(state, batch, key, leaves)
        with trace.device_span("train.step", self.device):
            for k, v in batch.items():
                copy_into(self._batch[k], v)
            self._graph.replay()
        return state, self._metrics

    def _buffers(self, batch) -> dict:
        """The static batch buffers, a copy of ``batch``: on a mesh each
        input laid out by ``batch_logical_axes``."""
        if self.mesh is None:
            return {k: v.clone() for k, v in batch.items()}
        axes = batch_logical_axes(self.cfg, ShapeCfg("step", "train", 0, 0))
        return {k: v.clone() if is_dtensor(v) else lay_out(v, layout_for(
            axes[k], v.shape, self.mesh, self.rules, fsdp=False))
            for k, v in batch.items()}

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
        self._batch = self._buffers(batch)
        self._key, self._leaves = key, leaves
        step = functools.partial(self._step, state, self._batch)
        with trace.span("train.capture"):
            with self._on_side_stream():
                metrics = step()                # the first step, eagerly
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


# --------------------------------------------------------------------------
# Abstract inputs + layouts for the dry-run (every arch x shape x mesh)
# --------------------------------------------------------------------------

def dryrun_spec(cfg: ArchConfig, shape: ShapeCfg, mesh,
                rules: ShardingRules, accum_steps: Optional[int] = None,
                master_fp32: bool = False):
    """Returns (fn, args_abstract, in_shardings, out_shardings_hint|None),
    as the reference's: the inputs are ``meta`` tensors and the shardings
    ``Layout`` trees (``mesh`` may be a ``DeviceMesh`` or its
    ``{axis: size}``).

    train:   fn(state, batch)
    prefill: fn(params_bf16, batch)
    decode:  fn(params_bf16, cache, token, pos)
    """
    api = get_api(cfg)
    accum = default_accum(cfg, shape) if accum_steps is None else accum_steps
    b_ax = batch_logical_axes(cfg, shape)
    bspec = batch_specs(cfg, shape)
    bshard = {k: layout_for(b_ax[k], v.shape, mesh, rules, fsdp=False)
              for k, v in bspec.items()}

    if shape.kind == "train":
        step, st_shard = make_train_step(
            cfg, mesh, rules, accum_steps=accum, max_seq=shape.seq_len,
            master_fp32=master_fp32)
        state = abstract_train_state(cfg, shape.seq_len,
                                     master_fp32=master_fp32)
        return step, (state, bspec), (st_shard, bshard), None

    defs = api.param_defs(cfg, shape.seq_len)
    params = abstract_params(defs, dtype_override=torch.bfloat16)
    pshard = param_shardings(defs, mesh, rules)
    prefill, decode = make_serve_fns(cfg, mesh, rules, max_cache=shape.seq_len)

    if shape.kind == "prefill":
        return prefill, (params, bspec), (pshard, bshard), None

    cache_defs = api.cache_defs(cfg, shape.global_batch, shape.seq_len)
    cache = abstract_params(cache_defs)
    cshard = param_shardings(cache_defs, mesh, rules)
    return (decode,
            (params, cache, bspec["token"], bspec["pos"]),
            (pshard, cshard, bshard["token"], bshard["pos"]),
            None)
