"""Batched serving engine (torch twin of ``repro.serve.engine``): prefill +
decode with a KV cache, greedy sampling, on one device or across the
ranks of a mesh (``ServeEngine``'s ``mesh``), and a
checkpointable serving state (cache + positions + generated tokens): the
service can be drained, snapshotted in the reference's checkpoint format,
and restored by either package.

The reference compiles its two programs, ``jax.jit(prefill)`` and
``jax.jit(decode, donate_argnums=(1,))``.  Here one prefill and one decode
step are written over static buffers the engine owns for each batch size
(the cache at ``max_seq``, the generated tokens, ``pos``, the logits) and
for each prompt shape (the prompt and ``extras``).  On the CPU ``generate``
runs the steps eagerly.  On CUDA it captures each step once per key as a
CUDA graph (prefill: B, P, the extras' shapes and dtypes, the policy and
both backends; decode: B, the policy and the backends) and replays it; the
graphs share one memory pool, since they never run at once, and their
cache grows with the shapes served, as ``jax.jit``'s does.  A capture or
a kernel that fails raises: nothing falls back to the eager steps on CUDA.

A graph holds the addresses of the params and buffers it read: if
``params`` is rebound, the graphs are dropped and captured again.
"""
from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import trace
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed.sharding import (ShardingRules, copy_into,
                                              is_dtensor, lay_out,
                                              lay_out_zeros, layout_for,
                                              sharding_ctx, window)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import mesh_device
from repro_torch.models.attention import get_attention_backend
from repro_torch.models.layers import DEFAULT_POLICY, Policy
from repro_torch.models.params import (is_pm, tree_leaves, tree_map,
                                      tree_unflatten)
from repro_torch.models.registry import get_api
from repro_torch.models.rglru import get_recurrence_backend


@dataclass
class GenResult:
    tokens: np.ndarray              # (B, n_new)
    prefill_s: float
    decode_s: float
    tokens_per_s: float


@dataclass
class _Batch:
    """The buffers of one batch size.  ``seq`` holds each request's tokens
    at their positions: the prefill writes the first at P, each decode
    step reads the token at ``pos`` and writes the next at ``pos + 1``."""
    cache: dict
    seq: torch.Tensor               # (B, max_seq) int64
    pos: torch.Tensor               # (B,) int64, advanced in place
    logits: torch.Tensor            # (B, V), the last step's


@dataclass
class _Prompt:
    """The inputs of one prefill shape."""
    key: tuple                      # (B, P), the extras' shapes and dtypes
    tokens: torch.Tensor            # (B, P) int64
    extras: dict


class ServeEngine:
    """``mesh`` and ``rules`` (both or neither) run the prefill and decode
    steps inside ``sharding_ctx(mesh, rules)``, on the graph path too, as
    the reference's programs do, and put the engine on the mesh's device.

    On a mesh the forward runs on DTensors (the sharded forward): plain
    params are laid out by the rules (``param_shardings``' layout of
    each leaf), leaves that already are DTensors on the mesh (an
    ``elastic_restore``) are served as they are, and the cache buffers
    are laid out by the cache defs; each rank holds its windows only.
    Prompts enter split over the batch axes where B divides them, the
    logits come out split over the vocab, and greedy sampling picks each
    row's first maximum across the vocab shards without gathering them:
    the tokens are whole on every rank."""

    def __init__(self, cfg: ArchConfig, params, *, max_seq: int,
                 policy: Policy = DEFAULT_POLICY, device="cuda", mesh=None,
                 rules: Optional[ShardingRules] = None):
        if (mesh is None) != (rules is None):
            raise ValueError("pass mesh and rules together, or neither")
        self.cfg = cfg
        self.mesh, self.rules = mesh, rules
        self.device = (mesh_device(mesh) if mesh is not None
                       else resolve_device(device))
        self.max_seq = max_seq
        self.policy = policy
        self.api = get_api(cfg)
        #: the forward runs on DTensors
        self.sharded = mesh is not None
        if self.sharded:
            params = self._lay_out(params)
        elif any(is_dtensor(t) for t in tree_leaves(params)):
            raise ValueError("DTensor params are served on their mesh: "
                             "pass the engine's mesh and rules")
        else:
            params = tree_map(lambda x: x.to(self.device), params)
        self.params = policy.cast_params(params)
        self.cache = None
        self.pos = None
        self.generated: List[np.ndarray] = []
        #: seconds spent capturing graphs, warm-ups included (0 on the CPU)
        self.capture_s = 0.0
        self._batches: dict = {}
        self._prompts: dict = {}
        self._graphs: dict = {}         # key -> ops.CountedGraph
        self._graphed_params = None
        self._pool = None
        self._stream = None

    def _lay_out(self, params):
        """Each leaf as a DTensor on the mesh: a plain one laid out by its
        def's logical axes (its own shape: a learned ``pos`` table need not
        be ``max_seq`` long), a DTensor kept as it is laid out."""
        defs = tree_leaves(self.api.param_defs(self.cfg, self.max_seq),
                           is_leaf=is_pm)
        out = []
        for t, d in zip(tree_leaves(params), defs):
            if is_dtensor(t):
                if t.device_mesh != self.mesh:
                    raise ValueError("a DTensor leaf on another mesh than "
                                     "the engine's")
                out.append(t)
            else:
                out.append(lay_out(t, layout_for(d.logical, t.shape,
                                                 self.mesh, self.rules,
                                                 fsdp=True)))
        return tree_unflatten(params, out)

    def last_logits(self, b: int) -> torch.Tensor:
        """The last step's logits of batch size ``b``, whole on every rank
        (gathered across the vocab shards on a mesh)."""
        logits = self._batches[b].logits
        return logits.full_tensor() if is_dtensor(logits) else logits

    # ------------------------------------------------------------- generate
    def no_grad(self):
        """The engine's steps run without autograd: under inference mode,
        and on DTensors under ``no_grad`` (DTensor cannot make views in
        inference mode: "Cannot set version_counter for inference
        tensor")."""
        return torch.no_grad() if self.sharded else torch.inference_mode()

    def generate(self, prompts: np.ndarray, n_new: int,
                 extras: Optional[dict] = None) -> GenResult:
        """prompts (B, P) equal-length token batch; greedy decode n_new.
        Both clocks are read only after the device has finished; the first
        request of a key also pays its captures, as the reference's first
        call pays its compile.  ``n_new=0`` gives what the reference gives:
        the prefill's greedy token, (B, 1), and ``pos`` = P + 1."""
        b, p = prompts.shape
        with trace.span("serve.generate",
                        args={"b": b, "p": p, "n_new": n_new}), \
                self.no_grad():
            return self._generate(prompts, n_new, extras)

    def _generate(self, prompts, n_new, extras) -> GenResult:
        b, p = prompts.shape
        n_out = max(n_new, 1)               # the prefill's token, always
        if n_new < 0 or p + n_out > self.max_seq:
            raise ValueError(f"prompt {p} + {n_new} new tokens: need at "
                             f"least 0 and at most max_seq {self.max_seq} "
                             f"(the prefill's token included)")
        dev = self.device
        with trace.span("serve.inputs"):
            extras = {k: torch.as_tensor(np.asarray(x), device=dev)
                      for k, x in (extras or {}).items()}
            tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                     device=dev)
            batch = self._batch(b)
            prompt = self._prompt(tokens, extras)
        synchronize(dev)
        t0 = time.perf_counter()
        prefill, decode = self._programs(batch, prompt)
        with trace.device_span("serve.prefill", dev):
            prefill()
        synchronize(dev)
        t_prefill = time.perf_counter() - t0

        t0 = time.perf_counter()
        if n_new > 1:
            with trace.device_span("serve.decode", dev):
                for _ in range(n_new - 1):
                    decode()
        with trace.span("serve.read"):
            toks = batch.seq[:, p:p + n_out].cpu().numpy().astype(np.int32)
            synchronize(dev)
        t_decode = time.perf_counter() - t0
        self.cache, self.pos = batch.cache, batch.pos + 1
        self.generated.append(toks)
        return GenResult(tokens=toks, prefill_s=t_prefill, decode_s=t_decode,
                         tokens_per_s=b * max(n_new - 1, 1) / max(t_decode, 1e-9))

    # ---------------------------------------------------- buffers and steps
    def _batch(self, b: int) -> _Batch:
        if b not in self._batches:
            dev, compute = self.device, self.policy.compute
            defs = self.api.cache_defs(self.cfg, b, self.max_seq, compute)
            v = self.cfg.vocab_size
            self._batches[b] = _Batch(
                cache=tree_map(lambda d: self._zeros(d.shape, d.dtype,
                                                     d.logical, fsdp=True),
                               defs, is_leaf=is_pm),
                seq=torch.zeros((b, self.max_seq), dtype=torch.long,
                                device=dev),
                pos=torch.zeros((b,), dtype=torch.long, device=dev),
                logits=self._zeros((b, v), compute, ("batch", "vocab")))
        return self._batches[b]

    def _zeros(self, shape, dtype, logical, fsdp=False):
        """A buffer: on a mesh a DTensor laid out by ``logical`` (a cache
        leaf as ``param_shardings`` lays it, an activation as
        ``shard_act``), each rank holding its window."""
        if not self.sharded:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return lay_out_zeros(shape, dtype, layout_for(
            logical, shape, self.mesh, self.rules, fsdp=fsdp))

    def _prompt(self, tokens, extras) -> _Prompt:
        """The static inputs of this prefill shape, filled with this
        request's.  On a mesh the tokens are split over the batch axes
        where B divides them; each rank copies in its rows."""
        key = (tuple(tokens.shape), tuple(sorted(
            (k, tuple(x.shape), x.dtype) for k, x in extras.items())))
        if key not in self._prompts:
            self._prompts[key] = _Prompt(
                key, self._zeros(tuple(tokens.shape), tokens.dtype,
                                 ("batch", "seq")),
                {k: torch.empty_like(x) for k, x in extras.items()})
        prompt = self._prompts[key]
        copy_into(prompt.tokens, tokens)
        for k, x in extras.items():
            prompt.extras[k].copy_(x)
        return prompt

    def _ctx(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        return sharding_ctx(self.mesh, self.rules)

    def _prefill_step(self, batch: _Batch, prompt: _Prompt) -> None:
        p = prompt.tokens.shape[1]
        with self._ctx():
            logits, _ = self.api.prefill(self.cfg, self.params,
                                         prompt.tokens, prompt.extras,
                                         self.max_seq, self.policy,
                                         cache=batch.cache)
        batch.logits.copy_(logits)
        batch.seq[:, p] = _greedy(logits)
        batch.pos.fill_(p)

    def _decode_step(self, batch: _Batch) -> None:
        at = batch.pos[:, None]
        with self._ctx():
            logits, _ = self.api.decode(self.cfg, self.params, batch.cache,
                                        batch.seq.gather(1, at), batch.pos,
                                        self.policy)
        batch.logits.copy_(logits)
        batch.seq.scatter_(1, at + 1, _greedy(logits)[:, None])
        batch.pos.add_(1)

    # --------------------------------------------------------------- graphs
    def _use_graphs(self) -> bool:
        return self.device.type == "cuda"

    def _programs(self, batch: _Batch, prompt: _Prompt):
        """(prefill, decode) callables: the eager steps on the CPU, the
        replays of their graphs on CUDA (captured first where missing)."""
        prefill = functools.partial(self._prefill_step, batch, prompt)
        decode = functools.partial(self._decode_step, batch)
        if not self._use_graphs():
            return prefill, decode
        if self._graphed_params is not self.params:
            self._graphs.clear()
            self._graphed_params = self.params
        run = (self.policy, get_attention_backend(), get_recurrence_backend())
        decode_key = ("decode", batch.seq.shape[0], *run)
        prefill_key = ("prefill", prompt.key, *run)
        if decode_key not in self._graphs:
            # decode first: its warm-up step writes the cache, seq and pos,
            # all of which the prefill then rewrites; pos 0 keeps its
            # indices in range whatever the last request left there
            batch.pos.zero_()
        decode = self._graph(decode_key, decode)
        prefill = self._graph(prefill_key, prefill)  # prefill is idempotent
        return prefill.replay, decode.replay

    def _graph(self, key, step) -> ops.CountedGraph:
        """The graph of ``key``, captured from ``step`` where it is missing,
        under a ``serve.capture`` span that names its kind and shape."""
        if key not in self._graphs:
            with trace.span("serve.capture", args={"key": str(key[:2])}):
                self._graphs[key] = self._capture(step)
        return self._graphs[key]

    def _capture(self, step) -> ops.CountedGraph:
        """One warm-up of ``step`` on a side stream (it builds and loads the
        kernels, and sets up cuBLAS for that stream, before any capture),
        then its capture on that stream into the shared pool.  The
        warm-up's launches are set-up, not served work: they are taken back
        off the counters, and each replay adds the captured ones."""
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        stream, current = self._stream, torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with ops.uncounted(), torch.cuda.stream(stream):
            step()
        current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                step()

        launches = ops.capture_launches(capture)
        synchronize(self.device)
        self.capture_s += time.perf_counter() - t0
        return ops.CountedGraph(graph, launches)

    # ----------------------------------------------------------- checkpoint
    def snapshot_service(self, mgr, step: int) -> None:
        """Drain + snapshot the serving state through ``mgr`` (a
        ``repro_torch.checkpoint.manager.CheckpointManager``), as the
        reference does: ``{"cache", "pos", "generated"}``, ``pos`` as int32
        like the reference's.  ``pos`` is one past the next cache slot: the
        last generated token is not in the cache yet, so a continuation
        feeds ``generated[:, -1]`` at ``pos - 1``.  The cache is the
        engine's buffers, read once the device has finished with them."""
        synchronize(self.device)
        payload = {"cache": self.cache,
                   "pos": None if self.pos is None
                   else self.pos.to(torch.int32),
                   "generated": np.concatenate(self.generated, axis=1)
                   if self.generated else np.zeros((0, 0), np.int32)}
        mgr.save(step, payload, meta={"kind": "serve", "arch": self.cfg.name})
        mgr.wait()


def _greedy(logits) -> torch.Tensor:
    """Each row's greedy token (B,), whole and plain on every rank.  Over
    DTensor logits each rank takes the first maximum of its own rows and
    vocab window; the (value, index) pairs of every window are gathered,
    2·B numbers a shard, and the first window holding the row's largest
    value wins: ``torch.argmax``'s first maximum, with no gather of the
    logits themselves."""
    if not is_dtensor(logits):
        return torch.argmax(logits, dim=-1)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = logits.device_mesh
    local = logits.to_local()
    start = window(logits.placements, tuple(logits.shape), tuple(mesh.shape),
                   mesh.get_coordinate())[1][0]
    idx = torch.argmax(local, dim=-1, keepdim=True)
    val = local.gather(-1, idx)
    # one column per vocab window, in vocab order; rows split as the logits'
    places = [Shard(1) if p.is_shard(1) else Shard(0) if p.is_shard(0)
              else Replicate() for p in logits.placements]

    def whole(t):
        return DTensor.from_local(t, mesh, places,
                                  run_check=False).full_tensor()
    vals, idxs = whole(val), whole(idx + start)
    best = torch.argmax(vals, dim=1, keepdim=True)
    return idxs.gather(1, best)[:, 0]
