"""Fault-tolerant training loop: the paper's FSM at the step level (torch
twin of ``repro.train.loop``).

RUN -> (every ckpt_every steps) QUIESCE/DRAIN -> SNAPSHOT -> RESUME

  drain    = synchronize the device + wait for the previous async write
             (``CheckpointManager.save``)
  snapshot = TrainState tree + pipeline cursor + rng; nothing else exists
             to save (DESIGN.md §2)
  restore  = newest valid checkpoint, auto-resumed onto ``device``.

The checkpoint is the reference's payload in the reference's format, so
a run that crashed in either package resumes in the other.

The step (``make_loop_step``): on CUDA a ``GraphedTrainStep``, the
reference's jitted, state-donating step (``repro/train/loop.py:64``) as
one CUDA graph a step that writes the new state into the old one's
tensors; on the CPU the pure step.  The batch crosses from the host
outside the graph.  A save between two replays is sound because
``CheckpointManager.save`` copies the state to the host before it returns;
a resumed run restores new tensors, and the step captures again over them.

On a mesh (``train(cfg, mesh, rules, ...)``) the state is made, or
restored from a checkpoint of any mesh and either package, straight into
``state_shardings``' DTensors; every rank draws the same global batch
from the seed and the batch is laid out by ``batch_logical_axes``; saves
run across the ranks (rank 0 commits the manifest), whose meta names the
rules and the mesh as the reference's does.  ``mesh=None`` trains plain
tensors on ``device``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (ShardingRules, lay_out,
                                              layout_for, local, mesh_shape,
                                              replicated)
from repro_torch.launch.mesh import mesh_device
from repro_torch.models.layers import Policy
from repro_torch.models.registry import batch_logical_axes
from repro_torch.train.state import (lay_out_state, make_train_state,
                                     train_state_template)
from repro_torch.train.step import GraphedTrainStep, make_train_step


@dataclass
class TrainResult:
    losses: List[float] = field(default_factory=list)
    steps_run: int = 0
    resumed_from: Optional[int] = None
    ckpt_stats: dict = field(default_factory=dict)
    wall_s: float = 0.0
    #: wall seconds of each step run, from the batch's build to the step's
    #: return and its loss read: a step whose loss is read (every step with
    #: ``log_every=1``) waits for the device, another times only the host's
    #: build and launch.  The device's own time of a graphed step is its
    #: ``train.step`` span (``repro_torch.core.trace``)
    step_s: List[float] = field(default_factory=list)
    #: CUDA graphs captured and the seconds their captures took (0 on the
    #: CPU); the first step of a run includes its capture
    captures: int = 0
    capture_s: float = 0.0
    #: the TrainState after the last step (on a mesh, its DTensors)
    state: Optional[dict] = None


def _use_graphs(dev: torch.device) -> bool:
    return dev.type == "cuda"


def make_loop_step(cfg: ArchConfig, mesh, rules, device, **step_kw):
    """The step the loop runs, ``(state, batch) -> (state, metrics)``, and
    the state's layouts: a ``GraphedTrainStep`` on CUDA, else the pure
    ``make_train_step``; on ``mesh``'s device, or on ``device`` without a
    mesh; ``step_kw`` are ``make_train_step``'s."""
    dev = resolve_device(device) if mesh is None else mesh_device(mesh)
    if _use_graphs(dev):
        step = GraphedTrainStep(cfg, mesh, rules, device=dev, **step_kw)
        return step, step.state_shardings
    return make_train_step(cfg, mesh, rules, **step_kw)


def train(cfg: ArchConfig, mesh, rules: Optional[ShardingRules], *,
          n_steps: int,
          global_batch: int,
          seq_len: int,
          ckpt_root: Optional[str | Path] = None,
          ckpt_every: int = 50,
          keep: int = 3,
          base_lr: float = 3e-4,
          warmup: int = 20,
          accum_steps: int = 1,
          policy: Policy = Policy(),
          seed: int = 0,
          fail_at_step: Optional[int] = None,
          log_every: int = 10,
          remat: bool = True,
          device="cuda") -> TrainResult:
    """Run (or resume) training on ``mesh`` by ``rules``, or with
    ``mesh=None`` on ``device``.  ``fail_at_step`` injects a crash for the
    fault-tolerance tests: the process raises AFTER that step completes
    but BEFORE the next checkpoint — a rerun must recover from the last
    one."""
    t_start = time.time()
    dev = resolve_device(device) if mesh is None else mesh_device(mesh)
    step_fn, st_shard = make_loop_step(
        cfg, mesh, rules, dev, accum_steps=accum_steps, base_lr=base_lr,
        warmup=warmup, policy=policy, max_seq=seq_len, total_steps=n_steps,
        remat=remat)

    result = TrainResult()
    mgr = None
    state = None
    pipe = None
    if ckpt_root is not None:
        mgr = CheckpointManager(ckpt_root, keep=keep)
        template = {"train": train_state_template(cfg, seq_len),
                    "data": {"seed": 0, "cursor": 0}}
        layouts = None
        if mesh is not None:
            rep = replicated(mesh)
            layouts = {"train": st_shard,
                       "data": {"seed": rep, "cursor": rep}}
        restored, meta = mgr.restore(template, layouts, device=dev)
        if restored is not None:
            state = restored["train"]
            data = {k: int(local(v)) for k, v in restored["data"].items()}
            pipe = TokenPipeline(cfg.vocab_size, global_batch, seq_len,
                                 seed=data["seed"])
            pipe.cursor = data["cursor"]
            result.resumed_from = int(meta.get("step", -1))
    if state is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = make_train_state(cfg, gen, seq_len, device=dev)
        if mesh is not None:
            state = lay_out_state(state, st_shard)
        pipe = TokenPipeline(cfg.vocab_size, global_batch, seq_len, seed=seed)
    layout_meta = {"rules": rules.name if rules is not None else "baseline",
                   "mesh": (mesh_shape(mesh) if mesh is not None
                            else {"data": 1, "model": 1})}
    batch_axes = batch_logical_axes(cfg, ShapeCfg("loop", "train", seq_len,
                                                  global_batch))

    start_step = int(local(state["step"]))
    for step in range(start_step, n_steps):
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipe.next_batch().items()}
        if cfg.family == "audio":
            # the stub encoder input a whisper batch carries (the
            # reference's batch_specs: (B, n_frames, d_model)), ones x 0.1
            # as the serve CLIs give it; the pipeline draws tokens only
            batch["frames"] = torch.full(
                (global_batch, cfg.encoder.n_frames, cfg.d_model), 0.1,
                device=dev)
        if mesh is not None:
            batch = {k: lay_out(v, layout_for(batch_axes[k], v.shape, mesh,
                                              rules, fsdp=False))
                     for k, v in batch.items()}
        state, metrics = step_fn(state, batch)
        if step % log_every == 0 or step == n_steps - 1:
            result.losses.append(float(metrics["loss"]))
        result.step_s.append(time.perf_counter() - t0)
        result.steps_run += 1
        if mgr is not None and (step + 1) % ckpt_every == 0:
            payload = {"train": state,
                       "data": {"seed": np.int64(pipe.seed),
                                "cursor": np.int64(pipe.cursor)}}
            mgr.save(step + 1, payload, meta={"step": step + 1,
                                              "arch": cfg.name,
                                              **layout_meta})
        if fail_at_step is not None and step + 1 >= fail_at_step:
            if mgr is not None:
                mgr.wait()
            raise RuntimeError(f"injected failure after step {step + 1}")
    if mgr is not None:
        mgr.wait()
        result.ckpt_stats = dict(mgr.stats)
    if isinstance(step_fn, GraphedTrainStep):
        result.captures, result.capture_s = (step_fn.captures,
                                             step_fn.capture_s)
    result.state = state
    result.wall_s = time.time() - t_start
    return result
