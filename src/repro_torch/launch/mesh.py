"""Mesh construction (torch twin of ``repro.launch.mesh``).  Functions,
not module-level constants: importing this module starts no process
group.

A mesh spans the ranks of the current process group.  A process that has
none gets a 1-rank world on the device it asked for, over an in-process
store (no port is opened); a multi-rank world is the caller's, started
with ``torch.distributed.init_process_group`` before the first mesh, or
on one host by ``run_world``, whose ranks call ``join_world``."""
from __future__ import annotations

import datetime
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def world_size() -> int:
    """Ranks in the current process group (1 when there is none)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def say(row: dict) -> None:
    """Print ``row`` as one JSON line, from rank 0 only in a world of
    several (the CLIs' output)."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(row))


def mesh_device(mesh) -> torch.device:
    """The device a mesh's tensors live on in this process."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(shape, axes, *, device="cuda"):
    """A ``DeviceMesh`` of `shape` named `axes` over the current world on
    `device` (asking for CUDA without a card raises; there is no CPU
    fallback).  Refuses a world of another size than the mesh's."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if dev.type == "cuda":
        # before the mesh: its collectives run on this process's card
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group(
            "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    need, have = math.prod(shape), dist.get_world_size()
    if need != have:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs a world of "
                         f"{need} ranks; this world has {have}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """Single pod: 16x16 = 256 ranks (data, model).
    Multi-pod: 2x16x16 = 512 ranks (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_local_mesh(n: int | None = None, model: int = 1, *, device="cuda"):
    """(data, model) mesh over the current world (smoke tests, one card,
    CPU worlds)."""
    n = n or world_size()
    assert n % model == 0, (n, model)
    return make_mesh((n // model, model), ("data", "model"), device=device)


def join_world(timeout_s: float = 120.0) -> int:
    """Join the gloo world ``run_world`` started this process in (``RANK``,
    ``WORLD_SIZE`` and the file store ``REPRO_WORLD_STORE`` from the
    environment).  Returns the rank."""
    rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.environ["REPRO_WORLD_STORE"], n),
        rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout_s))
    return rank


def run_world(n: int, code: str, *, timeout_s: float,
              env: Optional[dict] = None, cwd=None) -> List[str]:
    """Run `code` (``python -c``) in `n` processes on this host, which form
    one CPU world by calling ``join_world``: a file store in a fresh
    directory, no port.  Returns each rank's standard output.  The first
    rank to fail, or the deadline, stops every rank and raises with the
    failures' standard error."""
    with tempfile.TemporaryDirectory(prefix="repro-world-") as d:
        logs, procs = [], []
        try:
            for r in range(n):
                out = open(Path(d) / f"out{r}", "w+")
                err = open(Path(d) / f"err{r}", "w+")
                logs.append((out, err))
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code], stdout=out, stderr=err,
                    cwd=cwd, env={**(env or os.environ), "RANK": str(r),
                                  "WORLD_SIZE": str(n),
                                  "REPRO_WORLD_STORE": str(Path(d) / "store")}))
            deadline = time.monotonic() + timeout_s
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = []
        for out, err in logs:
            out.seek(0), err.seek(0)
            texts.append((out.read(), err.read()))
            out.close(), err.close()
    failed = [(r, p.returncode) for r, p in enumerate(procs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError(
            f"world of {n} ranks failed (rank, exit code): {failed}\n"
            + "\n".join(f"--- rank {r}:\n{texts[r][1][-3000:]}"
                        for r, _ in failed))
    return [t[0] for t in texts]
