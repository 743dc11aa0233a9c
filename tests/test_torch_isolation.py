"""The port stands alone: it imports neither jax nor the reference package.

In a fresh interpreter, importing every module of ``repro_torch`` leaves no
``jax*`` and no ``repro``/``repro.*`` module in ``sys.modules``; and no
source file of the port, nor chip_smoke.py, names them in an import."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch, repro_torch.serve.engine, repro_torch.launch.serve
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_importing_the_port_loads_no_jax_and_no_reference():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_)|from\s+(jax|jaxlib|repro)\b(?!_))",
    re.MULTILINE)


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    hits = {str(f.relative_to(ROOT)): _FORBIDDEN.findall(f.read_text())
            for f in files}
    assert not {f: h for f, h in hits.items() if h}


_NO_TORCH_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch.core
for m in pkgutil.walk_packages(repro_torch.core.__path__, "repro_torch.core."):
    importlib.import_module(m.name)
import repro_torch.core.runtime, repro_torch.distributed.proxy_grad
import repro_torch.distributed.faults, repro_torch.distributed.compression
import repro_torch.core.procworld, repro_torch.core.dataplane
import repro_torch.launch.procrun
import repro_torch.checkpoint.chunkstore, repro_torch.checkpoint.chunkservice
print("TORCH", sorted(n for n in sys.modules if n.split(".")[0] == "torch"))
"""


def test_the_rank_world_imports_no_torch():
    """A process-world rank child runs only these modules (the core
    package, the DP app, the driver, the CLI, the chunk store and
    service), and a forked child must stay off torch, so importing them
    loads no torch."""
    proc = subprocess.run([sys.executable, "-c", _NO_TORCH_PROBE], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "TORCH []", proc.stdout


_FORK_PROBE = r"""
import json, sys, time
import numpy as np
import torch
torch.set_num_threads(4)
a = torch.randn(256, 256)
(a @ a).sum().item()                     # the intra-op pool is running
from repro_torch.core import MPIJob
from repro_torch.distributed.proxy_grad import make_dp_app
init_fn, step_fn = make_dp_app(seed=2)
out = {}
for tr in ("proc", "shm"):
    job = MPIJob(3, step_fn, init_fn, transport=tr)
    t0 = time.perf_counter()
    try:
        res = job.run(6, timeout=60)
    finally:
        job.stop()
    out[tr] = {"s": time.perf_counter() - t0,
               "params": [{k: v.tobytes().hex() for k, v in o["params"].items()}
                          for o in res],
               "loss": [o["loss"] for o in res]}
    if tr == "proc":
        out["codes"] = sorted(job._proc.exit_codes.values())
        out["alive"] = [p.pid for p in job._proc._procs.values()
                        if p.is_alive()]
print(json.dumps(out))
"""


def test_a_process_world_forks_from_a_torch_process():
    """Every tier-1 worker has imported torch and run ops on its intra-op
    thread pool before it forks rank processes: from that state a process
    world finishes inside its timeout, bit-equal to the thread world, each
    child exiting 0 and reaped."""
    proc = subprocess.run([sys.executable, "-c", _FORK_PROBE], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["codes"] == [0, 0, 0] and out["alive"] == []
    assert out["proc"]["params"] == out["shm"]["params"]
    assert out["proc"]["loss"] == out["shm"]["loss"]
