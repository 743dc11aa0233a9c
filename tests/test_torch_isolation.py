"""The port stands alone: it imports neither jax nor the reference package.

In a fresh interpreter, importing every module of ``repro_torch`` leaves no
``jax*`` and no ``repro``/``repro.*`` module in ``sys.modules``; and no
source file of the port, nor chip_smoke.py, names them in an import."""
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
import sys
import repro_torch.core.runtime, repro_torch.distributed.proxy_grad
import repro_torch.distributed.faults
print("TORCH", sorted(n for n in sys.modules if n.split(".")[0] == "torch"))
"""


def test_the_rank_world_imports_no_torch():
    """The process world forks ranks from the rank-world modules before
    CUDA starts, so importing them loads no torch."""
    proc = subprocess.run([sys.executable, "-c", _NO_TORCH_PROBE], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "TORCH []", proc.stdout
