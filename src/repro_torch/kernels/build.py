"""Builds the port's CUDA kernels: ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.

Each ``csrc/*.cu`` file is one library, compiled at first use into
``build/repro_torch_kernels/`` under the checkout and named by the digest
of its source, so an edited source is rebuilt and an unchanged one is not.
ptxas's report (registers, shared memory, spills) is kept beside the
library.  Nothing is compiled when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# Never --use_fast_math or -prec-div=false: the int8 codes must divide
# exactly as numpy and torch do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the port's CUDA kernels cannot be built")
    return path


def ptxas_report(library: Path) -> Path:
    return library.with_name(f"{library.stem}.ptxas.txt")


def build(source: Path) -> Path:
    """Compile ``source`` once per source digest; returns the library path.
    Raises with nvcc's output if the build fails."""
    source = Path(source)
    digest = hashlib.blake2b(source.read_bytes(), digest_size=8).hexdigest()
    out = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}) building "
                           f"{source.name}:\n{proc.stderr}")
    ptxas_report(out).write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def build_all(sources) -> list:
    """Build several sources at once, one nvcc each; returns their paths in
    order.  The first failure is raised after every build has ended."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        futures = [pool.submit(build, s) for s in sources]
        return [f.result() for f in futures]


def load(source: Path, signatures: dict) -> ctypes.CDLL:
    """Build ``source`` and load it; ``signatures`` maps each C function to
    (argtypes, restype)."""
    lib = ctypes.CDLL(str(build(source)))
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = list(argtypes), restype
    return lib
