"""chip_smoke.py without a card: it refuses to run and prints no result,
and its phases, driven on the CPU with the kernel replaced by a counting
plain version and the model narrowed to smoke widths (head_dim 64, so
prefill takes the flash path), pass.  The kernel itself is only checked
on the card, by chip_smoke.py's kernels phase."""
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ref_flash_attention
from repro_torch.launch import serve
from repro_torch.models.attention import set_attention_backend

ROOT = Path(__file__).resolve().parents[1]


def _run(script: Path, cwd: Path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    proc = _run(ROOT / "chip_smoke.py", ROOT)
    assert proc.returncode != 0 and proc.stdout == "", proc.stdout
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    proc = _run(lone, tmp_path)
    assert proc.returncode != 0 and proc.stdout == "", proc.stdout


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "DEV", "cpu")
    tiny = dataclasses.replace(reduce_for_smoke(ARCHS["smollm-135m"]),
                               name="smoke-hd64", head_dim=64, n_layers=3)
    monkeypatch.setitem(ARCHS, tiny.name, tiny)
    monkeypatch.setattr(mod, "ARCH", tiny.name)
    monkeypatch.setattr(mod, "cuda_ms", lambda fn: (fn(), 1.0)[1])

    def counting(q, k, v, causal=True, window=0):
        ops.FLASH_LAUNCHES += 1
        return ref_flash_attention(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(ops, "flash_attention", counting)
    monkeypatch.setattr(
        fa, "flash_attention_fwd",
        lambda q, k, v, *, causal=True, window=0, scale=None:
        ref_flash_attention(q, k, v, causal=causal, window=window))
    main = serve.main

    def main_on_cpu(argv):
        set_attention_backend("flash")      # what main() selects on CUDA
        return main(argv + ["--device", "cpu"])

    monkeypatch.setattr(serve, "main", main_on_cpu)
    try:
        yield mod
    finally:
        set_attention_backend("chunked")


def test_chip_smoke_phases_on_cpu(smoke, capsys):
    card = "cpu rehearsal, 0 W"
    assert smoke.phase_kernels(card) == 0.0
    smoke.phase_serve_parity(card)
    assert smoke.phase_serve(card) == 3           # one launch per layer
    _, bound_ms, bound_by = smoke.phase_timing(card)
    # q + o (36x128x64) and k, v (12x128x64), bf16, over 3.35 TB/s
    assert bound_by == "bytes"
    assert bound_ms == pytest.approx(1_572_864 / 3.35e12 * 1e3)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"phase"')]
    assert [ln["phase"] for ln in lines] == ["kernels", "serve-parity",
                                             "serve", "timing"]
    assert all(ln["ok"] for ln in lines)
