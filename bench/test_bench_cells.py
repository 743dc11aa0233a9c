"""Whole runs of each traffic mix at smoke widths on the CPU: the result
line's schema, ``correct`` true on sound runs, false under the control
and under each fault the cell can have, the inputs made from the seed;
and ``run.py``'s refusal without a card."""
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import harness
import tiny
from reference import train as rtrain

ROOT = Path(__file__).resolve().parents[1]
BIG_SEED = 2 ** 33 + 12345


@pytest.fixture(autouse=True)
def _this_process_may_hold_jax(monkeypatch):
    """Other test files of this process import the JAX package; the check
    of a run's modules (``harness.forbidden_modules``, tested on its own
    and by ``run.py`` in a fresh interpreter) is left to those."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


def run(hf, wl, seed=BIG_SEED, trace=False, fault=None, seconds=0.3):
    return harness.run_cell(tiny.cell(hf, wl), seed, seconds, trace, "cpu",
                            time.perf_counter(), fault=fault)


def readings(hf, wl, seed, fault=None):
    c = tiny.cell(hf, wl)
    traffic = harness.generator(c)
    tmp = Path(tempfile.mkdtemp())
    dev = torch.device("cpu")
    r = harness.Run(c, seed, 0.0, False, dev, tmp, time.perf_counter(),
                    harness.Tracer(False, dev), fault)
    try:
        return traffic.readings(r, control=fault is None)
    finally:
        shutil.rmtree(tmp)


CASES = [("train", tiny.LLAMA, tiny.TRAIN), ("decode", tiny.DEEPSEEK,
                                               tiny.DECODE),
         ("prefill", tiny.DEEPSEEK, tiny.PREFILL),
         ("prefill_dense", tiny.LLAMA, tiny.PREFILL)]


@pytest.mark.parametrize("name,hf,wl", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
def test_a_sound_run_is_correct_and_its_line_is_whole(name, hf, wl, trace):
    res = run(hf, wl, trace=trace)
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for k, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
    cell = tiny.cell(hf, wl)
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert res["metrics"]           # the CPU slice: idle 100%
        assert all(m["unit"] == "%" or m["unit"] for m in
                   res["metrics"].values())
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.report(res)
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == res
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("fault,hf,wl", [
    ("unchanged", tiny.LLAMA, tiny.TRAIN),
    ("half_batch", tiny.LLAMA, tiny.TRAIN),
    ("token", tiny.DEEPSEEK, tiny.DECODE),
    ("token", tiny.LLAMA, tiny.PREFILL)])
def test_a_broken_timed_path_is_not_correct(fault, hf, wl):
    res = run(hf, wl, fault=fault)
    assert res["correct"] is False, res["checks"]
    after = run(hf, wl)                 # the fault is undone
    assert after["correct"] is True, after["checks"]


def test_the_fp8_control_fails_where_the_program_passes():
    tr = readings(tiny.LLAMA, tiny.TRAIN, 3)
    lim = tiny.TRAIN["limits"]
    assert all(v <= lim[k] for k, v in tr["program"].items())
    assert any(v > lim[k] for k, v in tr["control"].items())
    sv = readings(tiny.DEEPSEEK, tiny.DECODE, 3)
    assert sv["fp32"]["max_gap"] <= tiny.DECODE["limits"]["max_gap"]
    assert sv["fp8"]["max_gap"] > tiny.DECODE["limits"]["max_gap"]


def test_a_corrupt_save_is_not_correct(monkeypatch):
    from repro_torch.checkpoint.manager import CheckpointManager
    inner = CheckpointManager.restore

    def flipped(self, *a, **k):
        state, meta = inner(self, *a, **k)
        leaf = state["train"]["params"]["final"]["scale"] \
            if "train" in state else state["pos"]
        leaf.view(-1)[0] += 1
        return state, meta
    monkeypatch.setattr(CheckpointManager, "restore", flipped)
    for wl in (tiny.TRAIN, tiny.DECODE):
        hf = tiny.LLAMA if wl is tiny.TRAIN else tiny.DEEPSEEK
        res = run(hf, wl)
        key = "restore_mismatch" if wl is tiny.TRAIN else "snapshot_mismatch"
        assert res["checks"][key]["value"] == 1 and not res["correct"]


def test_inputs_come_from_the_seed_alone():
    traffic = harness.load_module(harness.BENCH / "traffic"
                                  / "serve_batches.py")
    a = traffic.prompts(BIG_SEED, 3, 16, 128, 102400)
    assert a.shape == (16, 128) and a.dtype == np.int32
    assert np.array_equal(a, traffic.prompts(BIG_SEED, 3, 16, 128, 102400))
    assert not np.array_equal(a, traffic.prompts(BIG_SEED + 1, 3, 16, 128,
                                                 102400))
    assert not np.array_equal(a, traffic.prompts(BIG_SEED, 4, 16, 128,
                                                 102400))
    from repro_torch.data.pipeline import TokenPipeline
    pipe = TokenPipeline(49152, 2, 64, seed=BIG_SEED)
    for i in range(3):
        got = pipe.next_batch()
        tok, tgt = rtrain.token_batch(BIG_SEED, i, 49152, 2, 64)
        assert np.array_equal(got["tokens"], tok)
        assert np.array_equal(got["targets"], tgt)


def test_the_same_seed_reads_the_same_numbers():
    a = readings(tiny.LLAMA, tiny.TRAIN, 7)
    b = readings(tiny.LLAMA, tiny.TRAIN, 7)
    assert a["program"] == b["program"] and a["losses"] == b["losses"]


def _cli(cwd: Path, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "smollm-135m.train_ckpt", "--seed", str(BIG_SEED), "--seconds",
         "1", "--trace", "0", *extra], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120)


def test_run_py_prints_no_result_without_a_card():
    p = _cli(ROOT)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_run_py_fails_where_only_the_benchmark_is(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0 and p.stdout == ""
