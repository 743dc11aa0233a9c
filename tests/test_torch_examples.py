"""The port's examples (examples/torch/), each run as a user runs it: in a
fresh interpreter, on the CPU (``--device cpu``), at its smallest flags.
quickstart's result line is held beside the reference example's own;
elastic_restart resumes one checkpoint on 2, 4 and 1 ranks;
train_driver crashed and rerun resumes from its last checkpoint with the
losses of the uninterrupted run.

The examples that run worlds or several processes run once, in a module
fixture with its own timeout (as the worlds of
tests/test_torch_sharded_*.py do), and the tests read what they
printed."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
# one intra-op thread a process: beside the suite's other workers, idle
# OpenMP threads spinning at every op's barrier slow these runs severalfold
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
       "OMP_NUM_THREADS": "1"}
TIMEOUT_S = 600


def _example(path, *args) -> str:
    proc = subprocess.run([sys.executable, str(ROOT / path), *args],
                          cwd=ROOT, env=ENV, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return proc.stdout


def _lines(out: str, prefix: str) -> list:
    return [ln.strip() for ln in out.splitlines()
            if ln.strip().startswith(prefix)]


def test_quickstart_restarts_bitwise_like_the_reference():
    ours = _example("examples/torch/quickstart.py", "--device", "cpu")
    theirs = _example("examples/quickstart.py")
    want = "RESULT: cross-implementation restart bitwise identical: True"
    assert _lines(ours, "RESULT:") == _lines(theirs, "RESULT:") == [want]
    # the same numpy ranks: the same losses, printed alike
    assert _lines(ours, "final loss") == _lines(theirs, "final loss")


@pytest.fixture(scope="module")
def elastic_worlds():
    """elastic_restart.py run whole: its three worlds' lines and its
    output."""
    out = _example("examples/torch/elastic_restart.py", "--device", "cpu")
    return [ast.literal_eval(ln) for ln in _lines(out, "{")], out


def test_elastic_restart_trains_on_two_ranks(elastic_worlds):
    w = elastic_worlds[0][0]
    assert (w["devices"], w["mesh"], w["resumed_from"]) == (
        2, {"data": 1, "model": 2}, None)
    assert len(w["losses"]) == 3 and np.all(np.isfinite(w["losses"]))


def test_elastic_restart_resumes_on_four_ranks(elastic_worlds):
    w = elastic_worlds[0][1]
    assert (w["devices"], w["mesh"], w["resumed_from"]) == (
        4, {"data": 2, "model": 2}, 10)
    assert np.all(np.isfinite(w["losses"]))


def test_elastic_restart_resumes_on_three_topologies(elastic_worlds):
    worlds, out = elastic_worlds
    assert [(w["devices"], w["mesh"], w["resumed_from"]) for w in worlds] == [
        (2, {"data": 1, "model": 2}, None),
        (4, {"data": 2, "model": 2}, 10),
        (1, {"data": 1, "model": 1}, 20)]
    assert out.rstrip().endswith("cross-implementation restart works")


def test_serve_batched_prints_the_references_lines():
    out = _example("examples/torch/serve_batched.py", "--arch", "smollm-135m",
                   "--batch", "2", "--prompt-len", "8", "--new-tokens", "4",
                   "--device", "cpu")
    assert re.search(r"^arch=smollm-135m batch=2: prefill \d+ms, "
                     r"decode \d+ms \(\d+ tok/s\), out shape \(2, 4\)$",
                     out, re.M), out
    assert _lines(out, "first sequence:")
    assert re.search(r"^serving state checkpointed mid-generation \(\d+ "
                     r"files\)", out, re.M), out


def _last_losses(out: str) -> list:
    (line,) = _lines(out, "losses:")
    return ast.literal_eval(line.split(" ... ")[1])


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """train_driver.py at its smallest flags: uninterrupted, crashed
    after step 5, and rerun on the crashed run's directory."""
    d = tmp_path_factory.mktemp("train_driver")
    flags = ["--steps", "12", "--batch", "2", "--seq", "16", "--ckpt-every",
             "3", "--device", "cpu"]
    path = "examples/torch/train_driver.py"
    return {"full": _example(path, *flags, "--ckpt-dir", str(d / "full")),
            "crashed": _example(path, *flags, "--ckpt-dir", str(d / "ck"),
                                "--kill-at", "5"),
            "resumed": _example(path, *flags, "--ckpt-dir", str(d / "ck"))}


def test_train_driver_trains_uninterrupted(train_runs):
    # losses logged every 5 steps and at the last: steps 0, 5, 10, 11
    assert len(_last_losses(train_runs["full"])) == 3
    assert _lines(train_runs["full"], "arch=smollm-135m")


def test_train_driver_crashes_when_asked(train_runs):
    assert _lines(train_runs["crashed"], "CRASHED (as requested): injected "
                                         "failure after step 5")


def test_train_driver_resumes_with_the_uninterrupted_losses(train_runs):
    """The rerun resumes from the crashed run's last checkpoint (step 3)
    and logs the uninterrupted run's losses at steps 5, 10 and 11."""
    resumed = train_runs["resumed"]
    assert _lines(resumed, "auto-resumed from checkpoint at step 3")
    assert _last_losses(resumed) == _last_losses(train_runs["full"])
