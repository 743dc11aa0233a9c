"""The port's extended MPI calls (Sendrecv, Alltoall, Reduce_scatter),
failure detection, variant composition and launch entry points: twins of
tests/test_extensions.py.

Each extended call runs in both packages on the same inputs, and what the
ranks received must be bit-equal; a checkpoint taken mid-sequence by either
package restarts in the other.  The launch entry points run the port's own
CLIs on the CPU (``--device cpu``) in fresh interpreters, and print the
reference's keys."""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from repro.core import MPIJob as RJob
from repro_torch.core import MPIJob
from test_torch_core_mpi import _same, run_both

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def run_app(n, step_fn, init_fn=lambda mpi: {}, steps=1, **kw):
    job = MPIJob(n, step_fn, init_fn, **kw)
    try:
        return job.run(steps, timeout=60), job
    finally:
        job.stop()


# ----------------------------------------------------------- API plumbing

@pytest.mark.parametrize("n", [2, 3, 4])
def test_sendrecv_ring(n):
    def step(mpi, st, k):
        me = mpi.Comm_rank()
        got = mpi.Sendrecv(me * 10, (me + 1) % n, 1, (me - 1) % n, 1)
        assert got == ((me - 1) % n) * 10
        x = np.arange(5, dtype=np.float64) * (me + 1)
        arr = mpi.Sendrecv(x, (me + 1) % n, 2, (me - 1) % n, 2)
        return {"got": got, "arr": arr}
    out = run_both(n, step)
    assert [out[r]["got"] for r in range(n)] == \
        [((r - 1) % n) * 10 for r in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_alltoall(n):
    def step(mpi, st, k):
        me = mpi.Comm_rank()
        out = mpi.Alltoall([me * 100 + j for j in range(n)])
        assert out == [src * 100 + me for src in range(n)]
        blocks = mpi.Alltoall([np.full(3, me + 0.5 * j) for j in range(n)])
        return {"out": out, "blocks": blocks}
    run_both(n, step)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_reduce_scatter_blocks(n):
    def step(mpi, st, k):
        me = mpi.Comm_rank()
        x = np.arange(n * 3, dtype=np.float64) * (me + 1)
        mine = mpi.Reduce_scatter(x, "sum")
        total = sum(range(1, n + 1))
        expect = np.array_split(np.arange(n * 3, dtype=np.float64) * total,
                                n)[me]
        assert np.allclose(mine, expect), (me, mine, expect)
        rng = np.random.default_rng(me)
        return {"mine": mine,
                "noisy": mpi.Reduce_scatter(rng.standard_normal(n * 5 + 1),
                                            "sum")}
    run_both(n, step)


def _rs_app():
    def init_fn(mpi):
        return {"rs": None, "a2a": None, "sr": None}

    def step_fn(mpi, st, k):
        me, n = mpi.Comm_rank(), mpi.Comm_size()
        if k == 2:   # after the checkpoint at step >= 1
            st["rs"] = mpi.Reduce_scatter(
                np.ones(8, np.float64) * (me + 1), "sum")
            st["a2a"] = mpi.Alltoall([me * 10 + j for j in range(n)])
            st["sr"] = mpi.Sendrecv(np.float64(me), (me + 1) % n, 3,
                                    (me - 1) % n, 3)
        return st
    return init_fn, step_fn


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "ref"),
                                           ("ref", "port")])
def test_extended_calls_survive_restart(tmp_path, writer, reader):
    """Checkpointed at step 1 (the world exits there), restarted on tcp by
    the reader package: the extended calls after the restart give what an
    uninterrupted reference run gives, bit for bit."""
    pkg = {"port": MPIJob, "ref": RJob}
    init_fn, step_fn = _rs_app()
    job = pkg[writer](4, step_fn, init_fn)
    job.checkpoint_at(1, tmp_path / "ck", resume=False)
    job.run(3, timeout=60)
    job.stop()
    job2 = pkg[reader].restart(tmp_path / "ck", step_fn, init_fn,
                               transport="tcp")
    out = job2.run(3, timeout=60)
    job2.stop()
    ref_job = RJob(4, step_fn, init_fn)
    want = ref_job.run(3, timeout=60)
    ref_job.stop()
    for r in range(4):
        assert np.allclose(out[r]["rs"], np.ones(2) * 10)
        assert _same(out[r], want[r]), (r, out[r], want[r])


# --------------------------------------------------- failure detection

def test_heartbeat_detects_stalled_rank():
    def step(mpi, st, k):
        if mpi.rank == 1 and k == 1:
            time.sleep(0.5)                  # stall beyond timeout
        else:
            time.sleep(0.01)
        return st

    job = MPIJob(3, step, lambda mpi: {}, heartbeat_timeout=0.2)
    t = threading.Thread(target=lambda: job.run(3, timeout=60))
    t.start()
    detected = []
    deadline = time.time() + 5
    while time.time() < deadline and 1 not in detected:
        detected = job.heartbeat.dead_ranks()
        time.sleep(0.02)
    t.join(30)
    job.stop()
    assert 1 in detected


def test_straggler_recorded_in_job():
    def step(mpi, st, k):
        time.sleep(0.15 if mpi.rank == 2 else 0.01)
        return st

    _, job = run_app(3, step, steps=3)
    assert 2 in job.stragglers.stragglers()


# --------------------------------------------------- variant composition

def test_variant_composition():
    from repro.distributed.sharding import make_variant as r_make_variant
    from repro_torch.distributed.sharding import make_variant
    for name in ("seqshard+fsdp", "sp_saves+fsdp", "dponly+fsdp", "kvseq"):
        v, ref = make_variant(name), r_make_variant(name)
        assert dict(v.mapping) == dict(ref.mapping), name
        assert tuple(v.fsdp_axes) == tuple(ref.fsdp_axes), name
    v = make_variant("seqshard+fsdp")
    assert v.mapping["seq"] == ("model",) and v.fsdp_axes == ("data",)
    v = make_variant("sp_saves+fsdp")
    assert v.mapping["seq_saves"] == ("model",)
    v = make_variant("dponly+fsdp")
    assert v.fsdp_axes == ("data", "model")
    v = make_variant("kvseq")
    assert v.mapping["kv_seq"] == ("model",) and v.mapping["kv_heads"] == ()
    with pytest.raises(KeyError):
        make_variant("fsdp+bogus")


def test_ctx_divisible_outside_ctx_defaults_true():
    from repro_torch.distributed.sharding import ctx_divisible
    assert ctx_divisible("heads", 7)     # no mesh context -> permissive


# --------------------------------------------------- launch entrypoints

def _cli(module, *args):
    r = subprocess.run([sys.executable, "-m", module, *args],
                       capture_output=True, text=True, timeout=600, env=ENV,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    return [json.loads(ln) for ln in r.stdout.strip().splitlines()
            if ln.startswith("{")]


def test_launch_train_cli(tmp_path):
    rows = _cli("repro_torch.launch.train", "--arch", "smollm-135m",
                "--reduced", "--device", "cpu", "--steps", "3", "--batch",
                "2", "--seq", "32", "--ckpt-dir", str(tmp_path))
    # the reference CLI's two lines' keys (repro/launch/train.py)
    assert {"arch", "params_m", "mesh", "variant", "accum",
            "steps"} <= set(rows[0])
    last = rows[-1]
    assert {"resumed_from", "steps_run", "first_loss", "final_loss",
            "wall_s", "ckpt_stats"} <= set(last)
    assert last["steps_run"] == 3 and np.isfinite(last["final_loss"])


def test_launch_serve_cli():
    rows = _cli("repro_torch.launch.serve", "--arch", "smollm-135m",
                "--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--new-tokens", "8")
    out = rows[-1]
    # the reference CLI's round line's keys (repro/launch/serve.py)
    assert {"round", "prefill_s", "decode_s", "tok_per_s"} <= set(out)
    assert out["tok_per_s"] > 0
