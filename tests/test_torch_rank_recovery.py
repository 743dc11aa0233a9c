"""Mid-collective recovery and live migration on the port's thread world,
held against the reference package's unfaulted runs.

One twin each of tests/test_midstep_recovery.py's thread-world cases (a
rank killed inside the ring allreduce: the in-flight step finishes over
the survivors, no generation bump, no restart, zero recomputation) and of
a live-migration round of tests/test_live_migrate.py (rank 0 moved by
pre-copy rounds while the world runs, bit-identical to a run that never
moved; in the process world a replacement process is forked and joins).
Here the test plays the driver's part: it watches the job's failed ranks
and calls ``MPIJob.recover``; tests/test_torch_fault_driver.py drives the
same through the port's FaultTolerantDriver."""
import threading
import time

import numpy as np
import pytest

from repro.core import MPIJob as RJob
from repro_torch.core import MPIJob
from repro_torch.core import migrate as migration
from repro_torch.core.ckpt_protocol import checkpoint_valid, load_manifest
from repro_torch.distributed.faults import RankKilled

N = 3
STEPS = 6
VICTIM = 1
KILL_STEP = STEPS - 1      # the recovered step is the final state


def _acc_app(n_elems: int = 64):
    def init(mpi):
        return {"seed": mpi.rank, "acc": np.zeros(n_elems), "steps_run": 0}

    def step(mpi, st, k):
        rng = np.random.default_rng(1000 * k + st["seed"])
        x = rng.standard_normal(n_elems)
        tot = mpi.Allreduce(x, op="sum", algo="ring")
        return {"seed": st["seed"], "acc": st["acc"] + tot,
                "steps_run": st["steps_run"] + 1}
    return init, step


@pytest.fixture(scope="module")
def control():
    """The reference package's unfaulted N-rank run."""
    init, step = _acc_app()
    job = RJob(N, step, init, transport="shm")
    out = job.run(STEPS, timeout=60)
    job.stop()
    return out


def _run_async(job, n_steps):
    box = {}

    def runner():
        try:
            box["out"] = job.run(n_steps, timeout=60)
        except BaseException as e:  # noqa: BLE001 - surfaced by the test
            box["err"] = e

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    box["thread"] = t
    return box


@pytest.mark.parametrize("transport,where", [("shm", ("rs", 1)),
                                             ("shm", ("ag", 0)),
                                             ("tcp", ("rs", 1))])
def test_rank_killed_inside_allreduce_survives(control, transport, where):
    init, step = _acc_app()

    def killer_step(mpi, st, k):
        if mpi.rank == VICTIM and k == KILL_STEP and mpi.generation == 0:
            def hook(phase, hop):
                if (phase, hop) == where:
                    raise RankKilled(f"injected at {where}")
            mpi._hop_hook = hook
        return step(mpi, st, k)

    job = MPIJob(N, killer_step, init, transport=transport,
                 heartbeat_timeout=5.0)
    box = _run_async(job, STEPS)
    deadline = time.time() + 30
    while not job.failed_ranks() and time.time() < deadline:
        time.sleep(0.005)
    assert job.failed_ranks() == [VICTIM]
    rep = job.recover([VICTIM], timeout=20.0)
    box["thread"].join(60)
    job.stop()
    assert "err" not in box, box.get("err")
    out = box["out"]
    assert rep["dead"] == [VICTIM] and rep["rerun_ops"] == 0
    if where[0] == "rs":
        # mid-reduce the survivors are stuck in the op: it was finished
        # centrally from the contribution ledger
        assert rep["completed_ops"] == 1
    assert job.coord.generation == 0
    assert job.coord.live_set == {0, 2}
    for r in range(N):
        if r == VICTIM:
            continue
        assert out[r]["steps_run"] == STEPS          # no step ran twice
        assert np.array_equal(out[r]["acc"], control[r]["acc"]), r


# ----------------------------------------------------------- live migration

MIG_N = 2
MIG_STEPS = 100


def mig_init(mpi):
    r = mpi.rank
    return {"acc": np.zeros(32, dtype=np.float64),
            "hot": np.full(2048, float(r), dtype=np.float64),
            "cold": np.arange(8192, dtype=np.float64)}       # never dirtied


def mig_step(mpi, state, step):
    total = mpi.Allreduce(state["acc"][:4] + step)
    state = dict(state)
    state["acc"] = state["acc"].copy()
    state["acc"][:4] += total
    state["hot"] = state["hot"] + 0.5
    time.sleep(0.004)
    return state


@pytest.mark.parametrize("transport", ["shm", "tcp", "proc"])
def test_live_migrate_bit_identical(tmp_path, transport):
    """Rank 0 live-migrated mid-run: the world finishes bit-identical to
    the reference's run that never moved, and the migration's final
    stop-the-world round committed a restorable, leaf-split checkpoint."""
    job = MPIJob(MIG_N, mig_step, mig_init, transport=transport)
    box = _run_async(job, MIG_STEPS)
    time.sleep(0.3)
    rep = job.migrate(tmp_path / "ck", ranks=(0,), max_rounds=4,
                      timeout=60.0)
    box["thread"].join(120)
    job.stop()
    assert "err" not in box, box.get("err")
    migrated = box["out"]
    ctrl = RJob(MIG_N, mig_step, mig_init, transport="shm")
    control = ctrl.run(MIG_STEPS, timeout=120.0)
    ctrl.stop()
    for r in range(MIG_N):
        for k in control[r]:
            assert np.array_equal(migrated[r][k], control[r][k]), (r, k)
    assert rep["converged"] and rep["rounds"]
    assert 0 <= rep["final_bytes"] <= rep["total_bytes"]
    assert checkpoint_valid(tmp_path / "ck")
    assert migration.latest_round(tmp_path / "ck") == len(rep["rounds"])
    parts = load_manifest(tmp_path / "ck")["ranks"]["0"]["parts"]
    assert sorted(k for k in parts if k.startswith("app/")) == [
        "app/acc", "app/cold", "app/hot"]
    st = job.stats()["coordinator"]
    assert st["migrations"] == 1
    assert st["migrate_rounds"] == len(rep["rounds"])
    assert st["migrate_pause_s"] > 0.0
