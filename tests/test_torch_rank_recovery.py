"""Mid-collective recovery and live migration on the port's thread world,
held against the reference package's unfaulted runs.

The replay primitives that finish an op centrally reproduce the wire
dance's float association bit for bit, as the reference's do.

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
from repro.core import recovery as r_recovery
from repro.distributed.faults import FaultTolerantDriver as RDriver
from repro_torch.core import MPIJob
from repro_torch.core import migrate as migration
from repro_torch.core import recovery
from repro_torch.core.ckpt_protocol import checkpoint_valid, load_manifest
from repro_torch.distributed.faults import FaultTolerantDriver, RankKilled

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


# ------------------------------------------------------- bit-exact replay

def _one_shot_allreduce(algo):
    init, _ = _acc_app()

    def step(mpi, st, k):
        rng = np.random.default_rng(st["seed"])
        x = rng.standard_normal(37)      # uneven chunks: 13/12/12
        return {"x": x, "tot": mpi.Allreduce(x, op="sum", algo=algo)}
    job = MPIJob(N, step, init)
    out = job.run(1, timeout=60)
    job.stop()
    return out


@pytest.mark.parametrize("algo,replay,r_replay", [
    ("ring", recovery.replay_ring, r_recovery.replay_ring),
    ("tree", recovery.replay_tree, r_recovery.replay_tree),
])
def test_replay_matches_the_wire_dance_bit_for_bit(algo, replay, r_replay):
    """replay_ring/replay_tree reproduce the exact float association of the
    wire algorithms, as the reference's replays of the same contributions
    do: a centrally finished op is indistinguishable from the dance."""
    out = _one_shot_allreduce(algo)
    contribs = [out[r]["x"] for r in range(N)]
    expect = replay(contribs, "sum")
    assert np.array_equal(np.asarray(expect), np.asarray(r_replay(contribs,
                                                                  "sum")))
    for r in range(N):
        got = out[r]["tot"]
        assert np.array_equal(np.asarray(got).reshape(-1),
                              np.asarray(expect).reshape(-1)), (algo, r)


# ------------------------------- survive the step, through the driver

def _killed(where):
    """The accumulator with VICTIM raising RankKilled at ring hop `where`
    of step KILL_STEP (generation 0 only)."""
    init, step = _acc_app()

    def killer_step(mpi, st, k):
        if mpi.rank == VICTIM and k == KILL_STEP and mpi.generation == 0:
            def hook(phase, hop):
                if (phase, hop) == where:
                    raise RankKilled(f"injected at {where}")
            mpi._hop_hook = hook
        return step(mpi, st, k)
    return init, killer_step


def _drive(driver_cls, job_cls, tmp_path, where, transport):
    init, step = _killed(where)
    driver = driver_cls(
        job_factory=lambda: job_cls(N, step, init, transport=transport,
                                    heartbeat_timeout=5.0),
        restart_factory=lambda d, tr: job_cls.restart(
            d, step, init, transport=tr),
        ckpt_root=tmp_path / "ck", ckpt_every=100)
    out = driver.run(STEPS, transport_after_failure=transport, timeout=60)
    return driver, out


def _assert_survived(tmp_path, where, transport, control):
    """The port's FaultTolerantDriver finishes the step over the survivors
    in the same incarnation (no bump, no restart, nothing recomputed),
    bit-equal to the unfaulted control, with the events and the recovery
    the reference's driver reports for the same fault."""
    driver, out = _drive(FaultTolerantDriver, MPIJob, tmp_path / "port",
                         where, transport)
    ref, _ = _drive(RDriver, RJob, tmp_path / "ref", where, transport)
    assert driver.events[-1] == "done"
    assert any(e.startswith("recover:") for e in driver.events), driver.events
    assert not any(e.startswith(("restart:", "dead:", "failure:"))
                   for e in driver.events), driver.events
    assert [e.kind for e in driver.events] == [e.kind for e in ref.events]
    assert driver.membership.generation == 0
    rep = driver.recoveries[0]
    assert rep["dead"] == [VICTIM]
    assert rep["rerun_ops"] == 0          # zero recomputation, ever
    # completed_ops is 1 where the survivors are provably stuck in the op
    # (mid reduce-scatter) and timing-dependent past it, in both packages
    keys = ("dead", "rerun_ops") + (("completed_ops",) if where[0] == "rs"
                                    else ())
    assert {k: rep[k] for k in keys} == {k: ref.recoveries[0][k]
                                         for k in keys}
    for r in range(N):
        if r == VICTIM:
            continue
        assert out[r]["steps_run"] == STEPS          # no step ran twice
        assert np.array_equal(out[r]["acc"], control[r]["acc"]), r
    return rep


@pytest.mark.parametrize("where", [("rs", 0), ("rs", 1), ("ag", 0),
                                   ("ag", 1)])
def test_thread_shm_kill_inside_allreduce_survives(tmp_path, control, where):
    """Thread world, shm: the victim dies at every distinct ring position
    (entering the reduce-scatter, mid-fold, entering the allgather, its
    last hop); every position recovers over the survivors."""
    rep = _assert_survived(tmp_path, where, "shm", control)
    if where[0] == "rs":
        # mid-reduce the survivors are stuck in the op: it was finished
        # centrally from the ledger
        assert rep["completed_ops"] == 1


def test_thread_tcp_kill_inside_allreduce_survives(tmp_path, control):
    rep = _assert_survived(tmp_path, ("rs", 1), "tcp", control)
    assert rep["completed_ops"] == 1
