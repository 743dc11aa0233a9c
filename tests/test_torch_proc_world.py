"""The port's PROCESS world (DESIGN.md §10) against the reference package.

Twins of tests/test_proc_world.py on ``repro_torch.core``: ranks as real OS
processes behind socket proxy endpoints (distinct live PIDs, per-rank
logs, exit codes reaped), children writing their own rank images while the
launcher commits the manifest, a SIGKILL with no unwinding detected by the
torn socket, and a kill in the middle of an image write that never loses
the previous checkpoint.  Each world's result is held against the
reference's own run of the same numpy application, bit for bit: its
thread world's run, or its restart of the checkpoint the port wrote.

Then process-world checkpoints crossing the packages: one written by the
port's rank processes restarted by ``repro.core.MPIJob`` (thread world and
process world), and one written by the reference's rank processes
restarted by the port's (thread, process and ring worlds).  The app sends
across the step boundary, so every image holds drained envelopes."""
import os
import re
import signal
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from conftest import exact_transports

from repro.core import MPIJob as RJob
from repro.core.coordinator import Membership as RMembership
from repro.distributed.proxy_grad import make_dp_app as r_make_dp_app
from repro_torch.core import MPIJob
from repro_torch.core import runtime as t_runtime
from repro_torch.core.ckpt_protocol import (checkpoint_valid, load_manifest,
                                            load_rank_image)
from repro_torch.core.procworld import RankProcessDied
from repro_torch.distributed.faults import (FaultTolerantDriver,
                                            kill_rank_process)
from repro_torch.distributed.proxy_grad import make_dp_app

N_PP, STEPS_PP, CKPT_PP = 3, 14, 7


def _params_equal(a, b):
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def _runs_equal(a, b):
    return len(a) == len(b) and all(
        _params_equal(x["params"], y["params"]) and x["loss"] == y["loss"]
        for x, y in zip(a, b))


def pingpong_app():
    def init_fn(mpi):
        return {"acc": np.zeros(4, np.float64)}

    def step_fn(mpi, st, k):
        n, me = mpi.Comm_size(), mpi.Comm_rank()
        mpi.Send(np.full(4, me * 100 + k, np.float64), (me + 1) % n,
                 tag=k % 5)
        if k > 0:
            st["acc"] = st["acc"] + mpi.Recv(source=(me - 1) % n,
                                             tag=(k - 1) % 5)
        if k % 4 == 3:
            st["sum"] = mpi.Allreduce(st["acc"].copy(), "sum")
        return st

    return init_fn, step_fn


def _run(job, steps, timeout=60):
    try:
        return job.run(steps, timeout=timeout)
    finally:
        job.stop()


def _reference_restart(ckpt, steps, dead, world, transport="shm"):
    """The reference's restart of `ckpt` (written by either package) onto
    its thread world, reshaped past `dead` to `world`: its own run of the
    reference's DP app."""
    init_fn, step_fn = r_make_dp_app()
    ms = RMembership(load_manifest(ckpt)["n_ranks"])
    ms.bump(dead=list(dead), world_size=world)
    with exact_transports():
        job = RJob.restart(ckpt, step_fn, init_fn, transport=transport,
                           world_size=world, dead_ranks=list(dead),
                           membership=ms, coord_timeout=30.0)
    return _run(job, steps)


@pytest.fixture(scope="module")
def pingpong_reference():
    """The reference's thread-world run of the pingpong app."""
    init_fn, step_fn = pingpong_app()
    with exact_transports():
        job = RJob(N_PP, step_fn, init_fn, transport="shm")
    return _run(job, STEPS_PP)


@pytest.fixture(scope="module")
def proc_checkpoints(tmp_path_factory):
    """A pingpong world of rank processes checkpointed at CKPT_PP with
    resume=False, written once by each package: {"port": dir, "ref": dir}."""
    init_fn, step_fn = pingpong_app()
    root = tmp_path_factory.mktemp("proc_ckpts")
    out = {}
    for pkg, cls in (("port", MPIJob), ("ref", RJob)):
        job = cls(N_PP, step_fn, init_fn, transport="proc")
        job.checkpoint_at(CKPT_PP, root / pkg, resume=False)
        _run(job, STEPS_PP)
        out[pkg] = root / pkg
    return out


# ------------------------------------------------------- substrate basics

def test_proc_world_runs_with_real_pids_and_logs(tmp_path, monkeypatch):
    """Ranks are genuinely separate OS processes: distinct live PIDs (all
    different from the launcher), captured per-rank stdout, exit-code
    reaping, and a stop() that leaves no child behind; what they compute
    equals the reference's thread world."""
    monkeypatch.setenv("REPRO_PROC_LOG_DIR", str(tmp_path / "logs"))

    def init_fn(mpi):
        return {"acc": 0}

    def step_fn(mpi, st, k):
        print(f"hello from rank {mpi.rank} pid {os.getpid()} step {k}")
        st["pid"] = os.getpid()
        st["acc"] += int(mpi.Allreduce(np.float64(mpi.rank), "sum"))
        return st

    job = MPIJob(3, step_fn, init_fn, transport="proc")
    out = job.run(4, timeout=60)
    pids = {r: out[r]["pid"] for r in range(3)}
    # PID membership is LIVE: after the ranks exited it reports nobody
    assert job.rank_pids() == {}
    assert len(set(pids.values())) == 3
    assert os.getpid() not in pids.values()
    assert all(out[r]["acc"] == 4 * (0 + 1 + 2) for r in range(3))
    assert job._proc.exit_codes == {0: 0, 1: 0, 2: 0}
    for r in range(3):
        text = job._proc.log_path(r).read_text()
        assert f"hello from rank {r} pid {pids[r]}" in text
    job.stop()
    assert not any(p.is_alive() for p in job._proc._procs.values())
    with exact_transports():
        ref = _run(RJob(3, step_fn, init_fn, transport="shm"), 4)
    assert [o["acc"] for o in out] == [o["acc"] for o in ref]


def test_proc_checkpoint_restarts_on_both_substrates(proc_checkpoints,
                                                     pingpong_reference):
    """A checkpoint written by the port's rank PROCESSES (children write
    images into the shared chunk store, the launcher commits the manifest)
    restores bit-identically into another process world AND into a thread
    world of the port, equal to the reference's uninterrupted run."""
    ck = proc_checkpoints["port"]
    man = load_manifest(ck)
    assert man["meta"]["transport"] == "proc"
    assert man["n_ranks"] == N_PP
    init_fn, step_fn = pingpong_app()
    for target in ("proc", "shm"):
        out = _run(MPIJob.restart(ck, step_fn, init_fn, transport=target),
                   STEPS_PP)
        for r in range(N_PP):
            assert np.array_equal(out[r]["acc"],
                                  pingpong_reference[r]["acc"]), (target, r)
            assert np.array_equal(out[r]["sum"],
                                  pingpong_reference[r]["sum"]), (target, r)


@pytest.mark.parametrize("writer,target", [
    ("port", "shm"), ("port", "proc"),
    ("ref", "shm"), ("ref", "proc"), ("ref", "shmring"),
])
def test_proc_checkpoints_cross_the_packages(proc_checkpoints,
                                             pingpong_reference, writer,
                                             target):
    """A process-world checkpoint restarts in the OTHER package, thread or
    process world: the port's images in ``repro.core.MPIJob``, the
    reference's in the port's; the drained envelopes in the images load
    on both sides, and the resumed runs equal the reference's."""
    ck = proc_checkpoints[writer]
    assert sum(len(load_rank_image(ck, r).mpi_state["cache"])
               for r in range(N_PP)) == N_PP   # one message a rank drained
    init_fn, step_fn = pingpong_app()
    if writer == "port":
        with exact_transports():
            job = RJob.restart(ck, step_fn, init_fn, transport=target)
    else:
        job = MPIJob.restart(ck, step_fn, init_fn, transport=target)
    out = _run(job, STEPS_PP)
    for r in range(N_PP):
        assert np.array_equal(out[r]["acc"], pingpong_reference[r]["acc"])
        assert np.array_equal(out[r]["sum"], pingpong_reference[r]["sum"])


# --------------------------------------------------- SIGKILL fault injection

def test_sigkill_mid_allreduce_reshapes_and_matches_thread_resume(tmp_path):
    """A rank process SIGKILLs itself (deterministically, at a step
    boundary — its peers are inside that step's ring allreduce waiting on
    it); the driver detects the torn socket, bumps the generation, and
    restarts reshaped.  The resumed run is bit-identical to the reference
    resuming the SAME reshaped checkpoint on its thread world."""
    n, steps, victim = 3, 14, 2
    init_fn, dp_step = make_dp_app()

    def killing_step(mpi, st, k):
        if mpi.generation == 0 and k == 8 and mpi.rank == victim:
            os.kill(os.getpid(), signal.SIGKILL)   # a REAL kill: no unwind
        return dp_step(mpi, st, k)

    driver = FaultTolerantDriver(
        job_factory=lambda ws, ms: MPIJob(
            ws or n, killing_step, init_fn, transport="proc",
            heartbeat_timeout=5.0, membership=ms, coord_timeout=30.0),
        restart_factory=lambda d, tr, ws, dead, ms: MPIJob.restart(
            d, killing_step, init_fn, transport="proc", world_size=ws,
            dead_ranks=dead, membership=ms, heartbeat_timeout=5.0,
            coord_timeout=30.0),
        ckpt_root=tmp_path, ckpt_every=5)
    out = driver.run(steps, transport_after_failure="proc", timeout=90)

    assert len(out) == n - 1
    assert driver.membership.generation == 1
    assert any(e.startswith(f"dead:[{victim}]") for e in driver.events)
    assert any(e.startswith("restart:at_00000005") for e in driver.events)
    assert driver.events[-1] == "done"
    for r in range(1, n - 1):
        assert _params_equal(out[0]["params"], out[r]["params"])
    ref = _reference_restart(tmp_path / "at_00000005", steps, [victim],
                             n - 1)
    assert _runs_equal(out, ref), \
        "process-world resume diverged from the reference's thread world"


class PickleBomb:
    """App-state member that SIGKILLs its own process while being
    serialized — i.e. exactly mid-checkpoint-write, after some chunks may
    already be on disk but before this rank's manifest entry exists."""

    def __init__(self, latch: str):
        self.latch = latch
        self.armed = False

    def __getstate__(self):
        if self.armed and not os.path.exists(self.latch):
            Path(self.latch).touch()
            os.kill(os.getpid(), signal.SIGKILL)
        return {"latch": self.latch, "armed": False}   # restores disarmed


def test_sigkill_mid_checkpoint_write_never_loses_previous(tmp_path):
    """Killing a rank in the middle of writing its image leaves that
    checkpoint uncommitted (no manifest) — the previous valid checkpoint
    survives, is never gc'd, and recovery resumes from it, bit-equal to
    the reference resuming the same checkpoint."""
    n, steps, victim = 3, 14, 1
    init_fn, dp_step = make_dp_app()
    latch = str(tmp_path / "boom.latch")

    def init_with_bomb(mpi):
        st = init_fn(mpi)
        st["bomb"] = PickleBomb(latch)
        return st

    def step_fn(mpi, st, k):
        bomb = st["bomb"]
        st = dp_step(mpi, st, k)        # dp step returns a fresh dict
        st["bomb"] = bomb
        bomb.armed = (mpi.generation == 0 and mpi.rank == victim
                      and k >= 6)
        return st

    seed = MPIJob(n, step_fn, init_with_bomb, transport="proc")
    seed.checkpoint_at(4, tmp_path / "at_00000004", resume=False)
    _run(seed, steps)
    assert checkpoint_valid(tmp_path / "at_00000004", deep=True)

    driver = FaultTolerantDriver(
        job_factory=lambda ws, ms: MPIJob(
            ws or n, step_fn, init_with_bomb, transport="proc",
            heartbeat_timeout=5.0, membership=ms, coord_timeout=30.0),
        restart_factory=lambda d, tr, ws, dead, ms: MPIJob.restart(
            d, step_fn, init_with_bomb, transport="proc", world_size=ws,
            dead_ranks=dead, membership=ms, heartbeat_timeout=5.0,
            coord_timeout=30.0),
        ckpt_root=tmp_path, ckpt_every=4)
    out = driver.run(steps, transport_after_failure="proc", timeout=90)

    assert os.path.exists(latch), "the bomb must have gone off"
    assert len(out) == n - 1
    assert any(e.startswith(f"dead:[{victim}]") for e in driver.events)
    assert any(e.startswith("restart:at_00000004") and "world=2" in e
               for e in driver.events)
    assert driver.events[-1] == "done"
    assert checkpoint_valid(tmp_path / "at_00000004", deep=True)
    man = load_manifest(tmp_path / "at_00000004")
    assert man["n_ranks"] == n and man["generation"] == 0
    man8 = load_manifest(tmp_path / "at_00000008")
    assert man8["n_ranks"] == n - 1 and man8["generation"] == 1
    # the reference resumes the port's previous checkpoint alike (its app
    # state carries the disarmed bomb, which the reference's step ignores)
    ref = _reference_restart(tmp_path / "at_00000004", steps, [victim],
                             n - 1)
    for a, b in zip(out, ref):
        assert _params_equal(a["params"], b["params"]) and \
            a["loss"] == b["loss"]


def test_external_sigkill_detected_as_process_death(tmp_path, monkeypatch):
    """kill_rank_process: the driver-side fault injector sends a real
    SIGKILL to a live rank PID mid-run; the endpoint records the torn
    socket as RankProcessDied and the job completes reshaped, equal to
    the reference resuming the checkpoint the driver restarted from.  The
    ledger is off, so the kill takes the declare-dead -> reshape ladder."""
    monkeypatch.setattr(t_runtime, "LEDGER_ENABLED", False)
    n, victim, steps = 3, 1, 60
    init_fn, dp_step = make_dp_app()

    def slow_step(mpi, st, k):
        time.sleep(0.02)
        return dp_step(mpi, st, k)

    jobs = []

    def fresh(ws, ms):
        job = MPIJob(ws or n, slow_step, init_fn, transport="proc",
                     heartbeat_timeout=5.0, membership=ms,
                     coord_timeout=30.0)
        jobs.append(job)
        return job

    killed = {}

    def killer():
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if jobs and victim in jobs[0].rank_pids():
                break
            time.sleep(0.01)
        time.sleep(0.4)                    # let steps + a checkpoint land
        try:
            killed["pid"] = kill_rank_process(jobs[0], victim)
        except ValueError:
            pass                           # rank already gone: still a kill

    t = threading.Thread(target=killer)
    t.start()
    driver = FaultTolerantDriver(
        job_factory=fresh,
        restart_factory=lambda d, tr, ws, dead, ms: MPIJob.restart(
            d, slow_step, init_fn, transport="proc", world_size=ws,
            dead_ranks=dead, membership=ms, heartbeat_timeout=5.0,
            coord_timeout=30.0),
        ckpt_root=tmp_path, ckpt_every=5,
        world_size_after_failure=n - 1)
    out = driver.run(steps, transport_after_failure="proc", timeout=120)
    t.join(30)

    assert "pid" in killed, "the killer thread never found a live rank pid"
    assert len(out) == n - 1
    assert any(e.startswith("dead:") and str(victim) in e.split(":")[1]
               for e in driver.events)
    assert driver.events[-1] == "done"
    assert isinstance(jobs[0].errors.get(victim), RankProcessDied)
    for r in range(1, n - 1):
        assert _params_equal(out[0]["params"], out[r]["params"])
    # the reference's own run of what the driver resumed: its restart of
    # the checkpoint the driver restarted from or, when the kill landed
    # before the first checkpoint committed, its fresh world of n - 1
    restart = [e for e in driver.events if e.startswith("restart:")]
    dead = next(e for e in driver.events if e.startswith("dead:"))
    gone = [int(r) for r in re.findall(r"\d+", dead.split(":")[1])]
    if restart:
        ref = _reference_restart(tmp_path / restart[0].split(":")[1],
                                 steps, gone, n - 1)
    else:
        assert driver.events.count("start:fresh") == 2, driver.events
        r_init, r_step = r_make_dp_app()
        with exact_transports():
            ref = _run(RJob(n - 1, r_step, r_init, transport="shm"), steps)
    assert _runs_equal(out, ref)
