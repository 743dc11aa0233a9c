"""The port's FaultTolerantDriver against the reference package.

Twins of the driver's tests in the reference: tests/test_elastic_restart.py
(kill a rank, bump, restart reshaped onto another transport; the total
outage; the straggler excluded at a checkpoint boundary),
tests/test_mpi_training.py (the legacy factories), tests/test_midstep_
recovery.py (one FSM trace on both substrates; a real SIGKILL inside the
ring allreduce absorbed in place; a boundary death falling back to the
restart ladder; the sparse post-recovery checkpoint; auto-migration),
tests/test_observability.py (the pinned event vocabulary, the typed event
that is its legacy string, the merged timeline of a SIGKILLed process
world) and tests/test_chunk_service.py (a rank SIGKILLed mid chunk upload).

Each run is held against the reference's: its driver's event strings for
the same run where the run is deterministic (numbers of seconds masked),
and the reference's own restart of the checkpoint the port's driver
resumed from, or its unfaulted run, bit for bit.  Last, the procrun CLI
of both packages, with and without a kill: equal ``done:`` lines."""
import json
import os
import pickle
import re
import signal
import struct
import time

import numpy as np
import pytest

from conftest import exact_transports

from repro.core import MPIJob as RJob
from repro.core.coordinator import Membership as RMembership
from repro.distributed import faults as r_faults
from repro.distributed.faults import FaultTolerantDriver as RDriver
from repro.distributed.proxy_grad import make_dp_app as r_make_dp_app
from repro.launch import procrun as r_procrun
from repro_torch.checkpoint import chunkservice
from repro_torch.checkpoint.chunkservice import (CHUNK_PROTOCOL_VERSION,
                                                 ChunkServer)
from repro_torch.checkpoint.chunkstore import content_digest
from repro_torch.core import MPIJob
from repro_torch.core import trace
from repro_torch.core.ckpt_protocol import (checkpoint_valid, load_manifest,
                                            load_rank_image)
from repro_torch.core.coordinator import Membership, StaleGenerationError
from repro_torch.distributed.faults import (DriverEvent, DriverEventKind,
                                            DriverEventPayload,
                                            FaultTolerantDriver, RankKilled)
from repro_torch.distributed.proxy_grad import make_dp_app
from repro_torch.launch import procrun

N = 3
STEPS = 6
VICTIM = 1
KILL_STEP = STEPS - 1


def _params_equal(a, b):
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def _masked(events):
    """Event strings with their seconds masked (wall_s=, pause_s=, ...)."""
    return [re.sub(r"\d+\.\d+", "#", str(e)) for e in events]


def _run(job, steps, timeout=60):
    try:
        return job.run(steps, timeout=timeout)
    finally:
        job.stop()


def _reference_restart(ckpt, step_fn, init_fn, steps, dead=(), world=None,
                       transport="shm"):
    """The reference's thread-world restart of `ckpt` (written by the
    port), reshaped past `dead` to `world` under a bumped membership."""
    old = load_manifest(ckpt)["n_ranks"]
    kw = {}
    if dead or world is not None:
        ms = RMembership(old)
        ms.bump(dead=list(dead), world_size=world)
        kw = dict(world_size=world, dead_ranks=list(dead), membership=ms)
    with exact_transports():
        job = RJob.restart(ckpt, step_fn, init_fn, transport=transport,
                           coord_timeout=30.0, **kw)
    return _run(job, steps)


def _acc_app(n_elems: int = 64, algo: str = "ring"):
    """Deterministic accumulator (tests/test_midstep_recovery.py): each
    step allreduces a per-(seed, step) random array; the seed is state."""
    def init(mpi):
        return {"seed": mpi.rank, "acc": np.zeros(n_elems), "steps_run": 0}

    def step(mpi, st, k):
        rng = np.random.default_rng(1000 * k + st["seed"])
        x = rng.standard_normal(n_elems)
        tot = mpi.Allreduce(x, op="sum", algo=algo)
        return {"seed": st["seed"], "acc": st["acc"] + tot,
                "steps_run": st["steps_run"] + 1}
    return init, step


@pytest.fixture(scope="module")
def control():
    """The reference's unfaulted N-rank run of the accumulator."""
    init, step = _acc_app()
    with exact_transports():
        job = RJob(N, step, init, transport="shm")
    return _run(job, STEPS)


# --------------------------------------------------------------- e2e driver

def _kill_driver(cls, job_cls, tmp_path, n0, target, t1):
    init_fn, step_fn = (make_dp_app if cls is FaultTolerantDriver
                        else r_make_dp_app)()
    victim = n0 - 1

    def killing_step(mpi, st, k):
        if mpi.generation == 0 and k == 8 and mpi.rank == victim:
            raise RankKilled(f"rank {victim} killed at step {k}")
        return step_fn(mpi, st, k)

    return cls(
        job_factory=lambda ws, ms: job_cls(
            ws or n0, killing_step, init_fn, transport=t1,
            heartbeat_timeout=2.0, membership=ms, coord_timeout=30.0),
        restart_factory=lambda d, tr, ws, dead, ms: job_cls.restart(
            d, killing_step, init_fn, transport=tr, world_size=ws,
            dead_ranks=dead, membership=ms, heartbeat_timeout=2.0,
            coord_timeout=30.0),
        ckpt_root=tmp_path, ckpt_every=5, world_size_after_failure=target)


@pytest.mark.parametrize("n0,target,t1,t2", [
    (4, None, "shm", "tcp"),      # shrink: kill 1 of 4, restart at 3
    (2, 4, "tcp", "inproc"),      # grow: kill 1 of 2, restart at 4
])
def test_kill_rank_reshape_resume(tmp_path, n0, target, t1, t2):
    steps = 14
    victim = n0 - 1
    driver = _kill_driver(FaultTolerantDriver, MPIJob, tmp_path / "port",
                          n0, target, t1)
    out = driver.run(steps, transport_after_failure=t2, timeout=60)

    new_world = target if target else n0 - 1
    assert len(out) == new_world
    for r in range(1, new_world):
        assert _params_equal(out[0]["params"], out[r]["params"])
    assert any(e.startswith(f"dead:[{victim}]") for e in driver.events)
    assert any(e.startswith("restart:") and f"world={new_world}" in e
               and "gen=1" in e for e in driver.events)
    assert driver.events[-1] == "done"
    assert driver.membership.generation == 1
    assert driver.membership.world_size == new_world
    with pytest.raises(StaleGenerationError):
        driver.membership.check(0)
    man = load_manifest(tmp_path / "port" / "at_00000010")
    assert man["n_ranks"] == new_world and man["generation"] == 1
    elastic = man["meta"]["elastic"]
    assert (elastic["old_world"], elastic["new_world"]) == (n0, new_world)
    assert elastic["dead_ranks"] == [victim]
    assert elastic["rank_map"][str(victim)] is None
    assert (elastic["from_transport"], elastic["to_transport"]) == (t1, t2)

    # the reference's driver on the same run: the same event strings
    with exact_transports():
        r_driver = _kill_driver(RDriver, RJob, tmp_path / "ref", n0, target,
                                t1)
        r_out = r_driver.run(steps, transport_after_failure=t2, timeout=60)
    assert _masked(driver.events) == _masked(r_driver.events)
    # ... and the reference's restart of the port's checkpoint, bit for bit
    init_fn, step_fn = r_make_dp_app()
    ref = _reference_restart(tmp_path / "port" / "at_00000005", step_fn,
                             init_fn, steps, dead=[victim], world=new_world)
    for a, b, c in zip(out, ref, r_out):
        assert _params_equal(a["params"], b["params"])
        assert _params_equal(a["params"], c["params"])
        assert a["loss"] == b["loss"] == c["loss"]


def _outage_driver(cls, job_cls, tmp_path):
    init_fn, step_fn = (make_dp_app if cls is FaultTolerantDriver
                        else r_make_dp_app)()

    def killing_step(mpi, st, k):
        if mpi.generation == 0 and k == 6:
            raise RankKilled(f"rank {mpi.rank} killed at step {k}")
        return step_fn(mpi, st, k)

    return cls(
        job_factory=lambda ws, ms: job_cls(ws or 2, killing_step, init_fn,
                                           transport="shm", membership=ms,
                                           heartbeat_timeout=2.0,
                                           coord_timeout=30.0),
        restart_factory=lambda d, tr, ws, dead, ms: job_cls.restart(
            d, killing_step, init_fn, transport=tr, world_size=ws,
            dead_ranks=dead, membership=ms, heartbeat_timeout=2.0,
            coord_timeout=30.0),
        ckpt_root=tmp_path, ckpt_every=4)


def test_total_outage_restarts_full_world(tmp_path):
    """Every rank dying at once is an incarnation failure, not a shrink:
    the generation bumps, the world keeps its size, every image restores;
    the final params equal the reference driver's."""
    steps, n = 12, 2
    driver = _outage_driver(FaultTolerantDriver, MPIJob, tmp_path / "port")
    out = driver.run(steps, transport_after_failure="shm", timeout=60)
    assert len(out) == n
    assert driver.membership.world_size == n
    assert driver.membership.generation >= 1
    assert any(e.startswith("restart:") and f"world={n}" in e
               for e in driver.events)
    assert driver.events[-1] == "done"
    with exact_transports():
        r_driver = _outage_driver(RDriver, RJob, tmp_path / "ref")
        r_out = r_driver.run(steps, transport_after_failure="shm",
                             timeout=60)
    for a, b in zip(out, r_out):
        assert _params_equal(a["params"], b["params"])


def test_straggler_excluded_at_checkpoint_boundary(tmp_path):
    """A rank flagged slow for straggler_windows consecutive polls is
    excluded at the next checkpoint boundary: an immediate checkpoint, a
    bump, and a restart WITHOUT it from that boundary."""
    steps, n, victim = 30, 3, 2

    def init_fn(mpi):
        return {"params": {"w": np.zeros(2, np.float64)}}

    def lagging_step(mpi, st, k):
        time.sleep(0.08 if (mpi.generation == 0 and mpi.rank == victim)
                   else 0.001)
        st = dict(st, params={"w": st["params"]["w"] + 1.0})
        if k % 10 == 9:
            st["sum"] = mpi.Allreduce(np.ones(2, np.float64), "sum")
        return st

    driver = FaultTolerantDriver(
        job_factory=lambda ws, ms: MPIJob(ws or n, lagging_step, init_fn,
                                          transport="shm", membership=ms,
                                          heartbeat_timeout=5.0,
                                          coord_timeout=30.0),
        restart_factory=lambda d, tr, ws, dead, ms: MPIJob.restart(
            d, lagging_step, init_fn, transport=tr, world_size=ws,
            dead_ranks=dead, membership=ms, heartbeat_timeout=5.0,
            coord_timeout=30.0),
        ckpt_root=tmp_path, ckpt_every=100, straggler_windows=3)
    out = driver.run(steps, transport_after_failure="shm", timeout=90)

    assert len(out) == n - 1
    for r in range(n - 1):
        assert np.array_equal(out[r]["params"]["w"],
                              np.full(2, float(steps)))
        assert np.array_equal(out[r]["sum"], np.full(2, float(n - 1)))
    assert any(e.startswith(f"straggler:[{victim}]") for e in driver.events)
    assert any(e.startswith("ckpt:strag_g0000") for e in driver.events)
    assert any(e.startswith("restart:strag_g0000")
               and f"world={n - 1}" in e for e in driver.events)
    assert driver.events[-1] == "done"
    assert driver.membership.generation == 1
    assert driver.membership.world_size == n - 1
    strag_ck = next(d for d in tmp_path.iterdir()
                    if d.name.startswith("strag_g0000"))
    man = load_manifest(strag_ck)
    assert man["n_ranks"] == n and man["generation"] == 0


def test_fault_tolerant_driver_recovers(tmp_path):
    """The legacy factories: crash after the periodic checkpoint, restart
    from it on a DIFFERENT transport, finish equal to the reference's
    uninterrupted run."""
    n, steps = 3, 16
    init_fn, step_fn = make_dp_app()
    r_init, r_step = r_make_dp_app()
    with exact_transports():
        ref = _run(RJob(n, r_step, r_init, transport="shm"), steps)
    attempts = {"n": 0}

    def crashing_step(mpi, st, k):
        if attempts["n"] == 0 and k == 9:
            attempts["n"] += 1
            raise RuntimeError("injected node failure")
        return step_fn(mpi, st, k)

    driver = FaultTolerantDriver(
        job_factory=lambda: MPIJob(n, crashing_step, init_fn,
                                   transport="shm"),
        restart_factory=lambda d, tr: MPIJob.restart(d, crashing_step,
                                                     init_fn, transport=tr),
        ckpt_root=tmp_path / "fts", ckpt_every=5)
    out = driver.run(steps, transport_after_failure="tcp", timeout=120)
    assert any(e.startswith("failure") for e in driver.events)
    assert any(e.startswith("restart") for e in driver.events)
    for r in range(n):
        assert _params_equal(out[r]["params"], ref[r]["params"])


# ------------------------------------------------- cross-substrate parity

def test_fsm_traces_identical_across_substrates(tmp_path):
    """One rank loop, one FSM trace: the port's thread and process worlds
    and the reference's thread world trace the same lifecycle."""
    init, step = _acc_app()
    traces = {}
    for name, cls, tr in (("port-shm", MPIJob, "shm"),
                          ("port-proc", MPIJob, "proc"),
                          ("ref-shm", RJob, "shm")):
        with exact_transports():
            job = cls(N, step, init, transport=tr)
        job.checkpoint_at(4, tmp_path / name)
        out = _run(job, STEPS, timeout=90)
        assert all(out[r]["steps_run"] == STEPS for r in range(N))
        traces[name] = [job.fsm_trace(r) for r in range(N)]
    expected = ([("init",)]
                + [("step", k) for k in range(4)]
                + [("ckpt", 4), ("resume", 4)]
                + [("step", k) for k in range(4, STEPS)]
                + [("finish", STEPS)])
    for r in range(N):
        assert (traces["port-shm"][r] == traces["port-proc"][r]
                == traces["ref-shm"][r] == expected), r


# ------------------------------------------- survive the step (recovery)

def _arm_kill(where, boom):
    init, step = _acc_app()

    def killer_step(mpi, st, k):
        if mpi.rank == VICTIM and k == KILL_STEP and mpi.generation == 0:
            def hook(phase, hop):
                if (phase, hop) == where:
                    boom()
            mpi._hop_hook = hook
        return step(mpi, st, k)
    return init, killer_step


def test_proc_sigkill_inside_allreduce_survives(tmp_path, control):
    """Process world: a REAL SIGKILL mid-ring.  The endpoint records the
    death, the driver finishes the step over the surviving processes from
    the ledger, and the incarnation runs on: no bump, no restart, the
    survivors bit-equal to the reference's unfaulted run."""
    def boom():
        os.kill(os.getpid(), signal.SIGKILL)
    init, step = _arm_kill(("rs", 1), boom)
    driver = FaultTolerantDriver(
        job_factory=lambda: MPIJob(N, step, init, transport="proc",
                                   heartbeat_timeout=5.0),
        restart_factory=lambda d, tr: MPIJob.restart(d, step, init,
                                                     transport=tr),
        ckpt_root=tmp_path / "ck", ckpt_every=100)
    out = driver.run(STEPS, transport_after_failure="proc", timeout=90)
    assert _masked(driver.events) == [
        "start:fresh", f"recover:[{VICTIM}]:wall_s=#:completed=1:rerun=0",
        "done"]
    assert driver.membership.generation == 0
    rep = driver.recoveries[0]
    assert rep["dead"] == [VICTIM] and rep["rerun_ops"] == 0
    assert rep["completed_ops"] == 1
    for r in range(N):
        if r != VICTIM:
            assert out[r]["steps_run"] == STEPS
            assert np.array_equal(out[r]["acc"], control[r]["acc"]), r


def _boundary_driver(cls, job_cls, tmp_path):
    init, step = _acc_app()
    fired = {}

    def killer_step(mpi, st, k):
        if not fired and mpi.rank == VICTIM and k == KILL_STEP:
            fired["y"] = True
            raise RankKilled("boundary death")
        return step(mpi, st, k)

    ms = (Membership if job_cls is MPIJob else RMembership)(N)
    return cls(
        job_factory=lambda ws, m: job_cls(ws or N, killer_step, init,
                                          transport="shm", membership=m),
        restart_factory=lambda d, tr, ws, dead, m: job_cls.restart(
            d, killer_step, init, transport=tr, world_size=ws,
            dead_ranks=dead, membership=m),
        ckpt_root=tmp_path, ckpt_every=3, membership=ms)


def test_step_boundary_death_falls_back_to_restart(tmp_path):
    """A death between collectives leaves nothing in the ledger: recovery
    is ineligible (ledger-miss) and the driver takes the bump -> abort ->
    reshaped-restart ladder, with the reference driver's events."""
    driver = _boundary_driver(FaultTolerantDriver, MPIJob, tmp_path / "p")
    out = driver.run(STEPS, transport_after_failure="shm", timeout=60)
    assert any(e.startswith(f"fallback:[{VICTIM}]") and "ledger-miss" in e
               for e in driver.events), driver.events
    assert any(e.startswith(f"dead:[{VICTIM}]") for e in driver.events)
    assert any(e.startswith("restart:at_00000003") for e in driver.events)
    assert driver.membership.generation == 1
    assert driver.events[-1] == "done"
    assert len(out) == N - 1
    assert all(o["steps_run"] == STEPS for o in out)
    with exact_transports():
        r_driver = _boundary_driver(RDriver, RJob, tmp_path / "r")
        r_out = r_driver.run(STEPS, transport_after_failure="shm",
                             timeout=60)
    assert _masked(driver.events) == _masked(r_driver.events)
    for a, b in zip(out, r_out):
        assert np.array_equal(a["acc"], b["acc"])


def test_post_recovery_checkpoint_is_sparse_and_restartable(tmp_path):
    """After a recovery the world is sparse; a later checkpoint commits on
    the live count, records the hole, and restarts compacted over it —
    in the port and in the reference — equal to the recovered world's
    own finish."""
    steps, kill_at, ckpt_at = 10, 3, 6

    def boom():
        raise RankKilled("injected mid-ring")
    init, base = _acc_app()

    def killer_step(mpi, st, k):
        if mpi.rank == VICTIM and k == kill_at and mpi.generation == 0:
            def hook(phase, hop):
                if (phase, hop) == ("rs", 1):
                    boom()
            mpi._hop_hook = hook
        return base(mpi, st, k)

    driver = FaultTolerantDriver(
        job_factory=lambda: MPIJob(N, killer_step, init, transport="shm",
                                   heartbeat_timeout=5.0),
        restart_factory=lambda d, tr: MPIJob.restart(
            d, killer_step, init, transport=tr),
        ckpt_root=tmp_path, ckpt_every=ckpt_at)
    out = driver.run(steps, transport_after_failure="shm", timeout=60)
    assert any(e.startswith("recover:") for e in driver.events)
    assert not any(e.startswith("restart:") for e in driver.events)

    ck = tmp_path / f"at_{ckpt_at:08d}"
    assert checkpoint_valid(ck, deep=True)
    man = load_manifest(ck)
    assert man["n_ranks"] == N - 1
    assert man["meta"]["world_size"] == N
    assert man["meta"]["recovered_dead_ranks"] == [VICTIM]
    survivors = [r for r in range(N) if r != VICTIM]
    job2 = MPIJob.restart(ck, base, init, transport="shm")
    assert job2.n == N - 1
    with exact_transports():
        job3 = RJob.restart(ck, base, init, transport="shm")
    for again in (_run(job2, steps), _run(job3, steps)):
        for new_r, old_r in enumerate(survivors):
            assert again[new_r]["steps_run"] == steps
            assert np.array_equal(again[new_r]["acc"], out[old_r]["acc"])


def test_driver_auto_migrates_confirmed_straggler(tmp_path):
    """Opt-in migrate_windows: a rank flagged slow for K consecutive polls
    is LIVE-MIGRATED instead of excluded: the full world finishes, no
    generation bump, every step once."""
    init, base = _acc_app(n_elems=8, algo="tree")

    def slow_step(mpi, st, k):
        time.sleep(0.05 if mpi.rank == VICTIM else 0.002)
        return base(mpi, st, k)

    steps = 40
    driver = FaultTolerantDriver(
        job_factory=lambda: MPIJob(N, slow_step, init, transport="shm",
                                   heartbeat_timeout=5.0),
        restart_factory=lambda d, tr: MPIJob.restart(
            d, slow_step, init, transport=tr),
        ckpt_root=tmp_path, ckpt_every=100,
        migrate_windows=2, monitor_poll_s=0.05)
    out = driver.run(steps, transport_after_failure="shm", timeout=90)
    assert [e for e in driver.events
            if e.startswith(f"migrate:[{VICTIM}]")], driver.events
    assert not any(e.startswith(("restart:", "dead:", "straggler:",
                                 "migrate-failed:"))
                   for e in driver.events), driver.events
    assert driver.events[-1] == "done"
    assert driver.membership.generation == 0
    assert len(out) == N
    assert all(out[r]["steps_run"] == steps for r in range(N))


# ------------------------------------------------- driver event vocabulary

def test_driver_event_vocabulary_pinned():
    assert {k.value for k in DriverEventKind} == {
        "start", "restart", "dead", "straggler", "recover", "fallback",
        "migrate", "migrate-failed", "ckpt", "wait", "done", "failure"}
    assert [k.value for k in DriverEventKind] == [
        k.value for k in r_faults.DriverEventKind]
    assert [k.name for k in DriverEventKind] == [
        k.name for k in r_faults.DriverEventKind]


def test_driver_event_is_its_legacy_string():
    ev = DriverEvent(DriverEventKind.DEAD, "dead:[1]:gen=2",
                     ranks=(1,), generation=2)
    assert isinstance(ev, str)
    assert ev == "dead:[1]:gen=2" and ev.startswith("dead:")
    assert str(ev) == "dead:[1]:gen=2"
    assert json.loads(json.dumps([ev])) == ["dead:[1]:gen=2"]
    assert ev.kind is DriverEventKind.DEAD
    assert ev.payload == DriverEventPayload(
        kind=DriverEventKind.DEAD, ranks=(1,), generation=2, detail={})
    assert DriverEvent("straggler", "straggler:[2]:gen=1").kind \
        is DriverEventKind.STRAGGLER
    r_ev = r_faults.DriverEvent("dead", "dead:[1]:gen=2", ranks=(1,),
                                generation=2)
    assert ev == r_ev and ev.payload.ranks == r_ev.payload.ranks


def test_driver_emits_typed_events(tmp_path):
    init, step = _acc_app(n_elems=32)
    driver = FaultTolerantDriver(
        job_factory=lambda: MPIJob(2, step, init, transport="shm"),
        restart_factory=lambda d, tr: MPIJob.restart(
            d, step, init, transport=tr),
        ckpt_root=tmp_path, ckpt_every=100)
    driver.run(3, timeout=60)
    assert driver.events == ["start:fresh", "done"]
    assert all(isinstance(e, DriverEvent) for e in driver.events)
    assert [e.kind for e in driver.events] == [DriverEventKind.START,
                                               DriverEventKind.DONE]


@pytest.fixture
def tracing():
    prev = trace.ENABLED
    trace.set_enabled(True)
    yield
    trace.set_enabled(prev)


def test_proc_sigkill_merged_timeline_is_causally_ordered(tmp_path,
                                                          monkeypatch,
                                                          tracing):
    """Process world, remote chunk store, REAL SIGKILL mid-allreduce: the
    flight recorders of the driver and the surviving rank processes merge
    into one timeline in causal order — rank images parented across the
    socket under the coordinator's round, chunk uploads under the image
    save, the kill, then the recovery phases under its epoch."""
    tdir = tmp_path / "traces"
    monkeypatch.setenv("REPRO_TRACE_DIR", str(tdir))
    trace.clear()
    init, base = _acc_app(n_elems=32)

    def step(mpi, st, k):
        if mpi.rank == VICTIM and k == KILL_STEP and mpi.generation == 0:
            def hook(phase, hop):
                if (phase, hop) == ("rs", 1):
                    os.kill(os.getpid(), signal.SIGKILL)
            mpi._hop_hook = hook
        return base(mpi, st, k)

    srv = ChunkServer(tmp_path / "chunk_srv").start()
    try:
        spec = srv.spec_for("obs")
        driver = FaultTolerantDriver(
            job_factory=lambda: MPIJob(N, step, init, transport="proc",
                                       heartbeat_timeout=5.0,
                                       ckpt_store=spec),
            restart_factory=lambda d, tr: MPIJob.restart(
                d, step, init, transport=tr, ckpt_store=spec),
            ckpt_root=tmp_path / "ck", ckpt_every=3)
        out = driver.run(STEPS, transport_after_failure="proc", timeout=90)
    finally:
        srv.stop()
    assert driver.events[-1] == "done"
    assert any(e.kind is DriverEventKind.RECOVER for e in driver.events)
    survivors = [r for r in range(N) if r != VICTIM]
    assert all(out[r]["steps_run"] == STEPS for r in survivors)

    dumps = sorted(p.name for p in tdir.glob("trace-*.jsonl"))
    assert any("driver" in d for d in dumps), dumps
    assert sum("rank" in d for d in dumps) >= len(survivors), dumps
    evs = trace.merge_dir(tdir)["traceEvents"]
    spans = [e for e in evs if e["ph"] == "X"]
    instants = [e for e in evs if e["ph"] == "i"]

    def named(pool, name):
        return [e for e in pool if e["name"] == name]

    died = named(instants, "fault.rank_died")
    assert died
    kill_ts = died[0]["ts"]
    epochs = named(spans, "recover.epoch")
    assert len(epochs) == 1
    epoch_id = epochs[0]["args"]["span_id"]
    phase_ts = []
    for ph in ("collect", "quiesce", "patch", "resume"):
        got = named(spans, f"recover.{ph}")
        assert got, f"recover.{ph} missing"
        assert got[0]["args"]["parent_id"] == epoch_id, ph
        phase_ts.append(got[0]["ts"])
    assert kill_ts <= phase_ts[0] and phase_ts == sorted(phase_ts)
    assert epochs[0]["args"].get("outcome") == "ok"
    round_ids = {e["args"]["span_id"]: e["pid"]
                 for e in named(spans, "coord.ckpt_round")}
    assert round_ids
    assert [e for e in named(spans, "rank.ckpt")
            if e["args"].get("parent_id") in round_ids
            and e["pid"] != round_ids[e["args"]["parent_id"]]], \
        "no rank.ckpt parented across the process boundary"
    save_ids = {e["args"]["span_id"]
                for e in named(spans, "rank.save_image")}
    assert any(e["args"].get("parent_id") in save_ids
               for e in named(spans, "chunk.rpc"))
    assert named(spans, "chunkserver.req")
    finishes = named(instants, "rank.finish")
    assert len(finishes) >= len(survivors)
    assert all(e["ts"] >= phase_ts[-1] for e in finishes)
    assert any(e["ph"] == "s" for e in evs)
    assert any(e["ph"] == "f" for e in evs)


# ------------------------------------- SIGKILL mid-upload (process world)

def test_proc_rank_sigkill_mid_chunk_upload_leaves_no_partial(tmp_path,
                                                              monkeypatch):
    """A rank process SIGKILLed halfway through a chunk PUT frame: the torn
    frame never becomes a chunk, the previous checkpoint survives, and the
    driver recovers reshaped through the same service; the reference
    resumes that previous checkpoint alike."""
    n, steps, ns = 3, 14, "kill"
    server = ChunkServer(tmp_path / "server").start()
    try:
        spec = server.spec_for(ns, cache=tmp_path / "cache")
        init_fn, dp_step = make_dp_app()
        latch = tmp_path / "boom.latch"
        orig_put = chunkservice.RemoteChunkStore.put

        def torn_put(self, name, blob, raw_bytes=0):
            if os.environ.get("REPRO_TEST_TORN") and not latch.exists():
                latch.touch()
                payload = pickle.dumps(
                    (CHUNK_PROTOCOL_VERSION, self.namespace,
                     [("put", (name, bytes(blob), raw_bytes))]),
                    protocol=pickle.HIGHEST_PROTOCOL)
                s = self._conn()
                s.sendall(struct.pack("!q", len(payload))
                          + payload[:len(payload) // 2])
                os.kill(os.getpid(), signal.SIGKILL)
            return orig_put(self, name, blob, raw_bytes)

        monkeypatch.setattr(chunkservice.RemoteChunkStore, "put", torn_put)
        seed = MPIJob(n, dp_step, init_fn, transport="proc",
                      ckpt_store=spec)
        seed.checkpoint_at(4, tmp_path / "at_00000004", resume=False)
        _run(seed, steps)
        assert checkpoint_valid(tmp_path / "at_00000004", deep=True)

        monkeypatch.setenv("REPRO_TEST_TORN", "1")
        driver = FaultTolerantDriver(
            job_factory=lambda ws, ms: MPIJob(
                ws or n, dp_step, init_fn, transport="proc",
                ckpt_store=spec, heartbeat_timeout=5.0, membership=ms,
                coord_timeout=30.0),
            restart_factory=lambda d, tr, ws, dead, ms: MPIJob.restart(
                d, dp_step, init_fn, transport="proc", world_size=ws,
                dead_ranks=dead, membership=ms, ckpt_store=spec,
                heartbeat_timeout=5.0, coord_timeout=30.0),
            ckpt_root=tmp_path, ckpt_every=4)
        out = driver.run(steps, transport_after_failure="proc", timeout=90)
        monkeypatch.delenv("REPRO_TEST_TORN")

        assert latch.exists(), "the torn upload must have happened"
        assert len(out) == n - 1
        dead = next(e for e in driver.events if e.startswith("dead:"))
        assert driver.events[-1] == "done"
        assert checkpoint_valid(tmp_path / "at_00000004", deep=True)
        backing = server.backing(ns)
        names = backing.list_chunks()
        assert names, "the service must have received real chunks"
        for name in names:
            assert content_digest(backing.get(name)) == name.split(".")[0]
        assert not any(".tmp" in p.name for p in backing.root.iterdir())
        man8 = load_manifest(tmp_path / "at_00000008")
        assert man8["n_ranks"] == n - 1 and man8["generation"] == 1
        # the reference resumes the checkpoint the driver restarted from
        restart = next(e for e in driver.events if e.startswith("restart:"))
        gone = [int(r) for r in re.findall(r"\d+", dead.split(":")[1])]
        r_init, r_step = r_make_dp_app()
        ref = _reference_restart(tmp_path / restart.split(":")[1], r_step,
                                 r_init, steps, dead=gone, world=n - 1)
        for a, b in zip(out, ref):
            assert _params_equal(a["params"], b["params"])
    finally:
        server.stop()


# ----------------------------------------------------------- the procrun CLI

@pytest.mark.parametrize("kill", [False, True])
def test_procrun_done_line_equals_the_references(tmp_path, capsys, kill):
    """``repro_torch.launch.procrun`` and ``repro.launch.procrun`` with the
    same flags print the same ``done:`` line (world, generation, loss) and
    the same events; with a kill the world shrinks to 3 in generation 1."""
    args = ["--ranks", "4", "--steps", "12"]
    if kill:
        args += ["--kill-rank", "2", "--kill-step", "8"]
    lines = {}
    for name, mod in (("port", procrun), ("ref", r_procrun)):
        assert mod.main(args + ["--ckpt-root", str(tmp_path / name)]) == 0
        out = capsys.readouterr().out
        lines[name] = [re.sub(r" ckpts=\S+", "", ln) for ln in
                       out.splitlines() if ln.startswith("[procrun]")
                       and "SIGKILLing" not in ln]
    assert lines["port"] == lines["ref"]
    done = next(ln for ln in lines["port"] if "done:" in ln)
    world, gen = re.search(r"world=(\d+) generation=(\d+)", done).groups()
    assert (int(world), int(gen)) == ((3, 1) if kill else (4, 0))
    assert lines["port"][-1] == "[procrun]   done"
    assert any("dead:[2]" in ln for ln in lines["port"]) == kill
