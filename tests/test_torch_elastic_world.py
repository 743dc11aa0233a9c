"""Elastic reshapes of the rank world on the port, held against the
reference package (DESIGN.md §8).

Twins of tests/test_live_migrate.py's atomic-reshape cases (both layers
under one membership bump, the tensor layer through the port's
CheckpointManager on a CPU mesh; the world layer only) and of
tests/test_elastic_restart.py's reshapes (the 4 -> 3 shrink bit-identical
to the survivor images, with ``restore_info``'s rank map and generation;
the 2 -> 4 grow cloning survivors; the membership generation rules;
stale-generation rejection everywhere; the heartbeat monitor).  Then rank
worlds crossing between the packages: one checkpointed by the reference
reshaped by the port's ``atomic_reshape``, one checkpointed by the port
restarted by the reference's ``MPIJob.restart``, each resuming bit for bit
like the other package's own restart."""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import MPIJob as RJob
from repro.core.coordinator import Membership as RMembership
from repro.distributed.faults import HeartbeatMonitor as RHeartbeat
from repro.distributed.proxy_grad import make_dp_app as r_make_dp_app
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import MPIJob
from repro_torch.core.ckpt_protocol import load_rank_image
from repro_torch.core.coordinator import (Coordinator, Membership,
                                          StaleGenerationError)
from repro_torch.distributed.elastic import atomic_reshape
from repro_torch.distributed.faults import HeartbeatMonitor
from repro_torch.distributed.proxy_grad import make_dp_app
from repro_torch.distributed.sharding import DEFAULT_RULES
from repro_torch.launch import mesh as tmesh

N = 2
STEPS = 30


def init_fn(mpi):
    r = mpi.rank
    return {"acc": np.zeros(32, dtype=np.float64),
            "hot": np.full(256, float(r), dtype=np.float64)}


def step_fn(mpi, state, step):
    total = mpi.Allreduce(state["acc"][:4] + step)
    state = dict(state)
    state["acc"] = state["acc"].copy()
    state["acc"][:4] += total
    state["hot"] = state["hot"] + 0.5
    return state


def _run(job, n_steps):
    try:
        return job.run(n_steps, timeout=120.0)
    finally:
        job.stop()


def _params_equal(a, b):
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def _image_params(ckpt_dir, rank):
    return load_rank_image(ckpt_dir, rank).state_obj()["params"]


# -------------------------------------------------- atomic reshape (§8/§13)

def test_atomic_reshape_single_bump_both_layers(tmp_path):
    """One atomic_reshape = ONE generation bump shared by the mesh manager
    and the reshaped rank world: their epochs cannot diverge."""
    ck = tmp_path / "ck"
    membership = Membership(N)
    job = MPIJob(N, step_fn, init_fn, transport="shm", membership=membership)
    job.checkpoint_at(10, ck, resume=True)
    _run(job, STEPS)
    assert membership.generation == 0

    mgr = CheckpointManager(tmp_path / "mesh", generation=0)
    mgr.save(7, {"w": torch.arange(8.0)})
    mgr.wait()
    mesh = tmesh.make_mesh((1,), ("data",), device="cpu")
    rep = atomic_reshape(membership, dead=(1,), mgr=mgr, template={"w": 0},
                         mesh=mesh, rules=DEFAULT_RULES, ckpt_dir=ck,
                         step_fn=step_fn, init_fn=init_fn, transport="tcp")
    # exactly one bump, visible identically from every layer
    assert rep.generation == 1 == membership.generation
    assert rep.layers == ("mesh", "world")
    assert mgr.generation == 1 and rep.job.coord.generation == 1
    assert rep.job.n == rep.world_size == 1 and rep.dead_ranks == (1,)
    assert torch.equal(rep.state["w"].to_local(), torch.arange(8.0))
    assert rep.job.restore_info["to_transport"] == "tcp"
    out = _run(rep.job, STEPS)
    assert out[0]["acc"].shape == (32,)
    # the next rank checkpoint and the next tensor checkpoint both record it
    mgr.save(8, {"w": torch.arange(8.0)})
    mgr.wait()
    assert mgr.restore({"w": 0}, device="cpu")[1]["generation"] == 1


def test_atomic_reshape_world_only(tmp_path):
    ck = tmp_path / "ck"
    membership = Membership(N)
    job = MPIJob(N, step_fn, init_fn, transport="shm", membership=membership)
    job.checkpoint_at(10, ck, resume=False)
    _run(job, STEPS)
    rep = atomic_reshape(membership, dead=(), world_size=N, ckpt_dir=ck,
                         step_fn=step_fn, init_fn=init_fn,
                         transport="inproc")
    assert rep.generation == 1 and rep.layers == ("world",)
    assert rep.state is None and rep.meta is None
    out = _run(rep.job, STEPS)
    control = _run(RJob(N, step_fn, init_fn, transport="shm"), STEPS)
    for r in range(N):
        for k in control[r]:
            assert np.array_equal(out[r][k], control[r][k])


@pytest.mark.parametrize("transport", ["proc", "shmring"])
def test_atomic_reshape_into_the_process_world(tmp_path, transport):
    """The rank world reshaped into forked rank processes: rank 1 dead,
    the world grown back to N from the survivor's image under one bump,
    run to the end; equal to the reference's thread-world restart of the
    same checkpoint under the same reshape."""
    ck = tmp_path / "ck"
    membership = Membership(N)
    job = MPIJob(N, step_fn, init_fn, transport="shm", membership=membership)
    job.checkpoint_at(10, ck, resume=False)
    _run(job, STEPS)
    rep = atomic_reshape(membership, dead=(1,), world_size=N, ckpt_dir=ck,
                         step_fn=step_fn, init_fn=init_fn,
                         transport=transport)
    assert rep.generation == 1 and rep.layers == ("world",)
    assert rep.job.coord.generation == 1 and rep.job._proc is not None
    assert rep.job.restore_info["rank_map"] == {"0": 0, "1": None}
    out = _run(rep.job, STEPS)
    assert set(rep.job._proc.exit_codes.values()) == {0}
    ms = RMembership(N)
    ms.bump(dead=[1], world_size=N)
    want = _run(RJob.restart(ck, step_fn, init_fn, transport="shm",
                             world_size=N, dead_ranks=[1], membership=ms),
                STEPS)
    for r in range(N):
        for k in want[r]:
            assert np.array_equal(out[r][k], want[r][k]), (r, k)


# ----------------------------------------------------- bit-identical resume

def test_elastic_restart_bit_identical_states(tmp_path):
    """restart(dead_ranks=[2]) of a 4-rank world restores EXACTLY the app
    state of the surviving images, compacted over the hole."""
    init, step = make_dp_app()
    job = MPIJob(4, step, init, transport="shm")
    job.checkpoint_at(6, tmp_path / "ck", resume=False)
    _run(job, 10)

    ms = Membership(4)
    ms.bump(dead=[2])
    job2 = MPIJob.restart(tmp_path / "ck", step, init, transport="inproc",
                          dead_ranks=[2], membership=ms)
    assert job2.n == 3
    for new_rank, src in [(0, 0), (1, 1), (2, 3)]:
        assert _params_equal(job2.states[new_rank]["params"],
                             _image_params(tmp_path / "ck", src))
    info = job2.restore_info
    assert info["rank_map"] == {"0": 0, "1": 1, "2": None, "3": 2}
    assert info["generation"] == 1 and info["dead_ranks"] == [2]
    assert (info["from_transport"], info["to_transport"]) == ("shm",
                                                              "inproc")
    with pytest.raises(StaleGenerationError):
        job2.coord.report_counters(0, 5, 5, generation=0)
    assert job2.coord.stats["stale_rejected"] == 1
    out = _run(job2, 10)
    for r in range(1, 3):
        assert _params_equal(out[0]["params"], out[r]["params"])


def test_elastic_grow_clones_survivor_images(tmp_path):
    init, step = make_dp_app()
    job = MPIJob(2, step, init, transport="shm")
    job.checkpoint_at(5, tmp_path / "ck", resume=False)
    _run(job, 8)
    job2 = MPIJob.restart(tmp_path / "ck", step, init, transport="tcp",
                          world_size=4)
    assert job2.n == 4
    for r in range(4):
        assert _params_equal(job2.states[r]["params"],
                             _image_params(tmp_path / "ck", r % 2))
    assert job2.restore_info["sources"] == {"0": 0, "1": 1, "2": 0, "3": 1}
    out = _run(job2, 8)
    for r in range(1, 4):
        assert _params_equal(out[0]["params"], out[r]["params"])


# -------------------------------------------------- membership + coordinator

def test_membership_generation_rules_match_the_reference():
    """The same epochs through the port's Membership and the reference's:
    equal generations, world sizes, histories and refusals."""
    ours, theirs = Membership(4), RMembership(4)
    for dead, ws in (([1, 1, 3], None), ((), 5), ([0], None)):
        assert ours.bump(dead, world_size=ws) == \
            theirs.bump(dead, world_size=ws)
        assert ours.world_size == theirs.world_size
    assert ours.history == theirs.history == [
        (0, 4, ()), (1, 2, (1, 3)), (2, 5, ()), (3, 4, (0,))]
    ours.check(3)
    ours.check(None)
    for stale in (0, 1, 2, 4):
        with pytest.raises(StaleGenerationError):
            ours.check(stale)
    with pytest.raises(ValueError):
        Membership(1).bump(dead=[0])


def test_coordinator_rejects_stale_everywhere():
    ms = Membership(2)
    coord = Coordinator(2, membership=ms)
    coord.join(0, generation=0)
    ms.bump(dead=[1])
    for call in (lambda: coord.join(0, generation=0),
                 lambda: coord.report_counters(0, 1, 1, generation=0),
                 lambda: coord.propose_ckpt_step(0, 3, generation=0),
                 lambda: coord.ack_drained(0, generation=0),
                 lambda: coord.ack_snapshot(0, generation=0),
                 lambda: coord.barrier(0, generation=0)):
        with pytest.raises(StaleGenerationError):
            call()
    assert coord.stats["stale_rejected"] == 6


def test_coordinator_timeouts_configurable_and_reported():
    coord = Coordinator(2, timeout=0.05)
    with pytest.raises(TimeoutError) as ei:
        coord.wait_phase("snapshot")
    assert "0.05" in str(ei.value)
    with pytest.raises(TimeoutError) as ei:
        coord.barrier(0)                          # second rank never comes
    assert "0.05" in str(ei.value) and "1/2" in str(ei.value)
    with pytest.raises(TimeoutError) as ei:
        coord.wait_phase("snapshot", timeout=0.01)
    assert "0.01" in str(ei.value)


def test_heartbeat_monitor_monotonic_remove_reset():
    for hb in (HeartbeatMonitor(3, timeout_s=0.05),
               RHeartbeat(3, timeout_s=0.05)):
        hb.ping(0), hb.ping(1), hb.ping(2)
        assert hb.dead_ranks() == []
        time.sleep(0.08)
        assert hb.dead_ranks() == [0, 1, 2]
        hb.remove(2)                 # replaced rank: never reported again
        assert hb.dead_ranks() == [0, 1]
        hb.reset(0)                  # replacement joined under the same id
        assert hb.dead_ranks() == [1]


def test_a_dead_rank_stops_its_heartbeat(tmp_path):
    """A rank whose thread died stops pinging: within the timeout the
    job's monitor reports it and no other rank."""
    def step(mpi, st, k):
        if mpi.rank == 1 and k == 1:
            raise RuntimeError("rank 1 dies")
        time.sleep(0.01)
        return st

    job = MPIJob(3, step, lambda mpi: {}, transport="shm",
                 heartbeat_timeout=0.2)
    box = {}

    def runner():
        try:
            job.run(200, timeout=20)
        except RuntimeError as e:
            box["err"] = e

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    deadline = time.time() + 10
    while 1 not in job.heartbeat.dead_ranks() and time.time() < deadline:
        time.sleep(0.02)
    assert job.failed_ranks() == [1]
    assert 1 in job.heartbeat.dead_ranks()
    job.abort("rank 1 died")
    t.join(30)
    job.stop()
    assert "rank 1 failed" in str(box["err"])


# ---------------------------------------------------- across the packages

def test_reference_world_reshaped_by_the_port(tmp_path):
    """A 4-rank world checkpointed by the reference, shrunk to 3 by the
    port's atomic_reshape onto tcp, resumes bit for bit like the
    reference's own reshaped restart of the same checkpoint."""
    kw = dict(din=16, dh=32, dout=4, batch_per_rank=8, seed=1)
    r_init, r_step = r_make_dp_app(**kw)
    init, step = make_dp_app(**kw)
    job = RJob(4, r_step, r_init, transport="shm")
    job.checkpoint_at(4, tmp_path / "ck", resume=False)
    _run(job, 10)

    rep = atomic_reshape(Membership(4), dead=(1,), ckpt_dir=tmp_path / "ck",
                         step_fn=step, init_fn=init, transport="tcp")
    assert rep.layers == ("world",) and rep.job.n == 3
    for new_rank, src in [(0, 0), (1, 2), (2, 3)]:
        assert _params_equal(rep.job.states[new_rank]["params"],
                             _image_params(tmp_path / "ck", src))
    ours = _run(rep.job, 10)
    ms = RMembership(4)
    ms.bump(dead=[1])
    theirs = _run(RJob.restart(tmp_path / "ck", r_step, r_init,
                               transport="shm", dead_ranks=[1],
                               membership=ms), 10)
    for a, b in zip(ours, theirs):
        assert _params_equal(a["params"], b["params"])
        assert a["loss"] == b["loss"]


def test_port_world_restarted_by_the_reference(tmp_path):
    """A world checkpointed by the port, grown 2 -> 3 by the reference's
    MPIJob.restart onto inproc, resumes bit for bit like the port's own."""
    kw = dict(din=16, dh=32, dout=4, batch_per_rank=8, seed=2)
    r_init, r_step = r_make_dp_app(**kw)
    init, step = make_dp_app(**kw)
    job = MPIJob(2, step, init, transport="tcp")
    job.checkpoint_at(5, tmp_path / "ck", resume=False)
    _run(job, 9)
    theirs = _run(RJob.restart(tmp_path / "ck", r_step, r_init,
                               transport="inproc", world_size=3), 9)
    ours = _run(MPIJob.restart(tmp_path / "ck", step, init,
                               transport="shm", world_size=3), 9)
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert _params_equal(a["params"], b["params"])
        assert a["loss"] == b["loss"]
    assert all(_params_equal(ours[0]["params"], o["params"]) for o in ours)
