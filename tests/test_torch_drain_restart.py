"""The paper's checkpoint/restart claims on the port's runtime, and rank
checkpoints crossing between the packages.

Twins of tests/test_drain_restart.py on ``repro_torch.core`` (in-flight
drain, cache-first recv/probe after restart, admin replay, cross-transport
restart), each result held against the reference package's uninterrupted
run of the same program; then the paper's "checkpointed on one
implementation, restarted on another" applied to the framework: a rank
checkpoint with drained in-flight envelopes written by either package
restarts under the other, on another transport, bit for bit.  That works
because both packages write the reference's class names into their
pickles (``Envelope`` and ``RankImage``), byte for byte, and the port reads
them through one unpickler that maps those names to its own classes and
refuses any other ``repro.*`` name."""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import pytest

from repro.core import MPIJob as RJob
from repro.core import ckpt_protocol as rcp
from repro.core import messages as rmsg
from repro.core.drain import MessageCache as RCache
from repro.distributed.proxy_grad import make_dp_app as r_make_dp_app
from repro_torch.core import MPIJob
from repro_torch.core import ckpt_protocol as tcp
from repro_torch.core import messages as tmsg
from repro_torch.core.drain import MessageCache, remap_cache_snapshot
from repro_torch.distributed.proxy_grad import make_dp_app

ROOT = Path(__file__).resolve().parents[1]
JOBS = {"torch": MPIJob, "jax": RJob}


def pingpong_app():
    """Sends cross step boundaries: message sent in step k is received in
    step k+1 — guaranteed in flight when a checkpoint lands between them."""
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


def reference(n=3, steps=14):
    """The reference package's uninterrupted run."""
    init_fn, step_fn = pingpong_app()
    job = RJob(n, step_fn, init_fn, transport="shm")
    out = job.run(steps, timeout=60)
    job.stop()
    return out


def _equal_states(out, ref, keys=("acc", "sum")):
    for r in range(len(ref)):
        for k in keys:
            assert np.array_equal(out[r][k], ref[r][k]), (r, k)


# ------------------------------------------------ twins of the drain suite

@pytest.mark.parametrize("t1,t2", [("shm", "tcp"), ("tcp", "shm"),
                                   ("shm", "inproc"), ("inproc", "shm")])
def test_cross_transport_restart(tmp_path, t1, t2):
    n, steps = 3, 14
    ref = reference(n, steps)
    init_fn, step_fn = pingpong_app()
    job = MPIJob(n, step_fn, init_fn, transport=t1)
    job.checkpoint_at(7, tmp_path / "ck", resume=False)
    job.run(steps, timeout=60)
    job.stop()
    man = json.loads((tmp_path / "ck" / "MANIFEST.json").read_text())
    assert man["meta"]["transport"] == t1 and man["version"] == 3

    job2 = MPIJob.restart(tmp_path / "ck", step_fn, init_fn, transport=t2)
    out = job2.run(steps, timeout=60)
    job2.stop()
    _equal_states(out, ref)


def test_inflight_messages_drained_to_cache(tmp_path):
    n = 3
    init_fn, step_fn = pingpong_app()
    job = MPIJob(n, step_fn, init_fn, transport="shm")
    job.checkpoint_at(6, tmp_path / "ck", resume=False)
    job.run(20, timeout=60)
    job.stop()
    total_cached = 0
    for r in range(n):
        img = tcp.load_rank_image(tmp_path / "ck", r)
        assert isinstance(img, tcp.RankImage)
        total_cached += len(img.mpi_state["cache"])
        assert img.mpi_state["sent"] >= 0 and img.mpi_state["received"] >= 0
        for b in img.mpi_state["cache"]:
            env = tmsg.Envelope.from_bytes(b)
            assert isinstance(env, tmsg.Envelope) and env.dst == r
    # each rank has exactly one unconsumed ring message from the final step
    assert total_cached == n
    assert job.coord.stats["drained_messages"] == total_cached


def test_resume_continues_identically(tmp_path):
    n, steps = 3, 14
    ref = reference(n, steps)
    init_fn, step_fn = pingpong_app()
    job = MPIJob(n, step_fn, init_fn, transport="shm")
    job.checkpoint_at(5, tmp_path / "ck")
    out = job.run(steps, timeout=60)
    job.stop()
    _equal_states(out, ref)
    assert job.coord.stats["checkpoints"] == 1
    assert (tmp_path / "ck" / "MANIFEST.json").exists()


def test_pending_irecv_survives_restart(tmp_path):
    def init_fn(mpi):
        return {"req": None, "got": None}

    def step_fn(mpi, st, k):
        if k == 0 and mpi.rank == 1:
            st["req"] = mpi.Irecv(source=0, tag=9)
        elif k == 1 and mpi.rank == 0:
            mpi.Send(np.float64(3.5), dest=1, tag=9)
        elif k == 2 and mpi.rank == 1:
            st["got"] = mpi.Wait(st["req"])    # virtual id still valid
        return st

    job = MPIJob(2, step_fn, init_fn, transport="shm")
    job.checkpoint_at(1, tmp_path / "ck", resume=False)
    job.run(3, timeout=60)
    job.stop()
    job2 = MPIJob.restart(tmp_path / "ck", step_fn, init_fn, transport="tcp")
    out = job2.run(3, timeout=60)
    job2.stop()
    assert out[1]["got"] == 3.5


def test_admin_replay_rebuilds_communicators(tmp_path):
    def init_fn(mpi):
        return {"sub": None, "tot": None}

    def step_fn(mpi, st, k):
        me = mpi.Comm_rank()
        if k == 0:
            st["sub"] = mpi.Comm_split(color=me % 2, key=me)
        elif k == 2:
            st["tot"] = mpi.Allreduce(np.float64(me), "sum", comm=st["sub"])
        return st

    job = MPIJob(4, step_fn, init_fn, transport="shm")
    job.checkpoint_at(1, tmp_path / "ck", resume=False)
    job.run(3, timeout=60)
    job.stop()
    job2 = MPIJob.restart(tmp_path / "ck", step_fn, init_fn,
                          transport="inproc")
    out = job2.run(3, timeout=60)
    job2.stop()
    assert [o["tot"] for o in out] == [2.0, 4.0, 2.0, 4.0]


def test_probe_served_from_restored_cache(tmp_path):
    def init_fn(mpi):
        return {}

    def step_fn(mpi, st, k):
        if k == 0 and mpi.rank == 0:
            mpi.Send(np.arange(5), dest=1, tag=4)
        if k == 2 and mpi.rank == 1:
            flag, status = mpi.Iprobe(source=0, tag=4)
            assert flag and status.count == 5
            st["v"] = mpi.Recv(source=0, tag=4)
        return st

    job = MPIJob(2, step_fn, init_fn, transport="shm")
    job.checkpoint_at(1, tmp_path / "ck", resume=False)
    job.run(3, timeout=60)
    job.stop()
    job2 = MPIJob.restart(tmp_path / "ck", step_fn, init_fn)
    out = job2.run(3, timeout=60)
    job2.stop()
    assert np.array_equal(out[1]["v"], np.arange(5))


def test_async_checkpoint_from_external_thread(tmp_path):
    init_fn, step_fn = pingpong_app()

    def slow_step(mpi, st, k):
        time.sleep(0.002)
        return step_fn(mpi, st, k)

    job = MPIJob(3, slow_step, init_fn, transport="shm")
    t = threading.Thread(target=lambda: job.run(60, timeout=90))
    t.start()
    time.sleep(0.05)
    job.checkpoint(tmp_path / "ck", resume=True)
    job.wait_checkpoint(timeout=30)
    t.join(60)
    job.stop()
    assert not job.errors
    assert tcp.checkpoint_valid(tmp_path / "ck", deep=True)
    assert job.results[0]["acc"].shape == (4,)


def test_checkpoint_after_finish_raises(tmp_path):
    init_fn, step_fn = pingpong_app()
    job = MPIJob(2, step_fn, init_fn)
    job.run(4, timeout=30)
    with pytest.raises(RuntimeError):
        job.checkpoint(tmp_path / "ck")
    job.stop()


# ---------------------------------------------------- across the packages

@pytest.mark.parametrize("writer,reader,t1,t2", [
    ("torch", "jax", "shm", "tcp"),
    ("jax", "torch", "tcp", "inproc"),
    ("torch", "jax", "inproc", "shm"),
    ("jax", "torch", "shm", "tcp"),
])
def test_cross_package_restart(tmp_path, writer, reader, t1, t2):
    """A rank checkpoint taken with drained in-flight messages under one
    package, restarted under the other on another transport, resumes bit
    for bit to the uninterrupted run."""
    n, steps = 3, 14
    ref = reference(n, steps)
    init_fn, step_fn = pingpong_app()
    job = JOBS[writer](n, step_fn, init_fn, transport=t1)
    job.checkpoint_at(7, tmp_path / "ck", resume=False)
    job.run(steps, timeout=60)
    job.stop()
    assert job.coord.stats["drained_messages"] > 0   # envelopes cross
    # the drained envelopes name the reference's class in either package
    img = rcp.load_rank_image(tmp_path / "ck", 0)
    assert img.mpi_state["cache"]
    assert all(b"repro.core.messages" in b and b"repro_torch" not in b
               for b in img.mpi_state["cache"])
    job2 = JOBS[reader].restart(tmp_path / "ck", step_fn, init_fn,
                                transport=t2)
    out = job2.run(steps, timeout=60)
    job2.stop()
    _equal_states(out, ref)


_PAYLOADS = [b"", b"abc", np.arange(5, dtype=np.float32),
             np.zeros((3, 4)), np.arange(7, dtype=np.int64),
             np.arange(300000, dtype=np.float32)]


@pytest.mark.parametrize("i", range(len(_PAYLOADS)))
def test_envelope_bytes_equal_the_references(i):
    p = _PAYLOADS[i]
    dt, count = (("MPI_BYTE", len(p)) if isinstance(p, bytes)
                 else (tmsg._NP_TO_MPI[p.dtype], p.size))
    fields = dict(src=2, dst=0, tag=7, comm_vid=3, seq=11, payload=p,
                  dtype=dt, count=count)
    mine = tmsg.Envelope(**fields).to_bytes()
    theirs = rmsg.Envelope(**fields).to_bytes()
    assert mine == theirs
    back = tmsg.Envelope.from_bytes(theirs)
    assert type(back) is tmsg.Envelope
    assert type(rmsg.Envelope.from_bytes(mine)) is rmsg.Envelope
    moved = dataclasses.replace(back, src=1)
    assert moved.src == 1 and moved.to_bytes() == dataclasses.replace(
        rmsg.Envelope.from_bytes(mine), src=1).to_bytes()


def test_packed_values_and_remapped_caches_equal_the_references():
    """Envelopes of values packed by each package's ``pack``, and a cache
    snapshot remapped for an elastic restart, are the same bytes in both."""
    from repro.core.drain import remap_cache_snapshot as r_remap
    values = [np.arange(6, dtype=np.float64), {"a": 1, "b": [2, 3]}, 3.5]
    envs = []
    for seq, v in enumerate(values):
        mine, theirs = tmsg.pack(v), rmsg.pack(v)
        assert mine[1:] == theirs[1:]
        envs.append((tmsg.Envelope(0, 1, 5, 0, seq, *mine),
                     rmsg.Envelope(0, 1, 5, 0, seq, *theirs)))
    snap = MessageCache([e for e, _ in envs]).snapshot()
    assert snap == RCache([e for _, e in envs]).snapshot()
    rank_map = {0: 1, 1: 0, 2: None}
    assert remap_cache_snapshot(snap, rank_map, ()) == r_remap(snap, rank_map,
                                                               ())
    restored = MessageCache.restore(snap)
    assert [tmsg.unpack(e) for e in restored.envelopes][1:] == values[1:]


def _dp_checkpoint(job_cls, make_app, root: Path, ckpt_store=None):
    init_fn, step_fn = make_app(seed=5)
    job = job_cls(4, step_fn, init_fn, transport="shm",
                  ckpt_store=ckpt_store)
    job.checkpoint_at(3, root, resume=False)
    job.run(6, timeout=60)
    job.stop()
    return json.loads((root / "MANIFEST.json").read_text())


def test_app_parts_have_equal_chunk_names(tmp_path):
    """The same checkpoint written by either package: every rank's app part
    is the same bytes, so it gets the same chunk name (and a shared store
    holds it once).  The MPI parts hold timings, so they differ run to
    run, even within one package."""
    shared = tmp_path / "chunks"
    mine = _dp_checkpoint(MPIJob, make_dp_app, tmp_path / "torch",
                          ckpt_store=shared)
    theirs = _dp_checkpoint(RJob, r_make_dp_app, tmp_path / "jax",
                            ckpt_store=shared)
    assert set(mine["ranks"]) == set(theirs["ranks"]) == {"0", "1", "2", "3"}
    for r in mine["ranks"]:
        a, b = mine["ranks"][r]["parts"], theirs["ranks"][r]["parts"]
        assert a["app"] == b["app"]
        assert mine["ranks"][r]["step_idx"] == theirs["ranks"][r]["step_idx"]
    apps = {p["parts"]["app"]["chunk"] for p in mine["ranks"].values()}
    assert {p.name for p in shared.iterdir()} >= apps


def _write_v2(src: Path, dst: Path, rank_image_cls, loader) -> None:
    """A v2 (monolithic image + crc32) copy of a v3 checkpoint, each image
    written by `rank_image_cls.to_bytes`."""
    man = json.loads((src / "MANIFEST.json").read_text())
    dst.mkdir(parents=True)
    ranks = {}
    for r, ent in man["ranks"].items():
        img = loader(src, int(r))
        blob = rank_image_cls(img.rank, img.n_ranks, img.step_idx,
                              img.mpi_state, img.app_state).to_bytes()
        (dst / f"rank_{r}.img").write_bytes(blob)
        ranks[r] = {"rank": img.rank, "n_ranks": img.n_ranks,
                    "step_idx": img.step_idx, "file": f"rank_{r}.img",
                    "crc32": zlib.crc32(blob), "bytes": len(blob)}
    v2 = {"version": 2, "time": man["time"], "n_ranks": man["n_ranks"],
          "generation": man["generation"], "ranks": ranks,
          "meta": man["meta"]}
    (dst / "MANIFEST.json").write_text(json.dumps(v2))


def test_reference_v2_image_loads_in_the_port(tmp_path):
    """A reference v2 checkpoint (pickled ``repro.core.ckpt_protocol.
    RankImage``s holding drained envelopes) loads in the port as the port's
    classes and restarts bit for bit; the port's v2 images are the
    reference's bytes."""
    n, steps = 3, 14
    ref = reference(n, steps)
    init_fn, step_fn = pingpong_app()
    job = RJob(n, step_fn, init_fn, transport="shm")
    job.checkpoint_at(7, tmp_path / "v3", resume=False)
    job.run(steps, timeout=60)
    job.stop()
    _write_v2(tmp_path / "v3", tmp_path / "v2", rcp.RankImage,
              rcp.load_rank_image)
    blob = (tmp_path / "v2" / "rank_0.img").read_bytes()
    assert b"repro.core.ckpt_protocol" in blob
    img = tcp.load_rank_image(tmp_path / "v2", 0)
    assert type(img) is tcp.RankImage
    assert all(type(tmsg.Envelope.from_bytes(b)) is tmsg.Envelope
               for b in img.mpi_state["cache"])
    assert tcp.RankImage(img.rank, img.n_ranks, img.step_idx, img.mpi_state,
                         img.app_state).to_bytes() == blob
    assert tcp.checkpoint_valid(tmp_path / "v2", deep=True)
    job2 = MPIJob.restart(tmp_path / "v2", step_fn, init_fn, transport="tcp")
    out = job2.run(steps, timeout=60)
    job2.stop()
    _equal_states(out, ref)


_REFUSE = r"""
import pickle, sys
from pathlib import Path
from repro_torch.core import ckpt_protocol as cp
from repro_torch.core.messages import Envelope, WireNameError, loads_wire
d = Path(sys.argv[1])
env = Envelope.from_bytes((d / "envelope.bin").read_bytes())
assert type(env) is Envelope and env.payload == b"ok", env
refused = []
for what, load in (("status", lambda: loads_wire((d / "status.bin").read_bytes())),
                   ("v2", lambda: cp.load_rank_image(d / "ck", 0))):
    try:
        load()
    except WireNameError as e:
        refused.append((what, "repro.core.messages.Status" in str(e)))
print(refused, sorted(m for m in sys.modules
                      if m == "repro" or m.startswith("repro.")))
"""


def test_loading_another_reference_class_is_refused(tmp_path):
    """An image (or a pickle read by the same unpickler) naming a class of
    the reference package that the port does not map is refused with a
    clear error, and nothing of the reference is imported: run in a fresh
    interpreter that has only the port."""
    (tmp_path / "envelope.bin").write_bytes(
        rmsg.Envelope(0, 1, 0, 0, 0, b"ok").to_bytes())
    status = pickle.dumps(rmsg.Status(source=1), protocol=5)
    assert b"repro.core.messages" in status
    (tmp_path / "status.bin").write_bytes(status)
    img = rcp.RankImage(0, 1, 0, {"cache": [], "status": rmsg.Status()}, b"")
    blob = img.to_bytes()
    (tmp_path / "ck").mkdir()
    (tmp_path / "ck" / "rank_0.img").write_bytes(blob)
    (tmp_path / "ck" / "MANIFEST.json").write_text(json.dumps(
        {"version": 2, "n_ranks": 1, "generation": 0, "meta": {},
         "ranks": {"0": {"rank": 0, "n_ranks": 1, "step_idx": 0,
                         "file": "rank_0.img",
                         "crc32": zlib.crc32(blob)}}}))
    proc = subprocess.run(
        [sys.executable, "-c", _REFUSE, str(tmp_path)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[0] == \
        "[('status', True), ('v2', True)] []", proc.stdout
