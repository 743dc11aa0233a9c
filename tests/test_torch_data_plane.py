"""The port's zero-copy data plane (DESIGN.md §12) against the reference.

Twins of tests/test_data_plane.py on ``repro_torch.core``:

  * the shared-memory tensor ring's units — put/read reclaiming the slot,
    the full and oversized fallbacks, the generation stamp catching a
    stale descriptor, and the shrink-to-fit (2x headroom) that sizes the
    ring to ``/dev/shm``, slot for slot as the reference sizes it;
  * multi-MB and bf16 payloads bit-identical across the port's ``tcp``,
    ``proc`` and ``shmring`` fabrics and the reference's thread world;
  * a checkpoint mid-stream on the ring restarted on plain tcp, by the
    port and by the reference (no descriptor ever lands in an image);
  * the straggler under per-step collectives, caught through the
    compute/wait split by the port's FaultTolerantDriver;
  * the scatter-gather codec: the port's bodies and frames equal the
    reference's byte for byte and decode in either package, bufferless
    bodies stay plain pickle, ``pack`` keeps arrays in private copies;
  * the compute/wait telemetry in ``job.stats()`` (its keys the
    reference's, surviving a restart) and ``StragglerTracker``'s compute
    split, call for call the reference's."""
import pickle
import socket
import struct
import time

import numpy as np
import pytest

from conftest import exact_transports

from repro.core import MPIJob as RJob
from repro.core import dataplane as r_dataplane
from repro.core import transport as r_transport
from repro.core.messages import pack as r_pack
from repro.distributed.faults import StragglerTracker as RStragglerTracker
from repro_torch.core import MPIJob
from repro_torch.core import dataplane
from repro_torch.core.dataplane import (RING_PAYLOAD_MIN, RingRef, ShmRing,
                                        shm_available)
from repro_torch.core.messages import Envelope, pack, payload_nbytes, unpack
from repro_torch.core.transport import (SG_MAGIC, dumps_parts, frame_iov,
                                        loads_body, read_frame_mv,
                                        write_frame, write_frame_parts)
from repro_torch.distributed.faults import (FaultTolerantDriver,
                                            StragglerTracker)

needs_shm = pytest.mark.skipif(not shm_available(),
                               reason="POSIX shared memory unavailable")


# ============================================================== shm ring

@needs_shm
def test_ring_put_read_reclaims_slot():
    ring = ShmRing.create(slots=4, slot_bytes=1 << 16)
    assert ring is not None
    try:
        arr = np.random.default_rng(0).standard_normal(512)
        ref = ring.try_put(arr)
        assert isinstance(ref, RingRef) and ring.in_flight() == 1
        got = ring.read(ref)
        assert np.array_equal(got, arr) and got.flags.writeable
        assert ring.in_flight() == 0      # delivery reclaimed the slot
    finally:
        ring.destroy()


@needs_shm
def test_ring_full_and_oversized_fall_back_to_none():
    ring = ShmRing.create(slots=2, slot_bytes=1 << 12)
    assert ring is not None
    try:
        assert ring.try_put(
            np.zeros((1 << 12) + 1, np.uint8)) is None            # too big
        refs = [ring.try_put(np.ones(16, np.float64)) for _ in range(2)]
        assert all(r is not None for r in refs)
        assert ring.try_put(np.ones(16, np.float64)) is None      # full
        for r in refs:
            ring.read(r)
        assert ring.try_put(np.ones(16, np.float64)) is not None  # freed
    finally:
        ring.destroy()


@needs_shm
def test_ring_read_detects_stale_descriptor():
    """The generation stamp catches a descriptor for a freed slot and one
    whose slot was reused by a later put."""
    ring = ShmRing.create(slots=1, slot_bytes=1 << 12)
    assert ring is not None
    try:
        stale = ring.try_put(np.arange(32, dtype=np.float64))
        assert np.array_equal(ring.read(stale),
                              np.arange(32, dtype=np.float64))
        with pytest.raises(RuntimeError, match="reclamation"):
            ring.read(stale)              # slot already freed
        fresh = ring.try_put(np.zeros(8, np.float32))
        assert fresh.slot == stale.slot and fresh.seq != stale.seq
        with pytest.raises(RuntimeError, match="reclamation"):
            ring.read(stale)              # slot reused by a later put
        assert np.array_equal(ring.read(fresh), np.zeros(8, np.float32))
    finally:
        ring.destroy()


@needs_shm
@pytest.mark.parametrize("budget", [None, 512 << 20, 64 << 20, 64_000_000,
                                    16 << 20, 4 << 20])
def test_ring_shrinks_to_fit_like_the_reference(monkeypatch, budget):
    """``ShmRing.create`` halves the slot count (to 4), then the slot size
    (to 1 MiB), until twice the segment fits the free ``/dev/shm`` bytes,
    and gives up below that: a container's 64 MB gives 4 slots of 4 MiB.
    The reference sizes every budget alike."""
    monkeypatch.setattr(dataplane, "_shm_free_bytes", lambda: budget)
    monkeypatch.setattr(r_dataplane, "_shm_free_bytes", lambda: budget)
    got, want = ShmRing.create(), r_dataplane.ShmRing.create()
    try:
        shape = None if got is None else (got.slots, got.slot_bytes)
        assert shape == (None if want is None
                         else (want.slots, want.slot_bytes))
        expect = {None: (16, 8 << 20), 512 << 20: (16, 8 << 20),
                  64 << 20: (4, 4 << 20), 64_000_000: (4, 4 << 20),
                  16 << 20: (4, 1 << 20), 4 << 20: None}[budget]
        assert shape == expect
    finally:
        for ring in (got, want):
            if ring is not None:
                ring.destroy()


def test_ring_knobs_and_descriptor_match_the_reference():
    assert RING_PAYLOAD_MIN == r_dataplane.RING_PAYLOAD_MIN == 1 << 18
    assert (dataplane.DEFAULT_SLOTS, dataplane.DEFAULT_SLOT_BYTES) == (
        r_dataplane.DEFAULT_SLOTS, r_dataplane.DEFAULT_SLOT_BYTES)
    ref = RingRef(slot=1, length=8, seq=3, dtype="float64", shape=(1,))
    assert ref == RingRef(**vars(r_dataplane.RingRef(
        slot=1, length=8, seq=3, dtype="float64", shape=(1,))))


# ================================================== cross-fabric parity

def _tensor_app(n_elems):
    """Sendrecv a multi-MB tensor around the ring every step, allreduce a
    checksum: both the point-to-point and the collective paths, payloads
    far above RING_PAYLOAD_MIN."""
    def init_fn(mpi):
        return {"digests": []}

    def step_fn(mpi, st, k):
        n, me = mpi.Comm_size(), mpi.Comm_rank()
        rng = np.random.default_rng(1000 * (me + 1) + k)
        x = rng.standard_normal(n_elems).astype(np.float32)
        got = mpi.Sendrecv(x, (me + 1) % n, k % 5, (me - 1) % n, k % 5)
        total = mpi.Allreduce(got[: 1 << 10].copy(), "sum")
        st = dict(st)
        st["digests"] = st["digests"] + [
            (got.tobytes()[:256].hex(), total.tobytes()[:64].hex())]
        return st

    return init_fn, step_fn


def _reference(step_fn, init_fn, steps):
    """The reference's thread-world run of the same program, 2 ranks."""
    with exact_transports():
        job = RJob(2, step_fn, init_fn, transport="shm")
    try:
        return job.run(steps, timeout=90)
    finally:
        job.stop()


def _fabrics():
    return ["tcp", "proc"] + (["shmring"] if shm_available() else [])


def test_multi_mb_tensors_bit_identical_across_fabrics():
    n_elems = 1 << 18                     # 1 MiB float32 >= RING_PAYLOAD_MIN
    assert n_elems * 4 >= RING_PAYLOAD_MIN
    init_fn, step_fn = _tensor_app(n_elems)
    outs = {}
    for tr in _fabrics():
        job = MPIJob(2, step_fn, init_fn, transport=tr)
        outs[tr] = job.run(3, timeout=90)
        if tr == "shmring":
            tele = job.stats()["telemetry"]["total"]
            assert tele.get("ring_bytes", 0) > 0, \
                "shmring leg never used the ring"
        job.stop()
    ref = _reference(step_fn, init_fn, 3)
    for tr, out in outs.items():
        for r in range(2):
            assert out[r]["digests"] == ref[r]["digests"], (tr, r)


def test_bf16_payload_bit_identical_across_fabrics():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    bf16 = np.dtype(ml_dtypes.bfloat16)

    def init_fn(mpi):
        return {}

    def step_fn(mpi, st, k):
        n, me = mpi.Comm_size(), mpi.Comm_rank()
        x = (np.random.default_rng(me + 7 * k)
             .standard_normal(1 << 18).astype(bf16))   # 512 KiB: the ring
        got = mpi.Sendrecv(x, (me + 1) % n, 1, (me - 1) % n, 1)
        st = dict(st, digest=got.tobytes().hex(), dtype=str(got.dtype))
        return st

    outs = {}
    for tr in _fabrics():
        job = MPIJob(2, step_fn, init_fn, transport=tr)
        outs[tr] = job.run(2, timeout=60)
        job.stop()
    ref = _reference(step_fn, init_fn, 2)
    for tr, out in outs.items():
        for r in range(2):
            assert out[r]["digest"] == ref[r]["digest"], (tr, r)
            assert out[r]["dtype"] == "bfloat16"


@needs_shm
def test_checkpoint_mid_stream_ring_to_tcp_bit_identical(tmp_path):
    """Checkpoint a shmring job mid-stream (large tensors in flight every
    step), restart the image on plain tcp in the port and in the
    reference, and land on byte-identical results: the drain barrier
    leaves no ring descriptor inside any channel image."""
    n_elems = 1 << 18
    init_fn, step_fn = _tensor_app(n_elems)
    ref = _reference(step_fn, init_fn, 6)

    job = MPIJob(2, step_fn, init_fn, transport="shmring")
    job.checkpoint_at(3, tmp_path / "ck", resume=True)
    mid = job.run(6, timeout=90)
    job.stop()
    for r in range(2):                    # uninterrupted shmring parity
        assert mid[r]["digests"] == ref[r]["digests"]

    job2 = MPIJob.restart(tmp_path / "ck", step_fn, init_fn,
                          transport="tcp")
    out = job2.run(6, timeout=90)
    job2.stop()
    with exact_transports():
        job3 = RJob.restart(tmp_path / "ck", step_fn, init_fn,
                            transport="tcp")
    out3 = job3.run(6, timeout=90)
    job3.stop()
    for r in range(2):
        assert out[r]["digests"] == ref[r]["digests"]
        assert out3[r]["digests"] == ref[r]["digests"]


# =============================================================== telemetry

def test_straggler_detected_under_per_step_collectives(tmp_path):
    """With an allreduce EVERY step all walls collapse to the victim's;
    the compute/wait split restores attribution: the driver excludes the
    victim and logs the wait: evidence record."""
    steps, n, victim = 30, 3, 2

    def init_fn(mpi):
        return {"params": {"w": np.zeros(2, np.float64)}}

    def lagging_step(mpi, st, k):
        time.sleep(0.06 if (mpi.generation == 0 and mpi.rank == victim)
                   else 0.001)
        st = dict(st, params={"w": st["params"]["w"] + 1.0})
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
        ckpt_root=tmp_path, ckpt_every=100,
        straggler_windows=3)
    out = driver.run(steps, transport_after_failure="shm", timeout=90)

    assert len(out) == n - 1
    for r in range(n - 1):
        assert np.array_equal(out[r]["params"]["w"],
                              np.full(2, float(steps)))
    assert any(e.startswith(f"straggler:[{victim}]") for e in driver.events)
    wait_ev = next(e for e in driver.events
                   if e.startswith(f"wait:rank={victim}"))
    fields = dict(f.split("=") for f in wait_ev.split(":")[1:])
    assert float(fields["compute_s"]) > 0.5 * float(fields["wall_s"])
    assert driver.events[-1] == "done"


# ============================================================== SG codec

def _body(parts) -> bytes:
    return b"".join(bytes(memoryview(p).cast("B")) for p in parts)


def test_sg_body_roundtrips_arrays_out_of_band():
    obj = {"x": np.arange(1024, dtype=np.float32),
           "y": np.ones((3, 5), dtype=np.float64), "tag": 7}
    body = _body(dumps_parts(obj))
    assert SG_MAGIC == r_transport.SG_MAGIC
    assert body[:4] == SG_MAGIC          # arrays present -> SG encoding
    assert body == _body(r_transport.dumps_parts(obj))
    for loads in (loads_body, r_transport.loads_body):
        back = loads(body)
        assert back["tag"] == 7
        assert np.array_equal(back["x"], obj["x"])
        assert np.array_equal(back["y"], obj["y"])


def test_bufferless_body_is_plain_pickle():
    """No out-of-band payloads: the body is the pickle (a pre-SG reader
    parses it), and a pickle never aliases the magic."""
    parts = dumps_parts(("hello", [1, 2, 3]))
    assert len(parts) == 1
    assert pickle.loads(parts[0]) == ("hello", [1, 2, 3])
    assert bytes(parts[0][:4]) != SG_MAGIC
    assert loads_body(parts[0]) == ("hello", [1, 2, 3])
    assert bytes(parts[0]) == bytes(
        r_transport.dumps_parts(("hello", [1, 2, 3]))[0])


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "ref"),
                                           ("ref", "port")])
def test_sg_frame_over_socket_yields_writable_arrays(writer, reader):
    """A frame one package writes, the other reads: the array arrives
    bit-equal and writable (unpack is not forced into a copy)."""
    mods = {"port": (dumps_parts, write_frame_parts, read_frame_mv,
                     loads_body),
            "ref": (r_transport.dumps_parts, r_transport.write_frame_parts,
                    r_transport.read_frame_mv, r_transport.loads_body)}
    dumps, write, _, _ = mods[writer]
    _, _, read, loads = mods[reader]
    a, b = socket.socketpair()
    try:
        # well under the socketpair buffer: the write completes with no
        # reader scheduled yet (single-threaded test)
        arr = np.random.default_rng(3).standard_normal(1 << 12)
        write(a, dumps({"w": arr}))
        got = loads(read(b))["w"]
        assert np.array_equal(got, arr)
        assert got.flags.writeable
        got += 1.0
    finally:
        a.close()
        b.close()


def test_legacy_writer_sg_reader_interop():
    """An old-style frame (one pre-pickled body), written by either
    package, reads through the port's read_frame_mv + loads_body."""
    for write in (write_frame, r_transport.write_frame):
        a, b = socket.socketpair()
        try:
            write(a, pickle.dumps({"k": list(range(10))}))
            assert loads_body(read_frame_mv(b)) == {"k": list(range(10))}
        finally:
            a.close()
            b.close()


def test_frame_iov_total_matches_length_header():
    parts = dumps_parts({"x": np.zeros(777, np.uint8), "n": 1})
    iov = frame_iov(parts)
    (total,) = struct.unpack("!q", bytes(iov[0]))
    assert total == sum(v.nbytes for v in iov[1:])
    assert [bytes(v) for v in iov] == [
        bytes(v) for v in r_transport.frame_iov(
            r_transport.dumps_parts({"x": np.zeros(777, np.uint8), "n": 1}))]


def test_pack_keeps_arrays_and_makes_private_copies():
    src = np.arange(64, dtype=np.float32)
    payload, dt, count = pack(src)
    assert isinstance(payload, np.ndarray) and dt == "MPI_FLOAT"
    assert count == 64 and payload_nbytes(payload) == 256
    assert (dt, count) == r_pack(src)[1:]
    src += 100.0                          # sender mutates after "send"
    assert payload[0] == 0.0              # the payload must not see it
    env = Envelope(0, 1, 0, 0, 0, payload, dt, count)
    out = unpack(env)
    assert out.flags.writeable and np.array_equal(out, np.arange(64))


def test_pack_pickles_unknown_types_as_before():
    payload, dt, count = pack({"a": 1})
    assert isinstance(payload, bytes) and dt == "MPI_BYTE"
    assert payload_nbytes(payload) == len(payload) == count
    assert (payload, dt, count) == r_pack({"a": 1})


# =============================================================== telemetry

def _coll_app(sleep_s):
    def init_fn(mpi):
        return {}

    def step_fn(mpi, st, k):
        time.sleep(sleep_s)
        return dict(st, s=float(mpi.Allreduce(np.float64(1.0), "sum")))
    return init_fn, step_fn


def test_job_stats_expose_compute_wait_split():
    init_fn, step_fn = _coll_app(0.002)
    stats = {}
    for name, cls in (("port", MPIJob), ("ref", RJob)):
        job = cls(2, step_fn, init_fn, transport="shm")
        try:
            job.run(5, timeout=60)
            stats[name] = job.stats()
        finally:
            job.stop()
    st = stats["port"]
    assert st["world_size"] == 2 and st["generation"] == 0
    tele = st["telemetry"]
    assert sorted(tele["ranks"]) == [0, 1]
    for r, c in tele["ranks"].items():
        for key in ("wait_recv_us", "wait_coll_us", "bytes_sent",
                    "bytes_received", "ring_bytes"):
            assert key in c, (r, key)
        assert set(c) == set(stats["ref"]["telemetry"]["ranks"][r])
    # an allreduce-every-step workload blocks in collectives, and the
    # totals aggregate across ranks; the bytes are the reference's
    assert tele["total"]["wait_coll_us"] > 0
    assert tele["total"]["bytes_sent"] > 0
    for key in ("bytes_sent", "bytes_received"):
        assert tele["total"][key] == stats["ref"]["telemetry"]["total"][key]
    strag = st["stragglers"]
    for r in (0, 1):
        assert strag[r]["compute_s"] is not None
        assert strag[r]["wait_s"] >= 0.0


def test_wait_telemetry_survives_checkpoint_restart(tmp_path):
    """Counters resume from the snapshot, not from zero: the port's
    restart of its own checkpoint, and of the reference's, report totals
    that cover the steps before the checkpoint."""
    init_fn, step_fn = _coll_app(0.0)
    for writer in (MPIJob, RJob):
        ck = tmp_path / writer.__module__
        job = writer(2, step_fn, init_fn, transport="shm")
        job.checkpoint_at(3, ck, resume=False)
        job.run(6, timeout=60)
        job.stop()
        job2 = MPIJob.restart(ck, step_fn, init_fn, transport="shm")
        try:
            job2.run(6, timeout=60)
            tele = job2.stats()["telemetry"]
        finally:
            job2.stop()
        assert tele["total"]["wait_coll_us"] > 0


def test_straggler_tracker_prefers_compute_split():
    """Wall-clock EWMAs are uniform under per-step collectives (everyone
    waits for the slowest rank), so the legacy path flags nobody; the
    compute split names the culprit, with the reference's report."""
    trackers = (StragglerTracker(3, factor=3.0),
                RStragglerTracker(3, factor=3.0))
    for t in trackers:
        for _ in range(4):
            for r in range(3):            # all walls identical: blind
                t.record(r, 0.100, compute=0.090 if r == 2 else 0.002)
    t = trackers[0]
    assert t.stragglers() == [2] == trackers[1].stragglers()
    rep = t.report()
    assert rep == trackers[1].report()
    assert rep[2]["wait_s"] == pytest.approx(0.010, abs=1e-9)
    assert rep[0]["wait_s"] == pytest.approx(0.098, abs=1e-9)

    legacy = StragglerTracker(3, factor=3.0)
    for _ in range(4):
        for r in range(3):
            legacy.record(r, 0.100)       # wall-only callers: old behavior
    assert legacy.stragglers() == []
    assert legacy.report()[0]["compute_s"] is None
