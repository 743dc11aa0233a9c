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
    compute/wait split by the port's FaultTolerantDriver."""
import time

import numpy as np
import pytest

from conftest import exact_transports

from repro.core import MPIJob as RJob
from repro.core import dataplane as r_dataplane
from repro_torch.core import MPIJob
from repro_torch.core import dataplane
from repro_torch.core.dataplane import (RING_PAYLOAD_MIN, RingRef, ShmRing,
                                        shm_available)
from repro_torch.distributed.faults import FaultTolerantDriver

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
