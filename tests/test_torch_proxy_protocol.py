"""The port's batched proxy wire protocol (``repro_torch.core.proxy``)
against the reference's: twins of tests/test_proxy_protocol.py.

The same workloads run in both packages: a burst of fire-and-forget sends
arrives in the same per-(src, dst) order, the sender's batches cost the
same queue hops, the coordinator sees the same counter reports under
``REPORT_EPOCH``, and a world checkpointed mid-batch restarts on the other
transport with the reference's uninterrupted results.  Deferred errors,
the empty-channel invariant and the switchboard's teardown run on the
port's own objects."""
import socket
import struct
import time

import numpy as np
import pytest

from repro.core import MPIJob as RJob
from repro.core.api import REPORT_EPOCH as R_REPORT_EPOCH
from repro.core.proxy import MAX_BATCH as R_MAX_BATCH
from repro_torch.core import MPIJob
from repro_torch.core.api import REPORT_EPOCH
from repro_torch.core.proxy import (CMD_FLUSH, CMD_POLL_ALL, CMD_SEND,
                                    MAX_BATCH, MPIProxy, ProxyChannel)
from repro_torch.core.transport import ShmTransport, _Switchboard


def run_app(n, step_fn, init_fn=lambda mpi: {}, steps=1, transport="shm",
            job_cls=MPIJob):
    job = job_cls(n, step_fn, init_fn, transport=transport)
    try:
        return job.run(steps, timeout=120), job
    finally:
        job.stop()


# ------------------------------------------------------- ordering & batching

@pytest.mark.parametrize("transport", ["shm", "tcp"])
def test_batched_send_ordering_per_src_dst(transport):
    """A burst of fire-and-forget sends from two sources (several
    auto-flushed batches plus a piggybacked tail) arrives in issue order
    per (src, dst), in both packages alike."""
    assert MAX_BATCH == R_MAX_BATCH
    m = 3 * MAX_BATCH + 7          # forces auto-flush mid-burst

    def step(mpi, st, k):
        if mpi.rank in (0, 2):
            for i in range(m):
                mpi.Isend(np.int64(1000 * mpi.rank + i), dest=1, tag=5)
        elif mpi.rank == 1:
            st["got"] = {src: [int(mpi.Recv(source=src, tag=5))
                               for _ in range(m)] for src in (2, 0)}
        return st

    out, _ = run_app(3, step, transport=transport)
    ref, _ = run_app(3, step, transport=transport, job_cls=RJob)
    for src in (0, 2):
        assert out[1]["got"][src] == [1000 * src + i for i in range(m)], \
            "batched sends must preserve order"
    assert out[1]["got"] == ref[1]["got"]


def test_bulk_poll_amortizes_round_trips():
    """The receiver drains a burst with far fewer channel round trips than
    messages: the point of CMD_POLL_ALL/CMD_POLL_WAIT."""
    m = 100

    def step(mpi, st, k):
        if mpi.rank == 0:
            for i in range(m):
                mpi.Isend(np.int64(i), dest=1, tag=1)
            mpi.flush()
        else:
            time.sleep(0.05)       # let the burst land on the transport
            t0 = mpi.channel.stats["round_trips"]
            for i in range(m):
                mpi.Recv(source=0, tag=1)
            st["rt"] = mpi.channel.stats["round_trips"] - t0
        return st

    out, _ = run_app(2, step)
    assert out[1]["rt"] <= 10, \
        f"{out[1]['rt']} round trips for {m} messages (bulk poll broken?)"


def test_sender_side_batching_round_trips():
    """The sender's burst costs m / MAX_BATCH queue hops and no waiting
    round trip until the flush barrier, as the reference's does."""
    m = 4 * MAX_BATCH

    def step(mpi, st, k):
        if mpi.rank == 0:
            rt0 = mpi.channel.stats["round_trips"]
            ab0 = mpi.channel.stats["async_batches"]
            for i in range(m):
                mpi.Isend(b"x", dest=1, tag=1)
            st["rt"] = mpi.channel.stats["round_trips"] - rt0
            st["ab"] = mpi.channel.stats["async_batches"] - ab0
        else:
            for i in range(m):
                mpi.Recv(source=0, tag=1)
        return st

    out, _ = run_app(2, step)
    ref, _ = run_app(2, step, job_cls=RJob)
    assert out[0]["rt"] == ref[0]["rt"] == 0, \
        "fire-and-forget sends must not round-trip"
    assert out[0]["ab"] == ref[0]["ab"] == m // MAX_BATCH


# --------------------------------------------------------- deferred errors

class _FailingSendTransport(ShmTransport):
    name = "failing-send"

    def send_many(self, envs):
        raise RuntimeError("wire torn")

    send = send_many


def _proxy_pair(transport):
    transport.start(2)
    ch = ProxyChannel()
    proxy = MPIProxy(0, transport, ch)
    proxy.start()
    return ch, proxy


def test_deferred_error_surfaces_on_next_blocking_call():
    ch, proxy = _proxy_pair(_FailingSendTransport())
    ch.send_async(CMD_SEND, 1, 0, 0, b"payload", "MPI_BYTE", 7)
    ch.flush_async()               # fire-and-forget: no error here
    time.sleep(0.05)
    with pytest.raises(RuntimeError, match="wire torn"):
        ch.call(CMD_POLL_ALL)      # ...but the next replied call raises it
    ch.call(CMD_FLUSH)             # slot cleared: channel usable again
    proxy.stop()
    proxy.join(5.0)


def test_deferred_error_surfaces_on_flush():
    ch, proxy = _proxy_pair(_FailingSendTransport())
    ch.send_async(CMD_SEND, 1, 0, 0, b"payload", "MPI_BYTE", 7)
    with pytest.raises(RuntimeError, match="wire torn"):
        ch.flush()                 # the blocking barrier surfaces it
    proxy.stop()
    proxy.join(5.0)


# ------------------------------------------------- epoch-based counter flush

def test_epoch_counters_reduce_coordinator_traffic():
    """During PHASE_RUN counters flush once per REPORT_EPOCH ops, not once
    per message, and the end-of-run flush leaves them exact; the reference
    reports as often for the same program."""
    assert REPORT_EPOCH == R_REPORT_EPOCH
    m = 200

    def step(mpi, st, k):
        if mpi.rank == 0:
            for i in range(m):
                mpi.Isend(b"z", dest=1, tag=1)
        else:
            for i in range(m):
                mpi.Recv(source=0, tag=1)
        return st

    _, job = run_app(2, step)
    _, ref = run_app(2, step, job_cls=RJob)
    stats = job.coord.stats
    # per-message reporting would be >= 2*m; epoch reporting is ~2*m/EPOCH
    assert stats["counter_reports"] <= 4 * m // REPORT_EPOCH + 16, stats
    assert stats["counter_reports"] == ref.coord.stats["counter_reports"]
    assert job.coord.network_empty(), "final flush must leave exact counters"


# --------------------------------------------- drain invariant & checkpoints

def burst_app(m=40):
    """Each step fires a mid-size batch consumed one step later, so a
    checkpoint always lands with batches in flight."""
    def init_fn(mpi):
        return {"acc": 0}

    def step_fn(mpi, st, k):
        n, me = mpi.Comm_size(), mpi.Comm_rank()
        for j in range(m):
            mpi.Isend(np.int64(k * m + j), (me + 1) % n, tag=j % 7)
        if k > 0:
            for j in range(m):
                st["acc"] += int(mpi.Recv(source=(me - 1) % n,
                                          tag=j % 7))
        return st

    return init_fn, step_fn


def test_channel_empty_at_snapshot_invariant(tmp_path):
    """Checkpoint taken mid-burst: every rank's channel is empty at the
    snapshot (asserted inside the runtime; counted per rank here)."""
    n = 3
    init_fn, step_fn = burst_app()
    job = MPIJob(n, step_fn, init_fn, transport="shm")
    job.checkpoint_at(4, tmp_path / "ck")
    job.run(8, timeout=120)
    job.stop()
    assert not job.errors
    assert job.coord.stats["empty_channel_snapshots"] == n
    for ch in job.channels:
        assert ch.is_empty()


@pytest.mark.parametrize("t1,t2", [("shm", "tcp"), ("tcp", "shm")])
def test_cross_transport_restart_mid_batch(tmp_path, t1, t2):
    """The checkpoint lands while multi-message batches are in flight; the
    port restarts it on the other transport, and so does the reference:
    both continue to the reference's uninterrupted results."""
    n, steps = 3, 8
    init_fn, step_fn = burst_app()
    ref, _ = run_app(n, step_fn, init_fn, steps, transport=t1, job_cls=RJob)

    job = MPIJob(n, step_fn, init_fn, transport=t1)
    job.checkpoint_at(4, tmp_path / "ck", resume=False)
    job.run(steps, timeout=120)
    job.stop()
    assert job.coord.stats["empty_channel_snapshots"] == n
    assert job.coord.stats["drained_messages"] > 0, \
        "checkpoint must have caught in-flight messages"

    for cls in (MPIJob, RJob):
        job2 = cls.restart(tmp_path / "ck", step_fn, init_fn, transport=t2)
        out = job2.run(steps, timeout=120)
        job2.stop()
        for r in range(n):
            assert out[r]["acc"] == ref[r]["acc"], (cls, r)


# ----------------------------------------------------- deterministic teardown

def test_switchboard_shutdown_with_missing_ranks():
    """shutdown() must unblock run() even when fewer than n ranks ever
    connected (the accept() race)."""
    board = _Switchboard(4)
    board.start()
    s = socket.create_connection(("127.0.0.1", board.port))
    s.sendall(struct.pack("!i", 0))       # only 1 of 4 ranks shows up
    time.sleep(0.05)
    t0 = time.time()
    board.shutdown()
    assert time.time() - t0 < 5.0
    assert not board.is_alive()
    s.close()
