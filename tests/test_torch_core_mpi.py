"""The port's proxy MPI runtime (``repro_torch.core``) against the reference
(``repro.core``): twins of tests/test_core_mpi.py on the port's MPIJob over
each thread transport (shm, inproc, tcp), the transport registry and the
batched fabric of tests/test_proxy_protocol.py, and the data-parallel rank
application of ``distributed/proxy_grad.py``.

Each program runs in both packages in this process on the same numpy
inputs; the assertions inside a program hold in both, and what the ranks
return is compared between them exactly (the applications are numpy, so
results are bit-equal, not within a tolerance)."""
import threading
import time

import numpy as np
import pytest

from repro.core import MPIJob as RJob
from repro.core.messages import DATATYPES as R_DATATYPES
from repro.core.messages import Status as RStatus
from repro.distributed import compression as r_comp
from repro.distributed.proxy_grad import make_dp_app as r_make_dp_app
from repro_torch.core import (ANY_SOURCE, ANY_TAG, TRANSPORTS, MPIJob,
                              Status, available_transports, make_transport)
from repro_torch.core.messages import DATATYPES, Envelope
from repro_torch.core.transport import (ShmTransport, Transport,
                                        register_transport)
from repro_torch.distributed import compression as t_comp
from repro_torch.distributed.proxy_grad import make_dp_app

THREAD_TRANSPORTS = ["shm", "inproc", "tcp"]


def _run(job_cls, n, step_fn, init_fn, steps, transport):
    job = job_cls(n, step_fn, init_fn, transport=transport)
    try:
        return job.run(steps, timeout=60)
    finally:
        job.stop()


def _same(a, b) -> bool:
    """Equal values, arrays bit for bit with their dtypes."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and \
            np.array_equal(a, b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


def run_both(n, step_fn, init_fn=lambda mpi: {}, steps=1, transport="shm"):
    """The program on the port's MPIJob over `transport` and on the
    reference's over shm; what the ranks return must be equal."""
    got = _run(MPIJob, n, step_fn, init_fn, steps, transport)
    want = _run(RJob, n, step_fn, init_fn, steps, "shm")
    assert _same(got, want), (got, want)
    return got


# ---------------------------------------------------------------- paper API

@pytest.mark.parametrize("transport", THREAD_TRANSPORTS)
def test_init_size_rank_type_size(transport):
    def step(mpi, st, k):
        assert mpi.Comm_size() == 3
        assert mpi.Comm_rank() == mpi.rank
        return {"int": mpi.Type_size("MPI_INT"),
                "double": mpi.Type_size("MPI_DOUBLE")}
    out = run_both(3, step, transport=transport)
    assert out[0] == {"int": 4, "double": 8}


@pytest.mark.parametrize("transport", THREAD_TRANSPORTS)
def test_send_recv_basic_and_order(transport):
    def step(mpi, st, k):
        got = []
        if mpi.rank == 0:
            for i in range(5):
                mpi.Send(np.array([i], np.int32), dest=1, tag=7)
        elif mpi.rank == 1:
            got = [mpi.Recv(source=0, tag=7) for _ in range(5)]
        return {"got": got}
    out = run_both(2, step, transport=transport)
    assert [int(v[0]) for v in out[1]["got"]] == list(range(5))


@pytest.mark.parametrize("transport", THREAD_TRANSPORTS)
def test_recv_any_source_any_tag(transport):
    def step(mpi, st, k):
        if mpi.rank == 0:
            got = set()
            for _ in range(2):
                status = Status()
                v = mpi.Recv(source=ANY_SOURCE, tag=ANY_TAG,
                             _status_out=status)
                got.add((status.source, status.tag, int(v)))
            return {"got": sorted(got)}
        mpi.Send(100 * mpi.rank, dest=0, tag=1 + 4 * mpi.rank)
        return {}
    out = run_both(3, step, transport=transport)
    assert out[0]["got"] == [(1, 5, 100), (2, 9, 200)]


@pytest.mark.parametrize("transport", THREAD_TRANSPORTS)
def test_probe_iprobe_get_count(transport):
    def step(mpi, st, k):
        if mpi.rank == 0:
            mpi.Send(np.zeros(10, np.float64), dest=1, tag=3)
            return {}
        status = mpi.Probe(source=0, tag=3)
        count = mpi.Get_count(status, "MPI_DOUBLE")
        flag, st2 = mpi.Iprobe(source=0, tag=3)
        v = mpi.Recv(source=0, tag=3)           # cache-first consumption
        flag_after, _ = mpi.Iprobe(source=0, tag=3)
        return {"count": count, "flag": flag, "st2": st2.count, "v": v,
                "flag_after": flag_after}
    out = run_both(2, step, transport=transport)
    assert out[1]["count"] == 10 and out[1]["flag"] and out[1]["st2"] == 10
    assert out[1]["v"].shape == (10,) and not out[1]["flag_after"]


def test_get_count_byte_conversion():
    assert DATATYPES == R_DATATYPES
    for dt, size in DATATYPES.items():
        for count, held in ((16, "MPI_BYTE"), (size, "MPI_BYTE"),
                            (3, "MPI_INT"), (5, "MPI_DOUBLE")):
            assert Status(count=count, dtype=held).get_count(dt) == \
                RStatus(count=count, dtype=held).get_count(dt)
    s = Status(count=16, dtype="MPI_BYTE")
    assert s.get_count("MPI_INT") == 4 and s.get_count("MPI_DOUBLE") == 2


# ------------------------------------------------------------- non-blocking

@pytest.mark.parametrize("transport", THREAD_TRANSPORTS)
def test_isend_irecv_test_wait(transport):
    def step(mpi, st, k):
        if mpi.rank == 0:
            req = mpi.Isend(np.arange(4), dest=1, tag=1)
            done, _ = mpi.Test(req)
            return {"done": done}                # buffered semantics
        req = mpi.Irecv(source=0, tag=1)
        return {"v": mpi.Wait(req)}
    out = run_both(2, step, transport=transport)
    assert out[0]["done"] and np.array_equal(out[1]["v"], np.arange(4))


# -------------------------------------------------------------- collectives

@pytest.mark.parametrize("transport", THREAD_TRANSPORTS)
@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_barrier_and_bcast(n, transport):
    def step(mpi, st, k):
        mpi.Barrier()
        v = mpi.Bcast(np.arange(6) if mpi.Comm_rank() == 0 else None, root=0)
        v2 = mpi.Bcast("hello" if mpi.Comm_rank() == 2 % n else None,
                       root=2 % n)
        return {"v": v, "v2": v2}
    out = run_both(n, step, transport=transport)
    assert all(np.array_equal(o["v"], np.arange(6)) and o["v2"] == "hello"
               for o in out)


@pytest.mark.parametrize("transport", THREAD_TRANSPORTS)
@pytest.mark.parametrize("n", [2, 4])
def test_scatter_gather_allgather(n, transport):
    def step(mpi, st, k):
        me = mpi.Comm_rank()
        return {"mine": mpi.Scatter([10 * i for i in range(n)]
                                    if me == 0 else None),
                "gather": mpi.Gather(me * me, root=1),
                "allgather": mpi.Allgather(me + 1)}
    out = run_both(n, step, transport=transport)
    for me, o in enumerate(out):
        assert o["mine"] == 10 * me
        assert o["gather"] == ([i * i for i in range(n)] if me == 1 else None)
        assert o["allgather"] == [i + 1 for i in range(n)]


@pytest.mark.parametrize("transport", THREAD_TRANSPORTS)
@pytest.mark.parametrize("n,op,expect", [
    (3, "sum", 0 + 1 + 2), (3, "max", 2), (4, "min", 0), (3, "prod", 0),
])
def test_reduce_ops(n, op, expect, transport):
    def step(mpi, st, k):
        return {"out": mpi.Reduce(np.float64(mpi.Comm_rank()), op=op,
                                  root=0)}
    out = run_both(n, step, transport=transport)
    assert out[0]["out"] == expect


@pytest.mark.parametrize("transport", THREAD_TRANSPORTS)
@pytest.mark.parametrize("n", [2, 3, 4])
def test_allreduce_ring_matches_numpy(n, transport):
    def step(mpi, st, k):
        rng = np.random.default_rng(mpi.Comm_rank())
        x = rng.standard_normal(17)                         # size % n != 0
        return {"x": x, "ring": mpi.Allreduce(x, "sum", algo="ring"),
                "tree": mpi.Allreduce(x, "sum", algo="tree")}
    out = run_both(n, step, transport=transport)
    expect = np.sum([o["x"] for o in out], axis=0)
    for o in out:
        assert np.allclose(o["ring"], expect)
        assert np.allclose(o["tree"], expect)


# ---------------------------------------------------- communicators / groups

@pytest.mark.parametrize("transport", THREAD_TRANSPORTS)
def test_comm_split_subcommunication(transport):
    def step(mpi, st, k):
        me = mpi.Comm_rank()
        sub = mpi.Comm_split(color=me % 2, key=me)
        out = {"size": mpi.Comm_size(sub),
               "tot": mpi.Allreduce(np.float64(me), "sum", comm=sub)}
        mpi.Comm_free(sub)
        return out
    out = run_both(4, step, transport=transport)
    assert [o["tot"] for o in out] == [2.0, 4.0, 2.0, 4.0]
    assert all(o["size"] == 2 for o in out)


@pytest.mark.parametrize("transport", THREAD_TRANSPORTS)
def test_group_incl_comm_create_group(transport):
    def step(mpi, st, k):
        g = mpi.Comm_group()
        sub_g = mpi.Group_incl(g, [0, 2])
        sub = mpi.Comm_create_group(sub_g)
        out = {"member": sub is not None}
        if sub is not None:
            out["size"] = mpi.Comm_size(sub)
            out["v"] = mpi.Bcast(42 if mpi.Comm_rank(sub) == 0 else None,
                                 root=0, comm=sub)
        mpi.Group_free(sub_g)
        return out
    out = run_both(3, step, transport=transport)
    assert [o["member"] for o in out] == [True, False, True]
    assert out[0]["v"] == out[2]["v"] == 42 and out[2]["size"] == 2


# ------------------------------------------------ registry & transport fabric

def test_transport_registry_lists_and_rejects():
    """The thread transports and the process world's "proc" and "shmring",
    as the reference registers them."""
    from repro.core import available_transports as r_available
    assert set(available_transports()) == {"shm", "tcp", "inproc", "proc",
                                           "shmring"}
    assert sorted(available_transports()) == sorted(r_available())
    with pytest.raises(ValueError, match="unknown transport"):
        make_transport("infiniband")


def test_transport_registry_accepts_plugins():
    class LoopbackTransport(ShmTransport):
        name = "loopback-test"

    try:
        register_transport(LoopbackTransport)
        assert isinstance(make_transport("loopback-test"), LoopbackTransport)
    finally:
        TRANSPORTS.pop("loopback-test", None)


def test_register_transport_requires_concrete_name():
    with pytest.raises(ValueError):
        register_transport(Transport)


@pytest.mark.parametrize("name", THREAD_TRANSPORTS)
def test_send_many_poll_all_fabric(name):
    tr = make_transport(name)
    tr.start(2)
    try:
        envs = [Envelope(src=0, dst=1, tag=3, comm_vid=0, seq=i,
                         payload=bytes([i]), dtype="MPI_BYTE", count=1)
                for i in range(10)]
        tr.send_many(envs)
        got = []
        deadline = time.time() + 10
        while len(got) < 10 and time.time() < deadline:
            got.extend(tr.poll_all(1))
        assert [e.seq for e in got] == list(range(10))
        assert [e.payload for e in got] == [bytes([i]) for i in range(10)]
    finally:
        tr.stop()


@pytest.mark.parametrize("name", THREAD_TRANSPORTS)
def test_poll_wait_blocks_then_returns_batch(name):
    tr = make_transport(name)
    tr.start(2)
    try:
        t0 = time.perf_counter()
        assert tr.poll_wait(1, 0.05) == []          # honest timeout
        assert time.perf_counter() - t0 >= 0.04
        env = Envelope(src=0, dst=1, tag=0, comm_vid=0, seq=0, payload=b"hi")
        threading.Timer(0.02, lambda: tr.send(env)).start()
        got = tr.poll_wait(1, 5.0)                  # wakes on arrival
        assert [e.payload for e in got] == [b"hi"]
    finally:
        tr.stop()


@pytest.mark.parametrize("transport", ["proc", "shmring"])
def test_process_world_transports_match_the_thread_world(transport):
    """Every rank a forked OS process behind a socket proxy endpoint (and
    with "shmring" the tensors of 256 KiB and more through the
    shared-memory ring): point to point, collectives of both algorithms
    and a split communicator give what the port's thread world and the
    reference's give, bit for bit; the processes exit 0 and are reaped."""
    def step(mpi, st, k):
        me, n = mpi.Comm_rank(), mpi.Comm_size()
        x = np.random.default_rng(me + 10 * k).standard_normal(1 << 16)
        got = mpi.Sendrecv(x, (me + 1) % n, 3, (me - 1) % n, 3)
        sub = mpi.Comm_split(color=me % 2, key=me)
        out = {"got": got, "ring": mpi.Allreduce(x, "sum", algo="ring"),
               "tree": mpi.Allreduce(x[:17], "max", algo="tree"),
               "bcast": mpi.Bcast(np.arange(5) if me == 0 else None, 0),
               "sub": mpi.Allreduce(np.float64(me), "sum", comm=sub)}
        mpi.Comm_free(sub)
        return out
    job = MPIJob(4, step, lambda mpi: {}, transport=transport)
    try:
        got = job.run(2, timeout=60)
        assert set(job._proc.exit_codes.values()) == {0}
    finally:
        job.stop()
    assert not any(p.is_alive() for p in job._proc._procs.values())
    assert _same(got, _run(MPIJob, 4, step, lambda mpi: {}, 2, "shm"))
    assert _same(got, _run(RJob, 4, step, lambda mpi: {}, 2, "shm"))


@pytest.mark.parametrize("transport", THREAD_TRANSPORTS)
def test_job_stop_joins_all_threads(transport):
    def step(mpi, st, k):
        mpi.Barrier()
        return st

    job = MPIJob(3, step, lambda mpi: {}, transport=transport)
    job.run(2, timeout=60)
    job.stop()
    for p in job.proxies:
        assert not p.is_alive(), "stop() must join proxy threads"
        assert p.channel.closed
    if transport == "tcp":
        assert not job.transport.board.is_alive()
        assert not any(t.is_alive() for t in job.transport._readers)


# ------------------------------------------------ the rank application

@pytest.mark.parametrize("compress", [False, True])
def test_dp_app_bit_equal_to_reference(compress):
    """The port's make_dp_app and the reference's, same seed, four ranks,
    the same number of steps: bit-equal params, losses and (compressed)
    error-feedback residuals."""
    kw = dict(din=16, dh=32, dout=4, batch_per_rank=8, seed=3,
              compress=compress)
    got = _run(MPIJob, 4, *reversed(make_dp_app(**kw)), 6, "shm")
    want = _run(RJob, 4, *reversed(r_make_dp_app(**kw)), 6, "shm")
    assert _same(got, want)
    assert all(_same(got[0]["params"], o["params"]) for o in got)
    assert np.isfinite(got[0]["loss"])


def test_compression_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((33, 17)).astype(np.float32)
    q, s, shape = t_comp.quantize_int8(x)
    rq, rs, rshape = r_comp.quantize_int8(x)
    assert _same((q, s, shape), (rq, rs, rshape))
    assert _same(t_comp.dequantize_int8(q, s, shape),
                 r_comp.dequantize_int8(rq, rs, rshape))
    ef, ref = t_comp.ErrorFeedback(), r_comp.ErrorFeedback()
    for step in range(3):
        g = rng.standard_normal(300).astype(np.float32) * (step + 1)
        assert _same(ef.compress("g", g), ref.compress("g", g))
    assert _same(ef.snapshot(), ref.snapshot())


def test_tcp_transport_same_semantics():
    def step(mpi, st, k):
        if mpi.rank == 0:
            mpi.Send(np.arange(3), dest=1, tag=2)
            got = None
        else:
            got = mpi.Recv(source=0, tag=2)
            assert np.array_equal(got, np.arange(3))
        gathered = mpi.Allgather(mpi.rank)
        assert gathered == [0, 1]
        return {"got": got, "gathered": gathered}
    run_both(2, step, transport="tcp")
