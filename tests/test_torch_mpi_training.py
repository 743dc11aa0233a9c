"""The paper's protocol driving the port's data-parallel training
(``repro_torch.distributed.proxy_grad``): twins of
tests/test_mpi_training.py (its driver case is
tests/test_torch_fault_driver.py::test_fault_tolerant_driver_recovers).

Ring-allreduced gradients through the proxies, a checkpoint mid-run and a
restart on the other transport continue bit for bit, whichever package
wrote the checkpoint and whichever restarts it; replicas stay in sync;
the loss falls; the straggler tracker flags the slow rank as the
reference's does."""
import numpy as np
import pytest

from repro.core import MPIJob as RJob
from repro.distributed.faults import StragglerTracker as RStragglerTracker
from repro.distributed.proxy_grad import make_dp_app as r_make_dp_app
from repro_torch.core import MPIJob
from repro_torch.distributed.faults import StragglerTracker
from repro_torch.distributed.proxy_grad import make_dp_app

PKG = {"port": (MPIJob, make_dp_app), "ref": (RJob, r_make_dp_app)}


def _params_equal(a, b):
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def _run(job_cls, n, init_fn, step_fn, steps):
    job = job_cls(n, step_fn, init_fn)
    try:
        return job.run(steps, timeout=120)
    finally:
        job.stop()


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "ref"),
                                           ("ref", "port")])
@pytest.mark.parametrize("compress", [False, True])
def test_dp_training_ckpt_restart_bitwise(tmp_path, compress, writer,
                                          reader):
    """Checkpointed at step 6 of 12 by the writer's world (which exits
    there), restarted on tcp by the reader's: every rank's params and loss
    equal the reference's uninterrupted run, bit for bit."""
    n, steps = 4, 12
    ref = _run(RJob, n, *r_make_dp_app(compress=compress), steps)
    assert ref[0]["loss"] < 3.0

    w_cls, w_app = PKG[writer]
    init_fn, step_fn = w_app(compress=compress)
    job = w_cls(n, step_fn, init_fn)
    job.checkpoint_at(6, tmp_path / "ck", resume=False)
    job.run(steps, timeout=120)
    job.stop()
    r_cls, r_app = PKG[reader]
    init_fn, step_fn = r_app(compress=compress)
    job2 = r_cls.restart(tmp_path / "ck", step_fn, init_fn, transport="tcp")
    out = job2.run(steps, timeout=120)
    job2.stop()
    for r in range(n):
        assert _params_equal(out[r]["params"], ref[r]["params"])
        assert out[r]["loss"] == ref[r]["loss"]


def test_dp_replicas_stay_in_sync():
    n = 3
    out = _run(MPIJob, n, *make_dp_app(), 8)
    for r in range(1, n):
        assert _params_equal(out[0]["params"], out[r]["params"])
    ref = _run(RJob, n, *r_make_dp_app(), 8)
    assert _params_equal(out[0]["params"], ref[0]["params"])


def test_loss_decreases():
    init_fn, step_fn = make_dp_app(lr=0.05)
    out = _run(MPIJob, 2, init_fn, step_fn, 30)
    out2 = _run(MPIJob, 2, init_fn, step_fn, 2)
    assert out[0]["loss"] < out2[0]["loss"] * 0.5
    assert out[0]["loss"] == _run(RJob, 2, *r_make_dp_app(lr=0.05),
                                  30)[0]["loss"]


def test_straggler_tracker():
    trackers = (StragglerTracker(4, factor=3.0),
                RStragglerTracker(4, factor=3.0))
    for t in trackers:
        for r in range(3):
            t.record(r, 0.10)
        t.record(3, 1.0)
    assert trackers[0].stragglers() == trackers[1].stragglers() == [3]
    for t in trackers:
        t.record(3, 0.1)
        t.record(3, 0.1)
    t = trackers[0]
    assert 3 not in t.stragglers() or t.dur[3] > 0.3
    assert t.stragglers() == trackers[1].stragglers()
    assert t.dur == trackers[1].dur
