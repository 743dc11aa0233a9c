"""End-to-end behaviour of the port: it trains (the loss falls) and the
paper's full C/R story composes: train, checkpoint asynchronously, restart
elsewhere, continue identically.  Twins of tests/test_system.py; the
training one runs the port's own loop on a 1-rank CPU ``DeviceMesh``
where the reference's runs JAX on a ``Mesh``."""
import numpy as np
import pytest
import torch

from repro.core import MPIJob as RJob
from repro.distributed.proxy_grad import make_dp_app as r_make_dp_app
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.core import MPIJob
from repro_torch.distributed.proxy_grad import make_dp_app
from repro_torch.distributed.sharding import make_variant
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.train.loop import train


@pytest.fixture
def one_thread():
    """One intra-op thread: beside the suite's other workers, idle OpenMP
    threads spinning at every op's barrier slow a training loop of tiny
    ops severalfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_jax_training_loss_decreases(one_thread):
    cfg = reduce_for_smoke(ARCHS["smollm-135m"])
    res = train(cfg, make_local_mesh(device="cpu"), make_variant("baseline"),
                n_steps=25, global_batch=8, seq_len=32, log_every=1,
                base_lr=3e-3, warmup=3, seed=0, device="cpu")
    first, last = res.losses[0], np.mean(res.losses[-3:])
    assert len(res.losses) == 25 and np.all(np.isfinite(res.losses))
    assert last < first - 0.1, (first, last)


def test_full_story_proxy_ckpt_to_other_transport(tmp_path):
    """Train DP over proxies, checkpoint asynchronously mid-run, kill,
    restart on the other "MPI implementation" (tcp), in the port and in the
    reference: the final params equal the reference's uninterrupted run,
    bit for bit."""
    n, steps = 4, 14
    r_init, r_step = r_make_dp_app(lr=0.03)
    ref = RJob(n, r_step, r_init)
    want = ref.run(steps, timeout=120)
    ref.stop()

    init_fn, step_fn = make_dp_app(lr=0.03)
    job = MPIJob(n, step_fn, init_fn, transport="shm")
    job.checkpoint_at(8, tmp_path / "ck", resume=False)
    job.run(steps, timeout=120)
    job.stop()

    for cls in (MPIJob, RJob):
        job2 = cls.restart(tmp_path / "ck", step_fn, init_fn, transport="tcp")
        got = job2.run(steps, timeout=120)
        job2.stop()
        for r in range(n):
            for k in want[r]["params"]:
                assert np.array_equal(got[r]["params"][k],
                                      want[r]["params"][k]), (cls, r, k)
