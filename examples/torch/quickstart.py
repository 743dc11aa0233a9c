"""Quickstart on the PyTorch port: the paper in 60 seconds.

The twin of examples/quickstart.py, on ``repro_torch`` alone.  Four MPI
ranks train a data-parallel model whose gradient allreduce rides
MPI_Send/MPI_Recv through per-rank PROXIES.  Mid-run we checkpoint
asynchronously (network drained, in-flight gradient chunks cached), kill
the job, and restart it ON A DIFFERENT MPI IMPLEMENTATION (tcp sockets
instead of shared-memory queues).  Final parameters are bitwise identical
to an uninterrupted run.

The ranks compute in numpy, as the reference's do (``make_dp_app``); the
final parameters of both runs are then placed on ``--device`` as torch
tensors and compared there, bit for bit.  The card unless ``--device cpu``:

  PYTHONPATH=src python examples/torch/quickstart.py
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""
import argparse
import tempfile
from pathlib import Path

import torch

from repro_torch.core import MPIJob
from repro_torch.device import resolve_device
from repro_torch.distributed.proxy_grad import make_dp_app

N_RANKS, STEPS, CKPT_AT = 4, 16, 9


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    init_fn, step_fn = make_dp_app(lr=0.05)

    print(f"[1/3] uninterrupted reference run ({STEPS} steps, shm)")
    ref_job = MPIJob(N_RANKS, step_fn, init_fn, transport="shm")
    ref = ref_job.run(STEPS)
    ref_job.stop()
    print(f"      final loss {ref[0]['loss']:.5f}")

    with tempfile.TemporaryDirectory() as d:
        ck = Path(d) / "ckpt"
        print(f"[2/3] same run, checkpoint+exit at step {CKPT_AT} (shm)")
        job = MPIJob(N_RANKS, step_fn, init_fn, transport="shm")
        job.checkpoint_at(CKPT_AT, ck, resume=False)
        job.run(STEPS)
        job.stop()
        stats = job.coord.stats
        print(f"      drained {stats['drained_messages']} in-flight messages "
              f"in {stats['drain_wall_s']*1e3:.1f} ms")

        print("[3/3] restart from the checkpoint on TCP sockets")
        job2 = MPIJob.restart(ck, step_fn, init_fn, transport="tcp")
        out = job2.run(STEPS)
        job2.stop()

    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    same = all(torch.equal(on_dev(out[r]["params"][k]),
                           on_dev(ref[r]["params"][k]))
               for r in range(N_RANKS) for k in ref[r]["params"])
    print(f"      final loss {out[0]['loss']:.5f}")
    print(f"RESULT: cross-implementation restart bitwise identical: {same}")
    assert same


if __name__ == "__main__":
    main()
