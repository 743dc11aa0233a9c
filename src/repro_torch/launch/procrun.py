"""CLI: drive a data-parallel training job on the PROCESS world.

The smallest end-to-end demonstration of DESIGN.md §10: every rank is a
real OS process behind a socket proxy endpoint, checkpoints are written by
the children into a shared content-addressed store, and (optionally) a
rank is SIGKILLed mid-run so the fault-tolerant driver proves the
detect -> bump -> abort -> reshaped-restart loop on real PIDs.  Nothing
here touches a device, and nothing a rank child runs imports ``torch``.

    PYTHONPATH=src python -m repro_torch.launch.procrun --ranks 4 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.procrun --ranks 4 --steps 20 \
        --kill-rank 2 --kill-step 8          # real SIGKILL, auto-recovery
"""
from __future__ import annotations

import argparse
import os
import signal
import tempfile
from pathlib import Path

from repro_torch.core import MPIJob
from repro_torch.distributed.faults import FaultTolerantDriver
from repro_torch.distributed.proxy_grad import make_dp_app


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--ckpt-root", default=None,
                    help="checkpoint root (default: a fresh temp dir)")
    ap.add_argument("--kill-rank", type=int, default=None,
                    help="SIGKILL this rank's process at --kill-step")
    ap.add_argument("--kill-step", type=int, default=None)
    args = ap.parse_args(argv)

    root = Path(args.ckpt_root or tempfile.mkdtemp(prefix="procrun-"))
    init_fn, dp_step = make_dp_app()
    kill_rank, kill_step = args.kill_rank, args.kill_step

    def step_fn(mpi, st, k):
        if (kill_rank is not None and mpi.generation == 0
                and k == (kill_step if kill_step is not None else 0)
                and mpi.rank == kill_rank):
            print(f"[procrun] rank {mpi.rank} (pid {os.getpid()}) "
                  f"SIGKILLing itself at step {k}")
            os.kill(os.getpid(), signal.SIGKILL)
        return dp_step(mpi, st, k)

    driver = FaultTolerantDriver(
        job_factory=lambda ws, ms: MPIJob(
            ws or args.ranks, step_fn, init_fn, transport="proc",
            membership=ms),
        restart_factory=lambda d, tr, ws, dead, ms: MPIJob.restart(
            d, step_fn, init_fn, transport="proc", world_size=ws,
            dead_ranks=dead, membership=ms),
        ckpt_root=root, ckpt_every=args.ckpt_every)
    out = driver.run(args.steps, transport_after_failure="proc")
    print(f"[procrun] done: world={len(out)} "
          f"generation={driver.membership.generation} "
          f"loss={out[0].get('loss'):.6f} ckpts={root}")
    for ev in driver.events:
        print(f"[procrun]   {ev}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
