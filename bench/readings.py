"""The readings that a cell's limits are set from: for each seed, the
compared numbers of the program and of the control (the reference in
float8, in the program's place), or of the program with a fault planted.
Several seeds in one process, one JSON line a seed.

  python3 bench/readings.py --workload <cell> --seeds 1,2,3 [--seconds 3]
      [--fault unchanged|half_batch|token] [--no-control]

Needs CUDA, as a benchmark run does.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(Path(__file__).resolve().parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    import shutil
    import tempfile

    import torch

    import harness
    cell = harness.load_cell(ROOT, args.workload)
    traffic = harness.generator(cell)
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        tmp = Path(tempfile.mkdtemp(prefix="bench-readings-"))
        run = harness.Run(cell, seed, args.seconds, False, dev, tmp,
                          time.perf_counter(), harness.Tracer(False, dev),
                          args.fault)
        t0 = time.perf_counter()
        try:
            out = traffic.readings(run, control=not args.no_control)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, "s": time.perf_counter() - t0,
                          **out}), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
