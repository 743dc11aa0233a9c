"""Runs one cell of the port's benchmark and prints its result line.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix
and metrics are named in ``BENCHMARK.json``; the program measured is
``src/repro_torch``.  The run needs CUDA and as many cards as the cell
asks for: without them it exits 2 and prints no result.  With
``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from a profiled slice of the
window.  The last line of standard output is the result (JSON); the
compared numbers, each with its limit, end standard error.

``--control 1`` puts the fp8 control (the plain reference one precision
below the configuration's) in the program's place in the check, to show
that the check fails it: such a run has to read ``correct`` false.  The
benchmark's own runs leave it at 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(Path(__file__).resolve().parent)]
# every cache the program could write stays at a fixed path in the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import harness
    cell = harness.load_cell(ROOT, args.workload)
    import torch
    need = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START,
                              control=bool(args.control))
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
