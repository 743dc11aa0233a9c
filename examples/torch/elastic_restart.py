"""Elastic / cross-topology restart on the PyTorch port: train on a 2-rank
mesh, checkpoint, then RESUME THE SAME CHECKPOINT on 4 ranks and on 1 —
the paper's "checkpoint on MPICH, restart on OpenMPI" at the tensor level
(DESIGN.md §2).

The twin of examples/elastic_restart.py, on ``repro_torch`` alone.  The 2-
and 4-rank worlds are CPU gloo worlds, one process a rank
(``launch.mesh.run_world``); the last resume runs on the 1-rank mesh of
``--device``, the card unless ``--device cpu``:

  PYTHONPATH=src python examples/torch/elastic_restart.py
  PYTHONPATH=src python examples/torch/elastic_restart.py --device cpu
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

from repro_torch.launch.mesh import run_world

SNIPPET = r"""
import json, os, sys
import torch
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.distributed.sharding import make_variant
from repro_torch.launch.mesh import join_world, make_local_mesh, world_size
from repro_torch.train.loop import train

args = json.loads(sys.argv[1])
if args["ranks"] > 1:
    torch.set_num_threads(1)           # the ranks share the host's cores
    join_world()
cfg = reduce_for_smoke(ARCHS["smollm-135m"])
mesh = make_local_mesh(model=args["model"], device=args["device"])
res = train(cfg, mesh, make_variant("baseline"), n_steps=args["steps"],
            global_batch=8, seq_len=32, log_every=1, seed=3,
            ckpt_root=args["root"], ckpt_every=args["every"])
print(json.dumps({"devices": world_size(),
                  "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                  "resumed_from": res.resumed_from,
                  "losses": res.losses[-3:]}))
"""


def run(ranks: int, model: int, steps: int, root: str, device: str,
        every: int = 5) -> dict:
    args = json.dumps({"ranks": ranks, "model": model, "steps": steps,
                       "root": root, "every": every, "device": device})
    code = f"import sys; sys.argv[1:] = [{args!r}]\n" + SNIPPET
    env = {**os.environ, "PYTHONPATH": "src"}
    if ranks > 1:
        try:
            out = run_world(ranks, code, timeout_s=900, env=env)[0]
        except RuntimeError as e:
            print(str(e)[-2000:])
            raise SystemExit(1)
    else:
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=900, env=env)
        if r.returncode != 0:
            print(r.stderr[-2000:])
            raise SystemExit(1)
        out = r.stdout
    return json.loads(out.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        root = str(Path(d) / "ck")
        print("[1/3] train 10 steps on a (1,2) mesh (2 ranks), ckpt@10")
        a = run(2, 2, 10, root, "cpu", every=5)
        print("      ", a)
        print("[2/3] resume the SAME checkpoint on (2,2) mesh (4 ranks)")
        b = run(4, 2, 20, root, "cpu", every=5)
        print("      ", b)
        assert b["resumed_from"] == 10, b
        print(f"[3/3] resume again on a SINGLE rank ({args.device})")
        c = run(1, 1, 22, root, args.device, every=50)
        print("      ", c)
        assert c["resumed_from"] == 20, c
    print("RESULT: one checkpoint, three topologies (2 -> 4 -> 1 devices) — "
          "cross-implementation restart works")


if __name__ == "__main__":
    main()
