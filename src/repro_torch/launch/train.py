"""Training entrypoint (torch twin of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 200 --batch 8 --seq 2048 --ckpt-dir /data/ck

Runs on CUDA unless ``--device cpu`` is given.  On CUDA it selects the
"flash" attention backend, as the serve CLI does: the reference's backend
defaults to "chunked" and its train CLI never switches it, so without the
switch the card would train through no kernel.  The forward then runs the
hand-written kernel (once a layer, and again in the remat recompute), and
the backward autograd through its plain version, as the reference's
custom_vjp.  The recurrence backend stays "scan", the differentiable plain
version (the RG-LRU kernel has no backward, in either package).  On CUDA
each step is the replay of one CUDA graph that holds the whole step (the
microbatches' forwards, the backward, the clip and AdamW) and writes the
new TrainState into the old one's tensors, the counterpart of the
reference's jitted, state-donating step (``train/step.py::
GraphedTrainStep``); its first step runs eagerly and is then captured.
On the CPU each step is the pure, eager step.
Auto-resumes from the newest valid checkpoint in ``--ckpt-dir``, written
by either package.  Prints the reference's two JSON lines.
``--variant`` and ``--model-parallel`` wait for the port's multi-device
layouts (ROADMAP.md, Queue 1, item 6).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import ARCHS, get_arch, reduce_for_smoke
from repro_torch.configs.base import ShapeCfg
from repro_torch.device import resolve_device
from repro_torch.models.attention import set_attention_backend
from repro_torch.train.loop import train
from repro_torch.train.step import default_accum


def main(argv=None) -> dict:
    """Trains; prints the two JSON lines and returns the second."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        set_attention_backend("flash")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_for_smoke(cfg)
    shape = ShapeCfg("cli", "train", args.seq, args.batch)
    accum = args.accum if args.accum is not None else default_accum(cfg, shape)

    print(json.dumps({"arch": cfg.name, "params_m": cfg.n_params() / 1e6,
                      "mesh": {"data": 1, "model": 1}, "variant": "baseline",
                      "accum": accum, "steps": args.steps,
                      "device": str(dev)}))
    res = train(cfg, n_steps=args.steps, global_batch=args.batch,
                seq_len=args.seq, base_lr=args.lr, warmup=args.warmup,
                accum_steps=accum, ckpt_root=args.ckpt_dir,
                ckpt_every=args.ckpt_every, keep=args.keep, seed=args.seed,
                log_every=10, device=dev)
    row = {"resumed_from": res.resumed_from,
           "steps_run": res.steps_run,
           "first_loss": res.losses[0] if res.losses else None,
           "final_loss": res.losses[-1] if res.losses else None,
           "wall_s": round(res.wall_s, 1),
           "ckpt_stats": res.ckpt_stats}
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
