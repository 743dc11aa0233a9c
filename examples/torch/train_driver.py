"""End-to-end training driver on the PyTorch port: train an assigned
architecture with the fault-tolerant loop (async checkpoints, auto-resume,
deterministic data).

The twin of examples/train_driver.py, on ``repro_torch`` alone, flag for
flag, with ``--device`` beside them: the card unless ``--device cpu``.  On
CUDA it selects the flash attention backend, as the train CLI does
(``repro_torch.launch.train``), and each step replays one CUDA graph.

  # ~100M-param SmolLM-135M, short demo schedule:
  PYTHONPATH=src python examples/torch/train_driver.py --arch smollm-135m \
      --steps 300 --batch 8 --seq 128 --preset full

  # fast demo (reduced config):
  PYTHONPATH=src python examples/torch/train_driver.py --steps 40 --preset tiny

  # crash/recovery demo: first invocation dies at step 25, second resumes
  PYTHONPATH=src python examples/torch/train_driver.py --steps 40 \
      --preset tiny --ckpt-dir /tmp/ck --kill-at 25
  PYTHONPATH=src python examples/torch/train_driver.py --steps 40 \
      --preset tiny --ckpt-dir /tmp/ck
"""
import argparse
import time

from repro_torch.configs import ARCHS, get_arch, reduce_for_smoke
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import make_variant
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.attention import set_attention_backend
from repro_torch.train.loop import train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=sorted(ARCHS))
    ap.add_argument("--preset", default="tiny", choices=("tiny", "full"))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--kill-at", type=int, default=None)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        set_attention_backend("flash")
    cfg = get_arch(args.arch)
    if args.preset == "tiny":
        cfg = reduce_for_smoke(cfg)
    print(f"arch={cfg.name} ({cfg.n_params()/1e6:.1f}M params) "
          f"steps={args.steps} batch={args.batch} seq={args.seq}")

    mesh = make_local_mesh(device=dev)
    rules = make_variant(args.variant)
    t0 = time.time()
    try:
        res = train(cfg, mesh, rules, n_steps=args.steps,
                    global_batch=args.batch, seq_len=args.seq,
                    base_lr=args.lr, ckpt_root=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, log_every=5,
                    fail_at_step=args.kill_at, seed=0)
    except RuntimeError as e:
        print(f"CRASHED (as requested): {e} — rerun to auto-resume")
        raise SystemExit(0)
    tok_s = args.steps * args.batch * args.seq / res.wall_s
    print(f"losses: {['%.4f' % l for l in res.losses[:3]]} ... "
          f"{['%.4f' % l for l in res.losses[-3:]]}")
    if res.resumed_from is not None:
        print(f"auto-resumed from checkpoint at step {res.resumed_from}")
    print(f"done in {time.time()-t0:.1f}s ({tok_s:.0f} tok/s); "
          f"ckpt stats: {res.ckpt_stats}")


if __name__ == "__main__":
    main()
