"""Batched serving demo on the PyTorch port: prefill + KV-cache decode,
with the serving state checkpointed mid-generation (a service can be
drained, snapshotted and moved — the paper's claim applied to inference).

The twin of examples/serve_batched.py, on ``repro_torch`` alone, flag for
flag, with ``--device`` beside them: the card unless ``--device cpu``.  On
CUDA it selects the flash attention and the RG-LRU kernel backends, as the
serve CLI does (``repro_torch.launch.serve``), and the engine serves
through CUDA graphs.

  PYTHONPATH=src python examples/torch/serve_batched.py --arch yi-9b --batch 4
"""
import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_arch, reduce_for_smoke
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import make_variant
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.serve import request_extras
from repro_torch.models.attention import set_attention_backend
from repro_torch.models.params import init_params
from repro_torch.models.registry import get_api
from repro_torch.models.rglru import set_recurrence_backend
from repro_torch.serve.engine import ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        set_attention_backend("flash")
        set_recurrence_backend("kernel")
    cfg = reduce_for_smoke(get_arch(args.arch))
    api = get_api(cfg)
    max_seq = args.prompt_len + args.new_tokens + 8
    params = init_params(api.param_defs(cfg, max_seq),
                         torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServeEngine(cfg, params, max_seq=max_seq,
                      mesh=make_local_mesh(device=dev),
                      rules=make_variant("baseline"))

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    extras = request_extras(cfg, args.batch)

    res = eng.generate(prompts, args.new_tokens, extras=extras)
    print(f"arch={cfg.name} batch={args.batch}: prefill {res.prefill_s*1e3:.0f}ms, "
          f"decode {res.decode_s*1e3:.0f}ms "
          f"({res.tokens_per_s:.0f} tok/s), out shape {res.tokens.shape}")
    print("first sequence:", res.tokens[0][:12], "...")

    with tempfile.TemporaryDirectory() as d:
        eng.snapshot_service(CheckpointManager(Path(d) / "svc"), step=1)
        n_files = len(list((Path(d) / "svc" / "step_0000000001").iterdir()))
        print(f"serving state checkpointed mid-generation ({n_files} files) "
              f"— cache+positions are a pure pytree, restorable on any mesh")


if __name__ == "__main__":
    main()
