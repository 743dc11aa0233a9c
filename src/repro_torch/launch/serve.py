"""Serving entrypoint: batched generate over the port's ServeEngine, with
optional service snapshots after each round.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --batch 4 --prompt-len 128 --new-tokens 32 --snapshot-dir /tmp/svc

On CUDA it selects the "flash" attention backend: the hand-written kernel
is the reference's serving/prefill fast path (``repro.kernels.ops``), and
without it every prompt would go through the chunked plain-torch path.
The kernel takes prompts whose length is a multiple of 128; other lengths
go to the chunked path, as in the reference.  The MoE archs take prompts
of at most 256 tokens or a multiple of 256 (``models/moe.py``'s groups);
deepseek-v2-lite's MLA never takes the flash kernel (q head dim 192, v
128).  xlstm-1.3b's mLSTM takes a prompt of at most 256 tokens or a
multiple of 256 (its chunks) and runs no kernel (no TPU kernel computes
it); whisper-tiny's requests carry the stub encoder frames (B, 1500,
d_model) and run the encoder inside the prefill, its decoder
self-attention through the flash kernel.  The weights are drawn in the
compute dtype leaf by leaf, so a 14-16 B-parameter MoE never holds its
fp32 tree beside the cast.  On CUDA
it also selects the "kernel" recurrence backend for the RG-LRU blocks
(recurrentgemma): the reference's model always runs its plain
associative scan and calls the recurrence kernel from nowhere, so
without the switch the hand-written kernel would never serve a request.  On CUDA the engine serves through
CUDA graphs, captured in the first round of each shape
(``serve/engine.py``).  After each round it prints how many times the
flash and the RG-LRU kernels were launched (graph replays included), and
with
``--snapshot-dir`` it then writes the serving state there
(``ServeEngine.snapshot_service``, step = the round) and prints
``{"snapshot": dir, "step": round}``.

``--variant`` (default ``baseline``; see ``sharding.make_variant``) and
``--model-parallel`` (default 1) build the engine's mesh,
``make_local_mesh(model=...)`` over the current world, and its sharding
rules, as the reference's CLI does.  A ``--model-parallel`` that does not
divide the world fails with the world's size; it is not clamped.  The
engine runs the sharded forward on that mesh: each rank holds its
windows of the weights and the cache.  The world is the process group
the caller started; a process that ``launch.mesh.run_world`` started
(``REPRO_WORLD_STORE`` in its environment) joins its world; any other
runs a 1-rank world.  Every rank serves; rank 0 prints the rows, each
with the round's generated tokens, whole on every rank:

  python -c "from repro_torch.launch.serve import main; main(['--arch',
      'smollm-135m', '--reduced', '--device', 'cpu', '--model-parallel',
      '2'])"            # as each of 2 ranks of launch.mesh.run_world
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_arch, reduce_for_smoke
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import make_variant
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (join_world, make_local_mesh, say,
                                     world_size)
from repro_torch.models.attention import set_attention_backend
from repro_torch.models.layers import DEFAULT_POLICY
from repro_torch.models.params import init_params
from repro_torch.models.rglru import set_recurrence_backend
from repro_torch.models.registry import get_api
from repro_torch.serve.engine import ServeEngine


def request_extras(cfg, batch: int) -> dict:
    """The inputs a request carries beside its tokens, as the reference's
    CLI makes them (ones x 0.1): whisper's stub encoder frames (B, 1500,
    d_model), a VLM's vision embeddings."""
    extras = {}
    if cfg.family == "audio":
        extras["frames"] = np.ones(
            (batch, cfg.encoder.n_frames, cfg.d_model), np.float32) * .1
    if cfg.family == "vlm":
        extras["vision_embeds"] = np.ones(
            (batch, cfg.n_vision_tokens, cfg.d_model), np.float32) * .1
    return extras


def main(argv=None) -> list:
    """Runs the rounds; prints one JSON line per round and returns them."""
    return run(argv)[0]


def run(argv=None):
    """``main``, returning the rows and the engine that served them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--snapshot-dir", default=None)
    args = ap.parse_args(argv)
    try:
        rules = make_variant(args.variant)
    except KeyError as e:
        ap.error(f"--variant {args.variant!r}: {e.args[0]}")
    if not dist.is_initialized() and "REPRO_WORLD_STORE" in os.environ:
        join_world()
    n = world_size()
    if args.model_parallel < 1 or n % args.model_parallel:
        ap.error(f"--model-parallel {args.model_parallel} does not divide "
                 f"the world of {n} rank(s)")

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        set_attention_backend("flash")
        set_recurrence_backend("kernel")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_for_smoke(cfg)
    api = get_api(cfg)
    max_seq = args.prompt_len + args.new_tokens * args.rounds + 8
    gen = torch.Generator(device=dev).manual_seed(0)
    # drawn in the compute dtype: the engine's cast is then a no-op
    params = init_params(api.param_defs(cfg, max_seq), gen, dev,
                         compute=DEFAULT_POLICY.compute)
    mesh = make_local_mesh(model=args.model_parallel, device=dev)
    eng = ServeEngine(cfg, params, max_seq=max_seq, mesh=mesh, rules=rules)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    extras = request_extras(cfg, args.batch)

    rows = []
    for r in range(args.rounds):
        ops.reset_launch_counts()
        res = eng.generate(prompts if r == 0 else res.tokens[:, -args.prompt_len:],
                           args.new_tokens, extras=extras)
        row = {"round": r, "prefill_s": res.prefill_s,
               "decode_s": res.decode_s, "tok_per_s": res.tokens_per_s,
               "flash_launches": ops.FLASH_LAUNCHES,
               "rglru_launches": ops.RGLRU_LAUNCHES,
               "tokens": res.tokens.tolist()}
        say(row)
        rows.append(row)
        if args.snapshot_dir:
            eng.snapshot_service(CheckpointManager(args.snapshot_dir), step=r)
            say({"snapshot": args.snapshot_dir, "step": r})
    return rows, eng


if __name__ == "__main__":
    main()
