#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (written for an H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the ``repro`` package.  Phases,
one JSON line each; any failure exits non-zero:

  build          compile the three kernel libraries from
                 src/repro_torch/kernels/csrc into build/repro_torch_kernels,
                 one nvcc each, all at once; print registers, spills and
                 static shared memory of every kernel instantiation (ptxas),
                 the RG-LRU kernel's apart, and fail if a flash kernel
                 instantiation (fp32 or bf16, each head dim) spills
  kernels        each kernel through kernels/ops.py on CUDA against its plain
                 version on the same CUDA tensors: flash attention over the
                 sweep of tests/test_kernels.py, constant V, the shapes of
                 both serving paths, bf16 cases that stress the tensor-core
                 tiling and fp32 cases that stress the CUDA-core tiling, and
                 its tile table against the library's; the
                 RG-LRU scan over its sweep, cases that stress its tiles and
                 carry (RGLRU_STRESS), the shapes of both hybrid paths,
                 linearity; int8
                 quantize/dequantize codes (bit-exact) and scales, the
                 half-step bound and idempotence
  serve-parity   full-width smollm-135m (seeded random weights), fp32, B=2,
                 prompt 128: 30 flash launches for the prefill; flash vs
                 chunked block by block at full depth, and logits and greedy
                 tokens end to end at a 2-layer cut
  serve          the repro_torch.launch.serve path, smollm-135m at full
                 width, bf16, B=4, prompt 128, 32 new tokens: a main path,
                 its launch count; with --snapshot-dir, and the serving
                 snapshot it writes validates and lists the payload's leaves.
                 The engine serves through CUDA graphs, captured in that
                 round (capture_s); then on the same engine a second
                 request of the same shape (its prefill_s, decode_s, and
                 launches through the replays, nothing captured again),
                 both requests' tokens and last-step logits bit-equal to
                 the same requests run uncaptured (timed: the numbers
                 before capture), one decode step and one prefill under
                 the profiler both ways, peak memory
  checkpoint     full-width smollm-135m's fp32 params on the card through
                 CheckpointManager: save, wait, restore onto the card,
                 bit-equal leaves; an unchanged re-save writes 0 bytes; the
                 stage times, bytes and codec
  elastic        full-width smollm-135m's fp32 params (seed 0, a CPU
                 generator): a 4-rank CPU gloo world (child processes)
                 lays them out on a (2, 2) (data, model) mesh by
                 DEFAULT_RULES and saves them across its ranks (each
                 window once: the windows per leaf, save seconds and bytes
                 per rank); elastic_restore onto this process's 1-rank
                 mesh on the card, every leaf bit-equal to the same tree
                 built here, the manifest's source world 4 devices,
                 restore_s beside the plain restore's; the engine
                 (mesh and rules) serves the restored tree, bf16, B=4,
                 prompt 128, 32 new tokens through its graphs: 30 flash
                 launches, tokens and last logits bit-equal to the
                 never-checkpointed tree's; then the card's tree saved and
                 restored into a 2-rank CPU world under (1, 2) baseline
                 and (2, 1) fsdp: each rank's shard its resolve_spec
                 window of the tree, bit for bit
  rankworld      the paper's proxy MPI runtime beside the tensor layer:
                 4 thread ranks of the port's MPIJob over shm run the
                 numpy data-parallel MLP of distributed/proxy_grad.py
                 (din 1024, dh 4096, dout 1024, 64 rows a rank: 33.6 MB of
                 fp32 params a rank through the ring allreduce), a 10-step
                 run checkpointed at step 6 with resume=False; full-width
                 smollm-135m's fp32 tree (seed 0) built on the card and
                 saved by CheckpointManager(generation=0); then one
                 atomic_reshape: one membership bump, rank 3 dead, 4 -> 3
                 ranks and shm -> tcp, the tree restored onto the card's
                 1-rank mesh: generation 1 in every layer, layers
                 (mesh, world), leaves on the card bit-equal to the tree
                 built, survivors bit-equal to their images under the
                 compacted rank map, a generation-0 report rejected, all
                 ranks' params equal after the 4 remaining steps; a
                 same-shape restart onto inproc bit-equal to an
                 uninterrupted run; a 4-rank world whose sends cross the
                 step boundary (8 MiB fp64 messages) checkpointed at step
                 6 with one message a rank drained into the images,
                 restarted onto tcp bit-equal to its uninterrupted run;
                 the seconds of each stage and the drained messages.  No
                 kernel runs
  procworld      the process world: the same MLP with every rank a forked
                 OS process behind a socket proxy endpoint in this (CUDA)
                 process.  A: smollm-135m's fp32 tree built on the card and
                 saved; 4 ranks over shmring (tensors >= 256 KiB cross
                 through the shared-memory ring) checkpointed at step 6 of
                 10; one atomic_reshape, rank 3 dead, onto proc, the tree
                 restored onto the card's mesh: generation 1 everywhere,
                 leaves and survivors bit-equal, the reshaped run bit-equal
                 to a thread-world restart of the same images over shm.
                 B: FaultTolerantDriver, 4 ranks over proc, 12 steps,
                 ckpt_every 5, rank 2 SIGKILLs itself at step 8: dead:[2],
                 restart:at_00000005 onto shmring, done; generation 1,
                 world 3, bit-equal to a thread-world restart.  C: python
                 -m repro_torch.launch.procrun with a kill in a fresh
                 interpreter: world=3 generation=1.  /dev/shm, the ring as
                 created, ring_bytes, pids, exit codes, each stage's
                 seconds, kill -> dead and restart -> done.  No kernel runs
  serve-parity-hybrid
                 full-width recurrentgemma-9b (seeded random weights), fp32,
                 B=1, prompt 2560 (past the 2048 window): kernels vs plain
                 paths block by block over all 38 blocks, and logits and
                 greedy tokens end to end at a 5-layer cut
  serve-hybrid   the repro_torch.launch.serve path, recurrentgemma-9b at full
                 width, bf16, B=2, prompt 2560, 32 new tokens: the other main
                 path; 12 flash and 26 RG-LRU launches, peak memory, and the
                 graph checks of serve
  snapshot-hybrid
                 full-width recurrentgemma-9b, bf16, B=2, prompt 2560, 32 new
                 tokens through the kernels and the engine's graphs, then
                 snapshot_service; 8 more
                 decode steps on the live engine, and 8 from the snapshot
                 restored onto the card: restored leaves bit-equal to the
                 host copy taken at snapshot time, equal tokens
  sharded        the sharded forward: full-width recurrentgemma-9b, bf16,
                 B=2, prompt 2560, 32 new, through the engine on the card's
                 1-rank mesh (params as DTensors wrapping the plain
                 engine's storage, graphs captured; the kernels through
                 local_map: 12 flash, 26 RG-LRU launches a request),
                 tokens and last logits bit-equal to the plain engine's,
                 both captured and uncaptured, each one's prefill and
                 decode step; a fresh process's first DTensor; then
                 smollm-135m's widths at a 2-layer cut, fp32, B=4, 128+8,
                 in CPU gloo worlds of 2 ranks (1, 2) and 4 ranks (2, 2)
                 beside the card: tokens equal to the one-device engine's,
                 logits within 1e-4, each block within 1e-4 of its
                 output's scale (at least 1), each rank's bytes of
                 params and cache the sum of its windows (9 query and 3
                 kv heads do not divide model = 2: the attention stays
                 replicated, the ffn and the vocab split)
  serve-parity-moe
                 full-width qwen2-moe-a2.7b (seeded random weights), fp32,
                 B=1, prompt 512 (two MoE groups): 24 flash launches; flash
                 vs chunked block by block over all 24 blocks, an MoE
                 block's difference over the tokens routed alike on both
                 paths, each token whose expert set differs reported with
                 its top-k margin (a near tie below ROUTE_TIE, or the phase
                 fails); logits and greedy tokens end to end at a 2-layer
                 cut
  serve-moe      the repro_torch.launch.serve path, qwen2-moe-a2.7b at full
                 width, bf16, B=4, prompt 512, 32 new tokens: 24 flash
                 launches a request, the graph checks of serve, the decode
                 step beside its weight-read bound, peak memory
  serve-mla      deepseek-v2-lite-16b the same way: 0 flash launches (MLA's
                 q head dim 192 is not v's 128), the serving snapshot (a
                 dense MLA prefix block, 26 MoE blocks) validates, the
                 absorbed MLA decode against the expanded forward on every
                 one of the 27 layers' weights in fp32 (at PARITY_TOL of
                 the output's scale, beside the fp32 noise floor), and the
                 compressed cache's bytes beside an expanded K/V cache's
  serve-parity-xlstm
                 full-width xlstm-1.3b (seeded random weights), fp32, B=1:
                 the chunkwise mLSTM over 512 tokens (two chunks) against
                 its first 256 and 256 recurrent decode steps, and the
                 sLSTM scan likewise, each of the 48 blocks from the same
                 input (held at the reference's 2e-3, or PARITY_TOL of the
                 output's scale, beside the fp32 noise floor); end to end
                 at a one-unit cut (7 mLSTM, 1 sLSTM): the forward's logits
                 over 256 tokens against prefill 224 + 32 teacher-forced
                 decode steps, the engine's greedy tokens against greedy by
                 the forward, and the cut's logits on the card against the
                 port on the CPU
  serve-xlstm    the repro_torch.launch.serve path, xlstm-1.3b at full
                 width, bf16, B=4, prompt 512, 32 new tokens: no kernel
                 launch (no TPU kernel computes an xLSTM block), the graph
                 checks of serve, the decode step beside its bound (the
                 weights, and the mLSTM's C read and written in place),
                 peak memory, and each block kind's share of the prefill,
                 captured and not (the sLSTM's time loop)
  serve-whisper  full-width whisper-tiny: fp32, B=1, prompt 128, flash
                 against chunked in each of the 4 decoder blocks and end to
                 end (logits, greedy tokens); then the serve CLI, bf16,
                 B=4, prompt 128, 32 new tokens, frames (4, 1500, 384), the
                 encoder inside the captured prefill: 4 flash launches a
                 request, the graph checks of serve, the decode step beside
                 its bound, the serving snapshot validated with its cross
                 K/V leaves
  train          the repro_torch.train.loop.train path, smollm-135m at full
                 width, bf16, the flash backend, remat on, B=8, seq 2048, 10
                 steps: the other main path, each step the replay of one
                 CUDA graph (GraphedTrainStep: the first step eager, then
                 captured once); 60 flash launches a step (the forward and
                 the remat recompute) counted through the replays, the
                 loss falling, step time, tokens/s, 6NT against the bf16
                 peak, peak memory with the graph's pool; 3 graphed steps
                 against 3 eager ones (the pure step and the in-place one)
                 from one state under deterministic algorithms, losses and
                 every TrainState leaf bit for bit; the eager step against
                 a replay: step time, capture_s, and one of each under the
                 profiler; flash gradients (kernel forward, plain backward)
                 against the plain version's at the training shape, one
                 step's gradients with the kernel against the plain path
                 at a 2-layer cut, in fp32, and the first full-width step's
                 new params, m and v against a plain fp64 AdamW fed the
                 same gradients
  train-resume   under deterministic algorithms: a crash after step 7,
                 resumed from the step-4 checkpoint, ends on the same last
                 loss as an uninterrupted run, both runs through the graph
                 (the resumed one captured again over the restored state);
                 then the full-width fp32 TrainState (params, m, v, the
                 uint32 rng key) saved and restored onto the card bit for
                 bit, with its times
  train-sharded  the loop on the card's one-rank DeviceMesh,
                 train.loop.train(cfg, mesh, rules), smollm-135m at TRAIN's
                 full width and shape under baseline and fsdp, each step
                 the replay of the sharded step's graph (the flash kernel
                 through local_map, 60 launches a step), beside the plain
                 loop from the same seed under deterministic algorithms:
                 losses and final TrainStates bit-equal; a sharded run
                 crashed after step 5 resumed on one device and on the
                 mesh, each bit-equal to the uninterrupted one; the eager
                 and graphed sharded step (step_s, capture_s, a profile
                 of each: busy share, device ops; the plain step's: the
                 train phase);
                 one step of a 2-rank CPU gloo world at (1, 2), the
                 widths cut to 2 layers, fp32, against the one-device step
  train-families the loop's graphed step for every other family it trains,
                 at full published widths and a depth cut, B=4, seq 256:
                 recurrentgemma-9b (5 layers; recurrence on its plain scan,
                 0 RG-LRU launches), qwen2-moe-a2.7b and deepseek-v2-lite-16b
                 (2), xlstm-1.3b (8), whisper-tiny (whole); each 3 graphed
                 steps against 3 eager in-place ones from one state under
                 deterministic algorithms, losses, launches and every
                 TrainState leaf equal
  dryrun         one production cell of the dry-run, smollm-135m
                 decode_32k on the (16, 16) pod mesh, through python -m
                 repro_torch.launch.dryrun as rank 0 of a fake 256-rank
                 world, once with the fake tensors on the card's device
                 type and once on the CPU, both in child processes: both
                 ok, flops, bytes and collectives equal, each trace_s and
                 this torch's version; a child that traces a product split
                 over the model axis must count one rank's local flops.
                 No kernel runs
  checkpoint-remote
                 the full-width TrainState after 2 steps through the
                 manager in three legs: its own directory, one chunk
                 server, three with replicas=2 (servers started through
                 python -m repro_torch.checkpoint.chunkservice); each leg
                 saves, re-saves unchanged (0 bytes uploaded), restores
                 onto the card from an empty cache (the bytes the
                 checkpoint references fetched) and from the warm one,
                 bit-equal; the sharded leg SIGKILLs a server, restores
                 again and reports it down; one bf16 flash training step
                 from each leg's restore, equal losses; then the 9B
                 serving snapshot through three servers, equal tokens
  timing         every kernel at the shapes its paths give it (flash also
                 at qwen2-moe's and whisper-tiny's, and in fp32 at the
                 serve-parity shapes,
                 the RG-LRU scan at both hybrid shapes and with bf16
                 inputs) against its plain
                 version, a PyTorch call where one computes the same
                 function (for flash: which SDPA backend ran, and its time
                 when only the memory-efficient backend may run), and the
                 card's bound; achieved TFLOP/s, TB/s and
                 share of the bound; the RG-LRU scratch traffic, from a
                 launch that counts it, and that launch's time

Then one line {"kernels": [...]}, the card's name and power limit as
nvidia-smi gives them, and last {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
ARCH = "smollm-135m"                               # served at full width
CUT_LAYERS = 2                                     # serve-parity's depth cut
SLICE_SHAPE = dict(b=4, h=9, kv=3, s=128, hd=64)   # smollm-135m prefill, B=4
HYBRID = "recurrentgemma-9b"                       # served at full width
HYBRID_CUT_LAYERS = 5                              # one unit + the 2-block tail
HYBRID_PARITY_PROMPT = 2560                        # > window, multiple of 128
HYBRID_SERVE = dict(batch=2, prompt=2560, new_tokens=32)
SNAPSHOT_CONTINUE = 8                              # decode steps after one
# recurrentgemma-9b prefill at B=2: 32 query heads over 2 kv heads, hd 256
HYBRID_FLASH_SHAPE = dict(b=2, h=16, kv=1, s=2560, hd=256, window=2048)
RGLRU_SHAPE = (2, 2560, 4096)                      # its rglru prefill, B=2
MOE = "qwen2-moe-a2.7b"                            # served at full width
MLA = "deepseek-v2-lite-16b"                       # served at full width
MOE_CUT_LAYERS = 2                                 # serve-parity-moe's cut
MOE_PARITY_PROMPT = 512                            # two MoE groups of 256
MOE_SERVE = dict(batch=4, prompt=512, new_tokens=32)
# qwen2-moe-a2.7b prefill at B=4: 16 heads over 16 kv heads (g = 1), hd 128
MOE_FLASH_SHAPE = dict(b=4, h=16, kv=16, s=512, hd=128)
XLSTM = "xlstm-1.3b"                               # served at full width
XLSTM_CUT_LAYERS = 8                               # one unit: 7 mLSTM, 1 sLSTM
# serve-parity-xlstm: chunkwise over `prompt` tokens (two chunks) against
# chunkwise over the first `split` and recurrent steps over the rest; end
# to end at the cut, the forward over `cut_seq` tokens against a prefill
# of `cut_prefill` and teacher-forced decode steps, and `greedy` tokens
XLSTM_PARITY = dict(prompt=512, split=256, cut_seq=256, cut_prefill=224,
                    greedy=8)
XLSTM_SERVE = dict(batch=4, prompt=512, new_tokens=32)
WHISPER = "whisper-tiny"                           # served at full width
WHISPER_PARITY_PROMPT = 128
WHISPER_SERVE = dict(batch=4, prompt=128, new_tokens=32)
# its decoder self-attention at prefill: MHA, q = kv = (B*6) x 128 x 64
WHISPER_FLASH_SHAPE = dict(b=4, h=6, kv=6, s=128, hd=64)
# a token whose expert set differs between two paths that agree to ~1e-6
# is a near tie when its k-th and (k+1)-th router probs are this close
# (fp32 paths move the probs by ~1e-9; adjacent probs lie ~1e-4 apart)
ROUTE_TIE = 1e-5
QUANT_N = 4096 * 12288                             # one of its MLP matrices
QUANT_BLOCK = 256
HBM_BYTES_PER_S = 3.35e12                          # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12                           # dense bf16 tensor cores
FP32_FLOP_PER_S = 67e12                            # fp32 outside tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}          # tests/test_kernels.py
SWEEP = [(4, 2, 256, 256, 64, True, 0), (2, 2, 128, 128, 128, True, 0),
         (8, 2, 128, 128, 64, True, 0), (6, 2, 256, 256, 64, True, 64),
         (2, 2, 128, 384, 64, False, 0), (2, 1, 512, 512, 256, True, 0)]
# bf16 cases for the tensor-core tiling (64-key tiles, 64/128-row q tiles):
# (bh, bkv, sq, sk, hd, causal, window, magnitude of q and k)
FLASH_BF16_CASES = [
    (4, 2, 256, 256, 64, True, 100, 1),   # a window no tile size divides
    (2, 1, 256, 256, 256, True, 100, 1),
    (4, 2, 256, 256, 64, True, 0, 8),     # q, k x 8: the running max moves
    (2, 1, 512, 512, 256, True, 64, 8),   # between tiles, and at the edge
    (16, 2, 256, 256, 128, True, 0, 1),   # hd 128, g = 8
]
# Their fp32 twins for the CUDA-core tiling (64-row q tiles, 64-key tiles),
# held at TOL["float32"], and the sweep's non-causal Sq != Sk case at hd 256.
# q and k x 8 are rounded to integers: every product and partial sum of
# Q K^T is then exact in fp32 whatever the order, so the check sees the
# softmax's rescaling and not the summation order, which on unrounded
# N(0, 64) inputs alone moves the output by more than 2e-5 (tests/
# test_torch_chip_smoke.py::test_chip_smoke_fp32_magnified_scores_are_exact).
FLASH_FP32_CASES = [
    (4, 2, 256, 256, 64, True, 100, 1),   # a window no tile size divides
    (2, 1, 256, 256, 256, True, 100, 1),
    (4, 2, 256, 256, 64, True, 0, 8),     # q, k x 8: the running max moves
    (2, 1, 512, 512, 256, True, 64, 8),   # between tiles, and at the edge
    (16, 2, 256, 256, 128, True, 0, 1),   # hd 128, g = 8
    (2, 1, 128, 384, 256, False, 0, 1),   # not causal, Sq != Sk
]
RGLRU_TOL = {"float32": 1e-4, "bfloat16": 2e-2}    # tests/test_kernels.py:99
RGLRU_SWEEP = [(2, 256, 512), (1, 128, 1024), (3, 512, 256), (2, 128, 128)]
# Cases that stress the kernel's tiles of 64 steps x 128 lanes
# (kernels/rglru.py::rglru_plan) and the carry across them: (b, s, d, a),
# a "sigmoid" = 0.98 sigmoid(N(0, 1)), "near-one" in [0.9999, 1) so h0's
# carry survives every chunk, "zeros" = sigmoid with ~1% exact zeros, which
# cut the carry mid-chunk, "offset" = sigmoid in views that start one
# element into their storage.  Odd D, and bf16 views at an odd element,
# are not 4-byte aligned: the kernel copies them through registers.
# near-one runs 1024 steps: with a so close to 1, h random-walks, and over
# many more steps the fp32 rounding of the plain version itself nears the
# tolerance.
RGLRU_STRESS = [(2, 63, 512, "sigmoid"), (2, 64, 512, "sigmoid"),
                (2, 65, 512, "sigmoid"), (2, 300, 200, "sigmoid"),
                (1, 129, 1001, "sigmoid"), (3, 1, 300, "sigmoid"),
                (1, 16384, 256, "sigmoid"), (2, 1024, 512, "near-one"),
                (2, 1024, 512, "zeros"), (2, 300, 256, "offset")]
QUANT_SIZES = [(4096, 256), (512, 128), (65536, 256)]
PARITY_TOL = 1e-3                                  # kernel vs plain paths
# the reference's own prefill + decode vs forward tolerance
# (tests/test_models_smoke.py:90), for the xLSTM's two forms
REFERENCE_TOL = 2e-3
# smollm-135m trained at full width through repro_torch.train.loop.train:
# bf16 DEFAULT_POLICY, flash backend, remat on, 16,384 tokens a step; a
# crash after step fail_at, resumed from the step-ckpt_every checkpoint
TRAIN = dict(batch=8, seq=2048, steps=10, lr=1e-3, warmup=2, ckpt_every=4,
             fail_at=7, seed=0)
# checkpoint-remote: the TrainState after PRE_STEPS steps, saved through
# each storage leg (the number of chunk servers it runs); the servers are
# processes started through the port's CLI, or "threads" in this process
PRE_STEPS = 2
# the elastic phase: the world that saves and its mesh, the world that
# restores the card's tree, the request served from the restored tree
ELASTIC = dict(ranks=4, mesh=(2, 2), reverse_ranks=2, batch=4, prompt=128,
               new_tokens=32, world_timeout_s=300)
CORRUPT_RANK = None          # a rank whose restored shard is corrupted
# the rankworld phase: the paper's proxy MPI runtime (thread world) running
# the reference's numpy data-parallel MLP, 33.6 MB of fp32 params a rank
# through the ring allreduce; checkpointed at ckpt_at of a steps-step run,
# then one reshape (dead ranks, a transport switch) and a same-shape restart;
# beside it a world whose sends cross the step boundary (boundary_width
# fp64 a message, one ring chunk of the MLP's allreduce), so the
# checkpoint drains one message a rank, restarted onto boundary_to
RANKWORLD = dict(ranks=4, dead=(3,), din=1024, dh=4096, dout=1024,
                 batch_per_rank=64, steps=10, ckpt_at=6, transport="shm",
                 reshape_to="tcp", same_shape_to="inproc",
                 boundary_width=1 << 20, boundary_to="tcp", timeout_s=300)
CORRUPT_IMAGE = None         # a rank whose app part is corrupted on disk
# the procworld phase: RANKWORLD's data-parallel MLP with every rank a forked
# OS process behind a socket proxy endpoint.  A: ranks over `transport`
# (the shared-memory tensor ring) checkpointed at ckpt_at of steps, one
# atomic_reshape past `dead` onto reshape_to, held against a thread-world
# restart of the same images over thread_to.  B: FaultTolerantDriver over
# driver_transport, kill_rank SIGKILLing itself at kill_step of generation
# 0, restarted onto after_failure, held against a thread-world restart of
# the checkpoint it resumed from.  C: the procrun CLI in a fresh interpreter
# at its own widths, cli_args
PROCWORLD = dict(ranks=4, dead=(3,), steps=10, ckpt_at=6, transport="shmring",
                 reshape_to="proc", thread_to="shm", driver_steps=12,
                 ckpt_every=5, kill_rank=2, kill_step=8,
                 driver_transport="proc", after_failure="shmring",
                 cli_args=("--ranks", "4", "--steps", "20", "--kill-rank",
                           "2", "--kill-step", "8"),
                 timeout_s=300)
REMOTE_LEGS = {"local": 0, "remote": 1, "sharded": 3}
# the sharded phase: its CPU worlds (ranks, mesh) and their model, ARCH's
# widths at a depth cut (the full-depth random stack is chaotic), fp32;
# logits within tol, each block's output within tol of its scale
SHARDED = dict(worlds=((2, (1, 2)), (4, (2, 2))), layers=2, batch=4,
               prompt=128, new_tokens=8, tol=1e-4, world_timeout_s=300)
REMOTE_SERVERS = "processes"
# the train step's fp32 AdamW against an fp64 one on the same gradients:
# fp32 rounding of the clip norm over 134.5 M squares and of each update
ADAMW_TOL = 1e-5
# graphed against eager train steps, bit for bit, from one state
GRAPH_CHECK_STEPS = 3
# train-families: S <= 256, as one MoE group and one mLSTM chunk need
FAMILY_TRAIN = dict(batch=4, seq=256)
# train-sharded: TRAIN's loop on the card's one-rank mesh under each
# variant, a sharded run crashed after fail_at; its CPU world: one step of
# ARCH's widths cut to `layers`, fp32, Adam's eps raised so the first
# update is a smooth function of the gradient (tests/test_torch_sharded_
# train.py), each leaf within tol of its scale or twice its noise floor
TRAIN_SHARDED = dict(variants=("baseline", "fsdp"), fail_at=5,
                     world=dict(ranks=2, mesh=(1, 2), rules="baseline",
                                layers=2, batch=2, seq=128, eps=1e-3,
                                tol=1e-5, world_timeout_s=300))


# dryrun: one production cell traced as rank 0 of its fake world, in a
# child process per device type (this process holds the meshes' 1-rank
# world); the costs must not depend on the device the fake tensors claim
DRYRUN = dict(arch="smollm-135m", shape="decode_32k", mesh="pod",
              variant="auto", timeout_s=240)
# x (64, 4096) whole times w (4096, 4096) split over a 16-wide model axis
# in a fake (16, 16) world: each rank's product is 64 x 4096 x 256, its
# modelled bytes this rank's fp32 x, w shard and output, its one
# temporary the output (the global-shape ops of DTensor's sharding
# propagation, billed, would show in all three)
DRYRUN_PROBE_WANT = {"flops": 2 * 64 * 4096 * 256,
                     "bytes": 4 * (64 * 4096 + 4096 * 256 + 64 * 256),
                     "peak_temp_bytes": 4 * 64 * 256}


class PhaseFailed(Exception):
    pass


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def emit(phase: str, ok: bool, card_line: str, **fields) -> None:
    print(json.dumps({"phase": phase, "ok": ok, **fields, "card": card_line}),
          flush=True)
    if not ok:
        raise PhaseFailed(phase)


def sync() -> None:
    import torch
    if DEV == "cuda":
        torch.cuda.synchronize()


def free() -> None:
    """Drop what is no longer referenced, so one 9B model is alive at a
    time."""
    import torch
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()


def free_and_reset_peak() -> None:
    import torch
    free()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes():
    import torch
    return torch.cuda.max_memory_allocated() if DEV == "cuda" else None


def reserved_bytes():
    """The most the caching allocator held, CUDA graphs' pools included."""
    import torch
    return torch.cuda.max_memory_reserved() if DEV == "cuda" else None


def cuda_ms(fn) -> float:
    """Mean ms per call over a run of calls, by CUDA events, after a warm-up;
    the run is sized to take about 0.2 s (3 to 200 calls)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = max(3, min(200, int(200.0 / max(start.elapsed_time(end), 1e-3))))
    for _ in range(min(iters // 10, 20)):
        fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns: dict) -> dict:
    """Time each function twice, in turns (a, b, ..., ..., b, a), so that
    drift within the call hits every one alike; returns every sample."""
    order = list(fns) + list(fns)[::-1]
    runs = {name: [] for name in fns}
    for name in order:
        runs[name].append(cuda_ms(fns[name]))
    return runs


# --------------------------------------------------------------- bounds

def achieved(ms: float, ops: float, n_bytes: int, bound_ms: float) -> dict:
    """What a kernel reached in ``ms``: TFLOP/s and TB/s on the work its
    bound counts, and the share of that bound (bound_ms / ms)."""
    return {"tflops": ops / ms / 1e9, "tbps": n_bytes / ms / 1e9,
            "share_of_bound": bound_ms / ms}


def _bound(n_bytes: int, ops: float, peak_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations", n_bytes, ops)


def attention_pairs(s: int, window: int) -> int:
    """Causal (q, k) pairs of one head, within the window if there is one."""
    if not window:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def flash_bound(bh, bkv, s, hd, window, elem_bytes=2,
                peak_ops=BF16_FLOP_PER_S):
    """q and o, k and v once each; QK^T and PV over the pairs that the
    causal window keeps, 2 flops per MAC, at ``peak_ops``: the bf16 tensor
    cores, or the fp32 CUDA cores (FP32_FLOP_PER_S) for the fp32 kernel."""
    n_bytes = (2 * bh + 2 * bkv) * s * hd * elem_bytes
    return _bound(n_bytes, 4 * hd * attention_pairs(s, window) * bh,
                  peak_ops)


def rglru_bound(b, s, d, elem_bytes=4):
    """a and x read and h_seq written (B, S, D), h0 read and h_last written
    (B, D); a multiply and an add an element, in fp32."""
    n_bytes = 2 * b * s * d * elem_bytes + b * s * d * 4 + 2 * b * d * 4
    return _bound(n_bytes, 2 * b * s * d, FP32_FLOP_PER_S)


def quant_bound(n, block, dequant=False):
    """fp32 values, int8 codes and fp32 scales once each.  Quantize: |x|,
    max, divide, round and clip an element; dequantize: one multiply."""
    n_bytes = n * 4 + n + (n // block) * 4
    return _bound(n_bytes, n * (1 if dequant else 5), FP32_FLOP_PER_S)


# ---------------------------------------------------------------- build

def ptxas_summary(report: str) -> list:
    """Each function of a ``ptxas -v`` report: its (mangled) name, which
    names the template instantiation, its registers, spill bytes and static
    shared memory (where ptxas reports any)."""
    out = []
    for ln in report.splitlines():
        if m := re.search(r"Function properties for (\S+)", ln):
            out.append({"function": m.group(1)})
        elif out and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                     r"bytes spill loads", ln)):
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        elif out and (m := re.search(r"Used (\d+) registers", ln)):
            out[-1]["registers"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", ln):
                out[-1]["smem_bytes"] = int(m.group(1))
    return out


def flash_instantiations(fns) -> dict:
    """The flash kernels' instantiations in a ptxas summary, by kernel: the
    fp32 ``fa_fwd_kernel`` and the bf16 ``fa_fwd_tc_kernel``, one per head
    dim each."""
    return {name: [f for f in fns if re.search(rf"\d{name}I", f["function"])]
            for name in ("fa_fwd_kernel", "fa_fwd_tc_kernel")}


def flash_spills(fns) -> list:
    """The flash instantiations that spill (or whose spills ptxas did not
    report), by mangled name."""
    return [f["function"] for found in flash_instantiations(fns).values()
            for f in found
            if f.get("spill_stores", 1) or f.get("spill_loads", 1)]


def phase_build(card_line):
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention, quantize, rglru
    sources = [m.SOURCE for m in (flash_attention, rglru, quantize)]
    t0 = time.perf_counter()
    libs = build.build_all(sources)
    build_s = time.perf_counter() - t0
    ptxas = {str(lib.relative_to(ROOT)): ptxas_summary(
        build.ptxas_report(lib).read_text()) for lib in libs}
    fns = [f for lib_fns in ptxas.values() for f in lib_fns]
    flash = flash_instantiations(fns)
    spills = flash_spills(fns)
    emit("build", all(lib.exists() for lib in libs)
         and all(len(found) == len(flash_attention._HEAD_DIMS)
                 for found in flash.values()) and not spills,
         card_line, build_s=build_s, ptxas=ptxas, flash_spills=spills,
         rglru_ptxas=[f for f in fns if "rglru" in f["function"]])


# -------------------------------------------------------------- kernels

def _randn(gen, *shape, dtype=None):
    import torch
    t = torch.randn(shape, generator=gen, device=DEV)
    return t if dtype is None else t.to(dtype)


def _check_flash_tiles():
    """The wrapper's tile table against the built library's own."""
    from repro_torch.kernels import flash_attention as fa
    bad = []
    for (dtype, hd), tiles in fa.TILES.items():
        built = fa.library_tiles(dtype, hd)
        if built != tiles:
            bad.append(["flash", "tiles", str(dtype), hd, tiles, built])
    return bad


def flash_qk(gen, dt, bh, bkv, sq, sk, hd, mag):
    """q and k of a flash case, N(0, mag^2); in fp32 with mag > 1 rounded to
    integers (see FLASH_FP32_CASES)."""
    import torch
    dtype = getattr(torch, dt)
    q, k = _randn(gen, bh, sq, hd) * mag, _randn(gen, bkv, sk, hd) * mag
    if dt == "float32" and mag > 1:
        q, k = q.round(), k.round()
    return q.to(dtype), k.to(dtype)


def _check_flash(gen):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_flash_attention
    # each path's shape, causal, with its window (flash_paths)
    path_cases = {path: (dt, b * h, b * kv, s, s, hd, True, window, 1)
                  for path, (b, h, kv, s, hd, window, dt)
                  in flash_paths().items()}
    cases = [(dt,) + c + (1,) for dt in ("float32", "bfloat16") for c in SWEEP]
    cases += [("float32", 2, 2, 384, 384, 64, True, 0, 1)]  # test_kernels.py:41
    cases += list(path_cases.values())
    cases += [("bfloat16",) + c for c in FLASH_BF16_CASES]
    cases += [("float32",) + c for c in FLASH_FP32_CASES]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    bad, errs = _check_flash_tiles(), {}
    for case in cases:
        dt, bh, bkv, sq, sk, hd, causal, window, mag = case
        dtype = getattr(torch, dt)
        q, k = flash_qk(gen, dt, bh, bkv, sq, sk, hd, mag)
        v = _randn(gen, bkv, sk, hd, dtype=dtype)
        out = ops.flash_attention(q, k, v, causal, window)
        ref = ref_flash_attention(q, k, v, causal=causal, window=window)
        err = float((out.float() - ref.float()).abs().max())
        worst[dt] = max(worst[dt], err)
        errs[case] = err
        if not err <= TOL[dt]:
            bad.append(["flash", dt, bh, bkv, sq, sk, hd, causal, window, mag,
                        err])
    at_path = {path: errs[case] for path, case in path_cases.items()}
    q = _randn(gen, 2, 128, 64)
    k = _randn(gen, 2, 128, 64)
    v = torch.full((2, 128, 64), 2.5, device=DEV)
    const_err = float((ops.flash_attention(q, k, v) - 2.5).abs().max())
    if not const_err <= 1e-5:                                # test_kernels.py:60
        bad.append(["flash", "constant_v", const_err])
    return {**worst, "constant_v": const_err}, bad, at_path, len(cases) + 1


def rglru_paths() -> dict:
    """The RG-LRU kernel's (b, s, d, dtype) on each path: fp32 on both
    hybrid paths (the gates are fp32 under every policy), and bf16 inputs,
    which no path gives it, at the serving shape."""
    b, s, d = RGLRU_SHAPE
    return {"serve-hybrid": (b, s, d, "float32"),
            "serve-parity-hybrid": (1, HYBRID_PARITY_PROMPT, d, "float32"),
            "bf16-inputs": (b, s, d, "bfloat16")}


def _rglru_inputs(gen, b, s, d, dtype, kind="sigmoid", a_scale=0.98):
    import torch
    if kind == "near-one":
        a = 1 - 1e-4 * torch.rand((b, s, d), generator=gen, device=DEV)
    else:
        a = torch.sigmoid(_randn(gen, b, s, d)) * a_scale
    if kind == "zeros":
        a = torch.where(torch.rand((b, s, d), generator=gen, device=DEV)
                        < 0.01, 0.0, a)
    a, x = a.to(dtype), (_randn(gen, b, s, d) * 0.1).to(dtype)
    if kind == "offset":
        a, x = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(b, s, d)
                for t in (a, x))
    return a, x, _randn(gen, b, d)


def _check_rglru(gen):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_rglru

    worst, worst_case = {"float32": 0.0, "bfloat16": 0.0}, {}
    bad, at_path = [], {}
    paths = {case: path for path, case in rglru_paths().items()}
    cases = [(dt, b, s, d, "sigmoid") for dt in ("float32", "bfloat16")
             for b, s, d in RGLRU_SWEEP]
    cases += [(dt, b, s, d, kind) for dt in ("float32", "bfloat16")
              for b, s, d, kind in RGLRU_STRESS]
    cases += [(dt, b, s, d, "sigmoid") for b, s, d, dt in paths]
    for dt, b, s, d, kind in cases:
        a, x, h0 = _rglru_inputs(gen, b, s, d, getattr(torch, dt), kind)
        hs, hl = ops.rglru(a, x, h0)
        rs, rl = ref_rglru(a, x, h0)
        err = max(float((hs - rs).abs().max()), float((hl - rl).abs().max()))
        if err >= worst[dt]:
            worst[dt], worst_case[dt] = err, [b, s, d, kind]
        if not (err <= RGLRU_TOL[dt] and hs.dtype == hl.dtype == torch.float32
                and hs.shape == (b, s, d) and hl.shape == (b, d)):
            bad.append(["rglru", dt, b, s, d, kind, err])
        if kind == "sigmoid" and (b, s, d, dt) in paths:
            at_path[paths[(b, s, d, dt)]] = err
    # linear in x with h0 = 0 (tests/test_kernels.py:104)
    a, x1, _ = _rglru_inputs(gen, 2, 256, 128, torch.float32, a_scale=0.95)
    x2 = _randn(gen, 2, 256, 128) * 0.1
    h0 = torch.zeros(2, 128, device=DEV)
    lin_err = float((ops.rglru(a, x1, h0)[0] + ops.rglru(a, x2, h0)[0]
                     - ops.rglru(a, x1 + x2, h0)[0]).abs().max())
    if not lin_err <= 1e-4:
        bad.append(["rglru", "linearity", lin_err])
    return ({**worst, "worst_case": worst_case, "linearity": lin_err}, bad,
            at_path, len(cases) + 1)


def _check_quant(gen):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_dequantize_int8, ref_quantize_int8
    bad, worst = [], {"code_mismatches": 0, "scale_rel": 0.0, "dequant": 0.0}
    errs = {}
    for n, block in QUANT_SIZES + [(QUANT_N, QUANT_BLOCK)]:
        x = _randn(gen, n) * 3
        q, s = ops.quantize_int8(x, block=block)
        rq, rs = ref_quantize_int8(x, block=block)
        mism = int((q != rq).sum())
        rel = float(((s - rs).abs() / rs).max())
        deq = float((ops.dequantize_int8(q, s)
                     - ref_dequantize_int8(rq, rs)).abs().max())
        worst["code_mismatches"] += mism
        worst["scale_rel"] = max(worst["scale_rel"], rel)
        worst["dequant"] = max(worst["dequant"], deq)
        if mism or not rel <= 1e-6 or not deq <= 1e-6 * float(rs.max()) * 127:
            bad.append(["quant", n, block, mism, rel, deq])
        if n == QUANT_N:
            errs = {"quantize_int8": float((q.int() - rq.int()).abs().max()),
                    "dequantize_int8": deq}
    # half a step per block (test_kernels.py:63), for several magnitudes
    for mag in (0.01, 1.0, 100.0):
        x = _randn(gen, 16 * 256) * mag
        q, s = ops.quantize_int8(x)
        err = (ops.dequantize_int8(q, s) - x).abs().reshape(16, 256)
        if not bool((err <= s[:, None] * 0.5 + 1e-6).all()):
            bad.append(["quant", "half_step", mag])
    # a fixed point after one round (test_kernels.py:77)
    x1 = ops.dequantize_int8(*ops.quantize_int8(_randn(gen, 1024) * 2))
    idem = float((ops.dequantize_int8(*ops.quantize_int8(x1)) - x1).abs().max())
    if not idem <= 1e-5:
        bad.append(["quant", "idempotence", idem])
    return {**worst, "idempotence": idem}, bad, errs, len(QUANT_SIZES) + 5


def phase_kernels(card_line):
    """Returns each kernel's max abs error at its serving shape (by path
    where it runs at more than one)."""
    import torch
    gen = torch.Generator(device=DEV).manual_seed(0)
    flash_worst, flash_bad, flash_err, n_flash = _check_flash(gen)
    rglru_worst, rglru_bad, rglru_err, n_rglru = _check_rglru(gen)
    quant_worst, quant_bad, quant_errs, n_quant = _check_quant(gen)
    sync()
    bad = flash_bad + rglru_bad + quant_bad
    emit("kernels", not bad, card_line, cases=n_flash + n_rglru + n_quant,
         tolerance={"flash_attention_fwd": {**TOL, "constant_v": 1e-5},
                    "rglru_scan": {**RGLRU_TOL, "linearity": 1e-4},
                    "quantize_int8": {"codes": "exact", "scale_rtol": 1e-6,
                                      "idempotence": 1e-5}},
         worst={"flash_attention_fwd": flash_worst, "rglru_scan": rglru_worst,
                "quantize_int8": quant_worst},
         flash_err_at_path=flash_err, rglru_err_at_path=rglru_err,
         failures=bad)
    return {"flash_attention_fwd": flash_err, "rglru_scan": rglru_err,
            **quant_errs}


# ------------------------------------------------------------- serving

def _greedy_flips(gen_a, gen_b, logits, p):
    """Rows where two greedy streams differ.  A flip is tolerated only at a
    near tie, a top-2 gap < 1e-2 in fp32 teacher-forced ``logits``
    (tests/test_substrate.py:211-222); after it the contexts differ, so the
    row stops there.  Returns (tolerated, beyond_noise)."""
    flips, bad = [], []
    for r in range(gen_a.shape[0]):
        for t in range(gen_a.shape[1]):
            a, c = int(gen_a[r, t]), int(gen_b[r, t])
            if a != c:
                gap = abs(float(logits[r, p + t - 1, a] - logits[r, p + t - 1, c]))
                (flips if gap < 1e-2 else bad).append([r, t, gap])
                break
    return flips, bad


def _backends(kernels: bool) -> None:
    from repro_torch.models import attention as att
    from repro_torch.models import rglru as rg
    att.set_attention_backend("flash" if kernels else "chunked")
    rg.set_recurrence_backend("kernel" if kernels else "scan")


def _train_backend(flash: bool) -> None:
    """The attention backend alone, as launch/train.py selects it on CUDA:
    the recurrence stays on its differentiable plain scan."""
    from repro_torch.models import attention as att
    att.set_attention_backend("flash" if flash else "chunked")


@contextlib.contextmanager
def recorded_routes():
    """Within it, every ``moe.route`` call's result is appended to the
    list it yields: the routing each MoE block chose."""
    from repro_torch.models import moe
    route, seen = moe.route, []

    def record(*args, **kwargs):
        seen.append(route(*args, **kwargs))
        return seen[-1]

    moe.route = record
    try:
        yield seen
    finally:
        moe.route = route


def routing_moved(a, b, top_k):
    """Two routings of the same tokens (``moe.route`` results): which
    tokens (B, S) chose another expert set, which kept another set of
    experts within capacity (an earlier flip in the group moves positions),
    and at each token whose set changed, the k-th minus the (k+1)-th
    router prob of ``b``."""
    import torch
    sets = (torch.sort(a["expert_idx"], dim=-1).values
            != torch.sort(b["expert_idx"], dim=-1).values).any(-1)
    kept = (a["keep"] != b["keep"]).any(-1)
    top = torch.topk(b["probs"], top_k + 1, dim=-1).values
    margin = top[..., top_k - 1] - top[..., top_k]
    n = sets.shape[0]
    return (sets.reshape(n, -1), (sets | kept).reshape(n, -1),
            margin[sets].tolist())


def _block_diffs(cfg, params, tokens, max_seq, policy):
    """Every block of the stack, each from the same input, through the
    kernel path and the plain path; the plain output feeds the next.  An
    MoE block's difference is taken over the tokens whose routing is the
    same on both paths; each token whose expert set differs is reported
    with its top-k margin (a near tie is below ROUTE_TIE)."""
    import torch
    from repro_torch.models import model as lm
    prefix, unit, n_units, tail = lm.stack_plan(cfg)
    blocks = (list(zip(prefix, params["prefix"]))
              + [(k, unit_p[f"b{i}"])
                 for unit_p in lm._unstack(params["units"], n_units)
                 for i, k in enumerate(unit)]
              + list(zip(tail, params["tail"])))
    b, p = tokens.shape
    positions = torch.arange(p, device=tokens.device)[None].expand(b, p)
    x = lm._embed_in(cfg, params, tokens, {}, policy)
    diffs, flips = {}, []
    for kind, bp in blocks:
        y, routes = {}, {}
        for kernels in (True, False):
            _backends(kernels)
            with recorded_routes() as routes[kernels]:
                y[kernels], _ = lm.prefill_block(cfg, kind, bp, x, positions,
                                                 max_seq, policy)
        _backends(False)
        gap = (y[True] - y[False]).abs().amax(-1)               # (B, S)
        if routes[False]:
            sets, moved, margins = routing_moved(
                routes[True][0], routes[False][0], cfg.moe.top_k)
            flips.append({"tokens": int(sets.sum()),
                          "routing_moved": int(moved.sum()),
                          "margins": margins})
            gap = gap[~moved]
        diffs.setdefault(kind, []).append(float(gap.max()) if gap.numel()
                                          else 0.0)
        x = y[False]
    out = {"blocks": {kind: len(d) for kind, d in diffs.items()},
           "block_max_abs_diff": {kind: max(d) for kind, d in diffs.items()}}
    if flips:
        out["routing_flips"] = flips
    return out


def _parity(arch, b, p, n_new, cut_layers):
    """The kernel paths (flash attention, the RG-LRU kernel) against the
    plain ones (chunked attention, the plain scan) on a full-width stack
    with seeded random weights, in fp32.

    Such a stack can be chaotic: for smollm-135m a 1e-7 relative change of
    the embedding moves the 30-layer last-token logits by ~0.5 (PERF.md),
    so end-to-end logits of two paths that differ in the last bit need not
    agree at full depth.  They are held to each other block by block at
    full depth (each block's output from the same input) and end to end at
    a depth cut of the same widths; the full-depth difference is reported
    beside its noise floor."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import model as lm
    from repro_torch.models.layers import Policy
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import ServeEngine

    fp32 = Policy(compute=torch.float32)
    max_seq = p + n_new + 8
    prompts = np.random.default_rng(0).integers(
        0, ARCHS[arch].vocab_size, (b, p)).astype(np.int32)
    tokens = torch.as_tensor(prompts, dtype=torch.long, device=DEV)

    def model(n_layers):
        cfg = dataclasses.replace(ARCHS[arch], n_layers=n_layers)
        params = init_params(lm.lm_param_defs(cfg, max_seq),
                             torch.Generator(device=DEV).manual_seed(0), DEV)
        return cfg, params

    def prefill(cfg, params, kernels):
        _backends(kernels)
        try:
            return lm.lm_prefill(cfg, params, tokens, {}, max_seq, fp32)[0]
        finally:
            _backends(False)

    out = {}
    with torch.inference_mode():
        cfg, params = model(ARCHS[arch].n_layers)
        ops.reset_launch_counts()
        full_kernels = prefill(cfg, params, True)
        sync()
        out["prefill_launches"] = {"flash": ops.FLASH_LAUNCHES,
                                   "rglru": ops.RGLRU_LAUNCHES}
        full_plain = prefill(cfg, params, False)
        out["full_depth_logits_diff"] = float(
            (full_kernels - full_plain).abs().max())
        params["embed"]["embedding"].mul_(1 + 1e-7)
        out["full_depth_noise_floor"] = float(
            (prefill(cfg, params, False) - full_plain).abs().max())
        params["embed"]["embedding"].div_(1 + 1e-7)
        out["logits_finite"] = bool(torch.isfinite(full_kernels).all())
        del full_kernels, full_plain

        out.update(_block_diffs(cfg, params, tokens, max_seq, fp32))
        del params
        free()

        # end to end at a depth cut: logits and greedy tokens
        cfg_cut, params_cut = model(cut_layers)
        out["cut_logits_diff"] = float(
            (prefill(cfg_cut, params_cut, True)
             - prefill(cfg_cut, params_cut, False)).abs().max())
        eng = ServeEngine(cfg_cut, params_cut, max_seq=max_seq, policy=fp32,
                          device=DEV)
        gen = {}
        for kernels in (True, False):
            _backends(kernels)
            gen[kernels] = eng.generate(prompts, n_new).tokens
        _backends(False)
        # fp32 teacher-forced logits of the kernel path's tokens, through
        # the plain prefill and decode (an MoE forward takes no length its
        # groups do not divide, such as P + n_new)
        lg, cache = lm.lm_prefill(cfg_cut, params_cut, tokens, {}, max_seq,
                                  fp32)
        steps = [lg]
        for t in range(n_new - 1):
            tok = torch.as_tensor(gen[True][:, t:t + 1], dtype=torch.long,
                                  device=DEV)
            lg, cache = lm.lm_decode(cfg_cut, params_cut, cache, tok,
                                     torch.full((b,), p + t, device=DEV), fp32)
            steps.append(lg)
        logits = torch.stack(steps, dim=1)              # (B, n_new, V)
        flips, bad = _greedy_flips(gen[True], gen[False],
                                   logits.float().cpu().numpy(), 1)
    out["cut_tie_flips"], out["cut_bad_flips"] = flips, bad
    out["cut_tokens_kernels"] = gen[True].tolist()
    route_margins = [m for f in out.get("routing_flips", [])
                     for m in f["margins"]]
    ok = (out["logits_finite"]
          and max(out["block_max_abs_diff"].values()) <= PARITY_TOL
          and out["cut_logits_diff"] <= PARITY_TOL and not bad
          and all(m < ROUTE_TIE for m in route_margins))
    return ok, cfg, out


def phase_serve_parity(card_line):
    ok, cfg, out = _parity(ARCH, 2, 128, 8, CUT_LAYERS)
    ok = ok and out["prefill_launches"] == {"flash": cfg.n_layers, "rglru": 0}
    emit("serve-parity", ok, card_line, arch=ARCH, dtype="float32", batch=2,
         prompt=128, new_tokens=8, cut_layers=CUT_LAYERS,
         tolerance=PARITY_TOL, **out)


def phase_serve_parity_hybrid(card_line):
    free_and_reset_peak()
    ok, cfg, out = _parity(HYBRID, 1, HYBRID_PARITY_PROMPT, 8,
                           HYBRID_CUT_LAYERS)
    kinds = cfg.layer_kinds()
    want = {"flash": kinds.count("local_attn"), "rglru": kinds.count("rglru")}
    ok = ok and out["prefill_launches"] == want
    emit("serve-parity-hybrid", ok, card_line, arch=HYBRID, dtype="float32",
         batch=1, prompt=HYBRID_PARITY_PROMPT, new_tokens=8,
         cut_layers=HYBRID_CUT_LAYERS, tolerance=PARITY_TOL,
         expected_launches=want, peak_bytes=peak_bytes(), **out)


def _serve(arch, batch, prompt, new_tokens, snapshot_dir=None):
    """One round of the serving CLI, with every count set to 0 just before
    and read just after it.  Returns its row, the counts and the engine."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt),
            "--new-tokens", str(new_tokens)]
    if snapshot_dir is not None:
        argv += ["--snapshot-dir", str(snapshot_dir)]
    ops.reset_launch_counts()                   # the main path starts here
    rows, eng = serve.run(argv)
    return rows[-1], _launches(), eng           # ... and ends here


def _local(tree):
    """An engine's DTensor leaves as their local tensors, whole on the
    card's 1-rank mesh: the plain model reads them as the engine's sharded
    forward does, in the same storage."""
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.models.params import tree_map
    return tree_map(lambda t: t.to_local() if is_dtensor(t) else t, tree)


def _launches() -> dict:
    from repro_torch.kernels import ops
    return {"flash_attention_fwd": ops.FLASH_LAUNCHES,
            "rglru_scan": ops.RGLRU_LAUNCHES,
            "quantize_int8": ops.QUANT_LAUNCHES,
            "dequantize_int8": ops.DEQUANT_LAUNCHES}


def _uncaptured(eng, prompts, n_new, extras=None) -> dict:
    """The engine's request run uncaptured on the same device: the model's
    prefill into a cache of its own, then the ``_continue`` loop, each op
    dispatched from Python, each clock read after a synchronize."""
    import torch
    b, p = prompts.shape
    tokens = torch.as_tensor(prompts, dtype=torch.long, device=DEV)
    dev_extras = {k: torch.as_tensor(v, device=DEV)
                  for k, v in (extras or {}).items()}
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, cache = eng.api.prefill(eng.cfg, _local(eng.params), tokens,
                                        dev_extras, eng.max_seq, eng.policy)
        first = torch.argmax(logits, dim=-1)[:, None]
        sync()
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rest, step_logits = _continue(
            eng, cache, first.cpu().numpy(),
            torch.full((b,), p + 1, dtype=torch.long, device=DEV), n_new - 1)
        sync()
        decode_s = time.perf_counter() - t0
    return {"tokens": torch.cat([first.cpu(), rest], dim=1).numpy(),
            "logits": step_logits[-1], "prefill_s": prefill_s,
            "decode_s": decode_s, "decode_step_ms": decode_s / (n_new - 1) * 1e3}


def _profile_steps(eng, b, p) -> dict:
    """One decode step and one prefill under the profiler, each as the
    engine runs it (on CUDA: its graph's replay) and uncaptured (its
    step function called eagerly), over the engine's own buffers."""
    import functools

    import torch
    batch = eng._batches[b]
    prompt = next(pr for key, pr in eng._prompts.items() if key[0] == (b, p))
    with eng.no_grad():
        prefill, decode = eng._programs(batch, prompt)
        steps = {"decode": (functools.partial(eng._decode_step, batch), decode),
                 "prefill": (functools.partial(eng._prefill_step, batch,
                                               prompt), prefill)}
        return {name: {"uncaptured": profile_step(eager, top=5),
                       "captured": profile_step(run, top=5)}
                for name, (eager, run) in steps.items()}


def _graph_checks(eng, batch, prompt, new_tokens, extras=None) -> dict:
    """After the main path's round, which captured the engine's graphs: a
    second request of the same shape (new prompts, the same graphs), both
    requests' tokens and last-step logits against the same request run
    uncaptured on the device (bit for bit), the launches of the second
    request, and the profiles.  The first request's prompts are the
    CLI's (``launch/serve.py``: seed 0), and both requests carry the
    CLI's ``extras`` (whisper's frames)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    prompts = [np.random.default_rng(seed).integers(
        0, eng.cfg.vocab_size, (batch, prompt)).astype(np.int32)
        for seed in (0, 1)]
    captured = [{"tokens": eng.generated[-1],
                 "logits": eng.last_logits(batch).clone()}]
    capture_s = eng.capture_s
    _backends(True)                             # what the CLI selected
    try:
        ops.reset_launch_counts()
        res = eng.generate(prompts[1], new_tokens, extras=extras)
        launches = _launches()
        captured.append({"tokens": res.tokens,
                         "logits": eng.last_logits(batch).clone()})
        plain = [_uncaptured(eng, p, new_tokens, extras) for p in prompts]
        profiles = _profile_steps(eng, batch, prompt)
    finally:
        _backends(False)
    # each profiled step's device time over its time outside the profiler
    step_s = {"decode": {"captured": res.decode_s / (new_tokens - 1),
                         "uncaptured": plain[1]["decode_s"] / (new_tokens - 1)},
              "prefill": {"captured": res.prefill_s,
                          "uncaptured": plain[1]["prefill_s"]}}
    for name, ways in profiles.items():
        for way, prof in ways.items():
            prof["step_s"] = step_s[name][way]
            prof["device_share_of_step"] = (
                None if prof["device_s"] is None
                else prof["device_s"] / prof["step_s"])
    diffs = [float((c["logits"].float() - u["logits"].float()).abs().max())
             for c, u in zip(captured, plain)]
    return {
        "capture_s": capture_s, "recaptured": eng.capture_s != capture_s,
        "second_request": {
            "prefill_s": res.prefill_s, "decode_s": res.decode_s,
            "decode_step_ms": res.decode_s / (new_tokens - 1) * 1e3,
            "tok_per_s": res.tokens_per_s, "launches": launches},
        "uncaptured": {k: plain[1][k] for k in ("prefill_s", "decode_s",
                                                "decode_step_ms")},
        "tokens_equal": [bool(np.array_equal(c["tokens"], u["tokens"]))
                         for c, u in zip(captured, plain)],
        "logits_equal": [bool(torch.equal(c["logits"], u["logits"]))
                         for c, u in zip(captured, plain)],
        "logits_max_abs_diff": diffs, "profiles": profiles}


def _graphs_ok(checks, launches, want) -> bool:
    """Both requests bit-equal to their uncaptured runs, the second one's
    launches those of the first (through the replays, nothing captured
    again), and capture time spent on the card only."""
    return (all(checks["tokens_equal"]) and all(checks["logits_equal"])
            and checks["second_request"]["launches"] == launches == want
            and not checks["recaptured"]
            and (checks["capture_s"] > 0) == (DEV == "cuda"))


def _payload_leaves(arch, batch, max_seq) -> int:
    """Leaves of a serving snapshot: the cache's, pos and generated."""
    from repro_torch.configs import get_arch
    from repro_torch.models.params import is_pm, tree_leaves
    from repro_torch.models.registry import get_api
    cfg = get_arch(arch)
    defs = get_api(cfg).cache_defs(cfg, batch, max_seq)
    return len(tree_leaves(defs, is_leaf=is_pm)) + 2


def phase_serve(card_line):
    from repro_torch.checkpoint import serialization as ser
    from repro_torch.checkpoint.resharding import plan_summary
    from repro_torch.configs import get_arch
    free_and_reset_peak()
    with tempfile.TemporaryDirectory() as snap:
        row, counts, eng = _serve(ARCH, 4, 128, 32, snap)
        peak = peak_bytes()
        step = Path(snap) / "step_0000000000"
        valid = ser.validate(step, deep=True)
        plan = plan_summary(step)
    n_layers = get_arch(ARCH).n_layers        # one launch per layer
    want = {"flash_attention_fwd": n_layers, "rglru_scan": 0,
            "quantize_int8": 0, "dequantize_int8": 0}
    checks = _graph_checks(eng, 4, 128, 32)
    del eng
    free()
    want_leaves = _payload_leaves(ARCH, 4, 128 + 32 + 8)
    ok = (counts == want and row["flash_launches"] == n_layers
          and _graphs_ok(checks, counts, want)
          and row["prefill_s"] > 0 and row["decode_s"] > 0
          and valid and plan["n_leaves"] == want_leaves)
    emit("serve", ok, card_line, arch=ARCH, batch=4, prompt_len=128,
         new_tokens=32, dtype="bfloat16", prefill_s=row["prefill_s"],
         decode_s=row["decode_s"], tok_per_s=row["tok_per_s"],
         flash_launches=counts["flash_attention_fwd"], launches=counts,
         peak_bytes=peak, **checks,
         snapshot={"valid": valid, "n_leaves": plan["n_leaves"],
                   "expected_leaves": want_leaves,
                   "approx_bytes": plan["approx_bytes"],
                   "compressed_bytes": plan.get("compressed_bytes")})
    return counts


_SAVE_STATS = ("drain_s", "snapshot_s", "write_s", "hash_s", "compress_s",
               "io_s", "last_bytes_written", "last_bytes_referenced")
_RESTORE_STATS = ("restore_io_s", "restore_decompress_s", "restore_device_s")


def _leaves_equal(a, b) -> bool:
    """Two trees of tensors (or numpy arrays) equal leaf for leaf, dtypes
    and bits."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.serialization import _leaf_paths
    la, lb = _leaf_paths(a), _leaf_paths(b)
    if [k for k, _ in la] != [k for k, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        x, y = (torch.as_tensor(np.asarray(t)) if not isinstance(t, torch.Tensor)
                else t for t in (x, y))
        if x.device != y.device:        # compared where both live
            x, y = x.cpu(), y.cpu()
        if x.dtype != y.dtype or not torch.equal(x, y):
            return False
    return True


def phase_checkpoint(card_line):
    """Full-width smollm-135m's fp32 params (~0.54 GB) through the
    manager: save -> wait -> restore onto the card, then an unchanged
    re-save, which must write nothing."""
    import torch
    from repro_torch.checkpoint import serialization as ser
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.models.registry import get_api
    free_and_reset_peak()
    cfg = get_arch(ARCH)
    params = init_params(get_api(cfg).param_defs(cfg, 128 + 32 + 8),
                         torch.Generator(device=DEV).manual_seed(0), DEV)
    leaves = tree_leaves(params)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    with tempfile.TemporaryDirectory() as root:
        mgr = CheckpointManager(root)
        t0 = time.perf_counter()
        mgr.save(0, params)
        mgr.wait()
        save_s = time.perf_counter() - t0
        save = {k: mgr.stats[k] for k in _SAVE_STATS}
        codec = ser.load_manifest(Path(root) / "step_0000000000")["codec"]
        t0 = time.perf_counter()
        restored, meta = mgr.restore(params, device=DEV)
        sync()
        restore_s = time.perf_counter() - t0
        on_card = all(t.device.type == torch.device(DEV).type
                      for t in tree_leaves(restored))
        equal = _leaves_equal(params, restored)
        del restored
        t0 = time.perf_counter()
        mgr.save(1, params)
        mgr.wait()
        resave_s = time.perf_counter() - t0
        resave = {k: mgr.stats[k] for k in ("last_bytes_written",
                                            "last_bytes_referenced")}
        restore = {k: mgr.stats[k] for k in _RESTORE_STATS}
    del params, leaves
    free()
    ok = (equal and on_card and meta["step"] == 0
          and save["last_bytes_written"] + save["last_bytes_referenced"]
          == n_bytes and resave["last_bytes_written"] == 0
          and resave["last_bytes_referenced"] == n_bytes)
    emit("checkpoint", ok, card_line, arch=ARCH, dtype="float32",
         param_bytes=n_bytes, codec=codec, save_s=save_s, save=save,
         restore_s=restore_s, restore=restore, leaves_equal=equal,
         resave_s=resave_s, resave=resave, peak_bytes=peak_bytes())


# ------------------------------------------------------------------ elastic

# The children of the elastic phase's CPU worlds (``launch.mesh.run_world``:
# ``python -c`` processes on this host, a file store, no port).  Each
# rebuilds the phase's params from the same CPU seed; ``ARGS`` is
# prepended as a JSON string.
_ELASTIC_CHILD = """
import json, os, pickle, sys, time
import torch
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.elastic import choose_mesh, elastic_restore
from repro_torch.distributed.sharding import (DEFAULT_RULES, lay_out,
                                              make_variant, param_shardings,
                                              resolve_spec)
from repro_torch.launch.mesh import join_world, make_mesh
from repro_torch.models.params import (init_params, is_pm, tree_leaves,
                                       tree_unflatten)
from repro_torch.models.registry import get_api
args = json.loads(ARGS)
rank = join_world()
torch.set_num_threads(max(1, (os.cpu_count() or 1) // args["ranks"]))
cfg = pickle.loads(bytes.fromhex(args["cfg"]))
defs = get_api(cfg).param_defs(cfg, args["max_seq"])
params = init_params(defs, torch.Generator().manual_seed(args["seed"]), "cpu")
out = {"rank": rank}


def spec_window(spec, shape, sizes, coord):
    # JAX's definition: a dim split over several axes, major to minor in
    # the spec's order
    win = []
    for n, entry in zip(shape, spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) \\
            else entry
        idx, parts = 0, 1
        for a in axes:
            idx, parts = idx * sizes[a] + coord[a], parts * sizes[a]
        win.append((idx * (n // parts), (idx + 1) * (n // parts)))
    return tuple(slice(a, b) for a, b in win)


if args["job"] == "save":
    mesh = make_mesh(tuple(args["mesh"]), ("data", "model"), device="cpu")
    tree = tree_unflatten(params, [
        lay_out(t, l) for t, l in zip(tree_leaves(params), tree_leaves(
            param_shardings(defs, mesh, DEFAULT_RULES)))])
    mgr = CheckpointManager(args["root"])
    t0 = time.perf_counter()
    mgr.save(0, tree)
    out.update(coord=mesh.get_coordinate(), save_s=time.perf_counter() - t0,
               bytes_written=mgr.stats["last_bytes_written"],
               bytes_referenced=mgr.stats["last_bytes_referenced"])
else:
    layouts = {
        "baseline": (lambda: choose_mesh(args["ranks"], model_parallel=2,
                                         device="cpu"), DEFAULT_RULES),
        "fsdp": (lambda: make_mesh((args["ranks"], 1), ("data", "model"),
                                   device="cpu"), make_variant("fsdp"))}
    for name, (make, rules) in layouts.items():
        mesh = make()
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        t0 = time.perf_counter()
        state, meta = elastic_restore(CheckpointManager(args["root"]), defs,
                                      mesh, rules)
        restore_s = time.perf_counter() - t0
        equal, sharded = True, 0
        for p, t, dt in zip(tree_leaves(defs, is_leaf=is_pm),
                            tree_leaves(params), tree_leaves(state)):
            local = dt.to_local()
            if rank == args["corrupt_rank"] and local.numel():
                local.view(-1)[0] += 1        # the rehearsal's fault
            win = spec_window(resolve_spec(p.logical, p.shape, mesh, rules,
                                           fsdp=True), p.shape, sizes, coord)
            equal &= torch.equal(local, t[win])
            sharded += local.shape != t.shape
        out[name] = {"mesh": sizes, "coord": mesh.get_coordinate(),
                     "leaves_equal": equal, "sharded_leaves": sharded,
                     "restore_s": restore_s,
                     "source_world": meta["source_world"],
                     "restored_onto": meta["restored_onto"]}
print(json.dumps(out))
"""


def _world(n: int, job: dict) -> list:
    """The elastic child in a CPU world of `n` ranks; each rank's JSON."""
    import pickle

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import run_world
    args = dict(job, ranks=n, seed=0, cfg=pickle.dumps(get_arch(ARCH)).hex(),
                max_seq=ELASTIC["prompt"] + ELASTIC["new_tokens"] + 8,
                corrupt_rank=CORRUPT_RANK)
    code = f"ARGS = {json.dumps(args)!r}\n" + _ELASTIC_CHILD
    outs = run_world(n, code, timeout_s=ELASTIC["world_timeout_s"],
                     env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                     cwd=ROOT)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def phase_elastic(card_line):
    """Full-width smollm-135m's fp32 params (seed 0, a CPU generator)
    laid out by DEFAULT_RULES on a (2, 2) CPU world and saved across its
    ranks; restored elastically onto this process's 1-rank mesh on the
    card (bit-equal to the tree built here), beside the plain restore;
    served from the restored DTensors through the engine's graphs
    (tokens and last logits bit-equal to the never-checkpointed tree's,
    30 flash launches a request); then the card's tree saved and restored
    into a 2-rank CPU world under two layouts (each rank's shard its
    resolve_spec window of the tree, bit for bit)."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import serialization as ser
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.distributed.elastic import choose_mesh, elastic_restore
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params, tree_leaves, tree_map
    from repro_torch.models.registry import get_api
    from repro_torch.serve.engine import ServeEngine
    free_and_reset_peak()
    cfg = get_arch(ARCH)
    b, p, n_new = ELASTIC["batch"], ELASTIC["prompt"], ELASTIC["new_tokens"]
    max_seq = p + n_new + 8
    defs = get_api(cfg).param_defs(cfg, max_seq)
    host = init_params(defs, torch.Generator().manual_seed(0), "cpu")
    want = tree_map(lambda t: t.to(DEV), host)
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(host))
    with tempfile.TemporaryDirectory() as d:
        world_root, card_root = Path(d) / "world", Path(d) / "card"
        t0 = time.perf_counter()
        saves = _world(ELASTIC["ranks"], {"job": "save",
                                          "mesh": ELASTIC["mesh"],
                                          "root": str(world_root)})
        world_s = time.perf_counter() - t0
        man = ser.load_manifest(world_root / "step_0000000000")
        windows = {k: [[s["index"], s["device"]] for s in e["shards"]]
                   for k, e in man["leaves"].items()}
        raw = sum(s["raw"] for e in man["leaves"].values()
                  for s in e["shards"])

        mesh = choose_mesh(device=DEV)
        mgr = CheckpointManager(world_root)
        sync()
        t0 = time.perf_counter()
        state, meta = elastic_restore(mgr, defs, mesh, DEFAULT_RULES)
        sync()
        restore_s = time.perf_counter() - t0
        # again: the first also pays this process's one-time DTensor set-up
        again_mgr = CheckpointManager(world_root)
        t0 = time.perf_counter()
        again, _ = elastic_restore(again_mgr, defs, mesh, DEFAULT_RULES)
        sync()
        again_s = time.perf_counter() - t0
        del again
        plain_mgr = CheckpointManager(world_root)
        t0 = time.perf_counter()
        plain, _ = plain_mgr.restore(defs, device=DEV)
        sync()
        plain_restore_s = time.perf_counter() - t0
        locals_ = [t.to_local() for t in tree_leaves(state)]
        on_card = all(t.device.type == torch.device(DEV).type
                      for t in locals_)
        equal = all(torch.equal(a, w) for a, w in zip(locals_,
                                                      tree_leaves(want)))
        del plain

        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (b, p)).astype(np.int32)
        _backends(True)                      # what the serve CLI selects
        try:
            eng = ServeEngine(cfg, state, max_seq=max_seq, mesh=mesh,
                              rules=DEFAULT_RULES)
            ref = ServeEngine(cfg, want, max_seq=max_seq, device=DEV)
            ops.reset_launch_counts()        # the main path starts here
            res = eng.generate(prompts, n_new)
            launches = _launches()           # ... and ends here
            ref_res = ref.generate(prompts, n_new)
        finally:
            _backends(False)
        tokens_equal = bool(np.array_equal(res.tokens, ref_res.tokens))
        logits_equal = bool(torch.equal(eng.last_logits(b),
                                        ref.last_logits(b)))
        capture_s = eng.capture_s
        del eng, ref

        card_mgr = CheckpointManager(card_root)
        card_mgr.save(0, state)
        card_mgr.wait()
        reverse = _world(ELASTIC["reverse_ranks"],
                         {"job": "restore", "root": str(card_root)})
        del state, want
    free()
    expect_reverse = {
        "baseline": {"data": 1, "model": ELASTIC["reverse_ranks"]},
        "fsdp": {"data": ELASTIC["reverse_ranks"], "model": 1}}
    reverse_ok = all(r[k]["leaves_equal"] and r[k]["mesh"] == m
                     and r[k]["sharded_leaves"] > 0
                     and r[k]["source_world"] == {"n_devices": 1}
                     for r in reverse for k, m in expect_reverse.items())
    written = sum(s["bytes_written"] for s in saves)
    ok = (equal and on_card and tokens_equal and logits_equal
          and launches["flash_attention_fwd"] == cfg.n_layers
          and meta["source_world"] == {"n_devices": ELASTIC["ranks"]}
          and meta["restored_onto"] == {"devices": 1,
                                        "mesh": {"data": 1, "model": 1}}
          and meta["topology_changed"] is True and raw == n_bytes
          and reverse_ok)
    emit("elastic", ok, card_line, arch=ARCH, dtype="float32",
         param_bytes=n_bytes, world={"ranks": ELASTIC["ranks"],
                                     "mesh": ELASTIC["mesh"],
                                     "rules": DEFAULT_RULES.name,
                                     "seconds": world_s},
         save={"per_rank": saves, "bytes_written": written,
               "raw_bytes_in_manifest": raw, "windows": windows},
         restore={"meta": {k: meta[k] for k in (
             "source_world", "restored_onto", "topology_changed",
             "generation")}, "restore_s": restore_s,
             "restore_device_s": mgr.stats["restore_device_s"],
             "again_restore_s": again_s,
             "again_restore_device_s": again_mgr.stats["restore_device_s"],
             "plain_restore_s": plain_restore_s,
             "plain_restore_device_s": plain_mgr.stats["restore_device_s"],
             "leaves_equal": equal, "on_card": on_card},
         serve={"batch": b, "prompt": p, "new_tokens": n_new,
                "dtype": "bfloat16", "prefill_s": res.prefill_s,
                "decode_s": res.decode_s, "tok_per_s": res.tokens_per_s,
                "capture_s": capture_s, "launches": launches,
                "tokens_equal": tokens_equal,
                "logits_equal": logits_equal},
         reverse=reverse, peak_bytes=peak_bytes())
    return launches


# ---------------------------------------------------------------- rankworld

def _corrupt_app_part(ckpt_dir: Path, rank: int) -> str:
    """Flip one byte in the middle of `rank`'s app part on disk (the
    rehearsal's fault); returns the chunk's name."""
    from repro_torch.core.ckpt_protocol import load_manifest
    man = load_manifest(ckpt_dir)
    name = man["ranks"][str(rank)]["parts"]["app"]["chunk"]
    path = ckpt_dir / man.get("chunk_dir", "chunks") / name
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 1
    path.write_bytes(bytes(blob))
    return name


def _boundary_app(width: int):
    """A rank application whose sends cross step boundaries: what rank r
    sends in step k (seeded normals, `width` fp64), rank r + 1 receives in
    step k + 1, so a checkpoint between two steps drains one message a
    rank into the images; an allreduce of the sum every fourth step."""
    import numpy as np

    def init_fn(mpi):
        return {"acc": np.zeros(width, np.float64)}

    def step_fn(mpi, st, k):
        n, me = mpi.Comm_size(), mpi.Comm_rank()
        msg = np.random.default_rng(1000 * k + me).standard_normal(width)
        mpi.Send(msg, (me + 1) % n, tag=k % 5)
        if k > 0:
            st["acc"] = st["acc"] + mpi.Recv(source=(me - 1) % n,
                                             tag=(k - 1) % 5)
        if k % 4 == 3:
            st["sum"] = mpi.Allreduce(st["acc"].copy(), "sum")
        return st

    return init_fn, step_fn


def phase_rankworld(card_line):
    """The rank world beside the tensor layer, under one membership bump:
    full-width smollm-135m's fp32 tree (seed 0) built on the card and saved
    by CheckpointManager(generation=0); RANKWORLD's data-parallel MLP run by
    the port's MPIJob (thread ranks, proxies, the shm transport) and
    checkpointed at ckpt_at with resume=False; then atomic_reshape of both
    layers: the tree restored onto the card's 1-rank mesh and the world
    shrunk past RANKWORLD's dead ranks onto another transport, which runs
    to the end.  Then a same-shape restart onto a third transport against
    an uninterrupted run, bit for bit.  Last, _boundary_app's world, whose
    checkpoint drains one in-flight message a rank into the images,
    restarted onto another transport against its uninterrupted run, bit
    for bit.  No kernel runs: the counts are set to 0 before and read
    after."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.core.ckpt_protocol import load_manifest, load_rank_image
    from repro_torch.core.coordinator import Membership, StaleGenerationError
    from repro_torch.core.runtime import MPIJob
    from repro_torch.distributed.elastic import atomic_reshape, choose_mesh
    from repro_torch.distributed.proxy_grad import make_dp_app
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.models.registry import get_api
    rw = RANKWORLD
    n = rw["ranks"]
    free_and_reset_peak()
    cfg = get_arch(ARCH)
    init_fn, step_fn = make_dp_app(din=rw["din"], dh=rw["dh"],
                                   dout=rw["dout"],
                                   batch_per_rank=rw["batch_per_rank"])
    seconds, checks, info = {}, {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            seconds[name] = time.perf_counter() - t0

    def run_to_end(job):
        try:
            return job.run(rw["steps"], timeout=rw["timeout_s"])
        finally:
            job.stop()

    def params_equal(a, b):
        return set(a) == set(b) and all(np.array_equal(a[k], b[k])
                                        for k in a)

    def boundary_world(ck):
        b_init, b_step = _boundary_app(rw["boundary_width"])
        control = timed("boundary_uninterrupted_s", lambda: run_to_end(
            MPIJob(n, b_step, b_init, transport=rw["transport"])))
        job = MPIJob(n, b_step, b_init, transport=rw["transport"])
        job.checkpoint_at(rw["ckpt_at"], ck, resume=False)
        timed("boundary_checkpointed_s", lambda: run_to_end(job))
        info["boundary_drained_messages"] = job.coord.stats[
            "drained_messages"]
        checks["boundary_drained"] = info["boundary_drained_messages"]
        checks["boundary_image_step"] = load_manifest(ck)["ranks"]["0"][
            "step_idx"]
        checks["boundary_cached_envelopes"] = sum(
            len(load_rank_image(ck, r).mpi_state["cache"])
            for r in range(n))
        out = timed("boundary_restart_s", lambda: run_to_end(MPIJob.restart(
            ck, b_step, b_init, transport=rw["boundary_to"])))
        checks["boundary_restart_equal"] = (
            len(out) == len(control) == n and all(
                np.array_equal(a[k], b[k])
                for a, b in zip(out, control) for k in ("acc", "sum")))

    error = None
    ops.reset_launch_counts()                # the path starts here
    with tempfile.TemporaryDirectory() as d:
        ck, mesh_root = Path(d) / "world", Path(d) / "mesh"
        defs = get_api(cfg).param_defs(cfg, 128)
        built = init_params(defs, torch.Generator(device=DEV).manual_seed(0),
                            DEV)
        mgr = CheckpointManager(mesh_root, generation=0)
        timed("mesh_save_s", lambda: (mgr.save(0, built), mgr.wait()))
        control = timed("uninterrupted_s", lambda: run_to_end(
            MPIJob(n, step_fn, init_fn, transport=rw["transport"])))
        membership = Membership(n)
        job = MPIJob(n, step_fn, init_fn, transport=rw["transport"],
                     membership=membership)
        job.checkpoint_at(rw["ckpt_at"], ck, resume=False)
        timed("checkpointed_s", lambda: run_to_end(job))
        drained = job.coord.stats["drained_messages"]
        man = load_manifest(ck)
        step_idx = man["ranks"]["0"]["step_idx"]
        info["image_bytes"] = sum(e["bytes"] for e in man["ranks"].values())
        if CORRUPT_IMAGE is not None:
            info["corrupted_chunk"] = _corrupt_app_part(ck, CORRUPT_IMAGE)
        try:
            rep = timed("reshape_s", lambda: atomic_reshape(
                membership, dead=rw["dead"], mgr=mgr, template=defs,
                mesh=choose_mesh(device=DEV), rules=DEFAULT_RULES,
                ckpt_dir=ck, step_fn=step_fn, init_fn=init_fn,
                transport=rw["reshape_to"]))
            checks["generations"] = [rep.generation, membership.generation,
                                     mgr.generation,
                                     rep.job.coord.generation]
            checks["layers"] = list(rep.layers)
            locals_ = [t.to_local() for t in tree_leaves(rep.state)]
            checks["leaves_on_card"] = all(
                t.device.type == torch.device(DEV).type for t in locals_)
            checks["leaves_equal"] = len(locals_) == len(
                tree_leaves(built)) and all(
                torch.equal(a, w) for a, w in zip(locals_,
                                                  tree_leaves(built)))
            del locals_
            rep.state = None             # one tree on the card at a time
            rank_map = rep.job.restore_info["rank_map"]
            checks["rank_map"] = rank_map
            checks["survivors_equal_images"] = all(
                params_equal(rep.job.states[new]["params"],
                             load_rank_image(ck, int(old))
                             .state_obj()["params"])
                for old, new in rank_map.items() if new is not None)
            try:
                rep.job.coord.report_counters(0, 5, 5, generation=0)
                checks["stale_rejected"] = False
            except StaleGenerationError:
                checks["stale_rejected"] = True
            out = timed("reshaped_run_s", lambda: run_to_end(rep.job))
            checks["reshaped_world"] = rep.job.n
            checks["reshaped_params_equal"] = all(
                params_equal(out[0]["params"], o["params"]) for o in out)
            same = timed("same_shape_s", lambda: run_to_end(MPIJob.restart(
                ck, step_fn, init_fn, transport=rw["same_shape_to"])))
            checks["same_shape_equal"] = (
                len(same) == len(control) == n and all(
                    params_equal(a["params"], b["params"])
                    and a["loss"] == b["loss"]
                    for a, b in zip(same, control)))
            boundary_world(Path(d) / "boundary")
        except Exception as e:                   # reported in the line
            error = f"{type(e).__name__}: {e}"
        del built
    counts = _launches()                         # ... and ends here
    free()
    want = {"generations": [1, 1, 1, 1], "layers": ["mesh", "world"],
            "leaves_on_card": True, "leaves_equal": True,
            "survivors_equal_images": True, "stale_rejected": True,
            "reshaped_world": n - len(rw["dead"]),
            "reshaped_params_equal": True, "same_shape_equal": True,
            # each rank's message of step ckpt_at - 1 is in flight
            "boundary_drained": n, "boundary_image_step": rw["ckpt_at"],
            "boundary_cached_envelopes": n, "boundary_restart_equal": True}
    ok = (error is None and all(checks.get(k) == v for k, v in want.items())
          and step_idx == rw["ckpt_at"] and not any(counts.values()))
    params_bytes = 4 * (rw["din"] * rw["dh"] + rw["dh"] * rw["dout"])
    emit("rankworld", ok, card_line, arch=ARCH, dtype="float32",
         app={k: rw[k] for k in ("din", "dh", "dout", "batch_per_rank")},
         params_bytes_per_rank=params_bytes, ranks=n, dead=list(rw["dead"]),
         transports=[rw["transport"], rw["reshape_to"],
                     rw["same_shape_to"], rw["boundary_to"]],
         boundary_width=rw["boundary_width"], steps=rw["steps"],
         image_step=step_idx, drained_messages=drained, checks=checks,
         error=error, seconds=seconds, launches=counts, **info)
    return counts

# ---------------------------------------------------------------- procworld

def phase_procworld(card_line):
    """The process world beside the tensor layer: RANKWORLD's
    data-parallel MLP with every rank a forked OS process behind a socket
    proxy endpoint in this process, which holds a CUDA context.
    A: smollm-135m's fp32 tree built on the card and saved (and waited on:
    nothing is written while the ranks fork); ranks over PROCWORLD's
    transport, whose tensors cross through the shared-memory ring,
    checkpointed at ckpt_at with resume=False; one atomic_reshape of both
    layers onto reshape_to, run to the end and held against a thread-world
    restart of the same images, bit for bit.  B: FaultTolerantDriver with
    kill_rank SIGKILLing itself at kill_step: the events, the reshaped
    world and its params against a thread-world restart of the checkpoint
    the driver resumed from.  C: the procrun CLI in a fresh interpreter.
    No kernel runs: the counts are set to 0 before and read after."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.core import dataplane, procworld
    from repro_torch.core.ckpt_protocol import load_manifest, load_rank_image
    from repro_torch.core.coordinator import Membership
    from repro_torch.core.runtime import MPIJob
    from repro_torch.distributed.elastic import atomic_reshape, choose_mesh
    from repro_torch.distributed.faults import FaultTolerantDriver
    from repro_torch.distributed.proxy_grad import make_dp_app
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.models.registry import get_api
    pw, rw = PROCWORLD, RANKWORLD
    n, dead = pw["ranks"], tuple(pw["dead"])
    free_and_reset_peak()
    cfg = get_arch(ARCH)
    app = {k: rw[k] for k in ("din", "dh", "dout", "batch_per_rank")}
    init_fn, step_fn = make_dp_app(**app)
    # the ring allreduce splits its largest leaf, w1 (din x dh fp32), into
    # one chunk a rank: the payload that rides the ring if a slot holds it
    chunk_bytes = 4 * -(-rw["din"] * rw["dh"] // n)
    seconds, checks, pids, info = {}, {}, {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            seconds[name] = time.perf_counter() - t0

    def run_to_end(job, steps, on_done=None):
        try:
            out = job.run(steps, timeout=pw["timeout_s"])
            if on_done is not None:
                on_done(job)
            return out
        finally:
            job.stop()

    def params_equal(a, b):
        return set(a) == set(b) and all(np.array_equal(a[k], b[k])
                                        for k in a)

    def same_runs(a, b):
        return len(a) == len(b) and all(
            params_equal(x["params"], y["params"]) and x["loss"] == y["loss"]
            for x, y in zip(a, b))

    def thread_restart(ck, gone, steps):
        """The same images restarted as thread ranks, reshaped alike."""
        ms = Membership(n)
        ms.bump(dead=list(gone))
        return run_to_end(MPIJob.restart(
            ck, step_fn, init_fn, transport=pw["thread_to"],
            world_size=n - len(gone), dead_ranks=list(gone), membership=ms),
            steps)

    def processes(job):
        """rank -> pid of every process the job forked, and exit codes."""
        world = job._proc
        return ({str(r): p.pid for r, p in sorted(world._procs.items())},
                {str(r): c for r, c in sorted(world.exit_codes.items())})

    def telemetry(job):
        info["ring_bytes"] = int(job.stats()["telemetry"]["total"].get(
            "ring_bytes", 0))

    error = None
    ops.reset_launch_counts()                # the path starts here
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        ck = d / "world"
        defs = get_api(cfg).param_defs(cfg, 128)
        built = init_params(defs, torch.Generator(device=DEV).manual_seed(0),
                            DEV)
        mgr = CheckpointManager(d / "mesh", generation=0)
        timed("save_s", lambda: (mgr.save(0, built), mgr.wait()))
        info["shm_free_bytes"] = dataplane._shm_free_bytes()
        try:
            # A: the checkpointed run over the ring, one reshape onto proc
            membership = Membership(n)
            job = MPIJob(n, step_fn, init_fn, transport=pw["transport"],
                         membership=membership)
            ring = job._proc.ring
            info["ring"] = (None if ring is None else
                            {"slots": ring.slots,
                             "slot_bytes": ring.slot_bytes})
            ring_expected = (ring is not None and chunk_bytes
                             >= procworld.RING_PAYLOAD_MIN
                             and chunk_bytes <= ring.slot_bytes)
            if not ring_expected:
                info["ring_note"] = (
                    f"a {chunk_bytes} B allreduce chunk does not ride the "
                    f"ring (ring {info['ring']}, payloads from "
                    f"{procworld.RING_PAYLOAD_MIN} B): it ships inline")
            job.checkpoint_at(pw["ckpt_at"], ck, resume=False)
            timed("checkpointed_s",
                  lambda: run_to_end(job, pw["steps"], telemetry))
            pids["checkpointed"], codes = processes(job)
            man = load_manifest(ck)
            checks["image_step"] = man["ranks"]["0"]["step_idx"]
            checks["image_transport"] = man["meta"]["transport"]
            checks["pids_distinct"] = (
                len(set(pids["checkpointed"].values())) == n
                and os.getpid() not in pids["checkpointed"].values())
            checks["exit_codes_zero"] = set(codes.values()) == {0}
            checks["ring_used"] = (info["ring_bytes"] > 0) == ring_expected
            rep = timed("reshape_s", lambda: atomic_reshape(
                membership, dead=dead, mgr=mgr, template=defs,
                mesh=choose_mesh(device=DEV), rules=DEFAULT_RULES,
                ckpt_dir=ck, step_fn=step_fn, init_fn=init_fn,
                transport=pw["reshape_to"]))
            checks["generations"] = [rep.generation, membership.generation,
                                     mgr.generation,
                                     rep.job.coord.generation]
            locals_ = [t.to_local() for t in tree_leaves(rep.state)]
            checks["leaves_equal"] = len(locals_) == len(
                tree_leaves(built)) and all(
                a.device.type == torch.device(DEV).type and torch.equal(a, w)
                for a, w in zip(locals_, tree_leaves(built)))
            del locals_
            rep.state = None             # one tree on the card at a time
            rank_map = rep.job.restore_info["rank_map"]
            checks["survivors_equal_images"] = all(
                params_equal(rep.job.states[new]["params"],
                             load_rank_image(ck, int(old))
                             .state_obj()["params"])
                for old, new in rank_map.items() if new is not None)
            out = timed("reshaped_run_s",
                        lambda: run_to_end(rep.job, pw["steps"]))
            pids["reshaped"], codes = processes(rep.job)
            checks["reshaped_world"] = len(out)
            checks["reshaped_exit_codes_zero"] = set(codes.values()) == {0}
            thread = timed("thread_restart_s",
                           lambda: thread_restart(ck, dead, pw["steps"]))
            checks["reshaped_equal_thread"] = same_runs(out, thread)

            # B: the driver, a real SIGKILL, the restart onto the ring
            kill_file = d / "killed_at"
            kill_rank, kill_step = pw["kill_rank"], pw["kill_step"]

            def killing_step(mpi, st, k):
                if (mpi.generation == 0 and k == kill_step
                        and mpi.rank == kill_rank):
                    kill_file.write_text(repr(time.time()))
                    os.kill(os.getpid(), signal.SIGKILL)
                return step_fn(mpi, st, k)

            jobs, stamps = [], []

            def fresh(ws, ms):
                jobs.append(MPIJob(
                    ws or n, killing_step, init_fn,
                    transport=pw["driver_transport"], heartbeat_timeout=5.0,
                    membership=ms, coord_timeout=30.0))
                return jobs[-1]

            def restarted(ckpt, tr, ws, gone, ms):
                jobs.append(MPIJob.restart(
                    ckpt, killing_step, init_fn, transport=tr, world_size=ws,
                    dead_ranks=gone, membership=ms, heartbeat_timeout=5.0,
                    coord_timeout=30.0))
                return jobs[-1]

            class StampedDriver(FaultTolerantDriver):
                def _event(self, kind, text, **kw):
                    ev = super()._event(kind, text, **kw)
                    stamps.append((time.time(), str(ev)))
                    return ev

            driver = StampedDriver(job_factory=fresh,
                                   restart_factory=restarted,
                                   ckpt_root=d / "driver",
                                   ckpt_every=pw["ckpt_every"])
            got = timed("driver_s", lambda: driver.run(
                pw["driver_steps"], transport_after_failure=pw[
                    "after_failure"], timeout=pw["timeout_s"]))
            events = [str(e) for e in driver.events]
            info["events"] = events
            pids["driver"] = [processes(j)[0] for j in jobs]
            info["driver_exit_codes"] = [processes(j)[1] for j in jobs]
            every = pw["ckpt_every"]
            resumed = f"at_{kill_step // every * every:08d}"
            checks["dead_event"] = any(
                e.startswith(f"dead:[{kill_rank}]") for e in events)
            checks["restart_event"] = any(
                e.startswith(f"restart:{resumed}") for e in events)
            checks["done_last"] = bool(events) and events[-1] == "done"
            checks["sigkilled"] = info["driver_exit_codes"][0].get(
                str(kill_rank)) == -signal.SIGKILL
            checks["driver_generation"] = driver.membership.generation
            checks["driver_world"] = len(got)
            checks["driver_params_equal"] = all(
                params_equal(got[0]["params"], o["params"]) for o in got)
            if (d / "driver" / resumed).is_dir():
                thread = timed("driver_thread_restart_s",
                               lambda: thread_restart(d / "driver" / resumed,
                                                      (kill_rank,),
                                                      pw["driver_steps"]))
                checks["driver_equal_thread"] = same_runs(got, thread)
            at = {e.split(":")[0]: t for t, e in stamps}
            if kill_file.exists() and "dead" in at:
                seconds["kill_to_dead_s"] = at["dead"] - float(
                    kill_file.read_text())
            if "restart" in at and "done" in at:
                seconds["restart_to_done_s"] = at["done"] - at["restart"]

            # C: the CLI in a fresh interpreter, no CUDA
            cli = timed("cli_s", lambda: subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.procrun",
                 *pw["cli_args"], "--ckpt-root", str(d / "cli")],
                cwd=ROOT, capture_output=True, text=True,
                timeout=pw["timeout_s"],
                env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                     "PYTHONPATH": str(ROOT / "src")}))
            done = re.search(r"\[procrun\] done: world=(\d+) "
                             r"generation=(\d+).*", cli.stdout)
            info["cli_done"] = done[0] if done else cli.stdout[-2000:]
            checks["cli_rc"] = cli.returncode
            checks["cli_world_generation"] = (
                [int(done[1]), int(done[2])] if done else None)
            if cli.returncode:
                info["cli_stderr"] = cli.stderr[-2000:]
        except Exception as e:                   # reported in the line
            error = f"{type(e).__name__}: {e}"
        del built
    counts = _launches()                         # ... and ends here
    free()
    want = {"image_step": pw["ckpt_at"], "image_transport": pw["transport"],
            "pids_distinct": True, "exit_codes_zero": True,
            "ring_used": True, "generations": [1, 1, 1, 1],
            "leaves_equal": True, "survivors_equal_images": True,
            "reshaped_world": n - len(dead),
            "reshaped_exit_codes_zero": True, "reshaped_equal_thread": True,
            "dead_event": True, "restart_event": True, "done_last": True,
            "sigkilled": True, "driver_generation": 1,
            "driver_world": n - 1, "driver_params_equal": True,
            "driver_equal_thread": True, "cli_rc": 0,
            "cli_world_generation": [3, 1]}
    ok = (error is None and all(checks.get(k) == v for k, v in want.items())
          and not any(counts.values()))
    emit("procworld", ok, card_line, arch=ARCH, dtype="float32", app=app,
         chunk_bytes=chunk_bytes, ranks=n, dead=list(dead),
         transports=[pw["transport"], pw["reshape_to"], pw["thread_to"],
                     pw["driver_transport"], pw["after_failure"]],
         steps=pw["steps"], driver_steps=pw["driver_steps"],
         kill=[pw["kill_rank"], pw["kill_step"]],
         cli=" ".join(pw["cli_args"]), checks=checks, error=error,
         seconds=seconds, pids=pids, launches=counts, **info)
    return counts


def phase_serve_hybrid(card_line):
    from repro_torch.configs import get_arch
    free_and_reset_peak()
    hs = HYBRID_SERVE
    row, counts, eng = _serve(HYBRID, hs["batch"], hs["prompt"],
                              hs["new_tokens"])
    peak = peak_bytes()
    kinds = get_arch(HYBRID).layer_kinds()
    want = {"flash_attention_fwd": kinds.count("local_attn"),   # 12
            "rglru_scan": kinds.count("rglru"),                 # 26
            "quantize_int8": 0, "dequantize_int8": 0}
    checks = _graph_checks(eng, hs["batch"], hs["prompt"], hs["new_tokens"])
    del eng
    free()
    ok = (counts == want and row["flash_launches"] == want["flash_attention_fwd"]
          and row["rglru_launches"] == want["rglru_scan"]
          and _graphs_ok(checks, counts, want)
          and row["prefill_s"] > 0 and row["decode_s"] > 0)
    emit("serve-hybrid", ok, card_line, arch=HYBRID, batch=hs["batch"],
         prompt_len=hs["prompt"], new_tokens=hs["new_tokens"],
         dtype="bfloat16", prefill_s=row["prefill_s"],
         decode_s=row["decode_s"], tok_per_s=row["tok_per_s"],
         launches=counts, expected_launches=want, peak_bytes=peak, **checks)
    return counts


def _continue(eng, cache, generated, pos, n):
    """n greedy decode steps from a serving snapshot: the last generated
    token goes in at pos - 1 (pos is one past the next cache slot).
    Returns the tokens and every step's logits."""
    import torch
    tok = torch.as_tensor(generated[:, -1:], dtype=torch.long,
                          device=eng.device)
    pos = pos.to(torch.long) - 1
    toks, logits = [], []
    params, cache = _local(eng.params), _local(cache)
    with torch.inference_mode():
        for _ in range(n):
            lg, cache = eng.api.decode(eng.cfg, params, cache, tok, pos,
                                       eng.policy)
            tok = torch.argmax(lg, dim=-1)[:, None]
            pos = pos + 1
            toks.append(tok)
            logits.append(lg)
    return torch.cat(toks, dim=1).cpu(), torch.stack(logits)


def _hybrid_engine():
    """recurrentgemma-9b at full width behind a ServeEngine, after one
    round of HYBRID_SERVE through the kernels.  Returns the engine, the
    round's result and the round's prefill launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    from repro_torch.models.registry import get_api
    from repro_torch.serve.engine import ServeEngine
    hs = HYBRID_SERVE
    cfg = get_arch(HYBRID)
    max_seq = hs["prompt"] + hs["new_tokens"] + SNAPSHOT_CONTINUE + 8
    params = init_params(get_api(cfg).param_defs(cfg, max_seq),
                         torch.Generator(device=DEV).manual_seed(0), DEV)
    eng = ServeEngine(cfg, params, max_seq=max_seq, device=DEV)
    del params                                  # the engine keeps its cast
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (hs["batch"], hs["prompt"])).astype(np.int32)
    before = {"flash": ops.FLASH_LAUNCHES, "rglru": ops.RGLRU_LAUNCHES}
    _backends(True)
    try:
        res = eng.generate(prompts, hs["new_tokens"])
    finally:
        _backends(False)
    launches = {"flash": ops.FLASH_LAUNCHES - before["flash"],
                "rglru": ops.RGLRU_LAUNCHES - before["rglru"]}
    return eng, res, launches


_SHARDED_CHILD = r"""
import json, pickle, time
import numpy as np
import torch
from repro_torch.distributed.sharding import (DEFAULT_RULES, is_dtensor,
    param_shardings, sharding_ctx, window)
from repro_torch.launch.mesh import join_world, make_mesh
from repro_torch.models import model as lm
from repro_torch.models.layers import Policy
from repro_torch.models.params import init_params, is_pm, tree_leaves
from repro_torch.models.registry import get_api
from repro_torch.serve.engine import ServeEngine
args = json.loads(ARGS)
rank = join_world()
mesh = make_mesh(tuple(args["mesh"]), ("data", "model"), device="cpu")
coord = mesh.get_coordinate()
cfg = pickle.loads(bytes.fromhex(args["cfg"]))
b, p, n = args["batch"], args["prompt"], args["new_tokens"]
max_seq = p + n + 8
fp32 = Policy(compute=torch.float32)
api = get_api(cfg)
defs = api.param_defs(cfg, max_seq)
params = init_params(defs, torch.Generator().manual_seed(0), "cpu")
prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, p))
t0 = time.perf_counter()
eng = ServeEngine(cfg, params, max_seq=max_seq, policy=fp32, mesh=mesh,
                  rules=DEFAULT_RULES)
res = eng.generate(prompts, n)
serve_s = time.perf_counter() - t0
plain = ServeEngine(cfg, params, max_seq=max_seq, policy=fp32, device="cpu")
ref = plain.generate(prompts, n)

# the prefill's blocks, each path chained on its own output
tokens = torch.as_tensor(prompts, dtype=torch.long)
blocks, scales = [], []
with torch.no_grad():
    x = lm._embed_in(cfg, params, tokens, {}, fp32)
    pos = lm._positions(b, p, "cpu")
    with sharding_ctx(mesh, DEFAULT_RULES):
        xs = lm._embed_in(cfg, eng.params, lm._tokens_in(tokens), {}, fp32)
        pos_s = lm._positions(b, p, "cpu")
    _, unit, n_units, _ = lm.stack_plan(cfg)
    for u, us in zip(lm._unstack(params["units"], n_units),
                     lm._unstack(eng.params["units"], n_units)):
        for i, kind in enumerate(unit):
            x = lm.apply_block(cfg, kind, u[f"b{i}"], x, pos, fp32)[0]
            with sharding_ctx(mesh, DEFAULT_RULES):
                xs = lm.apply_block(cfg, kind, us[f"b{i}"], xs, pos_s,
                                    fp32)[0]
            blocks.append(float((xs.full_tensor() - x).abs().max()))
            scales.append(float(x.abs().max()))

# each rank's bytes: held, and the sum of its windows by the layouts
def held(tree):
    return sum(t.to_local().numel() * t.element_size()
               for t in tree_leaves(tree))
def windows(defs, dtype_of):
    total = 0
    for d, lay in zip(tree_leaves(defs, is_leaf=is_pm),
                      tree_leaves(param_shardings(defs, mesh,
                                                  DEFAULT_RULES))):
        win = window(lay.placements, d.shape, tuple(mesh.shape), coord)
        total += int(np.prod([e - a for a, e in win])) * dtype_of(d)
    return total
cdefs = api.cache_defs(cfg, b, max_seq, torch.float32)
size = lambda dt: torch.empty((), dtype=dt).element_size()
attn = eng.params["units"]["b0"]["attn"]
print(json.dumps({
    "rank": rank, "coord": coord, "serve_s": serve_s,
    "tokens_equal": bool(np.array_equal(res.tokens, ref.tokens)),
    "logits_max_abs_diff": float((eng.last_logits(b)
                                  - plain.last_logits(b)).abs().max()),
    "block_max_abs_diff": blocks, "block_scale": scales,
    "param_bytes": held(eng.params), "param_window_bytes": windows(
        defs, lambda d: size(d.dtype)),
    "param_bytes_whole": sum(t.numel() * t.element_size()
                             for t in tree_leaves(params)),
    "cache_bytes": held(eng.cache), "cache_window_bytes": windows(
        cdefs, lambda d: size(d.dtype)),
    "split": {"wq": str(attn["wq"].placements),
              "mlp_wi": str(eng.params["units"]["b0"]["mlp"]["wi"].placements),
              "embedding": str(eng.params["embed"]["embedding"].placements)}}))
"""

_FIRST_DTENSOR = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
from repro_torch.launch.mesh import make_local_mesh
t1 = time.perf_counter()
mesh = make_local_mesh(device=sys.argv[1])
t2 = time.perf_counter()
from torch.distributed.tensor import DTensor, Replicate
def op():
    x = DTensor.from_local(torch.ones(4, device=sys.argv[1]), mesh,
                           [Replicate()] * mesh.ndim, run_check=False)
    y = (x * 2).sum().full_tensor()
    if sys.argv[1] == "cuda":
        torch.cuda.synchronize()
op()
t3 = time.perf_counter()
op()
t4 = time.perf_counter()
print(json.dumps({"imports_s": t1 - t0, "mesh_s": t2 - t1,
                  "first_op_s": t3 - t2, "second_op_s": t4 - t3}))
"""


def _sharded_worlds() -> list:
    """The sharded child in each CPU world; each rank's JSON."""
    import pickle

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import run_world
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=SHARDED["layers"])
    out = []
    for n, mesh in SHARDED["worlds"]:
        args = {k: SHARDED[k] for k in ("batch", "prompt", "new_tokens")}
        args.update(mesh=list(mesh), cfg=pickle.dumps(cfg).hex())
        t0 = time.perf_counter()
        outs = run_world(n, f"ARGS = {json.dumps(args)!r}\n" + _SHARDED_CHILD,
                         timeout_s=SHARDED["world_timeout_s"],
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         cwd=ROOT)
        out.append({"ranks": n, "mesh": {"data": mesh[0], "model": mesh[1]},
                    "world_s": time.perf_counter() - t0,
                    "per_rank": [json.loads(o.strip().splitlines()[-1])
                                 for o in outs]})
    return out


def _first_dtensor() -> dict:
    """The seconds a fresh process on this host takes to its first DTensor
    op on a 1-rank mesh of the card (imports, mesh, first and second op)."""
    proc = subprocess.run(
        [sys.executable, "-c", _FIRST_DTENSOR, DEV], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if proc.returncode:
        raise RuntimeError(proc.stderr[-3000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_sharded(card_line):
    """recurrentgemma-9b at full width through the sharded engine on this
    process's 1-rank mesh beside the plain engine over the same storage;
    a fresh process's first DTensor; the CPU worlds.  Returns the launch
    counts of the sharded engine's second request (its graphs' replays),
    the path's."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.layers import DEFAULT_POLICY
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.models.registry import get_api
    from repro_torch.serve.engine import ServeEngine
    free_and_reset_peak()
    hs = HYBRID_SERVE
    b, p, n_new = hs["batch"], hs["prompt"], hs["new_tokens"]
    cfg = get_arch(HYBRID)
    max_seq = p + n_new + 8
    # drawn in the compute dtype, as the serve CLI draws it: both engines'
    # casts are no-ops, and the DTensors wrap the plain tensors' storage
    params = init_params(get_api(cfg).param_defs(cfg, max_seq),
                         torch.Generator(device=DEV).manual_seed(0), DEV,
                         compute=DEFAULT_POLICY.compute)
    plain = ServeEngine(cfg, params, max_seq=max_seq, device=DEV)
    t0 = time.perf_counter()
    mesh = make_local_mesh(device=DEV)
    eng = ServeEngine(cfg, params, max_seq=max_seq, mesh=mesh,
                      rules=DEFAULT_RULES)
    lay_out_s = time.perf_counter() - t0
    del params
    shared = all(t.to_local().data_ptr() == u.data_ptr() for t, u in zip(
        tree_leaves(eng.params), tree_leaves(plain.params)))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, p)).astype(np.int32)
    out = {}
    _backends(True)
    try:
        for name, e in (("plain", plain), ("sharded", eng)):
            first = e.generate(prompts, n_new)       # captures
            out[name] = {"capture_s": e.capture_s,
                         "first_prefill_s": first.prefill_s}
        ops.reset_launch_counts()                    # the main path starts
        res = eng.generate(prompts, n_new)
        counts = _launches()                         # ... and ends here
        ref = plain.generate(prompts, n_new)
        for name, r in (("plain", ref), ("sharded", res)):
            out[name].update(prefill_s=r.prefill_s,
                             decode_step_ms=r.decode_s / (n_new - 1) * 1e3)
        checks = {"tokens_equal": bool(np.array_equal(res.tokens,
                                                      ref.tokens)),
                  "logits_equal": bool(torch.equal(eng.last_logits(b),
                                                   plain.last_logits(b)))}
        with ops.uncounted():                        # the same, uncaptured
            eager = {}
            for name, e in (("plain", plain), ("sharded", eng)):
                e._use_graphs = lambda: False
                try:
                    eager[name] = e.generate(prompts, n_new)
                finally:
                    del e._use_graphs
                out[name].update(
                    uncaptured_prefill_s=eager[name].prefill_s,
                    uncaptured_decode_step_ms=eager[name].decode_s
                    / (n_new - 1) * 1e3)
        checks["uncaptured_tokens_equal"] = bool(np.array_equal(
            eager["sharded"].tokens, ref.tokens))
    finally:
        _backends(False)
    peak = peak_bytes()
    del eng, plain
    free()
    first_dtensor = _first_dtensor()
    worlds = _sharded_worlds()
    tol = SHARDED["tol"]
    world_ok = all(
        r["tokens_equal"] and r["logits_max_abs_diff"] <= tol
        and all(d <= tol * max(1.0, sc) for d, sc in
                zip(r["block_max_abs_diff"], r["block_scale"]))
        and r["param_bytes"] == r["param_window_bytes"]
        and r["cache_bytes"] == r["cache_window_bytes"]
        for w in worlds for r in w["per_rank"])
    want = {"flash_attention_fwd": 12, "rglru_scan": 26}
    if DEV != "cuda":           # smoke widths: one per block of each kind
        kinds = cfg.layer_kinds()
        want = {"flash_attention_fwd": kinds.count("local_attn"),
                "rglru_scan": kinds.count("rglru")}
    ok = (shared and all(checks.values()) and world_ok
          and all(counts[k] == v for k, v in want.items()))
    emit("sharded", ok, card_line, arch=HYBRID, dtype="bfloat16",
         batch=b, prompt_len=p, new_tokens=n_new,
         mesh={"data": 1, "model": 1}, rules="baseline",
         storage_shared=shared, lay_out_s=lay_out_s, launches=counts,
         expected_launches=want, peak_bytes=peak, **checks, **out,
         first_dtensor=first_dtensor,
         worlds={"arch": ARCH, "layers": SHARDED["layers"],
                 "dtype": "float32", "batch": SHARDED["batch"],
                 "prompt_len": SHARDED["prompt"],
                 "new_tokens": SHARDED["new_tokens"], "tol": tol,
                 "note": "9 query and 3 kv heads do not divide model = 2: "
                         "the attention stays replicated; the ffn and the "
                         "vocab split", "runs": worlds})
    return counts


def _snapshot_host_copy(eng, res):
    """The serving snapshot's payload, copied to the host."""
    import torch
    from repro_torch.models.params import tree_map
    return {"cache": tree_map(lambda t: t.to("cpu", copy=True), eng.cache),
            "pos": eng.pos.to(torch.int32).cpu(), "generated": res.tokens}


def phase_snapshot_hybrid(card_line):
    """The serving snapshot at full width: recurrentgemma-9b generates
    through the kernels and snapshots; the live engine and the snapshot,
    restored onto the card, each decode SNAPSHOT_CONTINUE more tokens."""
    import torch
    from repro_torch.checkpoint import serialization as ser
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.checkpoint.resharding import plan_summary
    from repro_torch.kernels import ops
    free_and_reset_peak()
    hs = HYBRID_SERVE
    ops.reset_launch_counts()
    eng, res, launches = _hybrid_engine()
    capture_s = eng.capture_s                   # the snapshot is a graph's
    with tempfile.TemporaryDirectory() as root:
        mgr = CheckpointManager(root)
        t0 = time.perf_counter()
        eng.snapshot_service(mgr, 0)
        save_s = time.perf_counter() - t0
        host = _snapshot_host_copy(eng, res)
        step = Path(root) / "step_0000000000"
        plan = plan_summary(step)
        save = {k: mgr.stats[k] for k in _SAVE_STATS}
        encodings = {k: e["shards"][0]["chunk"].rsplit(".", 1)[1]
                     for k, e in ser.load_manifest(step)["leaves"].items()}
        live, live_logits = _continue(eng, eng.cache, res.tokens, eng.pos,
                                      SNAPSHOT_CONTINUE)
        t0 = time.perf_counter()
        snap, meta = mgr.restore(host, device=DEV)
        sync()
        restore_s = time.perf_counter() - t0
        restore = {k: mgr.stats[k] for k in _RESTORE_STATS}
    equal = _leaves_equal(host, snap)
    cont, cont_logits = _continue(eng, snap["cache"],
                                  snap["generated"].cpu().numpy(),
                                  snap["pos"], SNAPSHOT_CONTINUE)
    sync()
    logits_diff = float((live_logits.float() - cont_logits.float()).abs().max())
    ok = (equal and torch.equal(live, cont) and meta["kind"] == "serve"
          and bool(torch.isfinite(cont_logits).all())
          and (capture_s > 0) == (DEV == "cuda"))
    del eng, snap, live_logits, cont_logits
    emit("snapshot-hybrid", ok, card_line, arch=HYBRID, dtype="bfloat16",
         batch=hs["batch"], prompt_len=hs["prompt"],
         new_tokens=hs["new_tokens"], continue_steps=SNAPSHOT_CONTINUE,
         capture_s=capture_s, prefill_launches=launches,
         snapshot_leaves=plan["n_leaves"],
         snapshot_bytes=plan["approx_bytes"],
         compressed_bytes=plan.get("compressed_bytes"), encodings=encodings,
         save_s=save_s, save=save, restore_s=restore_s, restore=restore,
         leaves_equal=equal, tokens_equal=bool(torch.equal(live, cont)),
         continuation_tokens=live.tolist(), logits_max_abs_diff=logits_diff,
         peak_bytes=peak_bytes())


# ------------------------------------------------------------------ moe

def phase_serve_parity_moe(card_line):
    """qwen2-moe-a2.7b at full width, fp32: flash against chunked attention
    block by block over all 24 blocks (an MoE block's difference over the
    tokens routed alike on both paths, each routing flip with its top-k
    margin), and end to end at a 2-layer cut."""
    free_and_reset_peak()
    ok, cfg, out = _parity(MOE, 1, MOE_PARITY_PROMPT, 8, MOE_CUT_LAYERS)
    want = {"flash": cfg.n_layers, "rglru": 0}
    ok = ok and out["prefill_launches"] == want
    flips = out["routing_flips"]
    emit("serve-parity-moe", ok, card_line, arch=MOE, dtype="float32",
         batch=1, prompt=MOE_PARITY_PROMPT, new_tokens=8,
         cut_layers=MOE_CUT_LAYERS, tolerance=PARITY_TOL, route_tie=ROUTE_TIE,
         expected_launches=want,
         routing_flip_tokens=sum(f["tokens"] for f in flips),
         routing_moved_tokens=sum(f["routing_moved"] for f in flips),
         peak_bytes=peak_bytes(), **out)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def decode_bound(eng, batch, prompt, new_tokens) -> dict:
    """What a decode step of a request of ``batch`` x ``prompt`` with
    ``new_tokens`` must move, at the card's memory rate.

    ``weight_bytes``: every weight once; the input embedding only where
    the lm_head is that embedding (tied: the head reads all of it), since
    untied the step gathers B rows of it.  At S = 1 the MoE products run
    every expert.  ``state_bytes``: the cache and state the step reads
    and writes, in place: a recurrent state (mLSTM C, n, m and conv
    window; sLSTM c, n, h, m; RG-LRU conv and h) read and written whole; a
    self-attention K/V or an MLA cache read up to the step's position and
    one slot written, at the mean over the request's decode steps (P +
    n_new / 2 slots read; a window clips it); whisper's cross K/V read
    whole."""
    from repro_torch.checkpoint.serialization import _leaf_paths
    from repro_torch.models.params import tree_leaves
    weight = sum(_nbytes(t) for t in tree_leaves(eng.params))
    if not eng.cfg.tie_embeddings:
        weight -= _nbytes(eng.params["embed"]["embedding"])
    slots = prompt + new_tokens / 2
    state = 0.0
    for key, t in _leaf_paths(eng._batches[batch].cache):
        parts = key.split("/")
        if "cross" in parts:
            state += _nbytes(t)                     # read whole
        elif parts[-1] in ("k", "v", "c_kv", "k_rope"):
            seq = t.shape[t.dim() - (3 if parts[-1] in ("k", "v") else 2)]
            state += _nbytes(t) / seq * (min(seq, slots) + 1)
        else:
            state += 2 * _nbytes(t)                 # read and written
    return {"weight_bytes": weight, "state_bytes": int(state),
            "bound_ms": (weight + state) / HBM_BYTES_PER_S * 1e3}


def _serve_cell(arch, flash_launches, shape=None, snapshot_dir=None):
    """One serve cell: the CLI's round at ``shape`` (MOE_SERVE by
    default), then the graph checks of ``serve`` with the CLI's extras;
    the decode step beside its bound."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import request_extras
    ms = shape or MOE_SERVE
    row, counts, eng = _serve(arch, ms["batch"], ms["prompt"],
                              ms["new_tokens"], snapshot_dir)
    peak = peak_bytes()
    want = {"flash_attention_fwd": flash_launches, "rglru_scan": 0,
            "quantize_int8": 0, "dequantize_int8": 0}
    checks = _graph_checks(eng, ms["batch"], ms["prompt"], ms["new_tokens"],
                           request_extras(eng.cfg, ms["batch"]))
    bound = decode_bound(eng, ms["batch"], ms["prompt"], ms["new_tokens"])
    step_ms = checks["second_request"]["decode_step_ms"]
    ok = (counts == want and row["flash_launches"] == flash_launches
          and _graphs_ok(checks, counts, want)
          and row["prefill_s"] > 0 and row["decode_s"] > 0)
    fields = dict(arch=arch, batch=ms["batch"], prompt_len=ms["prompt"],
                  new_tokens=ms["new_tokens"], dtype="bfloat16",
                  n_params=get_arch(arch).n_params(),
                  prefill_s=row["prefill_s"], decode_s=row["decode_s"],
                  tok_per_s=row["tok_per_s"], launches=counts,
                  expected_launches=want, peak_bytes=peak,
                  decode_bound={**bound, "share_of_bound":
                                bound["bound_ms"] / step_ms},
                  **checks)
    return ok, eng, fields, counts


def phase_serve_moe(card_line):
    """The repro_torch.launch.serve path, qwen2-moe-a2.7b at full width:
    24 flash launches a request, one a layer."""
    from repro_torch.configs import get_arch
    free_and_reset_peak()
    ok, eng, fields, counts = _serve_cell(MOE, get_arch(MOE).n_layers)
    del eng
    free()
    emit("serve-moe", ok, card_line, **fields)
    return counts


def mla_absorbed_vs_expanded(eng, b=2):
    """Each layer's MLA weights (the engine's, in fp32): the absorbed
    decode at position S-1, after a prefill over S-1 tokens, against the
    expanded forward's last row, on unit-RMS inputs (what the block's
    norm hands it), S the serving prompt.

    The reference's fan_in (shape[-2], the 16 heads, for wq) makes these
    scores large (std ~52 at S = 512; the top prob of a row ~0.99996), so
    the last row's outputs reach |y| ~ 100 and move by ~5e-4 when the
    input moves by 1e-7 relative: fp32 alone is that far from itself.
    Each layer's difference is therefore held at PARITY_TOL of its output
    scale (max |y|, at least 1), and reported beside that noise floor."""
    import torch
    from repro_torch.models import attention as att
    from repro_torch.models import model as lm
    from repro_torch.models.layers import Policy
    from repro_torch.models.params import tree_map
    fp32 = Policy(compute=torch.float32)
    cfg, s = eng.cfg, MOE_SERVE["prompt"]
    _, unit, n_units, _ = lm.stack_plan(cfg)
    params = _local(eng.params)
    layers = ([p["attn"] for p in params["prefix"]]
              + [u[f"b{i}"]["attn"]
                 for u in lm._unstack(params["units"], n_units)
                 for i in range(len(unit))])
    gen = torch.Generator(device=DEV).manual_seed(3)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=DEV)
    pos = torch.arange(s, device=DEV)
    rows = {"max_abs_diff": [], "output_scale": [], "noise_floor": []}
    with torch.inference_mode():
        for p in layers:
            p32 = tree_map(lambda t: t.float(), p)
            full = att.mla_forward(cfg, p32, x, pos, policy=fp32)[:, -1]
            moved = att.mla_forward(cfg, p32, x * (1 + 1e-7), pos,
                                    policy=fp32)[:, -1]
            _, cache = att.mla_prefill(cfg, p32, x[:, :s - 1], pos[:s - 1], s,
                                       policy=fp32)
            y, _ = att.mla_decode(cfg, p32, x[:, s - 1:], cache,
                                  torch.full((b,), s - 1, device=DEV),
                                  policy=fp32)
            rows["max_abs_diff"].append(float((y[:, 0] - full).abs().max()))
            rows["output_scale"].append(float(full.abs().max()))
            rows["noise_floor"].append(float((moved - full).abs().max()))
    rel = [d / max(1.0, sc) for d, sc in zip(rows["max_abs_diff"],
                                             rows["output_scale"])]
    return {"layers": len(rel), "batch": b, "seq": s,
            "max_abs_diff": max(rows["max_abs_diff"]),
            "max_diff_over_scale": max(rel),
            "max_noise_floor": max(rows["noise_floor"]),
            "per_layer": rows}


def mla_cache_bytes(eng, b) -> dict:
    """The engine's compressed cache (c_kv and k_rope a layer) beside an
    expanded K/V cache of the same length and dtype (k and v of every
    head)."""
    from repro_torch.models.params import tree_leaves
    cfg, m = eng.cfg, eng.cfg.mla
    leaves = tree_leaves(eng._batches[b].cache)
    compressed = sum(t.numel() * t.element_size() for t in leaves)
    expanded = (cfg.n_layers * b * eng.max_seq * cfg.n_heads
                * (m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim)
                * leaves[0].element_size())
    return {"compressed_bytes": compressed, "expanded_bytes": expanded,
            "ratio": expanded / compressed}


def phase_serve_mla(card_line):
    """The repro_torch.launch.serve path, deepseek-v2-lite-16b at full
    width: MLA's q head dim 192 is not v's 128, so no flash launch; the
    serving snapshot (a dense MLA prefix block, then 26 MoE blocks)
    validates; the absorbed decode against the expanded path on every
    layer's weights (``mla_absorbed_vs_expanded``); the compressed
    cache's bytes."""
    from repro_torch.checkpoint import serialization as ser
    from repro_torch.checkpoint.resharding import plan_summary
    free_and_reset_peak()
    ms = MOE_SERVE
    with tempfile.TemporaryDirectory() as snap:
        ok, eng, fields, counts = _serve_cell(MLA, 0, snapshot_dir=snap)
        step = Path(snap) / "step_0000000000"
        valid = ser.validate(step, deep=True)
        plan = plan_summary(step)
    want_leaves = _payload_leaves(MLA, ms["batch"],
                                  ms["prompt"] + ms["new_tokens"] + 8)
    absorbed = mla_absorbed_vs_expanded(eng)
    cache = mla_cache_bytes(eng, ms["batch"])
    del eng
    free()
    ok = (ok and valid and plan["n_leaves"] == want_leaves
          and absorbed["max_diff_over_scale"] <= PARITY_TOL)
    emit("serve-mla", ok, card_line, **fields, tolerance=PARITY_TOL,
         absorbed_vs_expanded=absorbed, cache=cache,
         snapshot={"valid": valid, "n_leaves": plan["n_leaves"],
                   "expected_leaves": want_leaves,
                   "approx_bytes": plan["approx_bytes"]})
    return counts


# ------------------------------------------------------ xLSTM, whisper

def _held(diff, scale) -> bool:
    """The reference's 2e-3 where it holds; beyond it, PARITY_TOL of the
    output's scale (a full-width random stack's outputs grow with depth)."""
    return diff <= max(REFERENCE_TOL, PARITY_TOL * scale)


def xlstm_chunkwise_vs_recurrent(cfg, params, tokens, split) -> dict:
    """Every block of an xLSTM stack, each from the same input (the
    chunkwise output of the block before): the chunkwise form over all S
    tokens against the chunkwise form over the first ``split`` followed by
    S - split recurrent decode steps.  Per kind: the blocks, the largest
    difference, the output scale (largest |y|), the fp32 noise floor (the
    chunkwise output moved by a 1e-7 relative change of its input), the
    final state's largest difference over its scale, and whether every
    block is held (``_held``)."""
    import torch
    from repro_torch.models import model as lm
    from repro_torch.models import xlstm as xl
    from repro_torch.models.layers import Policy
    fp32 = Policy(compute=torch.float32)
    forms = {"mlstm": (xl.mlstm_apply, xl.mlstm_decode),
             "slstm": (xl.slstm_apply, xl.slstm_decode)}
    _, unit, n_units, _ = lm.stack_plan(cfg)
    s = tokens.shape[1]
    x = lm._embed_in(cfg, params, tokens, {}, fp32)
    rows = {}
    for unit_p in lm._unstack(params["units"], n_units):
        for i, kind in enumerate(unit):
            p = unit_p[f"b{i}"]
            apply, decode = forms[kind]
            full, full_state = apply(cfg, p, x, fp32)
            moved, _ = apply(cfg, p, x * (1 + 1e-7), fp32)
            y, state = apply(cfg, p, x[:, :split], fp32)
            ys = [y]
            for t in range(split, s):
                y, state = decode(cfg, p, x[:, t:t + 1], state, fp32)
                ys.append(y)
            diff = float((torch.cat(ys, dim=1) - full).abs().max())
            scale = float(full.abs().max())
            state_gap = max(float((state[k] - full_state[k]).abs().max())
                            / max(float(full_state[k].abs().max()), 1e-30)
                            for k in full_state)
            r = rows.setdefault(kind, {"blocks": 0, "max_abs_diff": 0.0,
                                       "output_scale": 0.0,
                                       "noise_floor": 0.0,
                                       "state_diff_over_scale": 0.0,
                                       "held": True})
            r["blocks"] += 1
            r["max_abs_diff"] = max(r["max_abs_diff"], diff)
            r["output_scale"] = max(r["output_scale"], scale)
            r["noise_floor"] = max(r["noise_floor"],
                                   float((moved - full).abs().max()))
            r["state_diff_over_scale"] = max(r["state_diff_over_scale"],
                                             state_gap)
            r["held"] = r["held"] and _held(diff, scale)
            x = full
    return rows


def _xlstm_cut(cfg, params, tokens, max_seq) -> dict:
    """End to end at a depth cut: the forward's logits over the cut's
    tokens against a prefill and teacher-forced decode steps over the
    same tokens; the greedy tokens of the engine (its graphs on CUDA)
    against greedy tokens by the forward; the forward's logits on the
    card against the port's on the CPU."""
    import torch
    from repro_torch.models import model as lm
    from repro_torch.models.layers import Policy
    from repro_torch.models.params import tree_map
    from repro_torch.serve.engine import ServeEngine
    fp32 = Policy(compute=torch.float32)
    xp = XLSTM_PARITY
    s, p, n = xp["cut_seq"], xp["cut_prefill"], xp["greedy"]
    toks = tokens[:, :s]
    full = lm.lm_forward(cfg, params, {"tokens": toks}, fp32)[0]
    moved = dict(params, embed={**params["embed"], "embedding":
                                params["embed"]["embedding"] * (1 + 1e-7)})
    noise = float((lm.lm_forward(cfg, moved, {"tokens": toks}, fp32)[0]
                   - full).abs().max())
    del moved
    lg, cache = lm.lm_prefill(cfg, params, toks[:, :p], {}, max_seq, fp32)
    steps = [lg]
    for t in range(p, s - 1):
        lg, cache = lm.lm_decode(cfg, params, cache, toks[:, t:t + 1],
                                 torch.full((toks.shape[0],), t, device=DEV),
                                 fp32)
        steps.append(lg)
    del cache
    recurrent = torch.stack(steps, dim=1)               # positions p-1..s-2
    diff = float((recurrent - full[:, p - 1:s - 1]).abs().max())
    scale = float(full.abs().max())
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu = lm.lm_forward(cfg, cpu_params, {"tokens": toks.cpu()}, fp32)[0]
    cpu_diff = float((full.cpu() - cpu).abs().max())
    del cpu_params, cpu
    eng = ServeEngine(cfg, params, max_seq=max_seq, policy=fp32, device=DEV)
    engine_tokens = eng.generate(toks[:, :p].cpu().numpy(), n).tokens
    seq = toks[:, :p]
    for _ in range(n):                  # greedy by the chunkwise forward
        nxt = torch.argmax(lm.lm_forward(cfg, params, {"tokens": seq},
                                         fp32)[0][:, -1], dim=-1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    forward_tokens = seq[:, p:].cpu().numpy()
    ctx = torch.cat([toks[:, :p], torch.as_tensor(engine_tokens, device=DEV,
                                                  dtype=torch.long)], dim=1)
    logits = lm.lm_forward(cfg, params, {"tokens": ctx}, fp32)[0]
    flips, bad = _greedy_flips(engine_tokens, forward_tokens,
                               logits.float().cpu().numpy(), p)
    del eng
    return {"layers": cfg.n_layers, "seq": s, "prefill": p,
            "logits_diff": diff, "logits_scale": scale, "noise_floor": noise,
            "card_vs_cpu_logits_diff": cpu_diff,
            "tokens_engine": engine_tokens.tolist(), "tie_flips": flips,
            "bad_flips": bad,
            "held": (_held(diff, scale) and _held(cpu_diff, scale)
                     and not bad)}


def phase_serve_parity_xlstm(card_line):
    """xlstm-1.3b at full width (seeded random weights), fp32, B=1: the
    chunkwise mLSTM over XLSTM_PARITY["prompt"] tokens (two chunks)
    against its first chunk and recurrent decode steps, and the sLSTM scan
    against itself and its decode steps, block by block over all 48
    blocks; end to end at a one-unit cut (``_xlstm_cut``).  No kernel runs
    (no TPU kernel computes either block)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import model as lm
    from repro_torch.models.params import init_params
    free_and_reset_peak()
    xp = XLSTM_PARITY
    cfg = get_arch(XLSTM)
    max_seq = xp["prompt"] + 8
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, xp["prompt"])).astype(np.int32)
    tokens = torch.as_tensor(prompts, dtype=torch.long, device=DEV)
    ops.reset_launch_counts()
    with torch.inference_mode():
        params = init_params(lm.lm_param_defs(cfg, max_seq),
                             torch.Generator(device=DEV).manual_seed(0), DEV)
        blocks = xlstm_chunkwise_vs_recurrent(cfg, params, tokens,
                                              xp["split"])
        del params
        free()
        cut = dataclasses.replace(cfg, n_layers=XLSTM_CUT_LAYERS)
        params = init_params(lm.lm_param_defs(cut, max_seq),
                             torch.Generator(device=DEV).manual_seed(0), DEV)
        end = _xlstm_cut(cut, params, tokens, max_seq)
        del params
    sync()
    launches = _launches()
    free()
    ok = (all(r["held"] for r in blocks.values()) and end["held"]
          and blocks["mlstm"]["blocks"] + blocks["slstm"]["blocks"]
          == cfg.n_layers and not any(launches.values()))
    emit("serve-parity-xlstm", ok, card_line, arch=XLSTM, dtype="float32",
         batch=1, prompt=xp["prompt"], split=xp["split"],
         cut_layers=XLSTM_CUT_LAYERS,
         tolerance={"reference": REFERENCE_TOL,
                    "of_output_scale": PARITY_TOL},
         blocks=blocks, cut=end, launches=launches, peak_bytes=peak_bytes())


def _graphed(fn):
    """``fn`` captured into its own CUDA graph (after a warm-up on a side
    stream): the graph's replay."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def _host_ms(fn) -> float:
    """ms of one call of ``fn`` by the host clock, after a synchronize."""
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


def block_times(eng, b, p) -> dict:
    """The engine's prefill step at B x P (its own graph's replay, and its
    step called eagerly), and one block of each kind of the stack's unit
    at that shape (the compute dtype, unit-RMS input), each timed
    uncaptured (the host clock around one call, every op dispatched from
    Python) and captured (a CUDA graph's replay, by CUDA events; on the
    CPU None); each kind's block time times its count of blocks, over the
    prefill's the same way: its share of the prefill.  All in one place,
    so both sides of a share see the same host; on a mesh both run the
    sharded forward, in the engine's sharding context."""
    import torch
    from repro_torch.distributed.sharding import replicate
    from repro_torch.kernels import ops
    from repro_torch.models import model as lm
    cfg = eng.cfg
    _, unit, n_units, _ = lm.stack_plan(cfg)
    unit_p = lm._unstack(eng.params["units"], n_units)[0]
    batch = eng._batches[b]
    prompt = next(pr for key, pr in eng._prompts.items() if key[0] == (b, p))
    gen = torch.Generator(device=DEV).manual_seed(4)
    with eng._ctx():
        x = replicate(torch.randn((b, p, cfg.d_model), generator=gen,
                                  device=DEV).to(eng.policy.compute))
        positions = lm._positions(b, p, DEV)
    kinds = cfg.layer_kinds()

    def timed(fn, graphed=None) -> dict:
        fn()                                        # warm
        return {"uncaptured": _host_ms(fn), "captured": None
                if DEV != "cuda" else cuda_ms(graphed or _graphed(fn))}

    _backends(True)                 # what the CLI selected: its graphs' key
    try:
        with eng.no_grad(), ops.uncounted():
            graphed = eng._programs(batch, prompt)[0]
            prefill = timed(lambda: eng._prefill_step(batch, prompt),
                            graphed if DEV == "cuda" else None)
    finally:
        _backends(False)
    out = {"prefill_ms": prefill}
    with eng.no_grad(), ops.uncounted(), eng._ctx():
        for i, kind in enumerate(unit):
            if kind in out:
                continue
            ms = timed(lambda i=i, kind=kind: lm.apply_block(
                cfg, kind, unit_p[f"b{i}"], x, positions, eng.policy))
            n = kinds.count(kind)
            out[kind] = {"blocks": n, "block_ms": ms, "share_of_prefill": {
                way: None if t is None else n * t / prefill[way]
                for way, t in ms.items()}}
    return out


def phase_serve_xlstm(card_line):
    """The repro_torch.launch.serve path, xlstm-1.3b at full width, bf16,
    B=4, prompt 512 (two mLSTM chunks), 32 new tokens: no kernel launch,
    the graph checks of ``serve``, the decode step beside its bound (the
    weights and the mLSTM's C, read and written), and each block kind's
    share of the prefill (``block_times``)."""
    free_and_reset_peak()
    xs = XLSTM_SERVE
    ok, eng, fields, counts = _serve_cell(XLSTM, 0, xs)
    shares = block_times(eng, xs["batch"], xs["prompt"])
    del eng
    free()
    emit("serve-xlstm", ok, card_line, **fields, block_times=shares)
    return counts


def _whisper_parity() -> dict:
    """whisper-tiny at full width (seeded random weights), fp32, B=1,
    prompt WHISPER_PARITY_PROMPT, with the CLI's frames: flash against
    chunked attention in each decoder block, each from the same input
    (beside the block's output scale and its fp32 noise floor, the output
    moved by a 1e-7 relative change of its input);
    the prefill's flash launches; logits end to end at full depth; greedy
    tokens of the engine through the kernel against the plain path, a
    flip tolerated only at a near tie of the plain path's teacher-forced
    logits."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import request_extras
    from repro_torch.models import whisper as wh
    from repro_torch.models.layers import Policy
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import ServeEngine
    fp32 = Policy(compute=torch.float32)
    cfg, p, n_new = get_arch(WHISPER), WHISPER_PARITY_PROMPT, 8
    max_seq = p + n_new + 8
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, p)).astype(np.int32)
    extras = request_extras(cfg, 1)
    tokens = torch.as_tensor(prompts, dtype=torch.long, device=DEV)
    dev_extras = {k: torch.as_tensor(v, device=DEV) for k, v in extras.items()}
    out = {}
    with torch.inference_mode():
        params = init_params(wh.whisper_param_defs(cfg, max_seq),
                             torch.Generator(device=DEV).manual_seed(0), DEV)
        mem = wh.encode(cfg, params, dev_extras["frames"], fp32)
        x = wh._dec_in(cfg, params, tokens, fp32)
        positions = torch.arange(p, device=DEV)[None]
        diffs, scales, floors = [], [], []
        for bp in wh._unstack(params["dec_blocks"], cfg.n_layers):
            y = {}
            for kernels in (True, False):
                _backends(kernels)
                y[kernels] = wh._dec_block(cfg, bp, x, positions, mem, fp32)
            _backends(False)
            moved = wh._dec_block(cfg, bp, x * (1 + 1e-7), positions, mem,
                                  fp32)
            diffs.append(float((y[True] - y[False]).abs().max()))
            scales.append(float(y[False].abs().max()))
            floors.append(float((moved - y[False]).abs().max()))
            x = y[False]
        lg = {}
        for kernels in (True, False):
            _backends(kernels)
            ops.reset_launch_counts()
            lg[kernels] = wh.whisper_prefill(cfg, params, tokens, dev_extras,
                                             max_seq, fp32)[0]
            sync()
            if kernels:
                out["prefill_launches"] = _launches()["flash_attention_fwd"]
        _backends(False)
        eng = ServeEngine(cfg, params, max_seq=max_seq, policy=fp32,
                          device=DEV)
        gen = {}
        for kernels in (True, False):
            _backends(kernels)
            gen[kernels] = eng.generate(prompts, n_new, extras=extras).tokens
        _backends(False)
        logit_steps, cache = wh.whisper_prefill(cfg, params, tokens,
                                                dev_extras, max_seq, fp32)
        steps = [logit_steps]
        for t in range(n_new - 1):
            tok = torch.as_tensor(gen[True][:, t:t + 1], dtype=torch.long,
                                  device=DEV)
            lgt, cache = wh.whisper_decode(cfg, params, cache, tok,
                                           torch.full((1,), p + t, device=DEV),
                                           fp32)
            steps.append(lgt)
        flips, bad = _greedy_flips(gen[True], gen[False], torch.stack(
            steps, dim=1).float().cpu().numpy(), 1)
        del eng, params, cache
    out.update({"blocks": len(diffs), "block_max_abs_diff": max(diffs),
                "block_output_scale": max(scales),
                "block_noise_floor": max(floors),
                "logits_diff": float((lg[True] - lg[False]).abs().max()),
                "logits_finite": bool(torch.isfinite(lg[True]).all()),
                "tokens_kernels": gen[True].tolist(), "tie_flips": flips,
                "bad_flips": bad})
    out["held"] = (out["logits_finite"] and max(diffs) <= PARITY_TOL
                   and out["logits_diff"] <= PARITY_TOL and not bad
                   and out["prefill_launches"] == cfg.n_layers)
    return out


def phase_serve_whisper(card_line):
    """whisper-tiny at full width: the fp32 parity (``_whisper_parity``),
    then the repro_torch.launch.serve path, bf16, B=4, prompt 128, 32 new
    tokens, each request with the CLI's frames (4, 1500, 384), the encoder
    inside the captured prefill: 4 flash launches a request (one a decoder
    block's self-attention; the encoder's 1500 frames and the
    cross-attention's keys are no multiple of 128, so they take the
    chunked path), the graph checks of ``serve``, the decode step beside
    its bound, and the serving snapshot written and validated, its cross
    K/V leaves listed."""
    from repro_torch.checkpoint import serialization as ser
    from repro_torch.checkpoint.resharding import plan_summary
    from repro_torch.configs import get_arch
    free_and_reset_peak()
    parity = _whisper_parity()
    free()
    ws = WHISPER_SERVE
    cfg = get_arch(WHISPER)
    with tempfile.TemporaryDirectory() as snap:
        ok, eng, fields, counts = _serve_cell(WHISPER, cfg.n_layers, ws, snap)
        step = Path(snap) / "step_0000000000"
        valid = ser.validate(step, deep=True)
        plan = plan_summary(step)
        cross = sorted(k for k in ser.load_manifest(step)["leaves"]
                       if "cross" in k.split("/"))
    del eng
    free()
    want_leaves = _payload_leaves(WHISPER, ws["batch"],
                                  ws["prompt"] + ws["new_tokens"] + 8)
    ok = (ok and parity["held"] and valid and plan["n_leaves"] == want_leaves
          and cross == ["cache/dec/cross/k", "cache/dec/cross/v"])
    emit("serve-whisper", ok, card_line, **fields, parity={
             "dtype": "float32", "batch": 1, "prompt": WHISPER_PARITY_PROMPT,
             "tolerance": PARITY_TOL, **parity},
         snapshot={"valid": valid, "n_leaves": plan["n_leaves"],
                   "expected_leaves": want_leaves, "cross_leaves": cross,
                   "approx_bytes": plan["approx_bytes"]})
    return counts


# ------------------------------------------------------------- training

def _grad_gap(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().max()
                 / max(float(want.float().abs().max()), 1e-30))


def _flash_grads_at_train_shape():
    """ops.flash_attention's gradients (the kernel's forward, the plain
    version's backward) against autograd through the plain version alone,
    bf16 at the training shape: the largest gap of dq, dk, dv, each over
    its largest gradient, held to the bf16 tolerance."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_flash_attention
    b, h, kv, s, hd, _, _ = flash_paths()["train"]
    gen = torch.Generator(device=DEV).manual_seed(3)
    base = [_randn(gen, n, s, hd, dtype=torch.bfloat16)
            for n in (b * h, b * kv, b * kv)]
    grads = {}
    for name, fn in (("kernel", ops.flash_attention),
                     ("plain", ref_flash_attention)):
        qkv = [t.clone().requires_grad_() for t in base]
        (fn(*qkv, causal=True).float() ** 2).sum().backward()
        grads[name] = [t.grad for t in qkv]
    gaps = {n: _grad_gap(a, c) for n, a, c in
            zip(("dq", "dk", "dv"), grads["kernel"], grads["plain"])}
    del grads, base
    return gaps


def _step_grads_at_cut(cfg, n_layers):
    """One train step's gradients at a depth cut of the full widths, fp32:
    the flash backend (kernel forward) against the chunked plain path.
    Returns the largest gap over the params, each leaf's gap taken over its
    largest gradient."""
    import dataclasses

    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.layers import Policy
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.state import make_train_state
    from repro_torch.train.step import loss_and_grads
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    state = make_train_state(cut, torch.Generator(device=DEV).manual_seed(0),
                             TRAIN["seq"], device=DEV)
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in TokenPipeline(
        cut.vocab_size, TRAIN["batch"], TRAIN["seq"]).next_batch().items()}
    out = {}
    for kernels in (True, False):
        _train_backend(kernels)
        try:
            loss, _, g = loss_and_grads(cut, state["params"], batch,
                                        policy=Policy(compute=torch.float32))
        finally:
            _train_backend(False)
        out[kernels] = (float(loss), tree_leaves(g))
    gap = max(_grad_gap(a, c) for a, c in zip(out[True][1], out[False][1]))
    loss_gap = abs(out[True][0] - out[False][0])
    finite = math.isfinite(out[True][0]) and all(
        bool(torch.isfinite(g).all()) for g in out[True][1])
    del state, out
    return {"grad_gap": gap, "loss_gap": loss_gap, "finite": finite}


def _step_update_against_plain_adamw(cfg):
    """The main path's first train step at full width (bf16, flash, remat)
    against a plain AdamW in fp64 on the host, fed the same gradients:
    they are taken again outside the step, under deterministic algorithms,
    so they are the step's own bits.  Each of the new params, m and v is
    held leaf by leaf, its largest gap over its largest value, to
    ADAMW_TOL; the step and count must read 1 and the grad norm agree to
    ADAMW_TOL."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim.adamw import AdamWCfg
    from repro_torch.train.state import make_train_state
    from repro_torch.train.step import loss_and_grads, make_train_step
    t = TRAIN
    step, _ = make_train_step(cfg, None, None, base_lr=t["lr"],
                              warmup=t["warmup"], total_steps=t["steps"],
                              max_seq=t["seq"])
    state = make_train_state(cfg, torch.Generator(device=DEV).manual_seed(0),
                             t["seq"], device=DEV)
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in TokenPipeline(
        cfg.vocab_size, t["batch"], t["seq"]).next_batch().items()}
    _train_backend(True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        new, metrics = step(state, batch)
        _, _, grads = loss_and_grads(cfg, state["params"], batch)
    finally:
        torch.use_deterministic_algorithms(False)
        _train_backend(False)

    a = AdamWCfg()
    lr = t["lr"] * min(1.0, 1.0 / t["warmup"])       # the schedule at step 0
    g64 = [g.double().cpu() for g in tree_leaves(grads)]
    gnorm = math.sqrt(sum(float((g * g).sum()) for g in g64))
    scale = min(1.0, a.clip_norm / (gnorm + 1e-12))

    def gap(got, want):
        return float((got.double().cpu() - want).abs().max()
                     / max(float(want.abs().max()), 1e-30))

    gaps = {"params": 0.0, "m": 0.0, "v": 0.0}
    for p, g, p1, m1, v1 in zip(
            tree_leaves(state["params"]), g64, tree_leaves(new["params"]),
            tree_leaves(new["opt"]["m"]), tree_leaves(new["opt"]["v"])):
        g = g * scale                   # zero moments, count 1
        m, v = (1 - a.b1) * g, (1 - a.b2) * g * g
        upd = (m / (1 - a.b1)) / (torch.sqrt(v / (1 - a.b2)) + a.eps)
        p64 = p.double().cpu()
        want = p64 - lr * (upd + a.weight_decay * p64)
        for name, got, ref in (("params", p1, want), ("m", m1, m),
                               ("v", v1, v)):
            gaps[name] = max(gaps[name], gap(got, ref))
    norm_gap = abs(float(metrics["grad_norm"]) - gnorm) / gnorm
    counters = (int(new["step"]), int(new["opt"]["count"]))
    del state, new, grads, g64
    free()
    return {"gaps": gaps, "grad_norm": gnorm, "grad_norm_gap": norm_gap,
            "clip_scale": scale, "lr": lr, "step_and_count": counters,
            "tolerance": ADAMW_TOL,
            "ok": (max(gaps.values()) <= ADAMW_TOL
                   and norm_gap <= ADAMW_TOL and counters == (1, 1))}


def profile_step(fn, top: int = 20) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time (ended by
    a synchronize), the device time of every kernel summed (a kernel's
    self time), the busy share (device over wall), the device ops it ran
    (kernels, copies and sets, each launch once), and the ``top`` kernels
    by device time: name, launches, ms.  On the CPU the table is of CPU
    ops and the device fields are None."""
    from torch.profiler import ProfilerActivity, profile
    cuda = DEV == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0

    def self_us(e):
        if not cuda:
            return e.self_cpu_time_total
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages() if self_us(e) > 0
              and (not cuda or "CUDA" in str(e.device_type))]
    events.sort(key=self_us, reverse=True)
    device_s = sum(self_us(e) for e in events) / 1e6 if cuda else None
    return {"wall_s": wall, "device_s": device_s,
            "busy_share": device_s / wall if cuda else None,
            "device_ops": sum(e.count for e in events) if cuda else None,
            "top": [[e.key[:120], e.count, self_us(e) / 1e3]
                    for e in events[:top]]}


def _train(cfg, mesh=None, rules=None, **kw):
    """``train.loop.train`` at TRAIN's shape: on ``mesh`` by ``rules``, or
    plain on DEV."""
    from repro_torch.train.loop import train
    t = TRAIN
    return train(cfg, mesh, rules, n_steps=t["steps"],
                 global_batch=t["batch"], seq_len=t["seq"], base_lr=t["lr"],
                 warmup=t["warmup"], seed=t["seed"], log_every=1,
                 device=DEV, **kw)


def _train_batch(cfg, host_batch, b) -> dict:
    """A pipeline batch on the card, as the loop makes it: a whisper batch
    carries the stub frames, ones x 0.1."""
    import torch
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in host_batch.items()}
    if cfg.family == "audio":
        batch["frames"] = torch.full(
            (b, cfg.encoder.n_frames, cfg.d_model), 0.1, device=DEV)
    return batch


def _step_kw(seq) -> dict:
    t = TRAIN
    return dict(base_lr=t["lr"], warmup=t["warmup"], total_steps=t["steps"],
                max_seq=seq)


def _train_step_before_after(cfg, mesh=None, rules=None) -> dict:
    """The main path's step at full width from one state and batch (on
    ``mesh`` by ``rules``, the state laid out by ``state_shardings``):
    eager (the pure step, every op dispatched from Python: the numbers
    before) and as the loop runs it (on CUDA the replay of its graph:
    after).  Each: the step time (median of GRAPH_CHECK_STEPS steps after
    a warm-up, which for the graph is its capture; each step ended by the
    loss read) and one more step under the profiler; the graph's
    capture_s."""
    import statistics

    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train.loop import make_loop_step
    from repro_torch.train.state import (lay_out_state, make_train_state,
                                         state_shardings)
    from repro_torch.train.step import GraphedTrainStep, make_train_step
    t = TRAIN
    state = make_train_state(cfg, torch.Generator(device=DEV).manual_seed(0),
                             t["seq"], device=DEV)
    if mesh is not None:
        state = lay_out_state(state, state_shardings(cfg, t["seq"], mesh,
                                                     rules))
    batch = _train_batch(cfg, TokenPipeline(
        cfg.vocab_size, t["batch"], t["seq"]).next_batch(), t["batch"])
    kw, out = _step_kw(t["seq"]), {}
    _train_backend(True)
    try:
        for name, step in (("eager", make_train_step(cfg, mesh, rules,
                                                     **kw)[0]),
                           ("graphed", make_loop_step(cfg, mesh, rules, DEV,
                                                      **kw)[0])):
            state, _ = step(state, batch)
            sync()
            times = []
            for _ in range(GRAPH_CHECK_STEPS):
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                float(metrics["loss"])
                times.append(time.perf_counter() - t0)
            out[name] = {"step_s": statistics.median(times),
                         "step_s_all": times,
                         "profile": profile_step(lambda: step(state, batch))}
            if isinstance(step, GraphedTrainStep):
                out[name]["capture_s"] = step.capture_s
    finally:
        _train_backend(False)
    del state, step
    free()
    return out


def _graphed_vs_eager(cfg, b, seq, eager=("inplace",)) -> dict:
    """GRAPH_CHECK_STEPS steps of the loop's step (on CUDA its graph; on the
    CPU the pure step) against as many of each ``eager`` kind ("pure":
    make_train_step; "inplace": make_train_step_, run eagerly), each run
    from the same seeded state and batches under deterministic algorithms
    (an op that has no deterministic version warns and is listed): every
    loss, the launches, and after the last step every TrainState leaf,
    bit for bit.  An eager run's final state goes to the host before the
    next run starts, and each of its leaves comes back to the card to be
    compared with the graphed run's, so one state is on the card at a time
    (the hybrid's 5-layer cut's is 38.7 GB).  The counts are set to 0 just
    before each run and read just after."""
    import warnings

    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.loop import make_loop_step
    from repro_torch.train.state import make_train_state
    from repro_torch.train.step import (GraphedTrainStep, make_train_step,
                                        make_train_step_)
    kw = _step_kw(seq)

    def inplace():
        step_, _ = make_train_step_(cfg, None, None, **kw)
        return lambda state, batch: (state, step_(state, batch))

    makers = {"pure": lambda: make_train_step(cfg, None, None, **kw)[0],
              "inplace": inplace}
    makers = {k: makers[k] for k in eager}
    makers["graphed"] = lambda: make_loop_step(cfg, None, None, DEV,
                                               **kw)[0]
    pipe = TokenPipeline(cfg.vocab_size, b, seq, seed=TRAIN["seed"])
    batches = [_train_batch(cfg, pipe.next_batch(), b)
               for _ in range(GRAPH_CHECK_STEPS)]
    runs, host, leaves_equal = {}, {}, {}
    _train_backend(True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for name, make in makers.items():
                state = make_train_state(
                    cfg, torch.Generator(device=DEV).manual_seed(0), seq,
                    device=DEV)
                step = make()
                ops.reset_launch_counts()          # the run starts here
                losses, times = [], []
                for batch in batches:
                    t0 = time.perf_counter()
                    state, metrics = step(state, batch)
                    losses.append(float(metrics["loss"]))
                    times.append(time.perf_counter() - t0)
                runs[name] = {"losses": losses, "launches": _launches(),
                              "step_s": times}      # ... and ends here
                if isinstance(step, GraphedTrainStep):
                    runs[name].update(captures=step.captures,
                                      capture_s=step.capture_s)
                del step, metrics
                free()
                if name != "graphed":
                    host[name] = [x.cpu() for x in tree_leaves(state)]
                else:
                    leaves_equal = {k: True for k in host}
                    for i, x in enumerate(tree_leaves(state)):
                        for k, want in host.items():
                            leaves_equal[k] &= (
                                x.dtype == want[i].dtype
                                and torch.equal(x, want[i].to(x.device)))
                del state
                free()
    finally:
        torch.use_deterministic_algorithms(False)
        _train_backend(False)
    del host
    graphed = runs["graphed"]
    losses_equal = all(r["losses"] == graphed["losses"] for r in runs.values())
    launches_equal = all(r["launches"] == graphed["launches"]
                         for r in runs.values())
    captured = graphed.get("captures", 0) == (1 if DEV == "cuda" else 0)
    return {"steps": GRAPH_CHECK_STEPS, "batch": b, "seq": seq,
            "runs": runs, "losses_equal": losses_equal,
            "leaves_equal": leaves_equal, "launches_equal": launches_equal,
            "nondeterministic_ops": sorted({
                str(w.message).split(".")[0] for w in caught
                if "deterministic" in str(w.message)}),
            "equal": (losses_equal and launches_equal and captured
                      and all(leaves_equal.values()))}


def phase_train(card_line):
    """The training path at full width: smollm-135m, bf16, the flash
    backend, remat on, TRAIN["steps"] steps through train.loop.train (on
    CUDA one graph, captured once and replayed) with every count set to 0
    just before and read just after.  Beside it: the graph against the
    eager steps bit for bit, the eager step against a replay, the flash
    gradients at the training shape, and one step's gradients with the
    kernel against the plain path at a depth cut."""
    import statistics

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import count_params
    cfg = get_arch(ARCH)
    flash_gaps = _flash_grads_at_train_shape()
    cut = _step_grads_at_cut(cfg, CUT_LAYERS)
    update = _step_update_against_plain_adamw(cfg)
    free_and_reset_peak()
    _train_backend(True)
    try:
        ops.reset_launch_counts()          # the main path starts here
        res = _train(cfg)
        counts = {"flash_attention_fwd": ops.FLASH_LAUNCHES,  # ... ends here
                  "rglru_scan": ops.RGLRU_LAUNCHES,
                  "quantize_int8": ops.QUANT_LAUNCHES,
                  "dequantize_int8": ops.DEQUANT_LAUNCHES}
    finally:
        _train_backend(False)
    peak = peak_bytes()
    reserved = reserved_bytes()
    free()
    before_after = _train_step_before_after(cfg)
    graph_check = _graphed_vs_eager(cfg, TRAIN["batch"], TRAIN["seq"],
                                    eager=("pure", "inplace"))
    step_s = statistics.median(res.step_s[1:])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    n_params = count_params(cfg, TRAIN["seq"])
    per_step = counts["flash_attention_fwd"] / res.steps_run
    want = 2 * cfg.n_layers                # forward + remat recompute
    ok = (per_step == want and res.losses[-1] < res.losses[0]
          and all(math.isfinite(x) for x in res.losses)
          and max(flash_gaps.values()) <= TOL["bfloat16"]
          and cut["finite"] and cut["grad_gap"] <= PARITY_TOL
          and update["ok"] and counts["rglru_scan"] == 0
          and graph_check["equal"]
          and res.captures == (1 if DEV == "cuda" else 0))
    emit("train", ok, card_line, arch=ARCH, dtype="bfloat16", remat=True,
         batch=TRAIN["batch"], seq=TRAIN["seq"], steps=res.steps_run,
         lr=TRAIN["lr"], warmup=TRAIN["warmup"], step_s=step_s,
         step_s_all=res.step_s, tok_per_s=tokens / step_s,
         captures=res.captures, capture_s=res.capture_s,
         step_s_before=before_after["eager"]["step_s"],
         step_s_after=before_after["graphed"]["step_s"],
         model_flops_6nt=6 * n_params * tokens, n_params=n_params,
         mfu_6nt=6 * n_params * tokens / step_s / BF16_FLOP_PER_S,
         peak_bytes=peak, reserved_bytes=reserved,
         flash_launches=counts["flash_attention_fwd"],
         flash_launches_per_step=per_step, expected_per_step=want,
         launches=counts, first_loss=res.losses[0], last_loss=res.losses[-1],
         losses=res.losses, flash_grad_gap_at_train_shape=flash_gaps,
         flash_grad_tolerance=TOL["bfloat16"],
         step_grads_at_cut={"cut_layers": CUT_LAYERS, "dtype": "float32",
                            **cut, "tolerance": PARITY_TOL},
         step_update_vs_fp64_adamw=update, graphed_vs_eager=graph_check,
         step_before_after=before_after)
    return counts


def _train_state_roundtrip(cfg):
    """The full-width fp32 TrainState (params, m, v, counters, the uint32
    rng key) through the manager: save + wait, restore onto the card,
    bit-equal leaves."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.state import make_train_state, train_state_template
    state = make_train_state(cfg, torch.Generator(device=DEV).manual_seed(0),
                             TRAIN["seq"], device=DEV)
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    with tempfile.TemporaryDirectory() as root:
        mgr = CheckpointManager(root)
        t0 = time.perf_counter()
        mgr.save(0, state)
        mgr.wait()
        save_s = time.perf_counter() - t0
        save = {k: mgr.stats[k] for k in _SAVE_STATS}
        t0 = time.perf_counter()
        restored, _ = mgr.restore(train_state_template(cfg, TRAIN["seq"]),
                                  device=DEV)
        sync()
        restore_s = time.perf_counter() - t0
        restore = {k: mgr.stats[k] for k in _RESTORE_STATS}
    equal = _leaves_equal(state, restored)
    rng_dtype = str(restored["rng"].dtype)
    del state, restored
    free()
    return {"state_bytes": n_bytes, "save_s": save_s, "save": save,
            "restore_s": restore_s, "restore": restore,
            "leaves_equal": equal, "rng_dtype": rng_dtype}


def phase_train_resume(card_line):
    """A crash after step TRAIN["fail_at"], resumed from the last
    checkpoint, against an uninterrupted run, under deterministic
    algorithms (CUBLAS_WORKSPACE_CONFIG is set before CUDA is first
    touched): the last losses must be equal.  On CUDA every run goes
    through the loop's graph, and the resumed run captures it again over
    the restored state.  An op that has no
    deterministic version warns (warn_only) and is listed.  Then the
    TrainState's own save and restore times."""
    import warnings

    import torch
    from repro_torch.configs import get_arch
    cfg = get_arch(ARCH)
    free_and_reset_peak()
    _train_backend(True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught, \
                tempfile.TemporaryDirectory() as root:
            warnings.simplefilter("always")
            ref = _train(cfg)
            t0 = time.perf_counter()
            try:
                _train(cfg, ckpt_root=root, ckpt_every=TRAIN["ckpt_every"],
                       fail_at_step=TRAIN["fail_at"])
                crashed = False
            except RuntimeError as e:
                if "injected failure" not in str(e):
                    raise
                crashed = True
            crash_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = _train(cfg, ckpt_root=root, ckpt_every=TRAIN["ckpt_every"])
            resume_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        _train_backend(False)
    nondeterministic = sorted({str(w.message).split(".")[0] for w in caught
                               if "deterministic" in str(w.message)})
    diff = abs(res.losses[-1] - ref.losses[-1])
    resumed_at = TRAIN["fail_at"] // TRAIN["ckpt_every"] * TRAIN["ckpt_every"]
    free()
    roundtrip = _train_state_roundtrip(cfg)
    captures = 1 if DEV == "cuda" else 0
    ok = (crashed and res.resumed_from == resumed_at
          and ref.captures == res.captures == captures
          and res.steps_run == TRAIN["steps"] - resumed_at and diff == 0.0
          and roundtrip["leaves_equal"]
          and roundtrip["rng_dtype"] == "torch.uint32")
    emit("train-resume", ok, card_line, arch=ARCH, dtype="bfloat16",
         deterministic=True, fail_at_step=TRAIN["fail_at"],
         ckpt_every=TRAIN["ckpt_every"], resumed_from=res.resumed_from,
         steps_after_resume=res.steps_run, last_loss=res.losses[-1],
         uninterrupted_last_loss=ref.losses[-1], last_loss_diff=diff,
         uninterrupted_losses=ref.losses, resumed_losses=res.losses,
         captures={"uninterrupted": ref.captures, "resumed": res.captures},
         resumed_capture_s=res.capture_s,
         nondeterministic_ops=nondeterministic, crash_run_s=crash_s,
         resume_run_s=resume_s, resume_ckpt_stats=res.ckpt_stats,
         train_state=roundtrip, peak_bytes=peak_bytes())


_TRAIN_SHARDED_CHILD = r"""
import json, pickle, time
import torch
from repro_torch.checkpoint.serialization import _leaf_paths
from repro_torch.distributed.sharding import is_dtensor, make_variant
from repro_torch.launch.mesh import join_world, make_mesh
from repro_torch.models.layers import Policy
from repro_torch.models.params import tree_leaves
from repro_torch.optim.adamw import AdamWCfg
from repro_torch.train.state import lay_out_state, make_train_state
from repro_torch.train.step import make_train_step
args = json.loads(ARGS)
# a fixed share of the host's cores a rank: the products' reductions then
# split alike in every run, as the noise floor's comparison needs
torch.set_num_threads(args["threads"])
rank = join_world(timeout_s=args["world_timeout_s"])
mesh = make_mesh(tuple(args["mesh"]), ("data", "model"), device="cpu")
cfg = pickle.loads(bytes.fromhex(args["cfg"]))
b, s = args["batch"], args["seq"]
state = make_train_state(cfg, torch.Generator().manual_seed(0), s,
                         device="cpu")
toks = torch.randint(0, cfg.vocab_size, (b, s + 1),
                     generator=torch.Generator().manual_seed(1))
batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
kw = dict(policy=Policy(compute=torch.float32), max_seq=s, base_lr=1e-3,
          warmup=1, adamw=AdamWCfg(eps=args["eps"]))
plain, _ = make_train_step(cfg, None, None, **kw)
want, wm = plain(state, batch)
# the stack's own noise floor: the embedding moved by 1e-7 relative
moved = dict(state, params=dict(state["params"]))
moved["params"]["embed"] = {"embedding": state["params"]["embed"][
    "embedding"] * (1 + 1e-7)}
near, nm = plain(moved, batch)
step, shardings = make_train_step(cfg, mesh, make_variant(args["rules"]),
                                  **kw)
laid = lay_out_state(state, shardings)
t0 = time.perf_counter()
got, gm = step(laid, batch)
step_s = time.perf_counter() - t0
def rel(a, ref):
    a = a.full_tensor() if is_dtensor(a) else a
    return float((a.double() - ref.double()).abs().max()
                 / max(float(ref.double().abs().max()), 1e-30))
diffs, noise = {}, {}
for (k, a), (_, w), (_, n) in zip(_leaf_paths(got), _leaf_paths(want),
                                  _leaf_paths(near)):
    if w.is_floating_point():
        kind = k.split("/")[1] if k.startswith("opt/") else k.split("/")[0]
        diffs[kind] = max(diffs.get(kind, 0.0), rel(a, w))
        noise[kind] = max(noise.get(kind, 0.0), rel(n, w))
split = sum(t.to_local().numel() < t.numel() for t in tree_leaves(laid)
            if is_dtensor(t))
print(json.dumps({
    "rank": rank, "coord": mesh.get_coordinate(), "step_s": step_s,
    "loss": [float(gm["loss"]), float(wm["loss"]), float(nm["loss"])],
    "grad_norm": [float(gm["grad_norm"]), float(wm["grad_norm"]),
                  float(nm["grad_norm"])],
    "diffs": diffs, "noise": noise, "split_leaves": split}))
"""


def _train_sharded_world() -> dict:
    """One sharded step of ARCH's widths at a depth cut in a CPU world
    against the one-device step, on every rank (_TRAIN_SHARDED_CHILD)."""
    import pickle

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import run_world
    w = TRAIN_SHARDED["world"]
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=w["layers"])
    args = {k: w[k] for k in ("mesh", "rules", "batch", "seq", "eps",
                              "world_timeout_s")}
    args["cfg"] = pickle.dumps(cfg).hex()
    # no more intra-op threads a rank than this process runs with: the CPU
    # rehearsal runs with one beside the suite's other workers, where
    # spinning OpenMP threads of the ranks oversubscribe the cores
    args["threads"] = max(1, min(torch.get_num_threads(),
                                 (os.cpu_count() or 1) // w["ranks"]))
    t0 = time.perf_counter()
    outs = run_world(w["ranks"], f"ARGS = {json.dumps(args)!r}\n"
                     + _TRAIN_SHARDED_CHILD, timeout_s=w["world_timeout_s"],
                     env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                     cwd=ROOT)
    per_rank = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    tol = w["tol"]

    def held(r):
        for key in ("loss", "grad_norm"):
            got, want, near = r[key]
            if abs(got - want) > max(tol, 2 * abs(near - want) / abs(want)) \
                    * abs(want):
                return False
        # v is the squared gradient: twice the others' tolerance
        return all(d <= (2 if k == "v" else 1) * max(tol, 2 * r["noise"][k])
                   for k, d in r["diffs"].items()) and r["split_leaves"] > 0
    return {"ranks": w["ranks"], "mesh": dict(zip(("data", "model"),
                                                  w["mesh"])),
            "rules": w["rules"], "layers": w["layers"], "batch": w["batch"],
            "seq": w["seq"], "dtype": "float32", "adamw_eps": w["eps"],
            "tol": tol, "world_s": time.perf_counter() - t0,
            "per_rank": per_rank, "ok": all(map(held, per_rank))}


def phase_train_sharded(card_line):
    """The training path on a DeviceMesh: full-width smollm-135m through
    ``train.loop.train(cfg, mesh, rules)`` on the card's one-rank mesh
    under each of TRAIN_SHARDED["variants"] (bf16, flash, remat, TRAIN's
    shape and steps, each step the replay of the sharded step's graph)
    beside the plain loop from the same seed, under deterministic
    algorithms: losses and the final TrainState bit-equal, 2 × n_layers
    flash launches a step through ``local_map``.  A sharded run crashed
    after step fail_at resumes from its checkpoint on one device and on
    the mesh, each ending bit-equal to the uninterrupted sharded run.
    Then the eager and graphed sharded step (``_train_step_before_after``;
    the plain step's are the train phase's), and one step of a CPU world
    (``_train_sharded_world``).  Returns the launch counts of the first
    variant's run, the path's."""
    import statistics
    import warnings

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import make_variant
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    t0_phase = time.perf_counter()
    t, ts = TRAIN, TRAIN_SHARDED
    cfg = get_arch(ARCH)
    mesh = make_local_mesh(device=DEV)
    first = ts["variants"][0]
    runs, counts, plain, uninterrupted = {}, None, None, None
    states_equal, resumed = {}, {}
    _train_backend(True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught, \
                tempfile.TemporaryDirectory() as crash:
            warnings.simplefilter("always")
            for name in ("plain",) + ts["variants"]:
                on = (None, None) if name == "plain" else (
                    mesh, make_variant(name))
                free_and_reset_peak()
                ops.reset_launch_counts()       # a run starts here
                res = _train(cfg, *on)
                launches = _launches()          # ... and ends here
                if name == first:
                    counts = launches           # the path's run
                runs[name] = {
                    "losses": res.losses, "step_s": statistics.median(
                        res.step_s[1:]), "step_s_all": res.step_s,
                    "captures": res.captures, "capture_s": res.capture_s,
                    "launches": launches,
                    "flash_launches_per_step":
                        launches["flash_attention_fwd"] / res.steps_run,
                    "peak_bytes": peak_bytes(),
                    "reserved_bytes": reserved_bytes()}
                if name == "plain":
                    plain = res.state
                else:
                    states_equal[name] = _leaves_equal(_local(res.state),
                                                       plain)
                if name == first:
                    uninterrupted = _local(res.state)
                del res
                free()
            del plain
            # a sharded run crashed after fail_at, resumed from its
            # checkpoint on one device and on the mesh (neither saves)
            rules = make_variant(first)
            try:
                _train(cfg, mesh, rules, ckpt_root=crash,
                       ckpt_every=ts["fail_at"], fail_at_step=ts["fail_at"])
                crashed = False
            except RuntimeError as e:
                if "injected failure" not in str(e):
                    raise
                crashed = True
            for name, on in (("one_device", (None, None)),
                             ("mesh", (mesh, rules))):
                free()
                res = _train(cfg, *on, ckpt_root=crash,
                             ckpt_every=t["steps"] + 1)
                resumed[name] = {
                    "resumed_from": res.resumed_from,
                    "steps_run": res.steps_run, "losses": res.losses,
                    "captures": res.captures,
                    "losses_equal": res.losses == runs[first]["losses"][
                        ts["fail_at"]:],
                    "state_equal": _leaves_equal(_local(res.state),
                                                 uninterrupted)}
                del res
    finally:
        torch.use_deterministic_algorithms(False)
        _train_backend(False)
    del uninterrupted
    free()
    nondeterministic = sorted({str(w.message).split(".")[0] for w in caught
                               if "deterministic" in str(w.message)})
    losses_equal = {name: runs[name]["losses"] == runs["plain"]["losses"]
                    for name in ts["variants"]}
    # the plain step's, in the same call: the train phase's line
    before_after = _train_step_before_after(cfg, mesh, make_variant(first))
    world = _train_sharded_world()
    want = 2 * cfg.n_layers               # forward + remat recompute
    captures = 1 if DEV == "cuda" else 0
    ok = (all(states_equal.values()) and all(losses_equal.values())
          and all(r["flash_launches_per_step"] == want
                  and r["captures"] == captures for r in runs.values())
          and crashed and all(
              r["losses_equal"] and r["state_equal"]
              and r["resumed_from"] == ts["fail_at"]
              and r["steps_run"] == t["steps"] - ts["fail_at"]
              and r["captures"] == captures for r in resumed.values())
          and world["ok"])
    emit("train-sharded", ok, card_line, arch=ARCH, dtype="bfloat16",
         remat=True, batch=t["batch"], seq=t["seq"], steps=t["steps"],
         mesh={"data": 1, "model": 1}, variants=list(ts["variants"]),
         deterministic=True, runs=runs, losses_equal=losses_equal,
         states_equal=states_equal, expected_flash_per_step=want,
         fail_at_step=ts["fail_at"], resumed=resumed,
         step_before_after=before_after, nondeterministic_ops=nondeterministic,
         world=world, phase_s=time.perf_counter() - t0_phase)
    return counts


def phase_train_families(card_line):
    """The loop's step (on CUDA its graph) for every other family the port
    trains, each at its full published widths and a depth cut (the
    hybrid's recurrence on its plain scan, as launch/train.py leaves it),
    bf16, the flash backend, remat on, FAMILY_TRAIN's batch: each family's
    graphed run against its eager in-place run (_graphed_vs_eager).  The
    path's launches are the graphed runs' summed; the hybrid launches no
    RG-LRU kernel."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.registry import count_params
    cuts = {HYBRID: HYBRID_CUT_LAYERS, MOE: MOE_CUT_LAYERS,
            MLA: MOE_CUT_LAYERS, XLSTM: XLSTM_CUT_LAYERS, WHISPER: None}
    b, seq = FAMILY_TRAIN["batch"], FAMILY_TRAIN["seq"]
    rows = {}
    for arch, cut in cuts.items():
        cfg = get_arch(arch)
        if cut is not None:
            cfg = dataclasses.replace(cfg, n_layers=cut)
        free_and_reset_peak()
        t0 = time.perf_counter()
        check = _graphed_vs_eager(cfg, b, seq)
        rows[arch] = {"cut_layers": cut, "n_params": count_params(cfg, seq),
                      **check, "peak_bytes": peak_bytes(),
                      "seconds": time.perf_counter() - t0}
    counts = {k: sum(r["runs"]["graphed"]["launches"][k]
                     for r in rows.values()) for k in _launches()}
    ok = (all(r["equal"] for r in rows.values())
          and rows[HYBRID]["runs"]["graphed"]["launches"]["rglru_scan"] == 0)
    emit("train-families", ok, card_line, dtype="bfloat16", remat=True,
         batch=b, seq=seq, launches=counts, families=rows)
    return counts


# ---------------------------------------------------------------- dryrun

_DRYRUN_PROBE = r"""
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.dryrun import start_fake_world
from repro_torch.launch.mesh import make_mesh
dev = sys.argv[1]
start_fake_world(256)
mesh = make_mesh((16, 16), ("data", "model"), device=dev)
with FakeTensorMode():
    x = DTensor.from_local(torch.empty(64, 4096, device=dev), mesh,
                           [Replicate(), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(4096, 256, device=dev), mesh,
                           [Replicate(), Shard(1)], run_check=False)
    with ca.analyze() as an:
        x @ w
print(json.dumps({"flops": an.cost.flops, "bytes": an.cost.bytes,
                  "peak_temp_bytes": an.peak_temp_bytes,
                  "torch": torch.__version__}))
"""


def _dryrun_children(out: Path) -> dict:
    """The dry-run cell through ``python -m repro_torch.launch.dryrun`` on
    DEV and on the CPU, and the flop probe, as child processes started
    together; each one's exit code, output and record."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    name = (f"{DRYRUN['arch']}__{DRYRUN['shape']}__{DRYRUN['mesh']}__"
            f"{DRYRUN['variant']}.json")
    cmds = {dev: [sys.executable, "-m", "repro_torch.launch.dryrun",
                  "--arch", DRYRUN["arch"], "--shape", DRYRUN["shape"],
                  "--mesh", DRYRUN["mesh"], "--variant", DRYRUN["variant"],
                  "--device", dev, "--out", str(out / dev)]
            for dev in dict.fromkeys((DEV, "cpu"))}
    cmds["probe"] = [sys.executable, "-c", _DRYRUN_PROBE, DEV]
    procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, c in cmds.items()}
    res = {}
    try:
        for k, p in procs.items():
            so, se = p.communicate(timeout=DRYRUN["timeout_s"])
            rec = out / k / name
            res[k] = {"rc": p.returncode, "stdout": so, "stderr": se[-2000:],
                      "record": (json.loads(rec.read_text())
                                 if rec.exists() else None)}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def phase_dryrun(card_line):
    """One production cell of the dry-run (repro_torch.launch.dryrun):
    smollm-135m decode_32k on the pod mesh, as rank 0 of a fake 256-rank
    world, traced once with the fake tensors on the card's device type
    and once on the CPU: both ok, with equal flops, bytes and
    collectives; and the flop probe (a product split over the model
    axis), which must count one rank's local flops, bytes and temporary
    under this torch.  No kernel runs."""
    import torch
    with tempfile.TemporaryDirectory() as d:
        res = _dryrun_children(Path(d))
    cells = {k: r["record"] for k, r in res.items() if k != "probe"}
    keys = ("cost", "args_bytes_per_device", "bytes_per_device",
            "model_flops_per_device", "n_params")
    same = all(c is not None and c.get("status") == "ok"
               for c in cells.values()) and len({
                   json.dumps({k: c[k] for k in keys}, sort_keys=True)
                   for c in cells.values()}) == 1
    try:
        probe = json.loads(res["probe"]["stdout"].strip().splitlines()[-1])
    except (IndexError, ValueError):
        probe = {"error": res["probe"]["stderr"]}
    ok = (same and all(r["rc"] == 0 for r in res.values())
          and all(probe.get(k) == v for k, v in DRYRUN_PROBE_WANT.items()))
    first = next(iter(cells.values())) or {}
    emit("dryrun", ok, card_line, cell={k: DRYRUN[k] for k in
                                        ("arch", "shape", "mesh", "variant")},
         torch=torch.__version__, probe=probe,
         probe_want=DRYRUN_PROBE_WANT,
         trace_s={k: (c or {}).get("trace_s") for k, c in cells.items()},
         costs_equal=same, cost=first.get("cost"),
         args_bytes_per_device=first.get("args_bytes_per_device"),
         bytes_per_device=first.get("bytes_per_device"),
         roofline=first.get("roofline"),
         errors={k: r["stderr"][-600:] for k, r in res.items()
                 if r["rc"] != 0})


# ---------------------------------------------------- remote chunk stores

def _start_servers(n: int, root: Path) -> list:
    """n chunk servers over root/srv0 ... (REMOTE_SERVERS says how); none
    is left running when one fails to start."""
    servers = []
    try:
        for i in range(n):
            servers.append(ShardServer(root / f"srv{i}"))
    except BaseException:
        for srv in servers:
            srv.stop()
        raise
    return servers


class ShardServer:
    """One chunk server of the checkpoint-remote phase: a process started
    through the port's CLI (``python -m
    repro_torch.checkpoint.chunkservice DIR``), so that the interpreter
    lock does not serialise server and client; or, when REMOTE_SERVERS is
    "threads" (the CPU rehearsal), a ChunkServer in this process."""

    def __init__(self, root: Path):
        self.proc = self.srv = None
        if REMOTE_SERVERS == "threads":
            from repro_torch.checkpoint.chunkservice import ChunkServer
            self.srv = ChunkServer(root).start()
            self.endpoint = f"{self.srv.host}:{self.srv.port}"
            return
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.checkpoint.chunkservice",
             str(root), "--port", "0"],
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()
        if not line.startswith("chunkserver: "):
            self.stop()
            raise RuntimeError(f"chunk server over {root} did not start: "
                               f"{line!r}")
        self.endpoint = line.split()[-1]

    def kill(self) -> None:
        """SIGKILL the process (a thread server stops)."""
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait(30)
            self.proc.stdout.close()
            self.proc = None
        elif self.srv is not None:
            self.srv.stop()
            self.srv = None

    def stop(self) -> None:
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                pass
        self.kill()


def _store_spec(servers, namespace: str, cache: Path) -> str:
    from repro_torch.checkpoint.chunkstore import StoreSpec
    return StoreSpec(scheme="remote",
                     endpoints=tuple(s.endpoint for s in servers),
                     namespace=namespace,
                     replicas=2 if len(servers) > 1 else None,
                     cache=str(cache)).canonical()


def _wire(store) -> list:
    """Each chunk-service client's round trips, reconnects and wire bytes
    under a caching store."""
    remote = store.remote
    if hasattr(remote, "health"):
        return remote.health()
    return [{"endpoint": remote.endpoint,
             **{k: remote.stats[k] for k in ("round_trips", "reconnects",
                                             "bytes_uploaded",
                                             "bytes_fetched")}}]


def _referenced_bytes(ckpt_dir: Path) -> int:
    """Stored bytes of every chunk the checkpoint references, once each."""
    from repro_torch.checkpoint import serialization as ser
    clen = {s["chunk"]: s["clen"]
            for e in ser.load_manifest(ckpt_dir)["leaves"].values()
            for s in e["shards"]}
    return sum(clen.values())


def _timed_restore(mgr, template):
    t0 = time.perf_counter()
    out, meta = mgr.restore(template, device=DEV)
    sync()
    return out, meta, time.perf_counter() - t0


def _remote_leg(kind, state, template, step_fn, batch, root: Path) -> dict:
    """One storage leg of the TrainState: save + wait; an unchanged
    re-save; the writer's cache deleted, then a restore onto the card from
    an empty cache (a fresh host) and one from the warm cache; for the sharded leg, one server
    SIGKILLed and a restore from a second empty cache; then one training
    step from the cold restore.  Servers are stopped and the leg's
    directories deleted before it returns."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    root.mkdir(parents=True)
    disk_free = shutil.disk_usage(root).free
    servers = _start_servers(REMOTE_LEGS[kind], root)
    stores = []

    def manager(cache):
        if not servers:
            return CheckpointManager(root / "ckpt")
        mgr = CheckpointManager(root / "ckpt",
                                store=_store_spec(servers, "train", cache))
        stores.append(mgr.store)
        return mgr

    out = {"servers": [s.endpoint for s in servers],
           "disk_free_bytes": disk_free}
    try:
        writer = manager(root / "cache-writer")
        t0 = time.perf_counter()
        writer.save(0, state)
        writer.wait()
        out["save_s"] = time.perf_counter() - t0
        out["save"] = {k: writer.stats[k] for k in _SAVE_STATS + (
            "last_bytes_uploaded", "last_bytes_referenced_remote")}
        out["bytes_uploaded"] = writer.stats["last_bytes_uploaded"]
        out["bytes_referenced_remote"] = \
            writer.stats["last_bytes_referenced_remote"]
        out["remote_transfer_fraction"] = writer.remote_transfer_fraction()
        t0 = time.perf_counter()
        writer.save(1, state)
        writer.wait()
        out["resave_s"] = time.perf_counter() - t0
        out["resave"] = {k: writer.stats[k] for k in (
            "last_bytes_written", "last_bytes_referenced",
            "last_bytes_uploaded", "last_bytes_referenced_remote")}
        out["resave_remote_transfer_fraction"] = \
            writer.remote_transfer_fraction()
        referenced = _referenced_bytes(root / "ckpt" / "step_0000000001")
        out["bytes_referenced_by_checkpoint"] = referenced
        # the writing host is gone: a reader sees only the step dirs and
        # the servers (the manifest's chunk_dir names the writer's cache)
        shutil.rmtree(root / "cache-writer", ignore_errors=True)

        reader = manager(root / "cache-cold")
        restored, meta, out["restore_cold_s"] = _timed_restore(reader,
                                                               template)
        # prefetch: the batched fetch of every chunk the cache lacks
        out["restore_cold"] = {k: reader.stats.get(k) for k in _RESTORE_STATS
                               + ("restore_prefetch_s",
                                  "restore_prefetch_bytes")}
        out["cold_equal"] = _leaves_equal(state, restored) and \
            meta["step"] == 1
        fetched = reader.store.stats.get("bytes_fetched")
        out["bytes_fetched_cold"] = fetched
        warm, _, out["restore_warm_s"] = _timed_restore(reader, template)
        out["warm_equal"] = _leaves_equal(state, warm)
        del warm
        out["bytes_fetched_warm"] = (None if fetched is None else
                                     reader.store.stats["bytes_fetched"]
                                     - fetched)
        if servers:
            out["round_trips"] = {"writer": _wire(writer.store),
                                  "cold_reader": _wire(reader.store)}
            out["server_stats"] = writer.store.remote.server_stats()
            if kind != "sharded":
                out["server_stats"] = {servers[0].endpoint:
                                       out["server_stats"]}
            out["store_health"] = writer.store_health()
        if kind == "sharded":
            victim = servers[1]
            victim.kill()
            killed = manager(root / "cache-after-kill")
            again, _, out["restore_after_kill_s"] = _timed_restore(killed,
                                                                   template)
            out["after_kill_equal"] = _leaves_equal(state, again)
            del again
            out["bytes_fetched_after_kill"] = \
                killed.store.stats["bytes_fetched"]
            out["killed_server"] = victim.endpoint
            out["store_health_after_kill"] = killed.store_health()
            out["down_after_kill"] = [h["endpoint"]
                                      for h in killed.store_health()
                                      if not h["up"]]
        sync()
        _, metrics = step_fn(restored, batch)
        out["step_loss"] = float(metrics["loss"])
        del restored, metrics
    finally:
        for store in stores:
            store.close()
        for srv in servers:
            srv.stop()
        shutil.rmtree(root, ignore_errors=True)
        free()
    out["ok"] = bool(
        out["cold_equal"] and out["warm_equal"]
        and math.isfinite(out["step_loss"])
        and (out["resave"]["last_bytes_written"] == 0 if kind == "local"
             else out["resave"]["last_bytes_uploaded"] == 0
             and out["bytes_uploaded"] > 0
             and out["bytes_fetched_cold"] == referenced
             and out["bytes_fetched_warm"] == 0)
        and (kind != "sharded"
             or (out["after_kill_equal"]
                 and out["bytes_fetched_after_kill"] == referenced
                 and out["down_after_kill"] == [out["killed_server"]])))
    return out


def _hybrid_remote_leg(root: Path) -> dict:
    """recurrentgemma-9b's serving snapshot through a sharded store
    (three servers, replicas=2): decode resumes from it, restored onto the
    card from an empty cache, with the live engine's tokens."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    free_and_reset_peak()
    servers = _start_servers(3, root)
    stores = []
    out = {"servers": [s.endpoint for s in servers]}
    try:
        eng, res, out["prefill_launches"] = _hybrid_engine()
        writer = CheckpointManager(root / "snap", store=_store_spec(
            servers, "serve", root / "cache-writer"))
        stores.append(writer.store)
        t0 = time.perf_counter()
        eng.snapshot_service(writer, 0)
        out["save_s"] = time.perf_counter() - t0
        out["bytes_uploaded"] = writer.stats["last_bytes_uploaded"]
        shutil.rmtree(root / "cache-writer")       # the writing host is gone
        host = _snapshot_host_copy(eng, res)
        live, _ = _continue(eng, eng.cache, res.tokens, eng.pos,
                            SNAPSHOT_CONTINUE)
        reader = CheckpointManager(root / "snap", store=_store_spec(
            servers, "serve", root / "cache-cold"))
        stores.append(reader.store)
        snap, meta, out["restore_cold_s"] = _timed_restore(reader, host)
        out["bytes_fetched_cold"] = reader.store.stats["bytes_fetched"]
        out["bytes_referenced_by_checkpoint"] = _referenced_bytes(
            root / "snap" / "step_0000000000")
        out["leaves_equal"] = _leaves_equal(host, snap)
        cont, _ = _continue(eng, snap["cache"],
                            snap["generated"].cpu().numpy(), snap["pos"],
                            SNAPSHOT_CONTINUE)
        out["tokens_equal"] = bool(torch.equal(live, cont))
        out["continuation_tokens"] = live.tolist()
        out["server_stats"] = writer.store.remote.server_stats()
        out["store_health"] = reader.store_health()
        del eng, snap, host
    finally:
        for store in stores:
            store.close()
        for srv in servers:
            srv.stop()
        shutil.rmtree(root, ignore_errors=True)
        free()
    out["ok"] = bool(out["leaves_equal"] and out["tokens_equal"]
                     and meta["kind"] == "serve"
                     and out["bytes_fetched_cold"]
                     == out["bytes_referenced_by_checkpoint"])
    return out


def phase_checkpoint_remote(card_line):
    """The TrainState of full-width smollm-135m, after PRE_STEPS training
    steps, through CheckpointManager in three storage legs (REMOTE_LEGS:
    its own directory; one chunk server; three with replicas=2), each leg
    ending in one bf16 training step through the flash kernel from its
    restore, under deterministic algorithms: every leg's loss must equal
    the local leg's.  Then the hybrid's serving snapshot through a
    sharded store.  The counts are set to 0 just before the legs and read
    just after the hybrid leg."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.state import make_train_state, train_state_template
    from repro_torch.train.step import make_train_step
    cfg = get_arch(ARCH)
    t = TRAIN
    free_and_reset_peak()
    step_fn, _ = make_train_step(cfg, None, None, base_lr=t["lr"],
                                 warmup=t["warmup"], total_steps=t["steps"],
                                 max_seq=t["seq"])
    pipe = TokenPipeline(cfg.vocab_size, t["batch"], t["seq"])
    batches = [{k: torch.as_tensor(v, device=DEV)
                for k, v in pipe.next_batch().items()}
               for _ in range(PRE_STEPS + 1)]
    template = train_state_template(cfg, t["seq"])
    legs = {}
    _train_backend(True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as work:
            state = make_train_state(
                cfg, torch.Generator(device=DEV).manual_seed(0), t["seq"],
                device=DEV)
            for batch in batches[:-1]:
                state, _ = step_fn(state, batch)
            sync()
            n_bytes = sum(x.numel() * x.element_size()
                          for x in tree_leaves(state))
            t0 = time.perf_counter()
            ops.reset_launch_counts()          # the path starts here
            for kind in REMOTE_LEGS:
                legs[kind] = _remote_leg(kind, state, template, step_fn,
                                         batches[-1], Path(work) / kind)
            del state
            free()
            torch.use_deterministic_algorithms(False)
            _train_backend(False)
            hybrid = _hybrid_remote_leg(Path(work) / "hybrid")
            counts = {"flash_attention_fwd": ops.FLASH_LAUNCHES,  # ... and
                      "rglru_scan": ops.RGLRU_LAUNCHES,           # ends here
                      "quantize_int8": ops.QUANT_LAUNCHES,
                      "dequantize_int8": ops.DEQUANT_LAUNCHES}
            phase_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        _train_backend(False)
    kinds = get_arch(HYBRID).layer_kinds()
    want = {"flash_attention_fwd": len(REMOTE_LEGS) * 2 * cfg.n_layers
            + kinds.count("local_attn"),
            "rglru_scan": kinds.count("rglru"),
            "quantize_int8": 0, "dequantize_int8": 0}
    losses = {kind: leg["step_loss"] for kind, leg in legs.items()}
    ok = (all(leg["ok"] for leg in legs.values()) and hybrid["ok"]
          and len(set(losses.values())) == 1 and counts == want)
    emit("checkpoint-remote", ok, card_line, arch=ARCH, dtype="float32",
         state_bytes=n_bytes, pre_steps=PRE_STEPS, servers=REMOTE_SERVERS,
         step_losses=losses, losses_equal=len(set(losses.values())) == 1,
         launches=counts, expected_launches=want, phase_s=phase_s,
         legs=legs, hybrid={"arch": HYBRID, **hybrid},
         peak_bytes=peak_bytes())
    return counts


# -------------------------------------------------------------- timing

def sdpa_route(args, kwargs) -> dict:
    """Which SDPA backend runs a call: the dispatcher's own choice
    (``torch._fused_sdp_choice``, where this torch has it) and each backend
    that takes the call when it alone may run."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    try:
        choice = SDPBackend(torch._fused_sdp_choice(
            *args, kwargs.get("attn_mask"), 0.0,
            kwargs.get("is_causal", False),
            enable_gqa=kwargs.get("enable_gqa", False))).name
    except (AttributeError, TypeError, ValueError, RuntimeError):
        choice = None
    takes = []
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")
                F.scaled_dot_product_attention(*args, **kwargs)
            takes.append(backend.name)
        except RuntimeError:
            pass
    return {"dispatcher": choice, "backends_that_take_it": takes}


def _time_flash(gen, b, h, kv, s, hd, window, dtype="bfloat16"):
    """bf16 runs on the tensor cores and fp32 on the CUDA cores: each is
    bounded at its own peak rate.  Beside SDPA as the dispatcher runs it,
    SDPA with only the memory-efficient backend allowed, where it takes
    the call, to show which backend the library time is."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import ref_flash_attention
    dt = getattr(torch, dtype)
    q = _randn(gen, b * h, s, hd, dtype=dt)
    k = _randn(gen, b * kv, s, hd, dtype=dt)
    v = _randn(gen, b * kv, s, hd, dtype=dt)
    pos = torch.arange(s, device=DEV)
    mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - window)
    if not window:
        args = (q.view(b, h, s, hd), k.view(b, kv, s, hd),
                v.view(b, kv, s, hd))
        kwargs = {"is_causal": True, "enable_gqa": True}
    else:
        # kv heads broadcast to the q heads (a view for kv = 1), so that the
        # kernels that take a mask may run
        kx, vx = (t.view(b, kv, 1, s, hd).expand(b, kv, h // kv, s, hd)
                  .reshape(b, h, s, hd) for t in (k, v))
        args, kwargs = (q.view(b, h, s, hd), kx, vx), {"attn_mask": mask}

    def library():
        return F.scaled_dot_product_attention(*args, **kwargs)

    def library_efficient():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return library()

    fns = {"plain": lambda: ref_flash_attention(q, k, v, causal=True,
                                                window=window),
           "kernel": lambda: fa.flash_attention_fwd(q, k, v, causal=True,
                                                    window=window),
           "library": library}
    route = sdpa_route(args, kwargs)
    if "EFFICIENT_ATTENTION" in route["backends_that_take_it"]:
        fns["library_efficient"] = library_efficient
    lib_err = float((library().reshape(b * h, s, hd).float()
                     - fns["kernel"]().float()).abs().max())
    peak = BF16_FLOP_PER_S if dtype == "bfloat16" else FP32_FLOP_PER_S
    return fns, flash_bound(b * h, b * kv, s, hd, window, dt.itemsize,
                            peak), {"library_vs_kernel_max_abs_err": lib_err,
                                    "library_route": route}


def _time_rglru(gen, b, s, d, dtype):
    import torch
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels.ref import ref_rglru
    a, x, h0 = _rglru_inputs(gen, b, s, d, getattr(torch, dtype))
    fns = {"plain": lambda: ref_rglru(a, x, h0),
           "kernel": lambda: rg.rglru_scan(a, x, h0)}
    return fns, rglru_bound(b, s, d, a.element_size()), {}


def rglru_scratch(b, s, d, dtype) -> dict:
    """Bytes one launch moved through its scratch (flags, (A, X) pairs,
    carry-outs), from a launch that counts them, beside the bytes its bound
    counts; and what counting costs: that launch's time in turns with the
    launch the serving path makes, which counts nothing."""
    import torch
    from repro_torch.kernels import rglru as rg
    gen = torch.Generator(device=DEV).manual_seed(2)
    a, x, h0 = _rglru_inputs(gen, b, s, d, getattr(torch, dtype))
    plan = rg.rglru_plan(b, s, d)
    counts = torch.zeros(3, dtype=torch.int64, device=DEV)
    rg.rglru_scan(a, x, h0, counts=counts)
    sync()
    got = rg.scratch_traffic(plan, b, d, counts)
    moved = got["written_bytes"] + got["read_bytes"] + got["atomic_bytes"]
    runs = in_turns({"serving": lambda: rg.rglru_scan(a, x, h0),
                     "counting": lambda: rg.rglru_scan(a, x, h0,
                                                       counts=counts)})
    return {**got, "scratch_bytes": plan.scratch_bytes, "tiles": plan.tiles,
            "share_of_bound_bytes": moved / rglru_bound(b, s, d,
                                                        a.element_size())[2],
            "serving_ms": min(runs["serving"]),
            "counting_ms": min(runs["counting"])}


def _time_quant(gen, dequant):
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels.ref import ref_dequantize_int8, ref_quantize_int8
    x = _randn(gen, QUANT_N)
    if dequant:
        q, s = ref_quantize_int8(x, block=QUANT_BLOCK)
        fns = {"plain": lambda: ref_dequantize_int8(q, s),
               "kernel": lambda: qk.dequantize_int8(q, s)}
    else:
        fns = {"plain": lambda: ref_quantize_int8(x, block=QUANT_BLOCK),
               "kernel": lambda: qk.quantize_int8(x, block=QUANT_BLOCK)}
    return fns, quant_bound(QUANT_N, QUANT_BLOCK, dequant), {}


def flash_paths() -> dict:
    """The flash kernel's shape on each path, (b, h, kv, s, hd, window,
    dtype): bf16 on the serving paths, fp32 on the serve-parity paths."""
    hy, sm, mo, wh = (HYBRID_FLASH_SHAPE, SLICE_SHAPE, MOE_FLASH_SHAPE,
                      WHISPER_FLASH_SHAPE)
    return {"serve": (sm["b"], sm["h"], sm["kv"], sm["s"], sm["hd"], 0,
                      "bfloat16"),
            "serve-whisper": (wh["b"], wh["h"], wh["kv"], wh["s"], wh["hd"],
                              0, "bfloat16"),
            "serve-whisper-parity": (1, wh["h"], wh["kv"],
                                     WHISPER_PARITY_PROMPT, wh["hd"], 0,
                                     "float32"),
            "serve-moe": (mo["b"], mo["h"], mo["kv"], mo["s"], mo["hd"], 0,
                          "bfloat16"),
            "serve-parity-moe": (1, mo["h"], mo["kv"], MOE_PARITY_PROMPT,
                                 mo["hd"], 0, "float32"),
            "serve-hybrid": (hy["b"], hy["h"], hy["kv"], hy["s"], hy["hd"],
                             hy["window"], "bfloat16"),
            "serve-parity": (2, sm["h"], sm["kv"], 128, sm["hd"], 0,
                             "float32"),
            "serve-parity-hybrid": (1, hy["h"], hy["kv"], HYBRID_PARITY_PROMPT,
                                    hy["hd"], hy["window"], "float32"),
            "train": (TRAIN["batch"], sm["h"], sm["kv"], TRAIN["seq"],
                      sm["hd"], 0, "bfloat16")}


def phase_timing(card_line):
    """Each kernel at the shapes its paths give it: its time, its plain
    version's, a PyTorch call's where one computes the same function (SDPA
    for flash attention; none exists for a linear recurrence or for this
    blockwise int8 code), and the card's bound.  Returns them by kernel and
    path.  The library's difference from the kernel is held to the bf16
    tolerance in every row: a library is not held to the port's own."""
    import torch
    gen = torch.Generator(device=DEV).manual_seed(1)
    jobs = {("flash_attention_fwd", path): (lambda c=c: _time_flash(gen, *c))
            for path, c in flash_paths().items()}
    jobs.update({("rglru_scan", path): (lambda c=c: _time_rglru(gen, *c))
                 for path, c in rglru_paths().items()})
    jobs[("quantize_int8", "none")] = lambda: _time_quant(gen, False)
    jobs[("dequantize_int8", "none")] = lambda: _time_quant(gen, True)
    rows, ok = {}, True
    for key, job in jobs.items():
        fns, (bound_ms, bound_by, n_bytes, ops), extra = job()
        runs = in_turns(fns)
        ms = min(runs["kernel"])
        rows[key] = {"ms": ms, "plain_ms": min(runs["plain"]),
                     "library_ms": min(runs["library"]) if "library" in runs
                     else None, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": n_bytes, "ops": ops,
                     **achieved(ms, ops, n_bytes, bound_ms), "runs_ms": runs,
                     "library_vs_kernel_max_abs_err": None, **extra}
        if key[0] == "flash_attention_fwd":
            rows[key]["library_efficient_ms"] = (
                min(runs["library_efficient"]) if "library_efficient" in runs
                else None)
        lib_err = rows[key]["library_vs_kernel_max_abs_err"]
        ok = ok and (lib_err is None or lib_err <= TOL["bfloat16"])
        del fns
    for path, case in rglru_paths().items():
        rows[("rglru_scan", path)]["scratch"] = rglru_scratch(*case)
    shapes = {f"flash_attention_fwd/{path}": {
                  "q": [b * h, s, hd], "kv": [b * kv, s, hd], "dtype": dt,
                  "causal": True, "window": window}
              for path, (b, h, kv, s, hd, window, dt) in flash_paths().items()}
    shapes.update({f"rglru_scan/{path}": {"a,x": [b, s, d], "dtype": dt}
                   for path, (b, s, d, dt) in rglru_paths().items()})
    shapes["quantize_int8"] = {"n": QUANT_N, "block": QUANT_BLOCK}
    emit("timing", ok, card_line, shapes=shapes,
         kernels={f"{k}/{shape}": row for (k, shape), row in rows.items()})
    return rows


# ---------------------------------------------------------------- main

_KERNELS = {
    "flash_attention_fwd": ("flash_attention_fwd.cu",
                            "src/repro/kernels/flash_attention.py:28"),
    "rglru_scan": ("rglru_scan.cu", "src/repro/kernels/rglru.py:21"),
    "quantize_int8": ("quantize_int8.cu", "src/repro/kernels/quantize.py:17"),
    "dequantize_int8": ("quantize_int8.cu",
                        "src/repro/kernels/quantize.py:25"),
}


def kernels_line(errs, counts_by_path, timing) -> dict:
    """One entry per kernel.  Its launches are the sum over the serving
    paths; its numbers are those at the hybrid serving path's shape where
    it runs there (where its time goes), and its error the largest on the
    serving paths.  A kernel timed at more than one shape lists each in
    ``at_shapes``; ``instantiations`` says which flash kernel each dtype
    runs."""
    from repro_torch.kernels import flash_attention as fa
    entries = []
    for name, (src, replaces) in _KERNELS.items():
        by_path = {path: counts[name] for path, counts in counts_by_path.items()}
        shapes = {shape: row for (k, shape), row in timing.items() if k == name}
        main = shapes.get("serve-hybrid") or shapes["none"]
        err = errs[name]
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{src}",
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": max(e for path, e in err.items()
                                    if path in counts_by_path)
                 if isinstance(err, dict) else err,
                 **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}}
        if name == "flash_attention_fwd":
            entry["instantiations"] = {str(dt).removeprefix("torch."): how
                                       for dt, how in fa.INSTANTIATIONS.items()}
        if len(shapes) > 1:
            entry["at_shapes"] = {
                shape: {"max_abs_err": err[shape],
                        **{k: row[k] for k in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "tflops", "tbps", "share_of_bound",
                            "library_route", "library_efficient_ms",
                            "library_vs_kernel_max_abs_err") if k in row}}
                for shape, row in shapes.items()}
        entries.append(entry)
    return {"kernels": entries}


def main() -> int:
    # cuBLAS reads this when CUDA is first used; train-resume runs under
    # deterministic algorithms, which need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card_line = card()
    seconds = {}

    def run(name, phase):
        t0 = time.perf_counter()
        try:
            return phase(card_line)
        finally:
            seconds[name] = time.perf_counter() - t0

    try:
        run("build", phase_build)
        errs = run("kernels", phase_kernels)
        run("serve-parity", phase_serve_parity)
        counts = {"serve": run("serve", phase_serve)}
        run("checkpoint", phase_checkpoint)
        counts["elastic"] = run("elastic", phase_elastic)
        counts["rankworld"] = run("rankworld", phase_rankworld)
        run("procworld", phase_procworld)
        run("serve-parity-hybrid", phase_serve_parity_hybrid)
        counts["serve-hybrid"] = run("serve-hybrid", phase_serve_hybrid)
        run("snapshot-hybrid", phase_snapshot_hybrid)
        counts["sharded"] = run("sharded", phase_sharded)
        run("serve-parity-moe", phase_serve_parity_moe)
        counts["serve-moe"] = run("serve-moe", phase_serve_moe)
        counts["serve-mla"] = run("serve-mla", phase_serve_mla)
        run("serve-parity-xlstm", phase_serve_parity_xlstm)
        counts["serve-xlstm"] = run("serve-xlstm", phase_serve_xlstm)
        counts["serve-whisper"] = run("serve-whisper", phase_serve_whisper)
        counts["train"] = run("train", phase_train)
        run("train-resume", phase_train_resume)
        counts["train-sharded"] = run("train-sharded", phase_train_sharded)
        counts["train-families"] = run("train-families",
                                       phase_train_families)
        run("dryrun", phase_dryrun)
        counts["checkpoint-remote"] = run("checkpoint-remote",
                                          phase_checkpoint_remote)
        free_and_reset_peak()
        timing = run("timing", phase_timing)
    except PhaseFailed as e:
        print(f"chip_smoke: phase {e} failed", file=sys.stderr)
        return 1
    finally:
        print(json.dumps({"phase_seconds": seconds}), file=sys.stderr)
        import torch.distributed as dist
        if dist.is_initialized():            # the meshes' 1-rank world
            dist.destroy_process_group()
    print(json.dumps(kernels_line(errs, counts, timing)))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
