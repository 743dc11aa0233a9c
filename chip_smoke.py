#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (written for an H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the ``repro`` package.  Phases,
one JSON line each; any failure exits non-zero:

  build         compile the flash-attention kernel from
                src/repro_torch/kernels/csrc into build/repro_torch_kernels
  kernels       ops.flash_attention on CUDA against its plain version on the
                same CUDA tensors: the sweep of tests/test_kernels.py in fp32
                and bf16, the 384-length case, constant V, and the shapes
                the serving path gives the kernel
  serve-parity  full-width smollm-135m (seeded random weights), fp32, B=2,
                prompt 128: 30 kernel launches for the prefill; flash vs
                chunked block by block at full depth, and logits and greedy
                tokens end to end at a 2-layer cut
  serve         the repro_torch.launch.serve path at full width, bf16, B=4,
                prompt 128, 32 new tokens: the main path, its launch count
  timing        the kernel at the serving prefill shape against its plain
                version and torch's SDPA, with the card's bound

Then one line {"kernels": [...]}, the card's name and power limit as
nvidia-smi gives them, and last {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
ARCH = "smollm-135m"                               # served at full width
CUT_LAYERS = 2                                     # serve-parity's depth cut
SLICE_SHAPE = dict(b=4, h=9, kv=3, s=128, hd=64)   # smollm-135m prefill, B=4
HBM_BYTES_PER_S = 3.35e12                          # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12                           # dense bf16 tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}          # tests/test_kernels.py
SWEEP = [(4, 2, 256, 256, 64, True, 0), (2, 2, 128, 128, 128, True, 0),
         (8, 2, 128, 128, 64, True, 0), (6, 2, 256, 256, 64, True, 64),
         (2, 2, 128, 384, 64, False, 0), (2, 1, 512, 512, 256, True, 0)]


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


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build(card_line):
    from repro_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    lib = fa.build()
    build_s = time.perf_counter() - t0
    report = lib.with_name(f"{lib.stem}.ptxas.txt").read_text().splitlines()
    emit("build", lib.exists(), card_line, build_s=build_s,
         library=str(lib.relative_to(ROOT)),
         ptxas=[ln.split(":", 1)[-1].strip() for ln in report
                if "Function properties" in ln or "Used" in ln
                or "spill" in ln])


def phase_kernels(card_line):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ref_flash_attention
    gen = torch.Generator(device=DEV).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)

    cases = []
    for dt in ("float32", "bfloat16"):
        cases += [(dt,) + c for c in SWEEP]
    cases += [("float32", 2, 2, 384, 384, 64, True, 0),     # test_kernels.py:41
              ("bfloat16", 36, 12, 128, 128, 64, True, 0),  # serve, B=4 bf16
              ("float32", 18, 6, 128, 128, 64, True, 0)]    # serve-parity fp32
    worst = {"float32": 0.0, "bfloat16": 0.0}
    bad = []
    slice_err = None
    for dt, bh, bkv, sq, sk, hd, causal, window in cases:
        dtype = getattr(torch, dt)
        q = randn(bh, sq, hd, dtype=dtype)
        k = randn(bkv, sk, hd, dtype=dtype)
        v = randn(bkv, sk, hd, dtype=dtype)
        out = ops.flash_attention(q, k, v, causal, window)
        ref = ref_flash_attention(q, k, v, causal=causal, window=window)
        err = float((out.float() - ref.float()).abs().max())
        worst[dt] = max(worst[dt], err)
        if not err <= TOL[dt]:
            bad.append([dt, bh, bkv, sq, sk, hd, causal, window, err])
        if (bh, sq, dt) == (36, 128, "bfloat16"):
            slice_err = err
    q = randn(2, 128, 64, dtype=torch.float32)
    k = randn(2, 128, 64, dtype=torch.float32)
    v = torch.full((2, 128, 64), 2.5, device=DEV)
    const_err = float((ops.flash_attention(q, k, v) - 2.5).abs().max())
    if not const_err <= 1e-5:                                # test_kernels.py:60
        bad.append(["constant_v", const_err])
    sync()
    emit("kernels", not bad, card_line, cases=len(cases) + 1,
         tolerance={**TOL, "constant_v": 1e-5},
         worst={"flash_attention_fwd": {**worst, "constant_v": const_err}},
         failures=bad)
    return slice_err


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


def phase_serve_parity(card_line):
    """The full-width stack with seeded random weights is chaotic: a 1e-7
    relative change of the embedding moves the 30-layer last-token logits
    by ~0.5 (PERF.md), so the end-to-end logits of two attention paths that
    differ in the last bit cannot agree to 1e-3 at full depth.  The phase
    therefore holds the flash path to the chunked one where that is
    meaningful: block by block at full depth (each layer's block output
    from the same input) and end to end at a 2-layer cut of the same
    widths.  The full-depth difference is printed beside its noise floor."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import attention as att
    from repro_torch.models import model as lm
    from repro_torch.models.layers import Policy
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.serve.engine import ServeEngine

    fp32 = Policy(compute=torch.float32)
    b, p, n_new = 2, 128, 8
    max_seq = p + n_new + 8
    prompts = np.random.default_rng(0).integers(
        0, ARCHS[ARCH].vocab_size, (b, p)).astype(np.int32)
    tokens = torch.as_tensor(prompts, dtype=torch.long, device=DEV)

    def model(n_layers):
        cfg = dataclasses.replace(ARCHS[ARCH], n_layers=n_layers)
        params = init_params(lm.lm_param_defs(cfg, max_seq),
                             torch.Generator(device=DEV).manual_seed(0), DEV)
        return cfg, params

    def prefill(cfg, params, backend):
        att.set_attention_backend(backend)
        try:
            return lm.lm_prefill(cfg, params, tokens, {}, max_seq, fp32)[0]
        finally:
            att.set_attention_backend("chunked")

    out = {}
    with torch.inference_mode():
        cfg, params = model(ARCHS[ARCH].n_layers)
        ops.reset_launch_counts()
        full_flash = prefill(cfg, params, "flash")
        sync()
        out["prefill_launches"] = ops.FLASH_LAUNCHES
        full_chunked = prefill(cfg, params, "chunked")
        out["full_depth_logits_diff"] = float(
            (full_flash - full_chunked).abs().max())
        params["embed"]["embedding"].mul_(1 + 1e-7)
        out["full_depth_noise_floor"] = float(
            (prefill(cfg, params, "chunked") - full_chunked).abs().max())
        params["embed"]["embedding"].div_(1 + 1e-7)
        out["logits_finite"] = bool(torch.isfinite(full_flash).all())

        # block by block: the same input through both attention paths
        positions = torch.arange(p, device=DEV)[None].expand(b, p)
        x = lm._embed_in(cfg, params, tokens, {}, fp32)
        block_diffs = []
        for li in range(cfg.n_layers):
            unit = tree_map(lambda t: t[li], params["units"])["b0"]
            y = {}
            for backend in ("flash", "chunked"):
                att.set_attention_backend(backend)
                y[backend], _ = lm.prefill_block(cfg, "attn", unit, x,
                                                 positions, max_seq, fp32)
            att.set_attention_backend("chunked")
            block_diffs.append(float((y["flash"] - y["chunked"]).abs().max()))
            x = y["chunked"]
        out["block_max_abs_diff"] = max(block_diffs)
        del params, full_flash, full_chunked, x, y

        # end to end at a 2-layer cut: logits and greedy tokens
        cfg2, params2 = model(CUT_LAYERS)
        out["cut2_logits_diff"] = float(
            (prefill(cfg2, params2, "flash")
             - prefill(cfg2, params2, "chunked")).abs().max())
        eng = ServeEngine(cfg2, params2, max_seq=max_seq, policy=fp32,
                          device=DEV)
        gen = {}
        for backend in ("flash", "chunked"):
            att.set_attention_backend(backend)
            gen[backend] = eng.generate(prompts, n_new).tokens
        att.set_attention_backend("chunked")
        seq = torch.as_tensor(np.concatenate([prompts, gen["flash"]], axis=1),
                              dtype=torch.long, device=DEV)
        logits = lm.lm_forward(cfg2, params2, {"tokens": seq}, fp32)[0]
        flips, bad = _greedy_flips(gen["flash"], gen["chunked"],
                                   logits.float().cpu().numpy(), p)
    ok = (out["prefill_launches"] == cfg.n_layers and out["logits_finite"]
          and out["block_max_abs_diff"] <= 1e-3
          and out["cut2_logits_diff"] <= 1e-3 and not bad)
    emit("serve-parity", ok, card_line, arch=ARCH, dtype="float32",
         batch=b, prompt=p, new_tokens=n_new, tolerance=1e-3, **out,
         cut2_tie_flips=flips, cut2_bad_flips=bad,
         cut2_tokens_flash=gen["flash"].tolist())


def phase_serve(card_line):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_launch_counts()                   # the main path starts here
    rows = serve.main(["--arch", ARCH, "--batch", "4",
                       "--prompt-len", "128", "--new-tokens", "32"])
    launches = ops.FLASH_LAUNCHES              # ... and ends here
    row = rows[-1]
    n_layers = get_arch(ARCH).n_layers        # one launch per layer
    ok = (launches == n_layers and row["flash_launches"] == n_layers
          and row["prefill_s"] > 0 and row["decode_s"] > 0)
    emit("serve", ok, card_line, arch=ARCH, batch=4, prompt_len=128,
         new_tokens=32, dtype="bfloat16", prefill_s=row["prefill_s"],
         decode_s=row["decode_s"], tok_per_s=row["tok_per_s"],
         flash_launches=launches)
    return launches


def phase_timing(card_line):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import ref_flash_attention
    b, h, kv, s, hd = (SLICE_SHAPE[k] for k in ("b", "h", "kv", "s", "hd"))
    gen = torch.Generator(device=DEV).manual_seed(1)
    q = torch.randn((b * h, s, hd), generator=gen, device=DEV).bfloat16()
    k = torch.randn((b * kv, s, hd), generator=gen, device=DEV).bfloat16()
    v = torch.randn((b * kv, s, hd), generator=gen, device=DEV).bfloat16()

    def kernel():
        return fa.flash_attention_fwd(q, k, v, causal=True)

    def plain():
        return ref_flash_attention(q, k, v, causal=True)

    def library():
        return F.scaled_dot_product_attention(
            q.view(b, h, s, hd), k.view(b, kv, s, hd), v.view(b, kv, s, hd),
            is_causal=True, enable_gqa=True)

    lib_err = float((library().reshape(b * h, s, hd).float()
                     - kernel().float()).abs().max())
    # plain, kernel, kernel, plain: compare within one call, in turns
    t = {"plain": [], "kernel": [], "library": []}
    for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
        t[name].append(cuda_ms({"plain": plain, "kernel": kernel,
                                "library": library}[name]))
    ms = {name: min(v) for name, v in t.items()}
    n_bytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size()
    pairs = s * (s + 1) // 2                   # causal (q, k) pairs per head
    flops = 4 * hd * pairs * b * h             # QK^T and PV, 2 flop per MAC
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3
    bound_by = ("bytes" if n_bytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S
                else "operations")
    emit("timing", lib_err <= TOL["bfloat16"], card_line,
         shape={"q": [b * h, s, hd], "kv": [b * kv, s, hd], "dtype": "bfloat16",
                "causal": True},
         kernel_ms=ms["kernel"], ref_ms=ms["plain"], library_ms=ms["library"],
         runs_ms=t, bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
         flops=flops, library_vs_kernel_max_abs_err=lib_err)
    return ms, bound_ms, bound_by


def main() -> int:
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
    try:
        phase_build(card_line)
        slice_err = phase_kernels(card_line)
        phase_serve_parity(card_line)
        launches = phase_serve(card_line)
        ms, bound_ms, bound_by = phase_timing(card_line)
    except PhaseFailed as e:
        print(f"chip_smoke: phase {e} failed", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": launches, "max_abs_err": slice_err,
        "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": ms["library"]}]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
