"""Replay times of the serving engine's captured prefill and decode step,
for the checkout the command runs in (its ``src`` goes first on the path),
so two checkouts can be compared on one card in one call:

  for t in parent . . parent; do
    (cd $t && python /path/to/this/checkout/tools/replay_times.py \
        --arch xlstm-1.3b --batch 4 --prompt-len 512 --new-tokens 32)
  done

One request through ``repro_torch.launch.serve`` (its CUDA graphs
captured), then three rounds of: a prefill replay, three prefill replays
and 31 decode replays, each timed by CUDA events; then one profiled round
(``torch.profiler``), whose kernels' summed device time says whether a
difference lies in the kernels or between them.  Prints one JSON line.
Needs a CUDA card.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.getcwd(), "src"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--new-tokens", type=int, default=32)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, eng = serve.run(["--arch", args.arch, "--batch", str(args.batch),
                        "--prompt-len", str(args.prompt_len),
                        "--new-tokens", str(args.new_tokens)])
    batch = eng._batches[args.batch]
    prefill, decode = eng._programs(batch, next(iter(eng._prompts.values())))

    def ms(fn, n):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n

    res = {"prefill_ms": [], "decode_ms": []}
    for _ in range(3):
        prefill()
        res["prefill_ms"].append(ms(prefill, 3))
        res["decode_ms"].append(ms(decode, 31))
    prefill()
    for kind, fn, n in (("decode", decode, 3), ("prefill", prefill, 1)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = [getattr(e, "self_device_time_total", 0)
              for e in prof.key_averages()]
        res[f"{kind}_kernel_ms"] = sum(us) / 1e3 / n
    print(json.dumps(res))


if __name__ == "__main__":
    main()
