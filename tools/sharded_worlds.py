"""chip_smoke.py's sharded CPU worlds, repeated, each rank's sharded engine
held against the plain engine step by step, to measure how often a world
leaves its tolerance and where:

  PYTHONPATH=src python tools/sharded_worlds.py --seconds 660 --threads 1
  PYTHONPATH=src python tools/sharded_worlds.py --seconds 720 --threads 0

Each round runs chip_smoke's worlds side by side (a 2-rank (1, 2) and a
4-rank (2, 2) gloo world, smollm-135m's widths cut to 2 layers, fp32,
batch 4, prompt 128, 8 new tokens), ``--requests`` requests a process,
the first one with chip_smoke's prompts.  Every rank records, for every
step, the sharded and plain logits' largest difference, whether the
greedy tokens agree, and after the request each cache leaf's largest
difference and where it lies.  ``--threads`` sets each rank's intra-op
threads (0: torch's default, a thread a core).  Rounds start until
``--seconds`` have passed.  Prints a line a round, one line a request
whose logits leave 1e-4, and a JSON summary last; writes every world's
record to ``--out``.
"""
import argparse
import dataclasses
import json
import os
import pickle
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TOL = 1e-4

CHILD = r"""
import json, pickle, time
import numpy as np
import torch
from repro_torch.distributed.sharding import DEFAULT_RULES, is_dtensor
from repro_torch.launch.mesh import join_world, make_mesh
from repro_torch.models.layers import Policy
from repro_torch.models.params import init_params, tree_leaves
from repro_torch.models.registry import get_api
from repro_torch.serve import engine as E
args = json.loads(ARGS)
if args["threads"]:
    torch.set_num_threads(args["threads"])
rank = join_world()
mesh = make_mesh(tuple(args["mesh"]), ("data", "model"), device="cpu")
cfg = pickle.loads(bytes.fromhex(args["cfg"]))
b, p, n = args["batch"], args["prompt"], args["new_tokens"]
max_seq = p + n + 8
fp32 = Policy(compute=torch.float32)
api = get_api(cfg)
params = init_params(api.param_defs(cfg, max_seq),
                     torch.Generator().manual_seed(0), "cpu")
eng = E.ServeEngine(cfg, params, max_seq=max_seq, policy=fp32, mesh=mesh,
                    rules=DEFAULT_RULES)
plain = E.ServeEngine(cfg, params, max_seq=max_seq, policy=fp32,
                      device="cpu")
steps = {}

def whole(t):
    return (t.full_tensor() if is_dtensor(t) else t).clone()

def record(self, batch, logits):
    steps.setdefault(id(self), []).append(
        (whole(logits), whole(batch.logits), E._greedy(logits)))

def prefill_step(self, batch, prompt):
    with self._ctx():
        logits, _ = self.api.prefill(self.cfg, self.params, prompt.tokens,
                                     prompt.extras, self.max_seq,
                                     self.policy, cache=batch.cache)
    batch.logits.copy_(logits)
    batch.seq[:, prompt.tokens.shape[1]] = E._greedy(logits)
    batch.pos.fill_(prompt.tokens.shape[1])
    record(self, batch, logits)

def decode_step(self, batch):
    at = batch.pos[:, None]
    with self._ctx():
        logits, _ = self.api.decode(self.cfg, self.params, batch.cache,
                                    batch.seq.gather(1, at), batch.pos,
                                    self.policy)
    batch.logits.copy_(logits)
    batch.seq.scatter_(1, at + 1, E._greedy(logits)[:, None])
    batch.pos.add_(1)
    record(self, batch, logits)

E.ServeEngine._prefill_step = prefill_step
E.ServeEngine._decode_step = decode_step
rng = np.random.default_rng(1)
reqs = []
for req in range(args["requests"]):
    prompts = (np.random.default_rng(0) if req == 0 else rng).integers(
        0, cfg.vocab_size, (b, p))
    steps.clear()
    t0 = time.perf_counter()
    res = eng.generate(prompts, n)
    serve_s = time.perf_counter() - t0
    ref = plain.generate(prompts, n)
    ours, theirs = steps[id(eng)], steps[id(plain)]
    diffs = [(a[1] - c[1]).abs() for a, c in zip(ours, theirs)]
    caches = []
    for cs, cp in zip(tree_leaves(eng._batches[b].cache),
                      tree_leaves(plain._batches[b].cache)):
        d = (whole(cs) - cp).abs()
        caches.append({"max": float(d.max()), "at": [
            int(i) for i in np.unravel_index(int(d.argmax()), d.shape)],
            "placements": str(cs.placements)})
    reqs.append({
        "req": req, "serve_s": serve_s,
        "tokens_equal": bool(np.array_equal(res.tokens, ref.tokens)),
        "logits": [float(d.max()) for d in diffs],
        "model_logits": [float((a[0] - c[0]).abs().max())
                         for a, c in zip(ours, theirs)],
        "greedy_equal": [bool(torch.equal(a[2], c[2]))
                         for a, c in zip(ours, theirs)],
        "rows": [[float(r) for r in d.max(dim=1).values] for d in diffs],
        "cache": caches})
print(json.dumps({"rank": rank, "coord": mesh.get_coordinate(),
                  "threads": torch.get_num_threads(),
                  "torch": torch.__version__, "reqs": reqs}))
"""


def world(n: int, mesh, cfg, args: dict) -> dict:
    from repro_torch.launch.mesh import run_world
    args = dict(args, mesh=list(mesh), cfg=pickle.dumps(cfg).hex())
    t0 = time.perf_counter()
    outs = run_world(n, f"ARGS = {json.dumps(args)!r}\n" + CHILD,
                     timeout_s=600, cwd=ROOT,
                     env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    return {"ranks": n, "mesh": list(mesh),
            "world_s": time.perf_counter() - t0,
            "per_rank": [json.loads(o.strip().splitlines()[-1])
                         for o in outs]}


def bad(q: dict) -> bool:
    return (max(q["logits"]) > TOL or not q["tokens_equal"]
            or not all(q["greedy_equal"]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=600)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "sharded_worlds.jsonl"))
    args = ap.parse_args()
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch("smollm-135m"), n_layers=2)
    child = dict(batch=4, prompt=128, new_tokens=8,
                 requests=args.requests, threads=args.threads)
    worlds = ((2, (1, 2)), (4, (2, 2)))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    end = time.time() + args.seconds
    rounds = n_worlds = n_bad = 0
    first_bad = later_bad = 0
    with open(args.out, "w") as log:
        while time.time() < end:
            with ThreadPoolExecutor(len(worlds)) as pool:
                runs = list(pool.map(lambda w: world(*w, cfg, child),
                                     worlds))
            for w in runs:
                log.write(json.dumps(w) + "\n")
                n_worlds += 1
                hit = [(r, q) for r in w["per_rank"] for q in r["reqs"]
                       if bad(q)]
                n_bad += bool(hit)
                first_bad += any(q["req"] == 0 for _, q in hit)
                later_bad += any(q["req"] > 0 for _, q in hit)
                for r, q in hit:
                    print("LEFT", w["ranks"], r["rank"], r["coord"],
                          json.dumps(q), flush=True)
            print("round", rounds, [(w["ranks"], round(w["world_s"], 1))
                                    for w in runs], flush=True)
            rounds += 1
    print(json.dumps({"rounds": rounds, "worlds": n_worlds,
                      "worlds_left_tol": n_bad,
                      "in_first_request": first_bad,
                      "in_later_requests": later_bad,
                      "threads": runs[0]["per_rank"][0]["threads"],
                      "torch": runs[0]["per_rank"][0]["torch"]}))


if __name__ == "__main__":
    main()
