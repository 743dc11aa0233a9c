"""Offline batches served in a closed loop by the port's ``ServeEngine``,
with a service snapshot after each batch where the workload asks for it.

One client sends batch after batch: ``batch`` prompts of ``prompt``
tokens, drawn from the seed (batch i from ``default_rng([seed, i])``),
each greedily continued by ``new_tokens`` (the prefill's token
included); with ``snapshot`` the engine's serving state is then written
through ``snapshot_service``, as the serve CLI's ``--snapshot-dir`` does.
Set-up draws the weights, builds the engine and serves one batch of the
cell's shape (it captures the prefill and decode graphs), with its
snapshot (two new tokens are enough: the decode graph is one a batch
size).  The window runs batches until ``--seconds`` have passed and
ends with the last batch's snapshot.

``serve_tok_per_s`` counts every generated token of the window over its
wall time.  ``ttft_p95_s`` is the 95th percentile over every request of
the window of its time to first token: from the ``generate`` call to its
return, which with one new token holds the prefill alone and ends in a
synchronize.

The check: a sample of the window's batches, drawn from the seed, is run
through the float32 reference, each prompt with its served tokens, and
each served token's logit is held to the reference's best at its
position (``max_gap``); the newest snapshot, restored, is compared bit
for bit with the engine's state.  With the control in the program's
place (``Run.control``), ``max_gap`` is read of the tokens that the fp8
reference ranks first at the same positions.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from harness import Outcome
from reference import model as ref
import roofline
import system


def prompts(seed: int, i: int, b: int, p: int, vocab: int) -> np.ndarray:
    """Batch ``i``'s prompts; the warm-up batch is ``i = -1``."""
    rng = np.random.default_rng([seed, i + 1])
    return rng.integers(0, vocab, size=(b, p), dtype=np.int64).astype(
        np.int32)


def plant(fault, engine_mod):
    """A fault in the program's sampling (tests and readings only): row 0's
    token altered where it is produced.  Returns what undoes it."""
    inner = engine_mod._greedy

    def undo():
        engine_mod._greedy = inner
    if fault == "token":
        def altered(logits):
            t = inner(logits).clone()
            t[0] = (t[0] + 1) % logits.shape[-1]
            return t
        engine_mod._greedy = altered
    elif fault is not None:
        raise ValueError(f"fault {fault!r} is not one of a serving cell's")
    return undo


def setup(r):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.attention import set_attention_backend
    from repro_torch.models.registry import get_api
    from repro_torch.models.rglru import set_recurrence_backend
    from repro_torch.serve import engine as engine_mod
    hf, wl, dev = r.cell.hf, r.cell.wl, r.device
    if dev.type == "cuda":          # as the serve CLI on CUDA
        set_attention_backend("flash")
        set_recurrence_backend("kernel")
    undo = plant(r.fault, engine_mod)
    cfg = system.program_cfg(hf)
    b, p, n = wl["batch"], wl["prompt"], wl["new_tokens"]
    max_seq = p + max(n, 1)
    params = system.make_weights(get_api(cfg).param_defs(cfg, max_seq),
                                 r.seed, hf["initializer_range"],
                                 getattr(torch, hf["dtype"]), dev)
    eng = engine_mod.ServeEngine(cfg, params, max_seq=max_seq, device=dev)
    mgr = (CheckpointManager(r.scratch / "snapshots", keep=wl["keep"])
           if wl["snapshot"] else None)
    eng.generate(prompts(r.seed, -1, b, p, hf["vocab_size"]), min(n, 2))
    if mgr is not None:
        eng.snapshot_service(mgr, step=0)
    return {"eng": eng, "mgr": mgr, "params": params, "undo": undo}


def window(r, st):
    hf, wl = r.cell.hf, r.cell.wl
    b, p, n = wl["batch"], wl["prompt"], wl["new_tokens"]
    eng, mgr = st["eng"], st["mgr"]
    first = wl["trace_from"]
    traced = range(first, first + wl["trace_batches"])
    recs = []
    t0 = time.perf_counter()
    while True:
        i = len(recs)
        if r.trace and i == first:
            with r.tracer.slice():
                for _ in traced:
                    recs.append(_one(r, eng, mgr, len(recs), b, p, n, hf))
                    recs[-1]["traced"] = True
        else:
            recs.append(_one(r, eng, mgr, i, b, p, n, hf))
        if (time.perf_counter() - t0 >= r.seconds
                and (not r.trace or len(recs) >= traced.stop)):
            break
    t1 = time.perf_counter()
    return {"t0": t0, "t1": t1, "recs": recs}


def _one(r, eng, mgr, i, b, p, n, hf) -> dict:
    x = prompts(r.seed, i, b, p, hf["vocab_size"])
    ta = time.perf_counter()
    with r.tracer.span("generate"):
        res = eng.generate(x, n)
    tb = time.perf_counter()
    if mgr is not None:
        with r.tracer.span("snapshot"):
            eng.snapshot_service(mgr, step=i + 1)
    tc = time.perf_counter()
    return {"i": i, "ttft_s": tb - ta, "prefill_s": res.prefill_s,
            "decode_s": res.decode_s, "snapshot_s": tc - tb,
            "tokens": res.tokens}


def snapshot_mismatch(st) -> int:
    """Elements of the newest snapshot, restored, that differ in a bit
    from the engine's serving state (a missing snapshot counts whole)."""
    eng, mgr = st["eng"], st["mgr"]
    want = {"cache": eng.cache, "pos": eng.pos.to(torch.int32),
            "generated": torch.as_tensor(np.concatenate(eng.generated, 1))}
    template = {"cache": _map(eng.cache, lambda _: 0), "pos": 0,
                "generated": 0}
    got, _ = mgr.restore(template, device=eng.device)
    flat_w, flat_g = [], []
    _map(want, flat_w.append)
    if got is None:
        return sum(t.numel() for t in flat_w)
    _map(got, flat_g.append)
    bad = 0
    for a, w in zip(flat_g, flat_w):
        a = torch.as_tensor(a).to(w.device)
        if a.shape != w.shape or a.dtype != w.dtype:
            bad += w.numel()
        else:
            bad += int((a.view(-1) != w.reshape(-1)).sum())
    return bad


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(tree[k], fn) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def sample(r, n_batches: int) -> list:
    """The batches the check reads: ``sample_batches`` of them, drawn from
    the seed without replacement."""
    k = min(r.cell.wl["sample_batches"], n_batches)
    rng = np.random.default_rng([r.seed, 1 << 40])
    return sorted(rng.choice(n_batches, size=k, replace=False).tolist())


def gaps(r, st, recs, which, precs=("fp32",)):
    """For the sampled batches: the reference's logits at each served
    position, and how far each served token lies below their best; with
    "fp8" also how far the token the fp8 control ranks first lies below
    the float32 best.  Returns (gaps by precision, each sampled batch's
    routes: every MoE layer's top-k indices)."""
    hf, wl = r.cell.hf, r.cell.wl
    p, n = wl["prompt"], wl["new_tokens"]
    dev = r.device
    groups = ref.groups(hf, p) + [(p + j, 1) for j in range(n - 1)]
    at = list(range(p - 1, p + n - 1))
    out = {k: [] for k in precs}
    routes = []
    for i in which:
        routes.append([])
        rec = recs[i]
        seq = np.concatenate([prompts(r.seed, rec["i"], wl["batch"], p,
                                      hf["vocab_size"]),
                              rec["tokens"][:, :n - 1]], axis=1)
        tok = torch.as_tensor(seq, device=dev)
        served = torch.as_tensor(rec["tokens"][:, :n], device=dev)
        lg32 = ref.logits_at(hf, st["params"], tok, at, groups,
                             rows=wl["ref_rows"], routes=routes[-1])
        out["fp32"].append(ref.gap(lg32, served).flatten())
        if "fp8" in precs:
            lg8 = ref.logits_at(hf, st["params"], tok, at, groups,
                                prec=ref.Prec("fp8"), rows=wl["ref_rows"])
            out["fp8"].append(ref.gap(lg32, lg8.argmax(-1)).flatten())
            del lg8
        del lg32
    return {k: torch.cat(v) for k, v in out.items()}, routes


def distinct_experts(batches, p: int) -> float:
    """Mean over the decode steps of the sampled batches of the distinct
    experts the batch's tokens selected, summed over the MoE layers."""
    got = [_distinct(routes, p) for routes in batches if routes]
    return sum(got) / len(got) if got else 0.0


def _distinct(routes, p: int) -> float:
    total = 0.0
    for idx in routes:                      # (R, S, k) per MoE layer
        dec = idx[:, p:]
        if dec.shape[1] == 0:
            return 0.0
        hit = torch.zeros(dec.shape[1], int(idx.max()) + 1, dtype=torch.bool,
                          device=idx.device)
        for j in range(dec.shape[2]):
            hit.scatter_(1, dec[:, :, j].T, True)
        total += float(hit.sum(1).float().mean())
    return total


def settle(r, st, w) -> dict:
    dev = r.device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    mismatch = snapshot_mismatch(st) if st["mgr"] is not None else None
    st.pop("undo")()
    st.pop("eng")
    st.pop("mgr")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"peak": peak, "snapshot_mismatch": mismatch}


def run(r) -> Outcome:
    hf, wl = r.cell.hf, r.cell.wl
    b, p, n = wl["batch"], wl["prompt"], wl["new_tokens"]
    st = setup(r)
    w = window(r, st)
    t_check = time.perf_counter()
    after = settle(r, st, w)
    recs = w["recs"]
    judged = "fp8" if r.control else "fp32"
    got, routes = gaps(r, st, recs, sample(r, len(recs)),
                       ("fp32", "fp8") if r.control else ("fp32",))
    checks = {"max_gap": (float(got[judged].max()), wl["limits"]["max_gap"])}
    if after["snapshot_mismatch"] is not None:
        checks["snapshot_mismatch"] = (after["snapshot_mismatch"], 0)
    window_s = w["t1"] - w["t0"]
    ttft = np.repeat([x["ttft_s"] for x in recs], b)
    ctx = {"window_s": window_s, "recs": recs,
           "traced": sum(1 for x in recs if x.get("traced")),
           "traced_s": r.tracer.slice_s,
           "phases": {"setup_s": w["t0"] - r.t_start, "window_s": window_s,
                      "check_s": time.perf_counter() - t_check},
           "prefill_flops": roofline.prefill_flops(hf, b, p),
           "routed": distinct_experts(routes, p),
           "flash_shape": (b * hf["num_attention_heads"],
                           b * hf["num_key_value_heads"], p,
                           hf["hidden_size"] // hf["num_attention_heads"])}
    return Outcome(setup_s=w["t0"] - r.t_start,
                   e2e={"serve_tok_per_s": len(recs) * b * n / window_s,
                        "ttft_p95_s": float(np.percentile(ttft, 95))},
                   attempted=len(recs) * b, failed=0, checks=checks,
                   memory_peak_bytes=after["peak"], ctx=ctx)


def readings(r, control=True) -> dict:
    """The compared number of one seed, the program's and (``control``)
    the fp8 control's, over a window of ``r.seconds``."""
    st = setup(r)
    w = window(r, st)
    after = settle(r, st, w)
    which = sample(r, len(w["recs"]))
    got, _ = gaps(r, st, w["recs"], which,
                  ("fp32", "fp8") if control else ("fp32",))
    out = {"batches": len(w["recs"]), "sampled": which,
           "snapshot_mismatch": after["snapshot_mismatch"]}
    for k, g in got.items():
        top = torch.sort(g, descending=True).values[:5].tolist()
        out[k] = {"max_gap": top[0], "top5": top,
                  "nonzero": int((g > 0).sum()), "n": g.numel()}
    return out
