"""Training under a checkpoint: the port's training loop, one async save
in the window.

Set-up builds one graphed train step (``train.loop.make_loop_step``) over
a TrainState whose weights the benchmark drew from the seed, drives it
through ``check_steps`` steps fed by ``TokenPipeline`` (the first captures
the step's graph) and keeps what the check compares; then the same step,
state and pipeline run the window: each step the loop's batch copy and
step, the loss read every ``log_every`` steps, and at window step
``save_at`` one ``CheckpointManager.save`` of the TrainState and the data
cursor, as ``train.loop.train`` makes them.  The window ends once the
first step past ``--seconds`` has finished on the device; the save's
hold (drain and copy to the host) and its write thread's contention fall
inside it, and the write's rest is waited for after it, as the loop's
next save would.  ``train_tok_per_s`` is the window's tokens over its
wall time.  A traced run profiles ``trace_steps`` steady steps from
window step ``trace_from``: it first waits for the save's write to drain
(long done by then; the wait is timed as ``trace_wait_s``).

The check: the first steps' losses, each leaf's first gradient as AdamW
takes it (from its first moment after one step) and each leaf's change
after them, against the float32 reference's; and the save, restored,
bit for bit against a copy of what was saved.  With the control in the
program's place (``Run.control``), the fp8 reference's steps are
compared instead of the program's (the save's check stays the
program's).
"""
from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

from harness import Outcome
from reference import model as ref
from reference import train as rtrain
import roofline
import system


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def plant(fault, step_mod):
    """A fault in the program's step (tests and readings only); returns
    what undoes it."""
    saved = dict(vars(step_mod))

    def undo():
        for k in ("adamw_update_", "adamw_update", "loss_and_grads"):
            setattr(step_mod, k, saved[k])
    if fault == "unchanged":
        step_mod.adamw_update_ = lambda *a, **k: {}
        step_mod.adamw_update = lambda params, grads, opt, lr, cfg=None: (
            params, opt, {})
    elif fault == "half_batch":
        inner = step_mod.loss_and_grads

        def half(cfg, params, batch, **kw):
            n = next(iter(batch.values())).shape[0] // 2
            return inner(cfg, params, {k: v[:n] for k, v in batch.items()},
                         **kw)
        step_mod.loss_and_grads = half
    elif fault is not None:
        raise ValueError(f"fault {fault!r} is not one of a training cell's")
    return undo


def worst_leaf(prog: dict, refv: dict, keep=None) -> float:
    """The gap of the norms, leaf by leaf, against the reference's norm of
    that leaf or of the median leaf, whichever is larger; the worst."""
    keys = [k for k in refv if keep is None or keep(k)]
    med = statistics.median(refv[k] for k in keys)
    return max(abs(prog[k] - refv[k]) / max(refv[k], med, 1e-30)
               for k in keys)


def numbers(mine: dict, refv: dict, tiny: float) -> dict:
    """The three compared numbers of ``mine`` (the program's, or the
    control's) against the reference's."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(mine["losses"],
                                                  refv["losses"]))
    gmed = statistics.median(refv["grads"].values())
    moved = lambda k: refv["grads"][k] >= tiny * gmed
    return {"loss_gap": loss,
            "grad_gap": worst_leaf(mine["grads"], refv["grads"]),
            "change_gap": worst_leaf(mine["change"], refv["change"], moved)}


def setup(r):
    """The step, its state and pipeline after the check's first steps."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.attention import set_attention_backend
    from repro_torch.models.layers import Policy
    from repro_torch.models.registry import get_api
    from repro_torch.optim.adamw import AdamWCfg, init_opt_state
    from repro_torch.train import step as step_mod
    from repro_torch.train.loop import make_loop_step
    hf, wl, dev = r.cell.hf, r.cell.wl, r.device
    opt = wl["optimizer"]
    if dev.type == "cuda":
        set_attention_backend("flash")      # as the train CLI on CUDA
    st = {"undo": plant(r.fault, step_mod)}
    cfg = system.program_cfg(hf)
    b, s = wl["batch"], wl["seq"]
    params = system.make_weights(get_api(cfg).param_defs(cfg, s), r.seed,
                                 hf["initializer_range"], torch.float32,
                                 dev)
    st["init"] = rtrain._map(params, torch.clone)
    state = {"params": params, "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev),
             "rng": torch.zeros((2,), dtype=torch.uint32, device=dev),
             "data_cursor": torch.zeros((), dtype=torch.int32, device=dev)}
    step_fn, _ = make_loop_step(
        cfg, None, None, dev, accum_steps=1, base_lr=opt["lr"],
        warmup=opt["warmup"], total_steps=opt["total_steps"],
        policy=Policy(), max_seq=s, remat=True,
        adamw=AdamWCfg(b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                       weight_decay=opt["weight_decay"],
                       clip_norm=opt["clip_norm"]))
    if opt["min_lr_frac"] != 0.1:
        raise ValueError("the program's schedule decays to 0.1 of its rate")
    pipe = TokenPipeline(hf["vocab_size"], b, s, seed=r.seed)
    losses = []
    for i in range(wl["check_steps"]):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipe.next_batch().items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if i == 0:
            st["grads"] = rtrain.norms(rtrain._map(
                state["opt"]["m"], lambda m: m / (1 - opt["b1"])))
    st["losses"] = losses
    st["change"] = rtrain.norms(rtrain._map2(state["params"], st["init"],
                                             lambda a, b0: a - b0))
    st.update(state=state, step_fn=step_fn, pipe=pipe, cfg=cfg,
              mgr=CheckpointManager(r.scratch / "ckpt", keep=wl["keep"]),
              step=wl["check_steps"])
    _sync(dev)
    return st


def window(r, st):
    wl, dev = r.cell.wl, r.device
    b, s = wl["batch"], wl["seq"]
    state, step_fn, pipe, mgr = (st["state"], st["step_fn"], st["pipe"],
                                 st["mgr"])
    t0 = time.perf_counter()
    n, saved, drain_wait = 0, None, None
    while True:
        traced = r.trace and n == wl["trace_from"]
        if traced:
            # the traced slice is a steady one: the save's write has
            # drained by then (the wait finds it done and is timed)
            tw = time.perf_counter()
            mgr.wait()
            drain_wait = time.perf_counter() - tw
        with r.tracer.slice() if traced else contextlib.nullcontext():
            for _ in range(wl["trace_steps"] if traced else 1):
                with r.tracer.span("batch"):
                    batch = {k: torch.as_tensor(v, device=dev)
                             for k, v in pipe.next_batch().items()}
                with r.tracer.span("step"):
                    state, metrics = step_fn(state, batch)
                st["step"] += 1
                n += 1
                if st["step"] % wl["log_every"] == 0:
                    float(metrics["loss"])
                if n == wl["save_at"]:
                    payload = {"train": state,
                               "data": {"seed": np.int64(pipe.seed),
                                        "cursor": np.int64(pipe.cursor)}}
                    with r.tracer.span("save"):
                        mgr.save(st["step"], payload,
                                 meta={"step": st["step"],
                                       "arch": st["cfg"].name})
                    saved = ([t.clone() for t in _tensors(state)],
                             (pipe.seed, pipe.cursor))
        if (time.perf_counter() - t0 >= r.seconds and saved is not None
                and (not r.trace or n > wl["trace_from"])):
            break
    _sync(dev)
    t1 = time.perf_counter()
    mgr.wait()
    st["state"] = state
    return {"t0": t0, "t1": t1, "steps": n, "saved": saved,
            "tokens": n * b * s, "drain_wait_s": drain_wait}


def _tensors(tree) -> list:
    out = []
    rtrain._map(tree, out.append)
    return out


def restore_mismatch(r, st, saved) -> int:
    """Elements of the restored save that differ in a bit from the copy of
    what was saved (a leaf that will not restore counts whole)."""
    from repro_torch.train.state import train_state_template
    cfg, wl = st["cfg"], r.cell.wl
    template = {"train": train_state_template(cfg, wl["seq"]),
                "data": {"seed": 0, "cursor": 0}}
    got, _ = st["mgr"].restore(template, device=r.device)
    want, data = saved
    if got is None:
        return sum(t.numel() for t in want)
    bad = 0
    for a, b in zip(_tensors(got["train"]), want):
        if a.shape != b.shape or a.dtype != b.dtype:
            bad += b.numel()
        else:
            bad += int((_bits(a) != _bits(b)).sum())
    bad += int(int(got["data"]["seed"]) != data[0])
    bad += int(int(got["data"]["cursor"]) != data[1])
    return bad


def _bits(t):
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(ints[t.element_size()])


def reference_run(r, st, prec=ref.FP32):
    hf, wl = r.cell.hf, r.cell.wl
    batches = [tuple(torch.as_tensor(x, device=r.device) for x in
                     rtrain.token_batch(r.seed, i, hf["vocab_size"],
                                        wl["batch"], wl["seq"]))
               for i in range(wl["check_steps"])]
    return rtrain.train(hf, st["init"], batches, wl["optimizer"], prec=prec)


def settle(r, st, w) -> dict:
    """After the window: the peak, the restore check, the program freed."""
    dev = r.device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    mismatch = restore_mismatch(r, st, w["saved"])
    stats = dict(st["mgr"].stats)
    for k in ("state", "step_fn", "pipe", "mgr"):
        st.pop(k)
    st.pop("undo")()
    w.pop("saved")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"peak": peak, "restore_mismatch": mismatch, "ckpt": stats}


def run(r) -> Outcome:
    hf, wl = r.cell.hf, r.cell.wl
    st = setup(r)
    w = window(r, st)
    setup_s = w["t0"] - r.t_start
    t_check = time.perf_counter()
    after = settle(r, st, w)
    refv = reference_run(r, st)
    mine = reference_run(r, st, ref.Prec("fp8")) if r.control else st
    checks = {k: (v, wl["limits"][k]) for k, v in
              numbers(mine, refv, wl["tiny_grad"]).items()}
    checks["restore_mismatch"] = (after["restore_mismatch"], 0)
    window_s = w["t1"] - w["t0"]
    flops = roofline.train_flops(hf, wl["batch"], wl["seq"])
    ctx = {"window_s": window_s, "steps": w["steps"],
           "traced": wl["trace_steps"] if r.trace else 0,
           "traced_s": r.tracer.slice_s,
           "phases": {"setup_s": setup_s, "window_s": window_s,
                      "check_s": time.perf_counter() - t_check,
                      "trace_wait_s": w["drain_wait_s"]},
           "flops_per_step": flops, "ckpt": after["ckpt"],
           "flash_shape": (wl["batch"] * hf["num_attention_heads"],
                           wl["batch"] * hf["num_key_value_heads"],
                           wl["seq"], hf["hidden_size"]
                           // hf["num_attention_heads"])}
    return Outcome(setup_s=setup_s,
                   e2e={"train_tok_per_s": w["tokens"] / window_s},
                   attempted=w["steps"], failed=0, checks=checks,
                   memory_peak_bytes=after["peak"], ctx=ctx)


def readings(r, control=True) -> dict:
    """The compared numbers of one seed, the program's and (``control``)
    the fp8 control's; no window (the check reads the set-up's steps)."""
    st = setup(r)
    for k in ("state", "step_fn", "pipe", "mgr"):
        st.pop(k)
    st.pop("undo")()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    tiny = r.cell.wl["tiny_grad"]
    ref32 = reference_run(r, st)
    out = {"program": numbers(st, ref32, tiny), "losses": st["losses"],
           "ref_losses": ref32["losses"]}
    if control:
        ref8 = reference_run(r, st, ref.Prec("fp8"))
        out["control"] = numbers(ref8, ref32, tiny)
        out["control_losses"] = ref8["losses"]
    return out
