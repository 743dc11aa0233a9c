"""The port's sharded train step on the CPU: one pure step of
``make_train_step(cfg, mesh, rules)`` on DTensors across the ranks of a
4-rank ``gloo`` world at mesh (2, 2), against the one-device step from the
same state, for every family under the baseline rules and FSDP, for every
other ``make_variant`` part on smollm-135m, with two microbatches and with
the fp32 master; then two steps against the reference's own sharded step
on a (2, 2) mesh of forced CPU devices.

One world runs every check of this file (``launch.mesh.run_world``) and
each test reads its part of every rank's report; the JAX side runs in a
subprocess beside it.  Smoke widths, fp32, B=4 × 16 (the flash case: head
dim 64, 128 tokens, the kernel's plain version through ``local_map``, remat
on).  Attention's wq and wk are scaled by 1/4, as tests/test_torch_train.py
tames them, and the xLSTM is cut to one 8-block unit.

Tolerances.  The sharded step sums the row-parallel products, the vocab
shards and the batch shards in another order than one device does, so it
is held at fp32 ``TOL`` = 1e-5 of each leaf's largest element (the loss
and the grad norm at 1e-5 relative), or at twice the stack's own fp32
noise floor where that is higher: the same one-device step with the
embedding (and whisper's frames) moved by 1e-7 relative.  ``v`` is the
squared gradient, so its error is twice the gradient's: it is held at
twice the gradients' tolerance.  Under the fp32 master the params and
their gradients are bf16: two values a few fp32 ulps apart may round to
neighbouring bf16 values, one spacing, up to 2^-7 of a leaf's largest
element, and a replicated param's gradient is the sum of the ranks' bf16
partial sums, rounded again.  Adam divides each gradient by its own
magnitude, so where partial sums nearly cancel that rounding moves the
update far more than the gradient's scale: the master, ``m`` and ``v``
are held instead against the one-device AdamW fed the sharded step's own
gradients, at ``TOL`` (``v`` 2 × ``TOL``).  Adam's first step divides
each gradient by its own magnitude (m̂/√v̂ = ±1), so a gradient element
within rounding of zero would flip its param's update by 2·lr; the steps
here take ``eps`` = 1e-3, which keeps the update a smooth function of
the gradient, so every new leaf can be held.  The gradients
themselves are held too, with their own noise floor."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import serialization as tser
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce_for_smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.train.state import make_train_state
from test_torch_sharded_forward import ENV, ROOT

TOL = 1e-5
BF16_SPACING = 2.0 ** -7   # one bf16 spacing, over a leaf's largest element
B, S, LR, EPS = 4, 16, 1e-3, 1e-3
FAMILIES = ("smollm-135m", "llava-next-34b", "qwen2-moe-a2.7b",
            "deepseek-v2-lite-16b", "recurrentgemma-9b", "xlstm-1.3b",
            "whisper-tiny")
OTHER_PARTS = ("default", "kvseq", "seqshard", "sp_saves", "expert_ff",
               "dponly", "dponly_fsdp")
CASES = {   # name: (arch, variant, options)
    **{f"{a}/{v}": (a, v, {}) for a in FAMILIES for v in ("baseline",
                                                         "fsdp")},
    **{f"smollm-135m/{v}": ("smollm-135m", v, {}) for v in OTHER_PARTS},
    "smollm-135m/accum2": ("smollm-135m", "baseline", {"accum": 2}),
    "smollm-135m/fsdp-accum2": ("smollm-135m", "fsdp", {"accum": 2}),
    "smollm-135m/master_fp32": ("smollm-135m", "fsdp", {"master": True}),
    "smollm-135m/flash": ("smollm-135m", "baseline",
                          {"flash": True, "s": 128}),
}
#: the variants that split no param on (2, 2): data-parallel only
UNSPLIT = {"smollm-135m/dponly"}
V = t_reduce_for_smoke(T_ARCHS["smollm-135m"]).vocab_size
JAX_ARCHS = ("smollm-135m", "recurrentgemma-9b")
JAX_STEPS = 2
# the world runs all 25 cases: ~95 s alone, ~195 s beside five other test
# workers on the same cores
WORLD_TIMEOUT_S = 600

# each rank: every case's step against the one-device step, then the
# JAX cases' two steps from the shared numpy state
_WORLD = r'''
import dataclasses, json, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.checkpoint.serialization import _leaf_paths
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.distributed.sharding import is_dtensor, make_variant
from repro_torch.kernels import ops
from repro_torch.launch.mesh import join_world, make_mesh
from repro_torch.models import attention as att
from repro_torch.models.layers import Policy
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import AdamWCfg
from repro_torch.train import step as tstep
from repro_torch.train.state import (lay_out_state, make_train_state,
                                     train_state_from_numpy)
P32 = Policy(compute=torch.float32)
args = json.loads(sys.argv[1])
rank = join_world()
mesh = make_mesh(tuple(args["mesh"]), ("data", "model"), device="cpu")
out = {"rank": rank, "coord": mesh.get_coordinate(), "cases": {}, "t": {}}

class Collectives(TorchDispatchMode):
    """Every c10d collective run inside: [op, its input's shape]."""
    def __init__(self):
        super().__init__()
        self.ops = []
    def __torch_dispatch__(self, func, types, a=(), kw=None):
        name = str(func.overloadpacket)
        if "c10d" in name and not name.endswith(("wait_tensor",
                                                 "_wrap_tensor_autograd")):
            t = a[0][0] if isinstance(a[0], (list, tuple)) else a[0]
            self.ops.append([name.rsplit(".", 1)[-1], list(t.shape)])
        return func(*a, **(kw or {}))

# the gradients and moments as AdamW receives them, and softmax_xent's
# collectives
seen = {}
real_update, real_xent = tstep.adamw_update, tstep.softmax_xent
def spy_update(params, grads, opt, lr, cfg):
    seen["grads"] = tree_leaves(grads)
    seen["laid_as_params"] = all(
        is_dtensor(g) and is_dtensor(p) and tuple(g.placements)
        == tuple(p.placements) == tuple(m.placements) == tuple(v.placements)
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(opt["m"]), tree_leaves(opt["v"])))
    seen["split"] = sum(g.to_local().numel() < g.numel()
                        for g in tree_leaves(grads) if is_dtensor(g))
    return real_update(params, grads, opt, lr, cfg)
def spy_xent(logits, targets):
    with Collectives() as c:
        loss = real_xent(logits, targets)
    seen.setdefault("xent", []).append(c.ops)
    return loss
tstep.adamw_update, tstep.softmax_xent = spy_update, spy_xent
flash_rows = []
real_flash = ops.ref_flash_attention
def spy_flash(q, k, v, **kw):
    flash_rows.append([q.shape[0], k.shape[0]])
    return real_flash(q, k, v, **kw)
ops.ref_flash_attention = spy_flash

def smoke(arch, hd=0):
    cfg = reduce_for_smoke(ARCHS[arch])
    if arch.startswith("xlstm"):
        cfg = dataclasses.replace(cfg, n_layers=8)     # one unit
    return dataclasses.replace(cfg, head_dim=hd) if hd else cfg

def tame(params):
    """wq and wk (MLA: w_uk) of every attention block scaled by 1/4, as
    tests/test_torch_train.py::_tame_attention."""
    if "dec_blocks" in params:
        blocks = [params["enc_blocks"], params["dec_blocks"]]
    else:
        blocks = list(params["units"].values()) + list(params["prefix"])
    for block in blocks:
        for name in ("attn", "self_attn", "cross_attn"):
            if name in block:
                a = block[name]
                wk = "wk" if "wk" in a else "w_uk"
                a["wq"].mul_(0.25), a[wk].mul_(0.25)

def state_for(cfg, s, master=False):
    st = make_train_state(cfg, torch.Generator().manual_seed(0), s,
                          device="cpu")
    tame(st["params"])
    if master:
        st["opt"]["master"] = st["params"]
        st["params"] = tree_map(lambda p: p.to(torch.bfloat16), st["params"])
    return st

def batch_for(cfg, b, s, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["vision_embeds"] = np.ones(
            (b, cfg.n_vision_tokens, cfg.d_model), np.float32) * 0.1
    if cfg.family == "audio":
        batch["frames"] = np.random.default_rng(seed + 1).standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model), dtype=np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}

def whole(t):
    return t.full_tensor() if is_dtensor(t) else t

def rel(a, b):
    a, b = whole(a).double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))

def kind(key):
    head = key.split("/")
    return head[1] if head[0] == "opt" else head[0]

def compare(got, want, near):
    diffs, noise, exact = {}, {}, True
    for (k, a), (_, b), (_, n) in zip(_leaf_paths(got), _leaf_paths(want),
                                      _leaf_paths(near)):
        if not b.is_floating_point():
            exact &= bool(torch.equal(whole(a), b))
            continue
        diffs[kind(k)] = max(diffs.get(kind(k), 0.0), rel(a, b))
        noise[kind(k)] = max(noise.get(kind(k), 0.0), rel(n, b))
    return diffs, noise, exact

def case(arch, variant, opt):
    flash, s = opt.get("flash", False), opt.get("s", args["s"])
    att.set_attention_backend("flash" if flash else "chunked")
    cfg = smoke(arch, 64 if flash else 0)
    master = opt.get("master", False)
    kw = dict(policy=P32, max_seq=s, base_lr=args["lr"], warmup=1,
              accum_steps=opt.get("accum", 1), master_fp32=master,
              remat=flash, adamw=AdamWCfg(eps=args["eps"]))
    state, batch = state_for(cfg, s, master), batch_for(cfg, args["b"], s)
    plain, _ = tstep.make_train_step(cfg, None, None, **kw)
    want, wm = plain(state, batch)
    gwant = seen.pop("grads")
    # the stack's own noise floor: the embedding (and frames) moved 1e-7
    moved = dict(state, params=dict(state["params"]))
    moved["params"]["embed"] = dict(state["params"]["embed"])
    moved["params"]["embed"]["embedding"] = (
        state["params"]["embed"]["embedding"] * (1 + 1e-7))
    near, nm = plain(moved, {k: v * (1 + 1e-7) if v.is_floating_point()
                             else v for k, v in batch.items()})
    gnear = seen.pop("grads")
    step, shardings = tstep.make_train_step(cfg, mesh, make_variant(variant),
                                            **kw)
    laid = lay_out_state(state, shardings)
    seen.pop("xent", None)
    flash_rows.clear()
    with Collectives() as comm:
        got, gm = step(laid, batch)
    ggot = seen.pop("grads")
    logits_shapes = [[b_, s, v_] for b_ in (args["b"], args["b"] // 2)
                     for v_ in (cfg.vocab_size, cfg.vocab_size // 2)]
    diffs, noise, exact = compare(got, want, near)
    diffs["grads"] = max(rel(g, w) for g, w in zip(ggot, gwant))
    noise["grads"] = max(rel(n, w) for n, w in zip(gnear, gwant))
    fed = {}
    if master:
        # the one-device AdamW fed the sharded step's own gradients
        opt = {k: v for k, v in state["opt"].items() if k != "master"}
        grads = tree_unflatten(state["params"], [whole(g) for g in ggot])
        ref, ref_opt, _ = real_update(state["opt"]["master"], grads, opt,
                                      gm["lr"], kw["adamw"])
        fed = {name: max(rel(a, b) for a, b in zip(tree_leaves(mine),
                                                   tree_leaves(theirs)))
               for name, mine, theirs in (
                   ("master", got["opt"]["master"], ref),
                   ("m", got["opt"]["m"], ref_opt["m"]),
                   ("v", got["opt"]["v"], ref_opt["v"]))}
    att.set_attention_backend("chunked")
    return {"loss": [float(gm["loss"]), float(wm["loss"]),
                     float(nm["loss"])],
            "grad_norm": [float(gm["grad_norm"]), float(wm["grad_norm"]),
                          float(nm["grad_norm"])],
            "plain_metrics": all(not is_dtensor(v) and v.ndim == 0
                                 for v in gm.values()),
            "diffs": diffs, "noise": noise, "fed": fed, "s": s,
            "exact": exact,
            "laid_as_params": seen["laid_as_params"], "split": seen["split"],
            "state_layouts": all(
                not is_dtensor(t) or tuple(t.placements) == lay.placements
                for t, lay in zip(tree_leaves(got), tree_leaves(shardings))),
            "xent_collectives": seen.pop("xent"),
            "logits_moved": [op for op in comm.ops if op[1] in logits_shapes],
            "flash_rows": list(flash_rows)}

T0 = time.perf_counter()
for name, (arch, variant, opt) in args["cases"].items():
    t = time.perf_counter()
    out["cases"][name] = case(arch, variant, opt)
    out["t"][name] = time.perf_counter() - t

# the reference's check: JAX_STEPS steps from the shared numpy state
out["jax_losses"] = {}
for arch in args["jax_archs"]:
    t = time.perf_counter()
    cfg = smoke(arch)
    flat = dict(np.load(args["state"][arch]))
    template = state_for(cfg, args["s"])
    it = iter(flat[k] for k, _ in _leaf_paths(template))
    state = train_state_from_numpy(tree_map(lambda _: next(it), template),
                                   "cpu")
    step, shardings = tstep.make_train_step(
        cfg, mesh, make_variant("baseline"), policy=P32, max_seq=args["s"],
        base_lr=args["lr"], warmup=1, adamw=AdamWCfg(eps=args["eps"]))
    state, losses = lay_out_state(state, shardings), []
    for i in range(args["jax_steps"]):
        state, m = step(state, batch_for(cfg, args["b"], args["s"], 1 + i))
        losses.append(float(m["loss"]))
    final = {k: whole(v).numpy() for k, v in _leaf_paths(state)}
    if rank == 0:
        np.savez(args["port_out"][arch], **final)
    out["jax_losses"][arch] = losses
    out["t"]["jax/" + arch] = time.perf_counter() - t
out["t"]["all"] = time.perf_counter() - T0
print(json.dumps(out))
'''

# the reference's sharded step on a (2, 2) mesh of forced CPU devices,
# jitted with the state's shardings, from the same numpy state and batches
_JAX_SIDE = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.checkpoint.serialization import _leaf_paths
from repro.configs import ARCHS, reduce_for_smoke
from repro.configs.base import ShapeCfg
from repro.distributed.sharding import make_variant, resolve_spec
from repro.launch.mesh import compat_make_mesh
from repro.models.layers import Policy
from repro.models.registry import batch_logical_axes
from repro.optim.adamw import AdamWCfg
from repro.train.state import make_train_state
from repro.train.step import make_train_step
args = json.loads(sys.argv[1])
mesh = compat_make_mesh((2, 2), ("data", "model"))
rules = make_variant("baseline")
out = {}
for arch in args["jax_archs"]:
    cfg = reduce_for_smoke(ARCHS[arch])
    flat = dict(np.load(args["state"][arch]))
    template = jax.eval_shape(
        lambda: make_train_state(cfg, jax.random.PRNGKey(0), args["s"]))
    leaves, treedef = jax.tree_util.tree_flatten(template)
    state = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[k]) for k, _ in _leaf_paths(template)])
    step, st_shard = make_train_step(
        cfg, mesh, rules, policy=Policy(compute=jnp.float32),
        max_seq=args["s"], base_lr=args["lr"], warmup=1,
        adamw=AdamWCfg(eps=args["eps"]))
    axes = batch_logical_axes(cfg, ShapeCfg("t", "train", args["s"],
                                            args["b"]))
    bshard = {k: NamedSharding(mesh, resolve_spec(
        ax, (args["b"], args["s"]), mesh, rules)) for k, ax in axes.items()}
    jstep = jax.jit(step, in_shardings=(st_shard, bshard))
    state = jax.device_put(state, st_shard)
    losses = []
    for i in range(args["jax_steps"]):
        toks = np.random.default_rng(1 + i).integers(
            0, cfg.vocab_size, (args["b"], args["s"] + 1)).astype(np.int32)
        state, m = jstep(state, {"tokens": toks[:, :-1],
                                 "targets": toks[:, 1:]})
        losses.append(float(m["loss"]))
    np.savez(args["jax_out"][arch],
             **{k: np.asarray(v) for k, v in _leaf_paths(state)})
    out[arch] = {"losses": losses,
                 "devices": len(state["params"]["final"]["scale"]
                                .sharding.device_set)}
print(json.dumps(out))
'''


def _tame(params):
    """As the rank program's ``tame``."""
    if "dec_blocks" in params:
        blocks = [params["enc_blocks"], params["dec_blocks"]]
    else:
        blocks = list(params["units"].values()) + list(params["prefix"])
    for block in blocks:
        for name in ("attn", "self_attn", "cross_attn"):
            if name in block:
                a = block[name]
                wk = "wk" if "wk" in a else "w_uk"
                a["wq"].mul_(0.25), a[wk].mul_(0.25)


def _state_file(path, arch):
    """The port's seeded TrainState (attention tamed) saved by leaf path:
    both sides start from it."""
    cfg = t_reduce_for_smoke(T_ARCHS[arch])
    st = make_train_state(cfg, torch.Generator().manual_seed(0), S,
                          device="cpu")
    _tame(st["params"])
    np.savez(path, **{k: v.numpy() for k, v in tser._leaf_paths(st)})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded-train")
    for arch in JAX_ARCHS:
        _state_file(d / f"state-{arch}.npz", arch)
    common = {"s": S, "b": B, "lr": LR, "eps": EPS, "jax_archs": JAX_ARCHS,
              "jax_steps": JAX_STEPS,
              "state": {a: str(d / f"state-{a}.npz") for a in JAX_ARCHS},
              "jax_out": {a: str(d / f"jax-{a}.npz") for a in JAX_ARCHS},
              "port_out": {a: str(d / f"port-{a}.npz") for a in JAX_ARCHS}}
    jax_side = subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE, json.dumps(common)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV,
        cwd=ROOT)
    try:
        outs = tmesh.run_world(
            4, f"import sys; sys.argv[1:] = [{json.dumps(json.dumps(
                {**common, 'mesh': [2, 2], 'cases': CASES}))}]\n" + _WORLD,
            timeout_s=WORLD_TIMEOUT_S, env=ENV, cwd=ROOT)
        stdout, stderr = jax_side.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        if jax_side.poll() is None:
            jax_side.kill()
            jax_side.wait()
    assert jax_side.returncode == 0, stderr[-3000:]
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [r["coord"] for r in reports] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    print("seconds by case:", reports[0]["t"])
    return dict(reports=reports, d=d,
                jax=json.loads(stdout.strip().splitlines()[-1]))


def _tol(kind: str, noise: dict, master: bool) -> float:
    """A leaf kind's tolerance relative to its largest element: ``TOL`` or
    twice its noise floor; ``v``, quadratic in the gradient, twice the
    gradient's tolerance.  Under the master the gradients and the params
    are bf16 values that may round to their neighbours, one bf16
    spacing: up to 2^-7 of the largest element."""
    if master and kind in ("params", "grads"):
        return BF16_SPACING
    if kind == "v":
        return max(2 * _tol("grads", noise, master), 2 * noise["v"])
    return max(TOL, 2 * noise[kind])


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_one_device(world, name):
    """One pure step on DTensors at (2, 2) against the one-device step from
    the same state and batch, on every rank: the loss and the grad norm
    at 1e-5 relative, every gradient and every new leaf (params, m, v,
    the master) at 1e-5 of its largest element, or twice the stack's own
    noise floor where that is higher (``v`` and the bf16 leaves: see the
    module's docstring); the counters and the rng key exact; the metrics
    plain 0-d tensors, one value on every rank."""
    master = CASES[name][2].get("master", False)
    losses = set()
    for rep in world["reports"]:
        got = rep["cases"][name]
        losses.add(got["loss"][0])
        for key in ("loss", "grad_norm"):
            g, w, n = got[key]
            # under the master the norm is of bf16 gradients
            tol = BF16_SPACING if master and key == "grad_norm" else TOL
            assert abs(g - w) <= max(tol, 2 * abs(n - w) / abs(w)) * abs(w), (
                key, got[key])
        assert got["exact"] and got["plain_metrics"]
        for kind, diff in got["diffs"].items():
            if master and kind in ("master", "m", "v"):
                continue              # held against the fed update below
            assert diff <= _tol(kind, got["noise"], master), (kind, got)
        if master:
            assert got["fed"]["master"] <= TOL and got["fed"]["m"] <= TOL
            assert got["fed"]["v"] <= 2 * TOL, got["fed"]
        assert set(got["diffs"]) >= {"params", "m", "v", "grads"}
        assert ("master" in got["diffs"]) == master
    assert len(losses) == 1                 # the same loss on every rank


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_come_back_in_their_params_layouts(world, name):
    """What AdamW receives: every gradient a DTensor in its param's
    placements (a partial sum over the batch all-reduced where the param
    is replicated, reduce-scattered where FSDP splits it), ``m`` and ``v``
    laid out as the params, some of them split on this rank (none under
    data parallelism alone); and the new state laid out by
    ``state_shardings``."""
    for rep in world["reports"]:
        got = rep["cases"][name]
        assert got["laid_as_params"] and got["state_layouts"]
        assert (got["split"] > 0) == (name not in UNSPLIT), got["split"]


def test_loss_never_gathers_the_logits(world):
    """``softmax_xent`` over the (2, 2) step's logits (batch over data,
    vocab over model): two all-reduces over the model axis of (B/2, S)
    per-row values (the row maxima, then the sums of exponentials with the
    gold logits) and one scalar over data, nothing else; in every case
    its collectives move per-row values only, and no collective of the
    whole step moves a tensor of the logits' shapes, (B|B/2, S, V|V/2),
    but one: under ``seqshard`` the forward lays the vocab-split logits
    out split over the sequence, as the reference's constraint does, an
    all-to-all that gloo has not, so DTensor runs it as an all-gather
    and a chunk (``shard_dim_alltoall``'s CPU branch)."""
    for rep in world["reports"]:
        for name, got in rep["cases"].items():
            for ops in got["xent_collectives"]:
                assert all(op == "allreduce_"
                           and np.prod(shape) <= 2 * B * got["s"]
                           for op, shape in ops), (name, ops)
            moved = got["logits_moved"]
            if name == "smollm-135m/seqshard":
                assert moved == [["all_gather_into_tensor",
                                  [B // 2, S, V // 2]]], moved
            else:
                assert moved == [], (name, moved)
        base = rep["cases"]["smollm-135m/baseline"]
        assert base["xent_collectives"] == [[
            ["allreduce_", [B // 2, S, 1]],
            ["allreduce_", [2, B // 2, S]],
            ["allreduce_", []]]]
        # two microbatches: the same, each at half the rows
        assert rep["cases"]["smollm-135m/accum2"]["xent_collectives"] == [[
            ["allreduce_", [B // 4, S, 1]],
            ["allreduce_", [2, B // 4, S]],
            ["allreduce_", []]]] * 2


def test_flash_runs_on_each_ranks_local_heads(world):
    """The flash case (head dim 64, 128 tokens, remat on): the kernel's
    plain version gets B/2 · H/2 query rows and B/2 · KV/2 kv rows on each
    rank, once a layer in the forward and again in the remat recompute;
    its backward is the plain recompute, as the reference's custom_vjp."""
    cfg = t_reduce_for_smoke(T_ARCHS["smollm-135m"])
    rows = [B // 2 * cfg.n_heads // 2, B // 2 * cfg.n_kv_heads // 2]
    for rep in world["reports"]:
        got = rep["cases"]["smollm-135m/flash"]["flash_rows"]
        # forward, remat recompute, and the backward's own recompute
        assert got == [rows] * (3 * cfg.n_layers), got


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_sharded_steps_match_the_jax_reference(world, arch):
    """Two steps of the port's sharded step and the reference's
    ``make_train_step(cfg, mesh(2, 2), rules)`` jitted with the state's
    shardings, both on (2, 2) meshes from the same numpy state and
    batches, fp32: the losses at 1e-5 relative, every leaf of the final
    TrainState at 1e-5 of its largest element (``v`` at 2e-5), the
    counters and the rng key exact."""
    j = world["jax"][arch]
    assert j["devices"] == 4
    for rep in world["reports"]:
        np.testing.assert_allclose(rep["jax_losses"][arch], j["losses"],
                                   rtol=TOL)
    port = dict(np.load(world["d"] / f"port-{arch}.npz"))
    want = dict(np.load(world["d"] / f"jax-{arch}.npz"))
    assert sorted(port) == sorted(want)
    for k, w in want.items():
        p = port[k]
        assert p.dtype == w.dtype and p.shape == w.shape, k
        if not np.issubdtype(w.dtype, np.floating):
            assert np.array_equal(p, w), k
            continue
        tol = 2 * TOL if k.startswith("opt/v/") else TOL
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(p.astype(np.float64) - w).max()) <= tol * scale, k
