"""The port's sharded forward on the CPU: the model on DTensors across the
ranks of a 2-rank ``gloo`` world at mesh (1, 2), against its own
one-device forward, and the kernels' plain versions fed each rank's own
heads and channels.

One world runs every check of this file (``launch.mesh.run_world``:
``python -c`` ranks, a file store, no port) and each test reads its part
of every rank's report.  Smoke widths: 4 query heads over 2 kv heads (the
fold branch) or over 1 (MQA: the ``expand`` branch), the MoE's 8 experts
over 4 heads of MHA, the hybrid's ``d_rnn`` 64; all divide model = 2.
Parity is fp32 at ``ATOL`` = 1e-5: the same products, the row-parallel
ones summed in another order (measured up to ~8e-6).  The hybrid's local
attention wq and wk are scaled by 1/4, as tests/test_torch_models.py
tames them: untamed, its own fp32 noise floor is above 1e-4.

The serving snapshot of the world's engine is saved across its ranks and
restores in the JAX package and in the port on one device, where
generation continues in fp32 with the same tokens (the paper's checkpoint
on one layout, restart on another)."""
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import serialization as jser
from repro.checkpoint.chunkstore import ChunkStore as JChunkStore
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import ARCHS, reduce_for_smoke
from repro.models.layers import Policy as JPolicy
from repro.models.params import init_params as j_init_params
from repro.models.registry import get_api as j_get_api
from repro_torch.checkpoint import serialization as tser
from repro_torch.checkpoint.manager import CheckpointManager as TManager
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce_for_smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as t_serve
from repro_torch.models.layers import Policy as TPolicy
from repro_torch.models.params import params_from_numpy
from repro_torch.models.registry import get_api as t_get_api
from repro_torch.serve.engine import ServeEngine as TServeEngine

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
ATOL = 1e-5
WORLD_TIMEOUT_S = 300
SNAP = dict(b=4, p=16, n_new=4, more=4, max_seq=32)
CLI = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
       "--batch", "4", "--prompt-len", "16", "--new-tokens", "6"]

#: the rank program's preamble, shared with
#: tests/test_torch_sharded_serve.py: the world's mesh, the smoke configs,
#: and ``parity``: the prefill logits and 4 decode steps through
#: ``make_serve_fns`` on DTensors, and ``lm_forward``'s logits, against
#: the one-device path on the same weights, every leaf at its window
WORLD_COMMON = r'''
import dataclasses, json, sys
import numpy as np
import torch
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.distributed.sharding import (is_dtensor, lay_out,
    make_variant, param_shardings, sharding_ctx, window)
from repro_torch.launch.mesh import join_world, make_mesh
from repro_torch.models import attention as att
from repro_torch.models import rglru as rg
from repro_torch.models.layers import Policy
from repro_torch.models.params import (init_params, is_pm, tree_leaves,
    tree_map, tree_unflatten)
from repro_torch.models.registry import get_api
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.step import make_serve_fns
from torch.distributed.tensor.debug import CommDebugMode
P32 = Policy(compute=torch.float32)
args = json.loads(sys.argv[1])
rank = join_world()
mesh = make_mesh(tuple(args["mesh"]), ("data", "model"), device="cpu")
out = {"rank": rank, "coord": mesh.get_coordinate()}

def backends(name):
    att.set_attention_backend(name)
    rg.set_recurrence_backend("kernel" if name == "flash" else "scan")

def smoke(arch, kv=0, hd=0):
    cfg = reduce_for_smoke(ARCHS[arch])
    cfg = dataclasses.replace(cfg, n_kv_heads=kv) if kv else cfg
    return dataclasses.replace(cfg, head_dim=hd) if hd else cfg

def port_params(cfg, max_seq):
    p = init_params(get_api(cfg).param_defs(cfg, max_seq),
                    torch.Generator().manual_seed(0), "cpu")
    if cfg.family == "hybrid":      # tamed, as tests/test_torch_models.py
        a = p["units"]["b2"]["attn"]
        a["wq"].mul_(0.25), a["wk"].mul_(0.25)
    return p

def laid(tree, defs, rules):
    return tree_unflatten(tree, [lay_out(t, l) for t, l in zip(
        tree_leaves(tree), tree_leaves(param_shardings(defs, mesh, rules)))])

def at_windows(tree):
    """Every DTensor leaf's local shape is its window's; and how many
    leaves are split on this rank."""
    ok, split = True, 0
    for t in tree_leaves(tree):
        if not is_dtensor(t):
            continue
        win = window(t.placements, tuple(t.shape), tuple(mesh.shape),
                     mesh.get_coordinate())
        ok &= tuple(t.to_local().shape) == tuple(b - a for a, b in win)
        split += t.to_local().numel() < t.numel()
    return ok, split

def whole(x):
    return x.full_tensor() if is_dtensor(x) else x

def parity(arch, kv, backend, variant, b=4, p=16, n=4):
    backends(backend)
    cfg = smoke(arch, kv)
    api, rules, s = get_api(cfg), make_variant(variant), p + n + 1
    params = port_params(cfg, s)
    tree = laid(params, api.param_defs(cfg, s), rules)
    prefill, decode = make_serve_fns(cfg, mesh, rules, policy=P32,
                                     max_cache=s)
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(1))
    extras = {} if cfg.encoder is None else {"frames": torch.randn(
        (b, cfg.encoder.n_frames, cfg.d_model),
        generator=torch.Generator().manual_seed(2))}
    # the stack's own fp32 noise floor: the one-device forward again, its
    # embedding (and whisper's frames) moved by 1e-7 relative
    moved = dict(params, embed=dict(params["embed"]))
    moved["embed"]["embedding"] = params["embed"]["embedding"] * (1 + 1e-7)
    moved_extras = {k: v * (1 + 1e-7) for k, v in extras.items()}
    with torch.no_grad():
        want, wc = api.prefill(cfg, params, toks[:, :p], extras, s, P32)
        near, nc = api.prefill(cfg, moved, toks[:, :p], moved_extras, s, P32)
        got, gc = prefill(tree, {"tokens": toks[:, :p], **extras})
        diffs = [float((whole(got) - want).abs().max())]
        noise = [float((near - want).abs().max())]
        for t in range(p, p + n):
            pos = torch.full((b,), t)
            want, wc = api.decode(cfg, params, wc, toks[:, t:t + 1], pos, P32)
            near, nc = api.decode(cfg, moved, nc, toks[:, t:t + 1], pos, P32)
            with CommDebugMode() as comm:       # the step's collectives
                got, gc = decode(tree, gc, toks[:, t:t + 1], pos)
            diffs.append(float((whole(got) - want).abs().max()))
            noise.append(float((near - want).abs().max()))
        # the whole-sequence forward (the train path's, without autograd)
        batch = {"tokens": toks[:, :p], **extras}
        want = api.forward(cfg, params, batch, P32)[0]
        near = api.forward(cfg, moved, {**batch, **moved_extras}, P32)[0]
        with sharding_ctx(mesh, rules):
            got = api.forward(cfg, tree, batch, P32)[0]
        diffs.append(float((whole(got) - want).abs().max()))
        noise.append(float((near - want).abs().max()))
    backends("chunked")
    (pw, ps), (cw, cs) = at_windows(tree), at_windows(gc)
    return {"diffs": diffs, "noise": noise, "windows": pw and cw,
            "split_params": ps, "split_cache": cs,
            "decode_collectives": {str(k).rsplit(".", 1)[-1]: v for k, v in
                                   comm.get_comm_counts().items()}}
'''

# the (1, 2) world: parity in both GQA branches and both backends,
# locality of the kernels' plain versions, the DTensor refusal, the
# serving snapshot and the CLI
_WORLD = WORLD_COMMON + r'''
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.kernels import ops
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.engine import _greedy

import time
T0 = time.perf_counter()
out["parity"] = {}
out["t"] = {}
for name, case in args["cases"].items():
    t = time.perf_counter()
    out["parity"][name] = parity(*case)
    out["t"][name] = time.perf_counter() - t

# what the kernels' plain versions receive on this rank
seen = {"flash": [], "rglru": []}
ref_flash, ref_rglru = ops.ref_flash_attention, ops.ref_rglru
def spy_flash(q, k, v, **kw):
    seen["flash"].append([list(q.shape), list(k.shape)])
    return ref_flash(q, k, v, **kw)
def spy_rglru(a, x, h0):
    seen["rglru"].append(list(a.shape))
    return ref_rglru(a, x, h0)
ops.ref_flash_attention, ops.ref_rglru = spy_flash, spy_rglru

def served(arch, kv, b=2, p=128, n=4):
    """The engine on the mesh against the plain engine, the shapes its
    kernels' plain versions got, and its leaves' windows after every
    step of the generate.  Head dim 64: the flash kernel's smallest."""
    backends("flash")
    cfg = smoke(arch, kv, 64)
    s = p + n + 4
    params = port_params(cfg, s)
    eng = ServeEngine(cfg, params, max_seq=s, policy=P32, mesh=mesh,
                      rules=make_variant("baseline"))
    windows = []
    def checked(step):
        def run(*a):
            step(*a)
            windows.append(at_windows(eng.params)[0]
                           and at_windows(eng._batches[b].cache)[0])
        return run
    eng._prefill_step = checked(eng._prefill_step)
    eng._decode_step = checked(eng._decode_step)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, p))
    for k in seen:
        seen[k].clear()
    res = eng.generate(prompts, n)
    got = {k: list(v) for k, v in seen.items()}
    plain = ServeEngine(cfg, params, max_seq=s, policy=P32, device="cpu")
    ref = plain.generate(prompts, n)
    backends("chunked")
    return {"tokens_equal": bool(np.array_equal(res.tokens, ref.tokens)),
            "logits": float((eng.last_logits(b)
                             - plain.last_logits(b)).abs().max()),
            "windows": windows, "seen": got,
            "split_cache": at_windows(eng._batches[b].cache)[1]}

t = time.perf_counter()
out["served"] = {name: served(*case) for name, case in args["served"].items()}
out["t"]["served"] = time.perf_counter() - t
ops.ref_flash_attention, ops.ref_rglru = ref_flash, ref_rglru

# a DTensor handed to a kernel's wrapper is refused
from torch.distributed.tensor import DTensor, Replicate
def dt(*shape):
    return DTensor.from_local(torch.zeros(shape), mesh,
                              [Replicate(), Replicate()], run_check=False)
refused = {}
for name, call in [("flash", lambda: ops.flash_attention(
        dt(4, 128, 16), dt(4, 128, 16), dt(4, 128, 16))),
                   ("rglru", lambda: ops.rglru(dt(1, 4, 8), dt(1, 4, 8),
                                               dt(1, 8)))]:
    try:
        call()
        refused[name] = None
    except TypeError as e:
        refused[name] = str(e)
out["refused"] = refused

# the serving snapshot, saved across the ranks, and its live continuation
t = time.perf_counter()
sn = args["snapshot"]
def unflat(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: unflat(v, flat, f"{prefix}{k}/") for k, v in
                template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(unflat(v, flat, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return flat[prefix[:-1]]
cfg = smoke("smollm-135m")
rules = make_variant("baseline")
params = params_from_numpy(unflat(get_api(cfg).param_defs(cfg, sn["max_seq"]),
                                  dict(np.load(sn["weights"]))), "cpu")
eng = ServeEngine(cfg, params, max_seq=sn["max_seq"], policy=P32, mesh=mesh,
                  rules=rules)
prompts = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                            (sn["b"], sn["p"]))
res = eng.generate(prompts, sn["n_new"])
eng.snapshot_service(CheckpointManager(sn["dir"]), 1)
_, decode = make_serve_fns(cfg, mesh, rules, policy=P32)
tok = torch.as_tensor(res.tokens[:, -1:], dtype=torch.long)
pos, cache, live = eng.pos - 1, eng.cache, []
with torch.no_grad():
    for _ in range(sn["more"]):
        logits, cache = decode(eng.params, cache, tok, pos)
        tok, pos = _greedy(logits)[:, None], pos + 1
        live.append(tok[:, 0].tolist())
out["snapshot"] = {"tokens": res.tokens.tolist(),
                   "live": np.array(live).T.tolist(),
                   "split_cache": at_windows(eng.cache)[1]}

out["t"]["snap"] = time.perf_counter() - t
# the CLI: rank 0 prints the rows
from repro_torch.launch import serve
t = time.perf_counter()
serve.main(args["cli"])
out["t"]["cli"] = time.perf_counter() - t
out["t"]["all"] = time.perf_counter() - T0
print(json.dumps(out))
'''

CASES = {   # name: (arch, kv heads (0: the config's), backend, variant)
    "fold": ("smollm-135m", 2, "chunked", "baseline"),
    "fold-fsdp": ("smollm-135m", 2, "chunked", "fsdp"),
    "expand": ("smollm-135m", 1, "chunked", "baseline"),
    "hybrid": ("recurrentgemma-9b", 0, "chunked", "baseline"),
    "moe": ("qwen2-moe-a2.7b", 0, "chunked", "baseline"),
    "mla": ("deepseek-v2-lite-16b", 0, "chunked", "baseline"),
}
#: the cases whose cache the rules split at model = 2: kv heads that
#: divide it, the hybrid's d_rnn; MQA's one kv head and MLA's compressed
#: cache stay whole on every rank
SPLIT_CACHE = {"fold", "fold-fsdp", "hybrid", "moe"}
SERVED = {"dense": ("smollm-135m", 2), "hybrid": ("recurrentgemma-9b", 0)}


def _jax_weights(path, max_seq):
    """JAX-initialised smoke smollm-135m, saved as ``a/b/0`` keyed numpy
    arrays; returns the configs and the JAX params."""
    jc = reduce_for_smoke(ARCHS["smollm-135m"])
    jp = j_init_params(j_get_api(jc).param_defs(jc, max_seq),
                       jax.random.PRNGKey(0))
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    np.savez(path, **flat)
    return jc, jp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    jc, jp = _jax_weights(d / "weights.npz", SNAP["max_seq"])
    args = {"mesh": [1, 2], "cases": CASES, "served": SERVED,
            "snapshot": {**SNAP, "weights": str(d / "weights.npz"),
                         "dir": str(d / "snap")},
            "cli": CLI + ["--model-parallel", "2"]}
    outs = tmesh.run_world(
        2, f"import sys; sys.argv[1:] = [{json.dumps(args)!r}]\n" + _WORLD,
        timeout_s=WORLD_TIMEOUT_S, env=ENV, cwd=ROOT)
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    cli_rows = [json.loads(line) for line in outs[0].strip().splitlines()[:-1]
                if line.startswith("{")]
    return dict(reports=reports, cli_rows=cli_rows, rank1_lines=len(
        outs[1].strip().splitlines()), jc=jc, jp=jp, snap=d / "snap")


def parity_world(shape, cases) -> list:
    """Each rank's ``parity`` report of ``cases`` in a world of mesh
    ``shape`` (every rank checked at its mesh coordinate)."""
    n = int(np.prod(shape))
    code = WORLD_COMMON + (
        'out["parity"] = {name: parity(*case) for name, case in '
        'args["cases"].items()}\nprint(json.dumps(out))\n')
    outs = tmesh.run_world(
        n, f"import sys; sys.argv[1:] = "
        f"[{json.dumps({'mesh': list(shape), 'cases': cases})!r}]\n" + code,
        timeout_s=WORLD_TIMEOUT_S, env=ENV, cwd=ROOT)
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [r["coord"] for r in reports] == [
        [i, j] for i in range(shape[0]) for j in range(shape[1])]
    return [r["parity"] for r in reports]


def assert_parity(got: dict, split_cache=None) -> None:
    """One rank's parity report: prefill, 4 decode steps and the
    whole-sequence forward within fp32 ``ATOL`` of the one-device path,
    or within twice the stack's own fp32 noise floor where that is
    higher; every leaf at its window, some split on this rank."""
    assert max(got["diffs"]) <= max(ATOL, 2 * max(got["noise"])), got
    assert len(got["diffs"]) == 6 and got["windows"]
    assert got["split_params"] + got["split_cache"] > 0
    if split_cache is not None:
        assert (got["split_cache"] > 0) == split_cache, got


def _on_every_rank(world, key):
    parts = [r[key] for r in world["reports"]]
    assert [r["coord"] for r in world["reports"]] == [[0, 0], [0, 1]]
    return parts


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_forward_matches_one_device(world, case):
    """Prefill logits and 4 decode steps through ``make_serve_fns``, and
    the whole-sequence forward, on DTensors at (1, 2) equal the one-device
    path at fp32 ``ATOL``, on
    every rank; the params and the prefill's cache are split on this rank
    and every leaf stays at its window.  ``fold``: 2 kv heads split over
    model = 2; ``expand``: MQA, k and v repeated to the 4 query heads and
    then split (``attention._expand``); ``-flash``: through the flash
    out as baseline; the hybrid's RG-LRU channels, the MoE's experts and
    MLA's heads split over model (xLSTM and whisper:
    tests/test_torch_sharded_families.py).  Where the stack's own fp32 noise floor
    (the same forward with the embedding moved by 1e-7 relative) is
    higher, it holds at twice that floor: the tamed hybrid's is ~1e-5,
    as tests/test_torch_models.py measures.  The flash branch of both is held by
    ``test_engine_on_the_mesh_matches_the_plain_engine``."""
    for rep in _on_every_rank(world, "parity"):
        assert rep[case]["split_params"] > 0
        assert_parity(rep[case], split_cache=case in SPLIT_CACHE)


def test_decode_step_collectives_are_tensor_parallel(world):
    """One decode step's collectives at (1, 2), counted by DTensor's
    ``CommDebugMode``: the vocab-parallel lookup's and each block's two
    row-parallel products' partial sums all-reduced (1 + 2 · layers), an
    RG-LRU block's u gathered once for its gate products, an MoE block's
    router logits gathered once for the softmax over all experts, and
    nothing else: no weight, head or channel gathered around a kernel."""
    reps = _on_every_rank(world, "parity")
    for name, arch in [("fold", "smollm-135m"), ("expand", "smollm-135m"),
                       ("hybrid", "recurrentgemma-9b"),
                       ("moe", "qwen2-moe-a2.7b")]:
        kinds = t_reduce_for_smoke(T_ARCHS[arch]).layer_kinds()
        want = {"all_reduce": 1 + 2 * len(kinds)}
        gathers = kinds.count("rglru") + (len(kinds) if arch.startswith(
            "qwen2") else 0)
        if gathers:
            want["all_gather_into_tensor"] = gathers
        for rep in reps:
            assert rep[name]["decode_collectives"] == want, (name, rep[name])


@pytest.mark.parametrize("name", sorted(SERVED))
def test_engine_on_the_mesh_matches_the_plain_engine(world, name):
    """``ServeEngine`` on the (1, 2) mesh (fp32, B=2, 128 + 4 through the
    flash and RG-LRU kernels' plain versions, head dim 64) gives the plain
    engine's tokens, its last logits within ``ATOL``, with every weight and
    cache
    leaf at its window after the prefill and after every decode step."""
    for rep in _on_every_rank(world, "served"):
        got = rep[name]
        assert got["tokens_equal"]
        assert got["logits"] <= ATOL
        assert got["windows"] == [True] * 4, got["windows"]
        assert got["split_cache"] > 0


def test_kernels_see_only_local_heads_and_channels(world):
    """On each rank the flash kernel's plain version receives B·H/2 query
    rows and B·KV/2 kv rows of head dim 64 (smollm: 2 × 4 heads, 2 kv;
    the hybrid's MQA: its kv head repeated to the 4 query heads, then
    split), and the
    RG-LRU's receives d_rnn/2 channels: each rank its own heads and
    channels, nothing gathered around the kernels."""
    tc = t_reduce_for_smoke(T_ARCHS["recurrentgemma-9b"])
    for rep in _on_every_rank(world, "served"):
        dense, hybrid = rep["dense"]["seen"], rep["hybrid"]["seen"]
        assert dense["flash"] == [[[2 * 4 // 2, 128, 64],
                                   [2 * 2 // 2, 128, 64]]] * 2
        assert dense["rglru"] == []
        assert hybrid["flash"] == [[[2 * 4 // 2, 128, 64],
                                    [2 * 4 // 2, 128, 64]]] * 2
        kinds = tc.layer_kinds()
        assert hybrid["rglru"] == [[2, 128, tc.d_rnn // 2]] * kinds.count(
            "rglru")
        assert len(hybrid["flash"]) == kinds.count("local_attn")


def test_kernel_wrappers_refuse_a_dtensor(world):
    """``ops.flash_attention`` and ``ops.rglru`` given a DTensor raise
    ``TypeError`` naming ``local_map``: they hand ``data_ptr``s to the
    kernels, so a missed ``local_map`` fails loudly, neither gathered nor
    run through the plain version."""
    for rep in _on_every_rank(world, "refused"):
        assert set(rep) == {"flash", "rglru"}
        for msg in rep.values():
            assert msg and "local_map" in msg


def test_serve_cli_model_parallel_2_prints_the_tokens_of_1(world):
    """``launch/serve.py --model-parallel 2`` in the 2-rank world serves
    sharded and prints its row from rank 0 only; its tokens are those of
    ``--model-parallel 1`` in a 1-rank world up to near ties.  The CLI
    computes in bf16, where a row-parallel product is rounded to bf16 on
    each rank before the ranks' partial sums are added (the reference's
    GSPMD all-reduce rounds alike): a greedy token may flip where its top
    two logits lie within bf16 noise.  So a flip must be a near tie in
    fp32 teacher-forced logits: a gap below twice the bf16 forward's own
    error against the fp32 forward on the same sequence, as
    tests/test_torch_serve.py holds bf16 engines."""
    assert world["rank1_lines"] == 1                # rank 1: its report only
    (row,) = world["cli_rows"]
    rows, eng = t_serve.run(CLI)
    assert dict(zip(eng.mesh.mesh_dim_names, eng.mesh.shape)) == {
        "data": 1, "model": 1}
    assert row["round"] == 0
    got, want = np.asarray(row["tokens"]), np.asarray(rows[0]["tokens"])
    assert got.shape == want.shape == (4, 6)
    prompts = np.random.default_rng(0).integers(
        0, eng.cfg.vocab_size, (4, 16))          # the CLI's seed
    seq = torch.from_numpy(np.concatenate([prompts, want], axis=1))
    params = jax.tree.map(lambda t: t.full_tensor(), eng.params)
    api = t_get_api(eng.cfg)
    with torch.no_grad():
        f32 = api.forward(eng.cfg, jax.tree.map(lambda t: t.float(), params),
                          {"tokens": seq}, TPolicy(compute=torch.float32))[0]
        b16 = api.forward(eng.cfg, params, {"tokens": seq}, eng.policy)[0]
    bf16_err = float((b16.float() - f32).abs().max())
    assert 0 < bf16_err < 0.5
    for r in range(got.shape[0]):
        for t in range(got.shape[1]):
            if got[r, t] != want[r, t]:
                logits = f32[r, 16 + t - 1]
                gap = abs(float(logits[got[r, t]] - logits[want[r, t]]))
                assert gap < 2 * bf16_err, (r, t, gap, bf16_err)
                break


def _raw(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (str(t.dtype).replace("torch.", ""), tuple(t.shape),
                t.numpy().tobytes())
    a = np.asarray(leaf)
    return (a.dtype.name, a.shape, a.tobytes())


def test_sharded_snapshot_restores_in_jax_and_on_one_device(world):
    """The (1, 2) engine's serving snapshot (fp32, 4 tokens of a 16-token
    prompt; its K/V split over the kv heads), saved across the two
    ranks, restores in the JAX package on one device and in the port on
    one device leaf for leaf alike.  From each restore, 4 greedy fp32
    decode steps give the tokens the live sharded engine generated from
    its own cache."""
    b, p, n_new, more, max_seq = (SNAP[k] for k in
                                  ("b", "p", "n_new", "more", "max_seq"))
    reps = _on_every_rank(world, "snapshot")
    assert reps[0] == reps[1] and reps[0]["split_cache"] > 0
    live = np.asarray(reps[0]["live"])
    tc = t_reduce_for_smoke(T_ARCHS["smollm-135m"])
    jc, jp = world["jc"], world["jp"]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    t_api = t_get_api(tc)
    template = {"cache": t_api.cache_defs(tc, b, max_seq, torch.float32),
                "pos": torch.zeros((b,), dtype=torch.int32),
                "generated": np.zeros((b, n_new), np.int32)}
    template["cache"] = jax.tree.map(
        lambda d: torch.zeros(d.shape, dtype=d.dtype), template["cache"],
        is_leaf=lambda x: hasattr(x, "logical"))
    t_snap, meta = TManager(world["snap"]).restore(template, device="cpu")
    assert meta["kind"] == "serve" and meta["world"] == {"n_devices": 2}
    assert t_snap["generated"].tolist() == reps[0]["tokens"]
    jmgr = JManager(world["snap"])
    jmgr.store = JChunkStore(world["snap"] / "chunks")
    j_snap, _ = jmgr.restore(jax.tree.map(lambda _: 0, t_snap))
    assert ({k: _raw(v) for k, v in jser._leaf_paths(j_snap)}
            == {k: _raw(v) for k, v in tser._leaf_paths(t_snap)})

    # the port on one device
    eng = TServeEngine(tc, tp, max_seq=max_seq, policy=TPolicy(
        compute=torch.float32), device="cpu")
    tok = torch.as_tensor(np.asarray(t_snap["generated"])[:, -1:],
                          dtype=torch.long)
    pos, cache, t_cont = t_snap["pos"].long() - 1, t_snap["cache"], []
    with torch.inference_mode():
        for _ in range(more):
            lg, cache = t_api.decode(tc, eng.params, cache, tok, pos,
                                     eng.policy)
            tok, pos = torch.argmax(lg, dim=-1)[:, None], pos + 1
            t_cont.append(tok[:, 0].numpy())
    assert np.array_equal(np.stack(t_cont, 1), live)

    # JAX on one device, fp32
    j_api = j_get_api(jc)
    dec = jax.jit(lambda c, t, q: j_api.decode(jc, jp, c, t, q,
                                               JPolicy(compute=jnp.float32)))
    tok = jnp.asarray(np.asarray(j_snap["generated"])[:, -1:], jnp.int32)
    pos, cache, j_cont = jnp.asarray(j_snap["pos"]) - 1, j_snap["cache"], []
    for _ in range(more):
        lg, cache = dec(cache, tok, pos)
        tok = jnp.argmax(lg, axis=-1)[:, None].astype(jnp.int32)
        pos = pos + 1
        j_cont.append(np.asarray(tok[:, 0]))
    assert np.array_equal(np.stack(j_cont, 1), live)
