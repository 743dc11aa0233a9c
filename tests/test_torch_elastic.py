"""The port's multi-device layouts on the CPU: sharded checkpoints across
the ranks of a ``gloo`` world, elastic restores onto another world, and
both directions across the packages.

Worlds of several ranks are ``python -c`` processes on this host
(``launch.mesh.run_world``: a file store under a fresh directory, no
port); JAX's meshes are subprocesses with forced host devices, as
tests/test_resharding.py runs them.  The model is smoke smollm-135m
(2 layers, d 64, 4/2 heads), fp32, its port params drawn from a CPU
``torch.Generator`` seed, so every rank and this process build the same
tree.  Every comparison of values is bit for bit; windows and chunk names
are compared exactly."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import serialization as ser
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.core.coordinator import Membership, StaleGenerationError
from repro_torch.distributed import elastic
from repro_torch.distributed.sharding import (DEFAULT_RULES, is_dtensor,
                                              lay_out, param_shardings)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as t_serve
from repro_torch.models.layers import Policy
from repro_torch.models.params import init_params, tree_leaves, tree_unflatten
from repro_torch.models.registry import get_api
from repro_torch.serve.engine import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
MAX_SEQ = 64
STEP = 3
WORLD_TIMEOUT_S = 240

_PORT_TREE = """
import torch
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.models.params import init_params, tree_leaves, tree_unflatten
from repro_torch.models.registry import get_api
cfg = reduce_for_smoke(ARCHS["smollm-135m"])
defs = get_api(cfg).param_defs(cfg, {max_seq})
params = init_params(defs, torch.Generator().manual_seed(0), "cpu")
"""

# a (2, 2) world lays the params out under DEFAULT_RULES and saves them;
# a first save, into another root, fails on rank 1 and must commit nothing
_SAVE_WORLD = _PORT_TREE + """
import json, sys, time
from repro_torch.checkpoint import serialization as ser
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.elastic import choose_mesh
from repro_torch.distributed.sharding import DEFAULT_RULES, param_shardings
from repro_torch.distributed.sharding import lay_out
from repro_torch.launch.mesh import join_world, make_mesh
from repro_torch.models.params import tree_leaves, tree_unflatten
rank = join_world()
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
tree = tree_unflatten(params, [
    lay_out(t, l) for t, l in zip(tree_leaves(params), tree_leaves(
        param_shardings(defs, mesh, DEFAULT_RULES)))])
write = ser.write_chunks
def broken(*a, **k):
    raise OSError("disk full")
if rank == 1:
    ser.write_chunks = broken
try:
    CheckpointManager(sys.argv[1] + "-failed").save(1, tree)
    failed = None
except RuntimeError as e:
    failed = str(e)
ser.write_chunks = write
mgr = CheckpointManager(sys.argv[1])
t0 = time.perf_counter()
mgr.save({step}, tree)
save_s = time.perf_counter() - t0
print(json.dumps({{"rank": rank, "coord": mesh.get_coordinate(),
                   "failed": failed, "save_s": save_s,
                   "bytes_written": mgr.stats["last_bytes_written"],
                   "choose_3": list(choose_mesh(model_parallel=3,
                                                device="cpu").shape)}}))
"""

# a 2-rank world restores a checkpoint under two layouts; each rank
# reports its windows and whether its local shards equal the expected
# values' windows
_RESTORE_WORLD = _PORT_TREE + """
import json, sys
import numpy as np
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.serialization import _leaf_paths
from repro_torch.distributed.elastic import choose_mesh, elastic_restore
from repro_torch.distributed.sharding import DEFAULT_RULES, make_variant, window
from repro_torch.launch.mesh import join_world, make_mesh
rank = join_world()
want = dict(np.load(sys.argv[2]))
out = {{"rank": rank}}
for name, mesh, rules in [
        ("baseline", choose_mesh(2, model_parallel=2, device="cpu"),
         DEFAULT_RULES),
        ("fsdp", make_mesh((2, 1), ("data", "model"), device="cpu"),
         make_variant("fsdp"))]:
    state, meta = elastic_restore(CheckpointManager(sys.argv[1]), defs, mesh,
                                  rules)
    wins, equal = {{}}, True
    for key, dt in _leaf_paths(state):
        win = window(dt.placements, tuple(dt.shape), tuple(mesh.shape),
                     mesh.get_coordinate())
        wins[key] = win
        ref = torch.from_numpy(want[key][tuple(slice(a, b) for a, b in win)])
        equal &= torch.equal(dt.to_local(), ref)
    out[name] = {{"coord": mesh.get_coordinate(), "windows": wins,
                  "equal": equal, "devices": meta["restored_onto"]["devices"],
                  "topology_changed": meta["topology_changed"]}}
print(json.dumps(out))
"""

_JAX_SIDE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.checkpoint.manager import CheckpointManager
from repro.checkpoint.serialization import _leaf_paths
from repro.configs import ARCHS, reduce_for_smoke
from repro.distributed.sharding import (DEFAULT_RULES, make_variant,
                                        param_shardings)
from repro.models.params import init_params, is_pm
from repro.models.registry import get_api
jroot, troot, tnpz, j22root, jnpz = sys.argv[1:6]
cfg = reduce_for_smoke(ARCHS["smollm-135m"])
defs = get_api(cfg).param_defs(cfg, {max_seq})
def mesh(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
def put(tree, m, rules):
    return jax.device_put(tree, param_shardings(defs, m, rules))
out = {{}}
# (a) JAX's own params, saved sharded over (2, 4)
params = init_params(defs, jax.random.PRNGKey(0))
mgr = CheckpointManager(jroot)
mgr.save({step}, put(params, mesh((2, 4)), DEFAULT_RULES))
mgr.wait()
np.savez(jnpz, **{{k: np.asarray(v) for k, v in _leaf_paths(params)}})
# (b) the windows each coordinate of a 2-rank mesh holds under two layouts
out["windows"] = {{}}
for name, shape, rules in [("baseline", (1, 2), DEFAULT_RULES),
                           ("fsdp", (2, 1), make_variant("fsdp"))]:
    m = mesh(shape)
    wins = {{}}
    for k, sh in _leaf_paths(param_shardings(defs, m, rules)):
        leaf_shape = dict(_leaf_paths(defs))[k].shape
        for d, idx in sh.devices_indices_map(leaf_shape).items():
            c = json.dumps([int(i) for i in np.argwhere(m.devices == d)[0]])
            wins.setdefault(c, {{}})[k] = [
                [s.start or 0, leaf_shape[i] if s.stop is None else s.stop]
                for i, s in enumerate(idx)]
    out["windows"][name] = wins
# (c) the port world's checkpoint onto (2, 4) and onto one device
want = dict(np.load(tnpz))
tmgr = CheckpointManager(troot)
on24, meta = tmgr.restore(defs, mesh=mesh((2, 4)), rules=DEFAULT_RULES)
one, _ = tmgr.restore(defs, None)
def equal(tree):
    return all(np.array_equal(np.asarray(v), want[k])
               for k, v in _leaf_paths(tree))
out["port_on_2x4"] = equal(on24) and len(
    on24["embed"]["embedding"].addressable_shards) == 8
out["port_on_one"] = equal(one)
out["port_world"] = meta["world"]
# (d) the port's values saved by JAX under the port world's (2, 2) mesh
flat, treedef = jax.tree_util.tree_flatten_with_path(defs, is_leaf=is_pm)
keys = [k for k, _ in _leaf_paths(defs)]
tree = jax.tree_util.tree_unflatten(treedef, [want[k] for k in keys])
j22 = CheckpointManager(j22root)
j22.save({step}, put(tree, mesh((2, 2)), DEFAULT_RULES))
j22.wait()
print(json.dumps(out))
"""


def _port_params():
    cfg = reduce_for_smoke(ARCHS["smollm-135m"])
    defs = get_api(cfg).param_defs(cfg, MAX_SEQ)
    return cfg, defs, init_params(defs, torch.Generator().manual_seed(0),
                                  "cpu")


def _world(n, code, *args):
    outs = tmesh.run_world(n, code + "\n" if not args else
                           f"import sys; sys.argv[1:] = {list(args)!r}\n"
                           + code, timeout_s=WORLD_TIMEOUT_S, env=ENV,
                           cwd=ROOT)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The port's (2, 2) world saves; JAX saves its own params over (2, 4),
    restores the port's checkpoint, and saves the port's values under
    (2, 2); a port 2-rank world restores JAX's checkpoint."""
    d = tmp_path_factory.mktemp("cross")
    paths = {k: d / k for k in ("port", "jax", "jax22")}
    saves = _world(4, _SAVE_WORLD.format(max_seq=MAX_SEQ, step=STEP),
                   str(paths["port"]))
    _, defs, params = _port_params()
    tnpz, jnpz = d / "port.npz", d / "jax.npz"
    np.savez(tnpz, **{k: v.numpy() for k, v in ser._leaf_paths(params)})
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE.format(max_seq=MAX_SEQ, step=STEP),
         str(paths["jax"]), str(paths["port"]), str(tnpz),
         str(paths["jax22"]), str(jnpz)],
        capture_output=True, text=True, timeout=300, env=ENV, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    jax_side = json.loads(r.stdout.strip().splitlines()[-1])
    restores = _world(2, _RESTORE_WORLD.format(max_seq=MAX_SEQ),
                      str(paths["jax"]), str(jnpz))
    return dict(paths=paths, saves=saves, jax=jax_side, restores=restores,
                defs=defs, params=params, jnpz=dict(np.load(jnpz)))


def _manifest(root: Path, step=STEP) -> dict:
    return ser.load_manifest(root / f"step_{step:010d}")


# ------------------------------------------------------ across the packages

def test_jax_2x4_checkpoint_restores_on_one_device(cross):
    out, meta = CheckpointManager(cross["paths"]["jax"]).restore(
        cross["defs"], device="cpu")
    assert meta["world"] == {"n_devices": 8}
    assert all(torch.equal(v, torch.from_numpy(cross["jnpz"][k]))
               for k, v in ser._leaf_paths(out))
    assert any(len(e["shards"]) > 1 for e in
               _manifest(cross["paths"]["jax"])["leaves"].values())


def test_jax_2x4_checkpoint_restores_in_a_2_rank_world_at_jax_windows(cross):
    """Each rank's shard equals the JAX values at its window, and its
    window is the one JAX's NamedSharding gives the device at the same
    mesh coordinate: (1, 2) under the default rules, (2, 1) under FSDP."""
    for rank_out in cross["restores"]:
        for layout in ("baseline", "fsdp"):
            got = rank_out[layout]
            assert got["equal"] and got["devices"] == 2
            assert got["topology_changed"]         # 8 devices wrote it
            want = cross["jax"]["windows"][layout][json.dumps(got["coord"])]
            assert got["windows"] == want
    # the layouts did shard: some leaf of each is split across the ranks
    for layout in ("baseline", "fsdp"):
        wins = [r[layout]["windows"] for r in cross["restores"]]
        assert any(wins[0][k] != wins[1][k] for k in wins[0])


def test_port_4_rank_save_restores_in_jax_on_2x4_and_one_device(cross):
    assert cross["jax"]["port_on_2x4"] and cross["jax"]["port_on_one"]
    assert cross["jax"]["port_world"] == {"n_devices": 4}


def test_port_4_rank_manifest_lists_jax_windows_and_chunks(cross):
    """The port world's manifest and JAX's of the same values under the
    same (2, 2) mesh and rules: the same windows, chunk names and
    devices, leaf for leaf."""
    port, jax22 = (_manifest(cross["paths"][k]) for k in ("port", "jax22"))
    assert port["codec"] == jax22["codec"]
    assert list(port["leaves"]) == list(jax22["leaves"])

    def shards(entry):
        return sorted((json.dumps(s["index"]), s["chunk"], s["device"])
                      for s in entry["shards"])
    for k, entry in port["leaves"].items():
        assert (entry["shape"], entry["dtype"]) == (
            jax22["leaves"][k]["shape"], jax22["leaves"][k]["dtype"])
        assert shards(entry) == shards(jax22["leaves"][k]), k


# ------------------------------------------------------- saves across ranks

def test_port_4_rank_save_writes_each_window_once(cross):
    """Replicas are written once: the windows of every leaf tile it
    exactly, the ranks at data coordinate 1 (replicas of the ranks at 0
    under the default rules) write nothing, and the manifest validates."""
    man = _manifest(cross["paths"]["port"])
    logical = raw = 0
    for entry in man["leaves"].values():
        n = int(np.prod(entry["shape"]))
        logical += n * 4
        raw += sum(s["raw"] for s in entry["shards"])
        assert sum(int(np.prod([b - a for a, b in s["index"]]))
                   for s in entry["shards"]) == n
    assert raw == logical
    by_coord = {tuple(s["coord"]): s for s in cross["saves"]}
    assert by_coord[(1, 0)]["bytes_written"] == 0
    assert by_coord[(1, 1)]["bytes_written"] == 0
    assert by_coord[(0, 0)]["bytes_written"] > 0
    assert by_coord[(0, 1)]["bytes_written"] > 0
    assert {s["device"] for e in man["leaves"].values()
            for s in e["shards"]} == {0, 1}
    assert ser.validate(cross["paths"]["port"] / f"step_{STEP:010d}")
    assert man["meta"]["world"] == {"n_devices": 4}


def test_failed_rank_fails_the_save_everywhere_and_commits_nothing(cross):
    assert all("rank 1" in s["failed"] and "disk full" in s["failed"]
               for s in cross["saves"])
    failed = Path(str(cross["paths"]["port"]) + "-failed")
    assert not (failed / "step_0000000001" / "MANIFEST.json").exists()
    assert CheckpointManager(failed).latest_valid() is None


def test_port_4_rank_checkpoint_restores_elastically_on_one_rank(cross):
    """The (2, 2) world's checkpoint onto this process's 1-rank mesh:
    DTensors holding the whole leaves, bit-equal to the tree built here."""
    mgr = CheckpointManager(cross["paths"]["port"])
    state, meta = elastic.elastic_restore(
        mgr, cross["defs"], elastic.choose_mesh(device="cpu"), DEFAULT_RULES)
    assert meta["source_world"] == {"n_devices": 4}
    assert meta["restored_onto"] == {"devices": 1,
                                     "mesh": {"data": 1, "model": 1}}
    assert meta["topology_changed"] is True
    for (_, got), (_, want) in zip(ser._leaf_paths(state),
                                   ser._leaf_paths(cross["params"])):
        assert is_dtensor(got) and torch.equal(got.to_local(), want)


def test_one_rank_dtensor_save_is_todays_format(tmp_path):
    """In a 1-rank world a tree of DTensors saves to the manifest a tree
    of plain tensors gives: one whole shard a leaf, the same chunks."""
    _, defs, params = _port_params()
    mesh = tmesh.make_local_mesh(device="cpu")
    tree = tree_unflatten(params, [
        lay_out(t, l) for t, l in zip(tree_leaves(params), tree_leaves(
            param_shardings(defs, mesh, DEFAULT_RULES)))])
    CheckpointManager(tmp_path / "a", async_write=False).save(0, tree)
    CheckpointManager(tmp_path / "b", async_write=False).save(0, params)
    a, b = (_manifest(tmp_path / k, 0) for k in "ab")
    assert a["leaves"] == b["leaves"] and a["meta"]["world"] == {
        "n_devices": 1}


# -------------------------------------------------- the reference's semantics

def test_elastic_restore_reports_topology_change(tmp_path):
    """Twin of test_virtualization.py::
    test_elastic_restore_reports_topology_change, on a 1-rank mesh."""
    mesh = tmesh.make_mesh((1,), ("data",), device="cpu")
    mgr = CheckpointManager(tmp_path, generation=2)
    mgr.save(5, {"w": torch.arange(8.0)},
             meta={"world": {"n_devices": 4, "mesh": {"data": 4}}})
    mgr.wait()
    tpl = {"w": torch.empty(8)}
    out, meta = elastic.elastic_restore(mgr, tpl, mesh, DEFAULT_RULES)
    assert torch.equal(out["w"].to_local(), torch.arange(8.0))
    assert meta["restored_onto"] == {"devices": 1, "mesh": {"data": 1}}
    assert meta["source_world"] == {"n_devices": 4, "mesh": {"data": 4}}
    assert meta["topology_changed"] is True
    assert meta["generation"] == 2
    mgr2 = CheckpointManager(tmp_path / "same")
    mgr2.save(1, {"w": torch.arange(8.0)})
    mgr2.wait()
    _, meta2 = elastic.elastic_restore(mgr2, tpl, mesh, DEFAULT_RULES)
    assert meta2["topology_changed"] is False
    empty = CheckpointManager(tmp_path / "empty")
    assert elastic.elastic_restore(empty, tpl, mesh,
                                   DEFAULT_RULES) == (None, None)


def test_restore_refuses_a_path_in_place_of_shardings(tmp_path):
    """The reference's argument order, (template, shardings, ckpt_dir): a
    step directory passed second is a caller's error and raises before any
    checkpoint is read, not taken for a corrupt checkpoint and skipped."""
    mgr = CheckpointManager(tmp_path)
    d = mgr.save(1, {"w": torch.arange(8.0)})
    mgr.wait()
    with pytest.raises(TypeError, match="third argument"):
        mgr.restore({"w": 0}, d, device="cpu")
    out, _ = mgr.restore({"w": 0}, None, d, device="cpu")
    assert torch.equal(out["w"], torch.arange(8.0))


def test_atomic_reshape_single_bump_mesh_layer(tmp_path):
    """Twin of test_live_migrate.py::
    test_atomic_reshape_single_bump_both_layers: first both layers, the
    mesh manager and the port's rank world (``MPIJob.restart``) under one
    bump; then the mesh layer alone, one more bump, the manager stamped
    with it."""
    from repro_torch.core.runtime import MPIJob
    from repro_torch.distributed.proxy_grad import make_dp_app
    membership = Membership(2)
    init_fn, step_fn = make_dp_app()
    job = MPIJob(2, step_fn, init_fn, transport="shm", membership=membership)
    job.checkpoint_at(2, tmp_path / "ck", resume=False)
    job.run(4, timeout=60)
    job.stop()
    mgr = CheckpointManager(tmp_path / "mesh", generation=0)
    mgr.save(7, {"w": torch.arange(8.0)})
    mgr.wait()
    mesh = tmesh.make_mesh((1,), ("data",), device="cpu")
    both = elastic.atomic_reshape(membership, dead=(1,), mgr=mgr,
                                  template={"w": 0}, mesh=mesh,
                                  rules=DEFAULT_RULES,
                                  ckpt_dir=tmp_path / "ck", step_fn=step_fn,
                                  init_fn=init_fn, transport="tcp")
    assert both.layers == ("mesh", "world")
    assert both.generation == 1 == membership.generation == mgr.generation \
        == both.job.coord.generation
    assert both.job.n == both.world_size == 1
    out = both.job.run(4, timeout=60)
    both.job.stop()
    assert np.isfinite(out[0]["loss"])
    assert torch.equal(both.state["w"].to_local(), torch.arange(8.0))
    rep = elastic.atomic_reshape(membership, dead=(), mgr=mgr,
                                 template={"w": 0}, mesh=mesh,
                                 rules=DEFAULT_RULES)
    assert rep.generation == 2 == membership.generation == mgr.generation
    assert rep.layers == ("mesh",) and rep.job is None
    assert rep.world_size == membership.world_size == 1
    assert rep.dead_ranks == ()
    assert torch.equal(rep.state["w"].to_local(), torch.arange(8.0))
    assert rep.meta["restored_onto"]["devices"] == 1
    mgr.save(8, {"w": torch.arange(8.0)})
    mgr.wait()
    assert _manifest(tmp_path / "mesh", 8)["meta"]["generation"] == 2
    assert membership.history == [(0, 2, ()), (1, 1, (1,)), (2, 1, ())]


def test_membership_generation_rules():
    """Twin of test_elastic_restart.py::test_membership_generation_rules."""
    ms = Membership(4)
    assert ms.generation == 0 and ms.world_size == 4
    assert ms.bump(dead=[1, 1, 3]) == 1
    assert ms.world_size == 2
    assert ms.bump(world_size=5) == 2
    ms.check(2)
    ms.check(None)
    for stale in (0, 1, 3):
        with pytest.raises(StaleGenerationError):
            ms.check(stale)
    assert ms.history[-1] == (2, 5, ())
    with pytest.raises(ValueError):
        Membership(1).bump(dead=[0])


def test_choose_mesh_and_local_mesh_on_one_rank(cross):
    """choose_mesh steps model down until it divides the world (4 ranks:
    3 -> 2; 1 rank: 2 -> 1); make_local_mesh keeps the reference's
    assertion; a mesh of another size than the world is refused with the
    size it needs."""
    assert all(s["choose_3"] == [2, 2] for s in cross["saves"])
    assert elastic.choose_mesh(model_parallel=2, device="cpu").shape == (1, 1)
    with pytest.raises(AssertionError):
        tmesh.make_local_mesh(model=2, device="cpu")
    with pytest.raises(ValueError, match="needs a world of 2 ranks; this "
                                         "world has 1"):
        tmesh.make_local_mesh(n=2, device="cpu")
    with pytest.raises(ValueError, match="needs a world of 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        tmesh.make_production_mesh(device="cpu")


def test_mesh_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tmesh.make_local_mesh(device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        elastic.choose_mesh()


# ------------------------------------------------------------------ serving

def test_engine_serves_a_restored_tree_on_a_mesh(tmp_path):
    """ServeEngine(mesh, rules) over the DTensors of an elastic restore
    gives the tokens and last logits of an engine over the plain tree,
    bit for bit; the restored DTensors are served as they are, and a
    plain engine refuses them."""
    cfg, defs, params = _port_params()
    mgr = CheckpointManager(tmp_path)
    mgr.save(0, params)
    mgr.wait()
    mesh = elastic.choose_mesh(device="cpu")
    state, _ = elastic.elastic_restore(mgr, defs, mesh, DEFAULT_RULES)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    policy = Policy(compute=torch.float32)
    on_mesh = ServeEngine(cfg, state, max_seq=MAX_SEQ, policy=policy,
                          mesh=mesh, rules=DEFAULT_RULES)
    plain = ServeEngine(cfg, params, max_seq=MAX_SEQ, policy=policy,
                        device="cpu")
    a, b = on_mesh.generate(prompts, 6), plain.generate(prompts, 6)
    assert on_mesh.params["final"]["scale"] is state["final"]["scale"]
    assert np.array_equal(a.tokens, b.tokens)
    assert torch.equal(on_mesh.last_logits(2), plain.last_logits(2))
    with pytest.raises(ValueError, match="together"):
        ServeEngine(cfg, params, max_seq=MAX_SEQ, mesh=mesh)
    with pytest.raises(ValueError, match="mesh and rules"):
        ServeEngine(cfg, state, max_seq=MAX_SEQ, device="cpu")


def test_serve_cli_variant_and_model_parallel(capsys):
    """--variant and --model-parallel reach the engine; a model axis the
    world cannot hold fails with the world's size, not clamped."""
    rows, eng = t_serve.run(["--arch", "smollm-135m", "--reduced",
                             "--device", "cpu", "--prompt-len", "16",
                             "--new-tokens", "2", "--variant",
                             "fsdp+kvseq"])
    assert eng.rules.name == "fsdp+kvseq" and eng.rules.fsdp_axes == ("data",)
    assert dict(zip(eng.mesh.mesh_dim_names, eng.mesh.shape)) == {
        "data": 1, "model": 1}
    assert rows[0]["round"] == 0
    for argv, msg in [(["--model-parallel", "2"], "world of 1 rank"),
                      (["--variant", "nope"], "unknown sharding variant")]:
        with pytest.raises(SystemExit):
            t_serve.run(["--arch", "smollm-135m", "--reduced", "--device",
                         "cpu"] + argv)
        assert msg in capsys.readouterr().err
