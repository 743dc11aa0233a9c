"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's, without a world: specs, variants, every leaf of the ten
full configs on both production mesh shapes (JAX's side on an
``AbstractMesh``, which needs no devices), DTensor placements and the
windows they give against JAX's ``devices_indices_map`` (a subprocess
with forced host devices), and the ``expand`` GQA branch the rules select
in attention, against the reference's under a mesh with model = 2.

Specs are compared exactly.  The smoke stack's logits are O(1): the
port's expand branch agrees with its fold branch at fp32 1e-5 (one
framework, the same products in another layout; measured up to 6.9e-6),
and with the reference's jitted four-device program at the repo's fp32
logit tolerance, 1e-4 (two frameworks' summation orders; measured up to
5.1e-5)."""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.checkpoint.serialization import _leaf_paths as j_leaf_paths
from repro.configs import ARCHS
from repro.distributed import sharding as jsh
from repro.models.registry import get_api as j_get_api
from repro_torch.checkpoint.serialization import _leaf_paths
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce_for_smoke
from repro_torch.distributed import sharding as tsh
from repro_torch.models import attention as t_att
from repro_torch.models.layers import Policy as TPolicy
from repro_torch.models.params import params_from_numpy
from repro_torch.models.registry import get_api as t_get_api

ROOT = Path(__file__).resolve().parents[1]
T32 = TPolicy(compute=torch.float32)
ATOL = 1e-5            # the port's expand branch vs its fold branch
LOGIT_ATOL = 1e-4      # the port vs the reference (test_torch_models.py)
PARTS = ("baseline", "default", "fsdp", "kvseq", "seqshard", "sp_saves",
         "expert_ff", "dponly", "dponly_fsdp")
COMBOS = ("seqshard+fsdp", "dponly+fsdp", "fsdp+dponly", "kvseq+fsdp",
          "expert_ff+seqshard+fsdp", "sp_saves+kvseq")
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _abstract(shape, axes):
    return AbstractMesh(tuple(shape), tuple(axes))


# ------------------------------------------------------------------ rules

def test_resolve_spec_divisibility_and_prefix():
    """Twin of test_substrate.py::test_resolve_spec_divisibility_and_prefix
    on a (2, 4) mesh given by its axis sizes."""
    mesh = {"data": 2, "model": 4}
    r = tsh.make_variant("baseline")
    assert tsh.resolve_spec(("embed", "heads", None), (64, 8, 16), mesh,
                            r) == (None, "model", None)
    assert tsh.resolve_spec(("embed", "heads", None), (64, 9, 16), mesh,
                            r) == (None, None, None)
    assert tsh.resolve_spec(("batch", "seq"), (6, 128), mesh, r) == ("data",
                                                                    None)
    d = tsh.make_variant("dponly")
    assert tsh.resolve_spec(("batch", None), (6, 4), mesh, d) == ("data",
                                                                  None)
    assert tsh.resolve_spec(("heads", "ffn"), (8, 8), mesh, r) == ("model",
                                                                  None)
    f = tsh.make_variant("fsdp")
    assert tsh.resolve_spec(("embed", "ffn"), (64, 8), mesh, f,
                            fsdp=True) == ("data", "model")


_SPEC_CASES = [
    (("embed", "heads", None), (64, 8, 16)),
    (("embed", "heads", None), (64, 9, 16)),
    (("batch", "seq"), (6, 128)),
    (("batch", "seq"), (16, 128)),
    (("batch", None), (6, 4)),
    (("batch", None), (64, 4)),
    (("heads", "ffn"), (8, 8)),
    (("embed", "ffn"), (64, 8)),
    (("layers", "embed", "ffn"), (32, 64, 6)),
    (("kv_seq", "kv_heads", "head_dim"), (128, 1, 64)),
    (("batch", "seq", "embed"), (8, 32, 64)),
    (("vocab", "embed"), (49152, 576)),
    ((None, "experts", "expert_ff"), (2, 60, 1408)),
]


@pytest.mark.parametrize("variant", PARTS + COMBOS)
@pytest.mark.parametrize("mesh", [((2, 4), ("data", "model")),
                                  ((2, 2, 2), ("pod", "data", "model")),
                                  ((1, 1), ("data", "model"))])
def test_resolve_spec_matches_reference(variant, mesh):
    """The cases of test_substrate.py and more, both packages, with and
    without the FSDP extension: equal specs."""
    shape, axes = mesh
    jm, tm = _abstract(shape, axes), dict(zip(axes, shape))
    jr, tr = jsh.make_variant(variant), tsh.make_variant(variant)
    for (logical, dims), fsdp in itertools.product(_SPEC_CASES,
                                                   (False, True)):
        want = tuple(jsh.resolve_spec(logical, dims, jm, jr, fsdp=fsdp))
        assert tsh.resolve_spec(logical, dims, tm, tr, fsdp=fsdp) == want, (
            logical, dims, fsdp)
    for (logical, dims) in _SPEC_CASES:
        assert tsh.logical_spec(logical, dims, tm, tr) == tuple(
            jsh.logical_spec(logical, dims, jm, jr))


def test_variant_registry():
    """Twin of test_substrate.py::test_variant_registry."""
    for name in ("baseline", "fsdp", "kvseq", "seqshard", "expert_ff",
                 "dponly", "dponly_fsdp"):
        v = tsh.make_variant(name)
        assert v.name in (name, "baseline")
    with pytest.raises(KeyError):
        tsh.make_variant("nope")
    with pytest.raises(KeyError):
        tsh.make_variant("fsdp+nope")


@pytest.mark.parametrize("name", PARTS + COMBOS)
def test_make_variant_matches_reference(name):
    j, t = jsh.make_variant(name), tsh.make_variant(name)
    assert (t.mapping, t.fsdp_axes, t.name) == (j.mapping, j.fsdp_axes,
                                                j.name)
    assert tsh.DEFAULT_RULES.mapping == jsh.DEFAULT_RULES.mapping


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_shardings_match_reference_on_full_configs(name, mesh):
    """Every leaf of the full config on a production mesh shape, under the
    default rules and two FSDP variants: the port's spec is the
    reference's, and its placements shard each mesh dim the spec names."""
    shape, axes = MESHES[mesh]
    jm, tm = _abstract(shape, axes), dict(zip(axes, shape))
    jdefs = j_get_api(ARCHS[name]).param_defs(ARCHS[name], 4096)
    tdefs = t_get_api(T_ARCHS[name]).param_defs(T_ARCHS[name], 4096)
    for variant in ("baseline", "fsdp", "dponly_fsdp"):
        jr, tr = jsh.make_variant(variant), tsh.make_variant(variant)
        want = {k: tuple(s.spec) for k, s in
                j_leaf_paths(jsh.param_shardings(jdefs, jm, jr))}
        got = {k: lay for k, lay in
               _leaf_paths(tsh.param_shardings(tdefs, tm, tr))}
        assert list(got) == list(want)
        assert {k: lay.spec for k, lay in got.items()} == want, variant
        for lay in got.values():
            for i, axis in enumerate(axes):
                named = [d for d, e in enumerate(lay.spec)
                         if axis in tsh._axes(e)]
                p = lay.placements[i]
                assert (p.is_shard(named[0]) if named
                        else p.is_replicate()), (lay, axis)


# ------------------------------------------------------- placements/windows

_WINDOWS_SNIPPET = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.load(open(sys.argv[1]))
out = []
for mshape, axes, spec, shape in cases:
    n = int(np.prod(mshape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(mshape), tuple(axes))
    pspec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    imap = NamedSharding(mesh, pspec).devices_indices_map(tuple(shape))
    wins = {}
    for d, idx in imap.items():
        coord = [int(c) for c in np.argwhere(mesh.devices == d)[0]]
        wins[json.dumps(coord)] = [[s.start or 0, shape[i] if s.stop is None
                                    else s.stop] for i, s in enumerate(idx)]
    out.append(wins)
print(json.dumps(out))
"""


def _window_cases() -> list:
    """Every (mesh, spec, shape) the rules give the ten reduced configs'
    params under each variant part, and activation layouts with joint
    axes, on four mesh shapes."""
    cases = {}
    meshes = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
              ((1, 2), ("data", "model")), ((2, 1), ("data", "model"))]
    acts = [(("batch", "seq", "embed"), (16, 8, 64)), (("batch", None), (8, 4)),
            (("batch", "heads", "seq", "kv_seq"), (8, 4, 16, 16))]
    for (mshape, axes), variant in itertools.product(meshes, PARTS + COMBOS):
        m = dict(zip(axes, mshape))
        rules = tsh.make_variant(variant)
        for name in sorted(T_ARCHS):
            cfg = t_reduce_for_smoke(T_ARCHS[name])
            for _, p in _leaf_paths(t_get_api(cfg).param_defs(cfg, 64)):
                spec = tsh.resolve_spec(p.logical, p.shape, m, rules,
                                        fsdp=True)
                cases[json.dumps([mshape, axes, spec, p.shape])] = None
        for logical, shape in acts:
            spec = tsh.resolve_spec(logical, shape, m, rules)
            cases[json.dumps([mshape, axes, spec, shape])] = None
    return [json.loads(c) for c in cases]


def test_windows_match_jax_devices_indices_map(tmp_path):
    """The window each mesh coordinate holds under the placements of a
    spec (a dim split over two or three mesh axes included) is the one
    JAX's NamedSharding gives the device at that coordinate."""
    cases = _window_cases()
    assert any(isinstance(e, list) and len(e) == 3
               for _, _, spec, _ in cases for e in spec)   # joint dims
    path = tmp_path / "cases.json"
    path.write_text(json.dumps(cases))
    r = subprocess.run([sys.executable, "-c", _WINDOWS_SNIPPET, str(path)],
                       capture_output=True, text=True, timeout=300, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": "src",
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    for (mshape, axes, spec, shape), wins in zip(cases, want):
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        places = tsh.placements(spec, dict(zip(axes, mshape)))
        for coord in itertools.product(*(range(n) for n in mshape)):
            got = tsh.window(places, tuple(shape), tuple(mshape), coord)
            assert got == wins[json.dumps(list(coord))], (
                mshape, spec, shape, coord)


def test_placements_refuse_axes_out_of_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"data": 2, "model": 2}
    assert tsh.placements((("data", "model"), None), mesh) == (Shard(0),
                                                               Shard(0))
    assert tsh.placements((None, "model"), mesh) == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="order"):
        tsh.placements((("model", "data"),), mesh)
    with pytest.raises(ValueError, match="evenly"):
        tsh.window((Shard(0), Replicate()), (3,), (2, 2), (0, 0))


def test_context_reads_axis_sizes_and_plain_tensors_pass():
    """Outside a context every dim is divisible and shard_act is the
    identity; inside one, ctx_divisible reads the mesh's axis sizes and a
    plain tensor still passes through untouched."""
    x = torch.ones(4, 3)
    assert tsh.ctx_divisible("kv_heads", 1) and tsh.shard_act(x, ("batch",
                                                                 None)) is x
    with tsh.sharding_ctx({"data": 1, "model": 2}, tsh.DEFAULT_RULES):
        assert not tsh.ctx_divisible("kv_heads", 1)
        assert tsh.ctx_divisible("heads", 4) and tsh.ctx_divisible("embed", 3)
        assert tsh.shard_act(x, ("batch", None)) is x
        assert t_att._expand(1, 4) and not t_att._expand(2, 4)
    assert not t_att._expand(1, 4)
    assert not tsh.is_dtensor(x)


# ------------------------------------------------------- expand GQA branch

_EXPAND_SNIPPET = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ARCHS, reduce_for_smoke
from repro.distributed.sharding import DEFAULT_RULES, sharding_ctx
from repro.launch.mesh import compat_make_mesh
from repro.models import attention as att
from repro.models.layers import Policy
from repro.models.params import init_params
from repro.models.registry import get_api
B, S, P = {b}, {s}, {p}
cfg = dataclasses.replace(reduce_for_smoke(ARCHS["smollm-135m"]), n_kv_heads=1)
api = get_api(cfg)
params = init_params(api.param_defs(cfg, S), jax.random.PRNGKey(0))
toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
mesh = compat_make_mesh((2, 2), ("data", "model"))
J32 = Policy(compute=jnp.float32)
taken = []
fold = att._fold_gqa
def spy(q, n_kv):
    taken.append("fold")
    return fold(q, n_kv)
att._fold_gqa = spy
out = {{}}
with sharding_ctx(mesh, DEFAULT_RULES):
    pre = jax.jit(lambda p, t: api.prefill(cfg, p, t, {{}}, S, J32))
    dec = jax.jit(lambda p, c, t, pos: api.decode(cfg, p, c, t, pos, J32))
    logits, cache = pre(params, jnp.asarray(toks[:, :P]))
    out["prefill"] = np.asarray(logits)
    for t in range(P, S):
        logits, cache = dec(params, cache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.full((B,), t, jnp.int32))
        out[f"decode{{t}}"] = np.asarray(logits)
leaves = {{"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
          np.asarray(v) for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}}
np.savez(sys.argv[1], toks=toks, **out, **{{"param:" + k: v for k, v in leaves.items()}})
print(json.dumps({{"fold_calls": len(taken)}}))
"""


def _unflat(template, flat: dict, prefix=""):
    """A nested dict/list tree shaped like `template` from ``a/b/0``
    keyed arrays."""
    if isinstance(template, dict):
        return {k: _unflat(v, flat, f"{prefix}{k}/") for k, v in
                template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflat(v, flat, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return flat[prefix[:-1]]


def test_expand_branch_matches_reference_and_fold(tmp_path):
    """An MQA smoke config (kv 1, 4 q heads) under a mesh with model = 2:
    the reference's jitted prefill and decode take the expand branch (its
    fold helper is never called); the port's, under a context of the same
    axis sizes, take it too and agree with the reference's logits, and
    with the port's own fold branch under a mesh with model = 1."""
    b, s, p = 2, 24, 16
    path = tmp_path / "expand.npz"
    r = subprocess.run(
        [sys.executable, "-c", _EXPAND_SNIPPET.format(b=b, s=s, p=p),
         str(path)], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {"fold_calls": 0}
    ref = dict(np.load(path))
    cfg = dataclasses.replace(t_reduce_for_smoke(T_ARCHS["smollm-135m"]),
                              n_kv_heads=1)
    api = t_get_api(cfg)
    defs = api.param_defs(cfg, s)
    params = params_from_numpy(
        _unflat(defs, {k[len("param:"):]: v for k, v in ref.items()
                       if k.startswith("param:")}), "cpu")
    toks = torch.from_numpy(ref["toks"])

    def serve(ctx):
        out = {}
        with ctx:
            logits, cache = api.prefill(cfg, params, toks[:, :p], {}, s, T32)
            out["prefill"] = logits
            for t in range(p, s):
                logits, cache = api.decode(cfg, params, cache,
                                           toks[:, t:t + 1],
                                           torch.full((b,), t), T32)
                out[f"decode{t}"] = logits
        return out

    calls = []
    fold = t_att._fold_gqa

    def spy(q, n_kv):
        calls.append(q.shape)
        return fold(q, n_kv)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_att, "_fold_gqa", spy)
        expand = serve(tsh.sharding_ctx({"data": 2, "model": 2},
                                        tsh.DEFAULT_RULES))
        assert calls == []
        folded = serve(tsh.sharding_ctx({"data": 2, "model": 1},
                                        tsh.DEFAULT_RULES))
        assert len(calls) == cfg.n_layers * (1 + s - p)
    assert set(expand) == {k for k in ref if not k.startswith(("param:",
                                                                "toks"))}
    for k, want in expand.items():
        np.testing.assert_allclose(want.numpy(), ref[k], atol=LOGIT_ATOL)
        np.testing.assert_allclose(want.numpy(), folded[k].numpy(), atol=ATOL)
