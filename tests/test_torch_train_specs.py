"""The port's abstract training inputs and their layouts against the
reference's, without a world: ``batch_specs`` and ``batch_logical_axes``
(``models/registry.py``), ``abstract_train_state`` and
``state_shardings`` (``train/state.py``) and ``dryrun_spec``
(``train/step.py``), for the ten full configs.  The reference's side runs
on ``AbstractMesh`` and ``jax.eval_shape``, which need no devices; the
port's on ``meta`` tensors and a mesh given by its axis sizes.  Specs,
shapes and dtypes are compared exactly."""

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.checkpoint.serialization import _leaf_paths as j_leaf_paths
from repro.configs import ARCHS, SHAPES
from repro.distributed import sharding as jsh
from repro.models import registry as jreg
from repro.train import state as jstate
from repro.train import step as jstep
from repro_torch.checkpoint.serialization import _leaf_paths
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import reduce_for_smoke as t_reduce_for_smoke
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.layers import Policy as TPolicy
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.registry import get_api as t_get_api
from repro_torch.models import registry as treg
from repro_torch.train import state as tstate
from repro_torch.train import step as tstep

KINDS = ("train_4k", "prefill_32k", "decode_32k")
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _struct(tree, paths) -> dict:
    """{leaf path: (shape, dtype name)}."""
    return {k: (tuple(v.shape), _dtype(v)) for k, v in paths(tree)}


@pytest.mark.parametrize("shape", KINDS)
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_batch_specs_match_reference(name, shape):
    """The data inputs of a train, prefill and decode step: the same keys,
    shapes and dtypes (the audio frames and the VLM embeddings bf16), as
    ``meta`` tensors, and the same logical axes."""
    jc, tc = ARCHS[name], T_ARCHS[name]
    want = jreg.batch_specs(jc, SHAPES[shape])
    got = treg.batch_specs(tc, T_SHAPES[shape])
    assert list(got) == list(want)
    assert all(v.device.type == "meta" for v in got.values())
    assert {k: (tuple(v.shape), _dtype(v)) for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert treg.batch_logical_axes(tc, T_SHAPES[shape]) == \
        jreg.batch_logical_axes(jc, SHAPES[shape])


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_abstract_train_state_matches_reference(name, master):
    """``abstract_train_state`` leaf for leaf against ``jax.eval_shape``
    of the reference's ``make_train_state`` (params, m, v, the master
    under master_fp32, the int32 counters, the uint32[2] rng key): the
    same paths, shapes and dtypes, every leaf on the ``meta`` device."""
    seq = 4096
    want = jax.eval_shape(lambda: jstate.make_train_state(
        ARCHS[name], jax.random.PRNGKey(0), seq, master_fp32=master))
    got = tstate.abstract_train_state(T_ARCHS[name], seq, master_fp32=master)
    assert all(v.device.type == "meta" for _, v in _leaf_paths(got))
    assert list(_struct(got, _leaf_paths)) == list(
        _struct(want, j_leaf_paths))
    assert _struct(got, _leaf_paths) == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in j_leaf_paths(want)}


def _specs(tree, paths) -> dict:
    return {k: tuple(v.spec) for k, v in paths(tree)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_state_shardings_match_reference(name, mesh):
    """Every leaf of the full config's TrainState layouts on a production
    mesh shape, under the default rules and FSDP, with and without the
    master: the port's spec is the reference's (the counters and the rng
    key replicated, ``P()``), and its placements shard each mesh dim the
    spec names."""
    shape, axes = MESHES[mesh]
    jm, tm = AbstractMesh(shape, axes), dict(zip(axes, shape))
    for variant in ("baseline", "fsdp"):
        for master in (False, True):
            want = _specs(jstate.state_shardings(
                ARCHS[name], 4096, jm, jsh.make_variant(variant),
                master_fp32=master), j_leaf_paths)
            lays = tstate.state_shardings(T_ARCHS[name], 4096, tm,
                                          tsh.make_variant(variant),
                                          master_fp32=master)
            assert _specs(lays, _leaf_paths) == want
            assert list(_specs(lays, _leaf_paths)) == list(want)
            for _, lay in _leaf_paths(lays):
                for i, axis in enumerate(axes):
                    named = [d for d, e in enumerate(lay.spec)
                             if axis in tsh._axes(e)]
                    p = lay.placements[i]
                    assert (p.is_shard(named[0]) if named
                            else p.is_replicate()), (lay, axis)


@pytest.mark.parametrize("kind", KINDS + ("long_500k",))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_dryrun_spec_matches_reference(name, kind):
    """``dryrun_spec`` on the (16, 16) production mesh under FSDP: the same
    abstract arguments (paths, shapes, dtypes: the state for a train step,
    bf16 params and the batch for a prefill, the cache, token and position
    for a decode) and the same layouts, leaf for leaf; the default
    microbatching; and a callable step."""
    jm, tm = AbstractMesh((16, 16), ("data", "model")), {"data": 16,
                                                         "model": 16}
    jr, tr = jsh.make_variant("fsdp"), tsh.make_variant("fsdp")
    jfn, jargs, jshard, jout = jstep.dryrun_spec(ARCHS[name], SHAPES[kind],
                                                 jm, jr)
    tfn, targs, tshard, tout = tstep.dryrun_spec(T_ARCHS[name],
                                                 T_SHAPES[kind], tm, tr)
    assert tout is jout is None and callable(tfn)
    assert len(targs) == len(jargs) and len(tshard) == len(jshard)
    assert all(v.device.type == "meta" for _, v in _leaf_paths(targs))
    assert _struct(targs, _leaf_paths) == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in j_leaf_paths(jargs)}
    assert _specs(tshard, _leaf_paths) == _specs(jshard, j_leaf_paths)
    assert tstep.default_accum(T_ARCHS[name], T_SHAPES[kind]) == \
        jstep.default_accum(ARCHS[name], SHAPES[kind])


@pytest.mark.parametrize("name", ["smollm-135m", "whisper-tiny"])
def test_remat_recompute_runs_in_the_forwards_sharding_context(name):
    """On a 1-rank CPU mesh, the forward on DTensor params with remat
    under ``sharding_ctx``, its backward taken after the context has
    closed, as CUDA's autograd runs it in its own thread, which does not
    see the context: the recompute runs in the forward's context
    (``sharding.in_this_ctx``) and gives the gradients of the same
    forward on plain tensors, bit for bit (one rank: every placement
    ``Replicate``)."""
    cfg = t_reduce_for_smoke(T_ARCHS[name])
    api, mesh, s = t_get_api(cfg), make_local_mesh(device="cpu"), 16
    params = tstate.make_train_state(cfg, torch.Generator().manual_seed(0),
                                     s, device="cpu")["params"]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, s),
                                     generator=torch.Generator()
                                     .manual_seed(1))}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, cfg.encoder.n_frames, cfg.d_model),
                                      generator=torch.Generator()
                                      .manual_seed(2))
    rules = tsh.make_variant("baseline")
    layouts = tsh.param_shardings(api.param_defs(cfg, s), mesh, rules)
    p32 = TPolicy(compute=torch.float32)

    def grads(tree, ctx_mesh):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(tree)]
        it = iter(leaves)
        p = tree_map(lambda _: next(it), tree)
        with tsh.sharding_ctx(ctx_mesh, rules):
            logits = api.forward(cfg, p, batch, p32, True)[0]
            loss = (logits.to_local() if tsh.is_dtensor(logits)
                    else logits).float().square().mean()
        return [g.to_local() if tsh.is_dtensor(g) else g
                for g in torch.autograd.grad(loss, leaves)]

    laid = tree_map(lambda _: None, params)
    it = iter(tsh.lay_out(t, lay) for t, lay in zip(tree_leaves(params),
                                                    tree_leaves(layouts)))
    laid = tree_map(lambda _: next(it), laid)
    want = grads(params, None)
    got = grads(laid, mesh)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
