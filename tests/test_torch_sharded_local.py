"""The sharded forward and train step on the paths that the production
meshes take, in CPU ``gloo`` worlds at (2, 2) (batch split over data,
heads, groups and channels over model), against the one-device path at
the tolerances of tests/test_torch_sharded_forward.py and
tests/test_torch_sharded_train.py.

* xLSTM whose model axis does not divide its heads: one head over
  model = 2, as xlstm-1.3b's 4 heads over the production 16.  DTensor
  cannot unflatten a channel dim split over more ranks than divide the
  heads; the channels are gathered first (``sharding.fit_split``), and the
  merged heads' gradients likewise (``sharding.fit_grad``).
* Attention on each rank's own batch rows and heads, and the routed
  experts on each rank's own tokens (two MoE groups of 256 over
  model = 2), through ``sharding.local_map``: the paths the dry-run's fake
  tensors take where the batch and the heads (or groups) are both split,
  forced here on real tensors (``is_fake`` patched): the prefill, the
  decode steps and one train step, the routed weights whole with their
  gradients summed over the ranks that split the tokens.  The dense
  forward's collectives are DTensor's own plan's, one for one; the MoE
  forward's differ inside the routed experts, as its config implies."""
import json

import numpy as np
import pytest

from test_torch_sharded_forward import (ENV, ROOT, WORLD_COMMON,
                                        WORLD_TIMEOUT_S, assert_parity)
from test_torch_sharded_train import _WORLD as _TRAIN_WORLD
from test_torch_sharded_train import _tol

from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce_for_smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.models.moe import GROUP_SIZE, _group_capacity

MESH = (2, 2)
HEADS = {"xlstm-1.3b": 1}      # a head count model = 2 does not divide

# the rank programs' common tail: the smoke configs with HEADS, and a
# switch between DTensor's plan and the local paths
_FORCE = r'''
from repro_torch.distributed import sharding as _sh
_is_fake = _sh.is_fake
_smoke_cfg = smoke
def smoke(arch, *a):
    cfg = _smoke_cfg(arch, *a)
    heads = args["heads"].get(arch)
    return dataclasses.replace(cfg, n_heads=heads) if heads else cfg
def forced(local):
    _sh.is_fake = (lambda x: True) if local else _is_fake
'''

PARITY = {   # name: ((arch, kv heads, backend, variant[, batch, prompt]),
             #        local paths forced)
    "xlstm-one-head": (("xlstm-1.3b", 0, "chunked", "baseline", 2, 8),
                       False),
    "fold-local": (("smollm-135m", 2, "chunked", "baseline"), True),
    "expand-local": (("smollm-135m", 1, "chunked", "baseline"), True),
    "moe-local": (("qwen2-moe-a2.7b", 0, "chunked", "baseline", 4, 512),
                  True),
}

TRAIN = {   # name: (arch, variant, options)
    "xlstm-one-head": ("xlstm-1.3b", "baseline", {}),
    "smollm-local": ("smollm-135m", "baseline", {"local": True}),
    "qwen2-moe-local": ("qwen2-moe-a2.7b", "baseline",
                        {"local": True, "s": 512}),
    "deepseek-local-fsdp": ("deepseek-v2-lite-16b", "fsdp",
                            {"local": True, "s": 512}),
}


def _run(code: str, args: dict) -> list:
    n = int(np.prod(MESH))
    outs = tmesh.run_world(
        n, f"import sys; sys.argv[1:] = [{json.dumps(json.dumps(args))}]\n"
        + code, timeout_s=WORLD_TIMEOUT_S, env=ENV, cwd=ROOT)
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [r["coord"] for r in reports] == [
        [i, j] for i in range(MESH[0]) for j in range(MESH[1])]
    return reports


@pytest.fixture(scope="module")
def parity_reports():
    code = WORLD_COMMON + _FORCE + r'''
out["parity"] = {}
for name, (case, local) in args["cases"].items():
    forced(local)
    out["parity"][name] = parity(*case)
print(json.dumps(out))
'''
    return _run(code, {"mesh": list(MESH), "cases": PARITY, "heads": HEADS})


@pytest.fixture(scope="module")
def train_reports():
    defs = _TRAIN_WORLD[:_TRAIN_WORLD.index("T0 = time.perf_counter()")]
    code = defs + _FORCE + r'''
for name, (arch, variant, opt) in args["cases"].items():
    forced(opt.get("local", False))
    out["cases"][name] = case(arch, variant, opt)
# the forward's collectives, DTensor's plan and the local paths: the
# attention on local heads, the routed experts on local tokens
from repro_torch.distributed.sharding import sharding_ctx
from repro_torch.models.registry import get_api
class Moved(Collectives):
    """[op, its input's shape, its input's bytes]"""
    def __torch_dispatch__(self, func, types, a=(), kw=None):
        n = len(self.ops)
        res = super().__torch_dispatch__(func, types, a, kw)
        if len(self.ops) > n:
            t = a[0][0] if isinstance(a[0], (list, tuple)) else a[0]
            self.ops[-1].append(t.numel() * t.element_size())
        return res
out["collectives"] = {}
for arch, s in args["forward"].items():
    cfg = smoke(arch)
    state, batch = state_for(cfg, s), batch_for(cfg, args["b"], s)
    _, shardings = tstep.make_train_step(cfg, mesh, make_variant("baseline"),
                                         policy=P32, max_seq=s)
    params = lay_out_state(state, shardings)["params"]
    out["collectives"][arch] = {}
    for local in (False, True):
        forced(local)
        with torch.no_grad(), sharding_ctx(mesh, make_variant("baseline")), \
                Moved() as comm:
            get_api(cfg).forward(cfg, params, batch, P32, False)
        out["collectives"][arch][str(local)] = comm.ops
forced(False)
print(json.dumps(out))
'''
    return _run(code, {"mesh": list(MESH), "cases": TRAIN, "heads": HEADS,
                       "s": 16, "b": 4, "lr": 1e-3, "eps": 1e-3,
                       "forward": {"smollm-135m": 16,
                                   "qwen2-moe-a2.7b": 512}})


@pytest.mark.parametrize("name", sorted(PARITY))
def test_forward_on_the_production_paths_matches_one_device(parity_reports,
                                                            name):
    """Prefill logits, 4 decode steps and the whole-sequence forward at
    (2, 2) within fp32 1e-5 of the one-device path, or twice the stack's
    own noise floor where that is higher, every leaf at its window."""
    for rep in parity_reports:
        assert_parity(rep["parity"][name])


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_train_step_on_the_production_paths_matches_one_device(
        train_reports, name):
    """One pure step at (2, 2) against the one-device step: loss and grad
    norm at 1e-5 relative, every gradient and new leaf at 1e-5 of its
    largest element or twice its noise floor, the gradients in their
    params' placements, the new state laid out by its shardings."""
    for rep in train_reports:
        got = rep["cases"][name]
        for key in ("loss", "grad_norm"):
            g, w, n = got[key]
            assert abs(g - w) <= max(1e-5, 2 * abs(n - w) / abs(w)) * abs(w), (
                key, got[key])
        assert got["exact"] and got["plain_metrics"]
        assert got["laid_as_params"] and got["state_layouts"]
        assert set(got["diffs"]) >= {"params", "m", "v", "grads"}
        for kind, diff in got["diffs"].items():
            assert diff <= _tol(kind, got["noise"], False), (kind, got)


def test_local_heads_forward_moves_what_dtensors_plan_moves(train_reports):
    """The forward with the attention on each rank's own heads issues the
    collectives DTensor's plan issues, kind, shape and bytes, in order
    (the vocab-parallel lookup's and each block's two row-parallel
    products' all-reduces): the dry-run's fake tensors take that path.
    (The backwards differ: ROADMAP Queue 3.)"""
    for rep in train_reports:
        got = rep["collectives"]["smollm-135m"]
        plan, mine = got["False"], got["True"]
        assert mine == plan and [op for op, *_ in plan] == ["all_reduce"] * 5


def _moe_forward_collectives(local: bool) -> list:
    """The qwen2-moe smoke forward's collectives at (2, 2), B = 4, S = 512
    in fp32, derived from its config: the lookup's all-reduce, then each
    block's attention all-reduce and its routed experts' collectives.
    DTensor's plan gathers the expert outputs (B/2, n, E/2, C, D), split
    over the model axis by experts, and the block's output (B/2, S/2, D).
    The local plan gathers the router and the three expert weights, whole
    on each rank beside its own tokens, then the block's output, and
    all-reduces the shared experts' output (B/2, S, D)."""
    cfg = t_reduce_for_smoke(T_ARCHS["qwen2-moe-a2.7b"])
    e, d, b, s = cfg.moe, cfg.d_model, 4 // MESH[0], 512
    n, c, ex = s // GROUP_SIZE, _group_capacity(GROUP_SIZE, e), e.n_routed // 2

    def op(kind, *shape):
        return [kind, list(shape), 4 * int(np.prod(shape))]
    ag = "all_gather_into_tensor"
    block = [op("all_reduce", b, s, d)]
    if local:
        block += [op(ag, d, ex), op(ag, ex, d, e.d_expert),
                  op(ag, ex, d, e.d_expert), op(ag, ex, e.d_expert, d),
                  op(ag, b, s // 2, d), op("all_reduce", b, s, d)]
    else:
        block += [op(ag, b, n, ex, c, d), op(ag, b, s // 2, d)]
    return [op("all_reduce", b, s, d)] + block * cfg.n_layers


def test_local_tokens_forward_moves_the_split_expert_weights(train_reports):
    """The MoE forward (8 experts, two groups of 256 over model = 2) with
    the attention on each rank's own heads and the routed experts on each
    rank's own tokens matches DTensor's plan outside the routed experts,
    and within them moves the expert weights where DTensor's plan moves
    the expert outputs: kind, shape and bytes, in order, each plan as its
    config implies.  The dry-run's cells whose record lists ``moe`` among
    its ``local_paths`` count the former (ROADMAP Queue 3)."""
    for rep in train_reports:
        got = rep["collectives"]["qwen2-moe-a2.7b"]
        assert got["False"] == _moe_forward_collectives(False)
        assert got["True"] == _moe_forward_collectives(True)
