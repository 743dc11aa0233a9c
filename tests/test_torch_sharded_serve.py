"""The port's sharded forward in a 4-rank ``gloo`` world at mesh (2, 2)
(data 2 × model 2): its ``ServeEngine`` against the JAX package's
``ServeEngine`` on a (2, 2) mesh of forced CPU devices, on the same numpy
weights under ``DEFAULT_POLICY``, for the dense, hybrid and MoE families;
and its own fp32 forward on DTensors against its one-device forward in
both GQA branches under the baseline rules (FSDP:
tests/test_torch_sharded_fsdp.py; the other variants:
tests/test_torch_sharded_variants.py).

The JAX side runs in a subprocess with 8 forced host devices, beside the
world.  The port draws the weights (from a CPU ``torch.Generator`` seed),
the JAX side reads them, so both run at once.  Under ``DEFAULT_POLICY``
both engines compute in bf16 and round at other points, each carrying a
bf16 error against the fp32 forward of about the reference's own (its
bf16 prefill logits against its fp32 forward: 0.091, 0.144 and 0.121 for
dense, hybrid and MoE on these prompts; the port's sharded engine's
0.090, 0.138 and 0.141), and a row-parallel product is rounded to bf16
on each rank before the partial sums are added.  So prefill logits are
held within twice the reference's own bf16 error (one-device engines:
within once, tests/test_torch_serve.py), and greedy tokens agree up to
near ties of twice that error.  The fp32 parity checks are those of
tests/test_torch_sharded_forward.py at (2, 2)."""
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
from repro_torch.models.layers import Policy as TPolicy
from repro_torch.models.params import init_params
from repro_torch.models.registry import get_api as t_get_api
from test_torch_sharded_forward import (ENV, ROOT, WORLD_COMMON,
                                        WORLD_TIMEOUT_S, assert_parity)

B, P, N_NEW, MAX_SEQ = 4, 16, 6, 32
FAMILIES = {"dense": "smollm-135m", "hybrid": "recurrentgemma-9b",
            "moe": "qwen2-moe-a2.7b"}
CASES = {   # name: (arch, kv heads (0: the config's), backend, variant)
    "fold": ("smollm-135m", 2, "chunked", "baseline"),
    "expand": ("smollm-135m", 1, "chunked", "baseline"),
}

# each rank: the fp32 parity cases, then the engines under DEFAULT_POLICY
# on the shared weights: the prefill's logits (a request of 0 new tokens)
# and a request's greedy tokens
_WORLD = WORLD_COMMON + r'''
from repro_torch.distributed.sharding import DEFAULT_RULES
from repro_torch.models.params import params_from_numpy
out["parity"] = {name: parity(*case) for name, case in args["cases"].items()}
want = dict(np.load(args["weights"]))
def unflat(template, prefix):
    if isinstance(template, dict):
        return {k: unflat(v, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(unflat(v, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return want[prefix[:-1]]
prompts = np.asarray(args["prompts"])
out["engines"] = {}
for fam, arch in args["families"].items():
    cfg = smoke(arch)
    params = params_from_numpy(unflat(get_api(cfg).param_defs(
        cfg, args["max_seq"]), fam + "/"), "cpu")
    eng = ServeEngine(cfg, params, max_seq=args["max_seq"], mesh=mesh,
                      rules=DEFAULT_RULES)
    eng.generate(prompts, 0)
    logits = eng.last_logits(prompts.shape[0]).float()
    res = eng.generate(prompts, args["n_new"])
    out["engines"][fam] = {"logits": logits.tolist(),
                           "tokens": res.tokens.tolist(),
                           "windows": at_windows(eng.params)[0]
                           and at_windows(eng.cache)[0],
                           "split": at_windows(eng.params)[1]
                           + at_windows(eng.cache)[1]}
print(json.dumps(out))
'''

# the reference's engine on a (2, 2) mesh of forced CPU devices, its params
# laid out by its rules; its bf16 prefill logits, its fp32 forward's last
# logits, and a request's greedy tokens
_JAX_SIDE = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint.serialization import _leaf_paths
from repro.configs import ARCHS, reduce_for_smoke
from repro.distributed.sharding import DEFAULT_RULES, param_shardings
from repro.launch.mesh import compat_make_mesh
from repro.models.layers import Policy
from repro.models.params import is_pm
from repro.models.registry import get_api
from repro.serve.engine import ServeEngine
args = json.loads(sys.argv[1])
want = dict(np.load(args["weights"]))
mesh = compat_make_mesh((2, 2), ("data", "model"))
prompts = jnp.asarray(np.asarray(args["prompts"], np.int32))
out = {}
for fam, arch in args["families"].items():
    cfg = reduce_for_smoke(ARCHS[arch])
    api = get_api(cfg)
    defs = api.param_defs(cfg, args["max_seq"])
    _, treedef = jax.tree_util.tree_flatten(defs, is_leaf=is_pm)
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(want[f"{fam}/{k}"]) for k, _ in _leaf_paths(defs)])
    laid = jax.device_put(params, param_shardings(defs, mesh, DEFAULT_RULES))
    eng = ServeEngine(cfg, laid, mesh, DEFAULT_RULES, max_seq=args["max_seq"])
    logits, _ = eng._prefill(eng.params, prompts, {})
    full, _ = api.forward(cfg, params, {"tokens": prompts},
                          Policy(compute=jnp.float32))
    res = eng.generate(np.asarray(prompts), args["n_new"])
    out[fam] = {"logits": np.asarray(logits.astype(jnp.float32)).tolist(),
                "fp32_last": np.asarray(full[:, -1]).tolist(),
                "tokens": np.asarray(res.tokens).tolist(),
                "devices": len(eng.params["final"]["scale"].sharding.device_set)}
print(json.dumps(out))
'''


def _weights(path):
    """The port's draws for each family (the hybrid's local attention
    tamed, as in tests/test_torch_models.py), saved by leaf path."""
    flat, trees = {}, {}
    for fam, arch in FAMILIES.items():
        cfg = t_reduce_for_smoke(T_ARCHS[arch])
        p = init_params(t_get_api(cfg).param_defs(cfg, MAX_SEQ),
                        torch.Generator().manual_seed(0), "cpu")
        if cfg.family == "hybrid":
            a = p["units"]["b2"]["attn"]
            a["wq"].mul_(0.25), a["wk"].mul_(0.25)
        trees[fam] = (cfg, p)
        flat.update({f"{fam}/{k}": v.numpy()
                     for k, v in tser._leaf_paths(p)})
    np.savez(path, **flat)
    return trees


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded-serve")
    trees = _weights(d / "weights.npz")
    prompts = np.random.default_rng(1).integers(
        0, 256, (B, P)).tolist()                    # every smoke vocab: 256
    common = {"weights": str(d / "weights.npz"), "families": FAMILIES,
              "prompts": prompts, "max_seq": MAX_SEQ, "n_new": N_NEW}
    jax_side = subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE, json.dumps(common)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV,
        cwd=ROOT)
    try:
        outs = tmesh.run_world(
            4, f"import sys; sys.argv[1:] = "
            f"[{json.dumps({**common, 'mesh': [2, 2], 'cases': CASES})!r}]\n"
            + _WORLD, timeout_s=WORLD_TIMEOUT_S, env=ENV, cwd=ROOT)
        stdout, stderr = jax_side.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        if jax_side.poll() is None:
            jax_side.kill()
            jax_side.wait()
    assert jax_side.returncode == 0, stderr[-3000:]
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [r["coord"] for r in reports] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    return dict(reports=reports, jax=json.loads(stdout.strip().splitlines()[-1]),
                trees=trees, prompts=np.asarray(prompts))


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_forward_matches_one_device_at_2x2(both, case):
    """Prefill logits, 4 decode steps and the whole-sequence forward on
    DTensors at (2, 2) equal the one-device path on every rank
    (``assert_parity``): the batch split over data, the heads over model
    (``fold``: the kv heads too; ``expand``: MQA's one kv head repeated
    to the query heads, then split)."""
    for rep in both["reports"]:
        assert_parity(rep["parity"][case])


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_engine_matches_the_jax_engine_on_2x2(both, fam):
    """The port's engine in the 4-rank world and the reference's on four
    forced CPU devices, both on (2, 2) meshes under DEFAULT_RULES and
    DEFAULT_POLICY, on the same weights and prompts: every rank's bf16
    prefill logits within twice the reference's own bf16 error (its bf16
    logits against its fp32 forward) of the reference's, and every rank's
    greedy tokens equal to the reference's up to near ties of twice that
    error (fp32 teacher-forced logits of the port's one-device
    forward)."""
    j = both["jax"][fam]
    assert j["devices"] == 4
    j_bf16 = np.asarray(j["logits"])
    bf16_err = float(np.abs(j_bf16 - np.asarray(j["fp32_last"])).max())
    assert 0 < bf16_err < 0.5
    cfg, params = both["trees"][fam]
    prompts = both["prompts"]
    for rep in both["reports"]:
        got = rep["engines"][fam]
        assert got["windows"] and got["split"] > 0
        diff = float(np.abs(np.asarray(got["logits"]) - j_bf16).max())
        assert diff <= 2 * bf16_err, (diff, bf16_err)
        tokens, want = np.asarray(got["tokens"]), np.asarray(j["tokens"])
        assert tokens.shape == want.shape == (B, N_NEW)
        seq = torch.from_numpy(np.concatenate([prompts, tokens], axis=1))
        with torch.no_grad():
            f32 = t_get_api(cfg).forward(cfg, params, {"tokens": seq},
                                         TPolicy(compute=torch.float32))[0]
        for r in range(B):
            for t in range(N_NEW):
                if tokens[r, t] != want[r, t]:
                    row = f32[r, P + t - 1]
                    gap = abs(float(row[tokens[r, t]] - row[want[r, t]]))
                    assert gap < 2 * bf16_err, (r, t, gap, bf16_err)
                    break
