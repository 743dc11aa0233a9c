"""The port's MoE family against the JAX package, on the CPU: the
capacity-dispatch MoE FFN (qwen2-moe with its sigmoid-gated shared
expert, deepseek-v2-lite with two shared experts), MLA (expanded
prefill, absorbed decode over the compressed cache), and both stacks
end to end.

Inputs come from numpy with a fixed seed and both sides get the same
arrays; weights are JAX-initialised and carried into the port by
``params_from_numpy``.  Everything runs in fp32.  Routing is discontinuous
(a top-k choice), so each MoE comparison first holds the routing equal
(expert sets and ``keep`` masks, exactly) and states the smallest gap
between the k-th and (k+1)-th router prob of its inputs: far above fp32
noise, so no near tie can flip a choice between the two packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduce_for_smoke
from repro.models import attention as j_att
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models.params import init_params as j_init_params
from repro.models.registry import get_api as j_get_api
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce_for_smoke
from repro_torch.models import attention as t_att
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models.params import params_from_numpy
from repro_torch.models.registry import get_api as t_get_api

from test_torch_models import LOGIT_ATOL, _close, _f32, _leaf_paths

J32 = j_layers.Policy(compute=jnp.float32)
T32 = t_layers.Policy(compute=torch.float32)
QWEN, DEEPSEEK = "qwen2-moe-a2.7b", "deepseek-v2-lite-16b"
MOE = [QWEN, DEEPSEEK]
# the smallest k-th vs (k+1)-th router prob gap the inputs may have: fp32
# routers of the two packages agree to ~1e-8 on these probs
MIN_MARGIN = 1e-6


def _cfgs(name, **moe_changes):
    jc = reduce_for_smoke(ARCHS[name])
    tc = t_reduce_for_smoke(T_ARCHS[name])
    if moe_changes:
        jc, tc = (dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, **moe_changes)) for c in (jc, tc))
    return jc, tc


def _close_scaled(t, j, tol):
    """Within ``tol`` of the reference's largest element where that
    exceeds 1: the smoke MLA's outputs reach |y| ~ 10 (the reference's
    fan_in is the head count, 4, for wq), where fp32 in another summation
    order agrees to ~1e-6 relative."""
    j = np.asarray(j, np.float32)
    _close(t, j, tol * max(1.0, float(np.abs(j).max())))


def _j_route(cfg, p, x):
    """The reference's routing, line for line (repro/models/moe.py:52-70)."""
    e = cfg.moe
    b, s, d = x.shape
    gs = min(j_moe.GROUP_SIZE, s)
    xg = x.reshape(b, s // gs, gs, d)
    cap = j_moe._group_capacity(gs, e)
    probs = jax.nn.softmax((xg @ p["router"]).astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, e.top_k)
    mask = jnp.sum(jax.nn.one_hot(idx, e.n_routed), axis=3)
    pos = jnp.cumsum(mask, axis=2) - 1.0
    return np.asarray(probs), np.asarray(idx), np.asarray(mask * (pos < cap))


def _margin(probs, k):
    top = -np.sort(-probs, axis=-1)
    return float((top[..., k - 1] - top[..., k]).min())


def _moe_case(name, b, s, seed, **moe_changes):
    jc, tc = _cfgs(name, **moe_changes)
    jp = j_init_params(j_moe.moe_defs(jc), jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = _f32((b, s, jc.d_model), seed + 10)
    return jc, tc, jp, tp, x


# (name, B, S, moe changes): one group; two groups (S = 512); a capacity
# factor of 0.5, where capacity drops tokens
MOE_CASES = [(QWEN, 2, 64, {}), (DEEPSEEK, 2, 64, {}),
             (QWEN, 1, 512, {}), (DEEPSEEK, 2, 512, {}),
             (QWEN, 2, 64, {"capacity_factor": 0.5}),
             (DEEPSEEK, 2, 256, {"capacity_factor": 0.5})]


@pytest.mark.parametrize("name,b,s,changes", MOE_CASES,
                         ids=lambda v: str(v) if not isinstance(v, dict)
                         else "_".join(f"{k}{x}" for k, x in v.items()) or "-")
def test_apply_moe_matches_jax(name, b, s, changes):
    """Routing first (expert sets and keep masks exactly equal), then y at
    1e-5 and the Switch aux loss at 1e-6."""
    jc, tc, jp, tp, x = _moe_case(name, b, s, 3, **changes)
    j_probs, j_idx, j_keep = _j_route(jc, jp, jnp.asarray(x))
    assert _margin(j_probs, jc.moe.top_k) > MIN_MARGIN
    gs = min(t_moe.GROUP_SIZE, s)
    r = t_moe.route(tc, tp, torch.from_numpy(x).reshape(b, s // gs, gs, -1),
                    T32)
    assert r["expert_idx"].shape == j_idx.shape
    assert np.array_equal(np.sort(r["expert_idx"].numpy(), axis=-1),
                          np.sort(j_idx, axis=-1))
    assert np.array_equal(r["keep"].numpy(), j_keep)
    if "capacity_factor" in changes:
        assert int((r["mask"] - r["keep"]).sum()) > 0       # tokens dropped
    jy, jaux = j_moe.apply_moe(jc, jp, jnp.asarray(x), J32)
    ty, taux = t_moe.apply_moe(tc, tp, torch.from_numpy(x), T32)
    _close(ty, jy, 1e-5)
    assert taux.dtype == torch.float32
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)


def test_moe_defs_and_capacity_match_jax():
    for name in MOE:
        jc, tc = _cfgs(name)
        jd, td = j_moe.moe_defs(jc), t_moe.moe_defs(tc)
        assert jax.tree.map(lambda p: (p.shape, p.scale), jd,
                            is_leaf=lambda p: hasattr(p, "shape")) == \
            jax.tree.map(lambda p: (p.shape, p.scale), td,
                         is_leaf=lambda p: hasattr(p, "shape"))
        for gs in (1, 16, 256):
            assert t_moe._group_capacity(gs, tc.moe) == \
                j_moe._group_capacity(gs, jc.moe)
    assert "shared_gate" in t_moe.moe_defs(_cfgs(QWEN)[1])
    assert "shared_gate" not in t_moe.moe_defs(_cfgs(DEEPSEEK)[1])


def test_apply_moe_refuses_a_length_the_groups_do_not_divide():
    """The reference's contract (repro/models/moe.py:56): S <= 256 or a
    multiple of it."""
    _, tc, _, tp, x = _moe_case(QWEN, 1, 300, 0)
    with pytest.raises(AssertionError):
        t_moe.apply_moe(tc, tp, torch.from_numpy(x), T32)


def test_apply_moe_decode_step_keeps_every_chosen_expert():
    """At S = 1 the capacity is 1 and nothing is dropped: the decode step
    computes what the forward's position would, had it no competition."""
    jc, tc, jp, tp, x = _moe_case(DEEPSEEK, 3, 1, 4)
    r = t_moe.route(tc, tp, torch.from_numpy(x).reshape(3, 1, 1, -1), T32)
    assert r["cap"] == 1 and torch.equal(r["keep"], r["mask"])
    jy, _ = j_moe.apply_moe(jc, jp, jnp.asarray(x), J32)
    ty, _ = t_moe.apply_moe(tc, tp, torch.from_numpy(x), T32)
    _close(ty, jy, 1e-5)


# ------------------------------------------------------------------- MLA

def _mla_setup(seed=0):
    jc, tc = _cfgs(DEEPSEEK)
    jp = j_init_params(j_att.mla_defs(jc), jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_mla_forward_matches_jax():
    jc, tc, jp, tp = _mla_setup()
    x = _f32((2, 24, jc.d_model), 1)
    pos = np.arange(24)
    jy = j_att.mla_forward(jc, jp, jnp.asarray(x), jnp.asarray(pos), policy=J32)
    ty = t_att.mla_forward(tc, tp, torch.from_numpy(x), torch.from_numpy(pos),
                           policy=T32)
    _close_scaled(ty, jy, 1e-5)


@pytest.mark.parametrize("into", [False, True])
def test_mla_prefill_and_absorbed_decode_match_jax(into):
    """Prefill 12 tokens (into the engine's buffers, written zeros
    included, or into a fresh cache), then 8 absorbed decode steps that
    update the compressed cache in place; every output, and the
    c_kv/k_rope cache, at 1e-5 of its scale."""
    jc, tc, jp, tp = _mla_setup(1)
    B, P, S = 2, 12, 20
    x = _f32((B, S, jc.d_model), 2)
    pos = np.arange(P)
    jy, jcache = j_att.mla_prefill(jc, jp, jnp.asarray(x[:, :P]),
                                   jnp.asarray(pos), S, policy=J32)
    bufs = None
    if into:
        defs = t_att.mla_cache_defs(tc, B, S, torch.float32)
        bufs = {k: torch.full(d.shape, 7.0) for k, d in defs.items()}
    ty, tcache = t_att.mla_prefill(tc, tp, torch.from_numpy(x[:, :P]),
                                   torch.from_numpy(pos), S, policy=T32,
                                   into=bufs)
    if into:
        assert all(tcache[k] is bufs[k] for k in bufs)
    _close_scaled(ty, jy, 1e-5)
    for key in ("c_kv", "k_rope"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close_scaled(tcache[key], jcache[key], 1e-5)
    for t in range(P, S):
        jy, jcache = j_att.mla_decode(jc, jp, jnp.asarray(x[:, t:t + 1]),
                                      jcache, jnp.full((B,), t, jnp.int32),
                                      policy=J32)
        before = tcache["c_kv"]
        ty, tcache = t_att.mla_decode(tc, tp, torch.from_numpy(x[:, t:t + 1]),
                                      tcache, torch.full((B,), t), policy=T32)
        assert tcache["c_kv"] is before                     # in place
        _close_scaled(ty, jy, 1e-5)
    for key in ("c_kv", "k_rope"):
        _close_scaled(tcache[key], jcache[key], 1e-5)


def test_mla_absorbed_decode_equals_expanded_forward():
    """The absorbed decode at position S-1, after a prefill over S-1
    tokens, equals the expanded forward's last row: the same attention,
    the up-projections taken before or after the scores."""
    jc, tc, jp, tp = _mla_setup(2)
    B, S = 2, 17
    x = torch.from_numpy(_f32((B, S, tc.d_model), 3))
    full = t_att.mla_forward(tc, tp, x, torch.arange(S), policy=T32)
    _, cache = t_att.mla_prefill(tc, tp, x[:, :S - 1], torch.arange(S - 1), S,
                                 policy=T32)
    y, _ = t_att.mla_decode(tc, tp, x[:, S - 1:], cache,
                            torch.full((B,), S - 1), policy=T32)
    _close_scaled(y[:, 0], full[:, -1].numpy(), 1e-5)


def test_mla_cache_defs_match_jax():
    jc, tc = _cfgs(DEEPSEEK)
    jd = j_att.mla_cache_defs(jc, 3, 40)
    td = t_att.mla_cache_defs(tc, 3, 40)
    for key in ("c_kv", "k_rope"):
        assert td[key].shape == jd[key].shape and td[key].init == "zeros"
        assert td[key].dtype == torch.bfloat16 and jd[key].dtype == jnp.bfloat16


# ------------------------------------------------------------ whole model

def _params(jc, max_seq, seed=0):
    jp = j_init_params(j_get_api(jc).param_defs(jc, max_seq),
                       jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("name", MOE)
def test_moe_params_carry_across_with_the_same_leaf_paths(name):
    """The stacked (L, E, ...) expert leaves and deepseek's dense prefix
    block cross with the reference's leaf paths and shapes."""
    jc, _ = _cfgs(name)
    jp, tp = _params(jc, 32)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(x.shape)) for path, x in flat]
    assert _leaf_paths(tp) == want
    e = jc.moe
    assert tp["units"]["b0"]["mlp"]["wi"].shape == (
        jc.n_layers - e.first_k_dense, e.n_routed, jc.d_model, e.d_expert)
    assert len(tp["prefix"]) == e.first_k_dense
    if e.first_k_dense:
        assert tp["prefix"][0]["mlp"]["wi"].shape == (jc.d_model, e.dense_ff)
        assert "wkv_a" in tp["prefix"][0]["attn"]


@pytest.mark.parametrize("name", MOE)
def test_moe_lm_forward_matches_jax(name):
    """Logits at LOGIT_ATOL and the summed aux loss at 1e-6; S = 32 is one
    group whose capacity drops tokens in both packages alike."""
    jc, tc = _cfgs(name)
    jp, tp = _params(jc, 32)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 32))
    jl, jaux = j_get_api(jc).forward(jc, jp, {"tokens": jnp.asarray(toks)}, J32)
    tl, taux = t_get_api(tc).forward(tc, tp, {"tokens": torch.from_numpy(toks)},
                                     T32)
    assert tl.shape == (2, 32, jc.vocab_size) and float(taux) > 0
    _close(tl, jl, LOGIT_ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", MOE)
def test_moe_lm_prefill_decode_match_jax(name):
    """Prefill 24 tokens, then 8 decode steps, against the reference's
    prefill and decode: logits at LOGIT_ATOL, the cache (k/v, or deepseek's
    c_kv/k_rope, prefix block included) at 1e-4."""
    jc, tc = _cfgs(name)
    B, S, P = 2, 32, 24
    jp, tp = _params(jc, S)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (B, S))
    japi, tapi = j_get_api(jc), t_get_api(tc)
    jl, jcache = japi.prefill(jc, jp, jnp.asarray(toks[:, :P]), {}, S, J32)
    tl, tcache = tapi.prefill(tc, tp, torch.from_numpy(toks[:, :P]), {}, S,
                              T32)
    _close(tl, jl, LOGIT_ATOL)
    for t in range(P, S):
        jl, jcache = japi.decode(jc, jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.full((B,), t, jnp.int32), J32)
        tl, tcache = tapi.decode(tc, tp, tcache,
                                 torch.from_numpy(toks[:, t:t + 1]),
                                 torch.full((B,), t), T32)
        _close(tl, jl, LOGIT_ATOL)
    j_leaves = jax.tree_util.tree_flatten_with_path(jcache)[0]
    t_leaves = _leaf_paths(tcache)
    assert [k for k, _ in t_leaves] == [
        "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in path)
        for path, _ in j_leaves]
    for (key, _), (_, j) in zip(t_leaves, j_leaves):
        node = tcache
        for part in key.split("/"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        _close(node, j, 1e-4)
