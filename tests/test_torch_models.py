"""The port's model stack against the JAX package, on the CPU.

Inputs come from numpy with a fixed seed and both sides get the same
arrays; weights are JAX-initialised and carried into the port by
``params_from_numpy`` (jax.random and torch.Generator draw different
streams).  Everything runs in fp32, where the two frameworks differ only
in summation order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduce_for_smoke
from repro.models import attention as j_att
from repro.models import layers as j_layers
from repro.models import rglru as j_rg
from repro.models import xlstm as j_xl
from repro.models.params import init_params as j_init_params
from repro.models.registry import get_api as j_get_api
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce_for_smoke
from repro_torch.launch.serve import request_extras
from repro_torch.models import attention as t_att
from repro_torch.models import layers as t_layers
from repro_torch.models import rglru as t_rg
from repro_torch.models import xlstm as t_xl
from repro_torch.models.params import init_params as t_init_params
from repro_torch.models.params import params_from_numpy
from repro_torch.models.registry import count_params as t_count_params
from repro_torch.models.registry import get_api as t_get_api

J32 = j_layers.Policy(compute=jnp.float32)
T32 = t_layers.Policy(compute=torch.float32)
DENSE = ["granite-34b", "llava-next-34b", "smollm-135m", "stablelm-12b",
         "yi-9b"]
HYBRID = "recurrentgemma-9b"
MOE = ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"]
XLSTM, WHISPER = "xlstm-1.3b", "whisper-tiny"
ALL = DENSE + [HYBRID] + MOE + [XLSTM, WHISPER]
# Logits of the smoke stacks are O(1); fp32 with another summation order
# agrees to ~1e-5, so 1e-4 leaves a margin without hiding a real fault.
LOGIT_ATOL = 1e-4


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(shape, seed=0):
    return _rng(seed).standard_normal(shape, dtype=np.float32)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def _cfgs(name, **changes):
    jc = reduce_for_smoke(ARCHS[name])
    tc = t_reduce_for_smoke(T_ARCHS[name])
    if changes:
        jc, tc = (dataclasses.replace(c, **changes) for c in (jc, tc))
    return jc, tc


def _tame_local_attention(jp):
    """Scale wq and wk of the hybrid's local_attn blocks by 1/4, in the JAX
    tree that both sides then share.  The reference's fan_in (shape[-2])
    is the kv head count 1 for wk, so at smoke widths its scores are ~16x
    those of a fan_in of d_model, and the stack's own fp32 noise floor (the
    JAX logits moved by a 1e-7 relative change of the embedding) is
    1.5e-4 to 5.7e-4 over three seeds: above LOGIT_ATOL, so no
    implementation could meet it.  Tamed, that floor is ~1e-5."""
    attn = dict(jp["units"]["b2"]["attn"])
    attn["wq"], attn["wk"] = attn["wq"] * 0.25, attn["wk"] * 0.25
    return {**jp, "units": {**jp["units"], "b2": {**jp["units"]["b2"],
                                                  "attn": attn}}}


def _params(jc, max_seq):
    jp = j_init_params(j_get_api(jc).param_defs(jc, max_seq),
                       jax.random.PRNGKey(0))
    if jc.family == "hybrid":
        jp = _tame_local_attention(jp)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol)


# --------------------------------------------------------------- layers

@pytest.mark.parametrize("name", ["smollm-135m", "granite-34b"])  # rms, ln
def test_apply_norm_matches_jax(name):
    jc, tc = _cfgs(name)
    jx, tx = _both(_f32((2, 5, 64), 1))
    p = {"scale": _f32((64,), 2), "bias": _f32((64,), 3)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(t_layers.apply_norm(tc, tp, tx, T32),
           j_layers.apply_norm(jc, jp, jx, J32), 1e-5)
    _close(t_layers.rms_head_norm(tx, tp["scale"]),
           j_layers.rms_head_norm(jx, jp["scale"]), 1e-5)


@pytest.mark.parametrize("rot", [16, 8])            # full, partial rotary
def test_rope_qk_matches_jax(rot):
    jq, tq = _both(_f32((2, 12, 4, 16), 1))
    jk, tk = _both(_f32((2, 12, 2, 16), 2))
    pos = _rng(3).integers(0, 4096, (2, 12))
    jpos, tpos = jnp.asarray(pos, jnp.int32), torch.from_numpy(pos)
    jo = j_layers.rope_qk(jq, jk, jpos, rot, 10000.0)
    to = t_layers.rope_qk(tq, tk, tpos, rot, 10000.0)
    for t, j in zip(to, jo):
        # angles up to 4096 rad: fp32 cos/sin of two libraries agree to ~1e-6
        _close(t, j, 1e-5)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu"])
def test_apply_mlp_matches_jax(mlp):
    jc, tc = _cfgs("smollm-135m", mlp=mlp)
    defs = j_layers.mlp_defs(jc)
    jp = j_init_params(defs, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jx, tx = _both(_f32((2, 7, 64), 4))
    _close(t_layers.apply_mlp(tc, tp, tx, T32),
           j_layers.apply_mlp(jc, jp, jx, J32), 1e-5)


@pytest.mark.parametrize("tie", [True, False])
def test_embed_and_lm_logits_match_jax(tie):
    jc, tc = _cfgs("smollm-135m", tie_embeddings=tie)
    jp = j_init_params(j_layers.embed_defs(jc), jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = _rng(5).integers(0, jc.vocab_size, (2, 9))
    _close(t_layers.embed_tokens(tc, tp, torch.from_numpy(toks), T32),
           j_layers.embed_tokens(jc, jp, jnp.asarray(toks), J32), 0)
    jx, tx = _both(_f32((2, 9, 64), 6))
    _close(t_layers.lm_logits(tc, tp, tx, T32),
           j_layers.lm_logits(jc, jp, jx, J32), 1e-5)


# ------------------------------------------------------------ attention

@pytest.mark.parametrize("window,q_chunk", [(0, 1024), (16, 1024), (0, 16),
                                            (16, 16)])
def test_gqa_attention_chunked_matches_jax(window, q_chunk):
    """GQA 4 heads over 2 kv heads; local window; several q chunks."""
    jq, tq = _both(_f32((2, 48, 4, 16), 1))
    jk, tk = _both(_f32((2, 48, 2, 16), 2))
    jv, tv = _both(_f32((2, 48, 2, 16), 3))
    pos = np.arange(48)
    jo = j_att.gqa_attention(jq, jk, jv, q_positions=jnp.asarray(pos),
                             k_positions=jnp.asarray(pos), window=window,
                             q_chunk=q_chunk)
    to = t_att.gqa_attention(tq, tk, tv, q_positions=torch.from_numpy(pos),
                             k_positions=torch.from_numpy(pos), window=window,
                             q_chunk=q_chunk)
    _close(to, jo, 1e-5)


@pytest.mark.parametrize("window", [0, 100])
def test_gqa_attention_chunked_accepts_lengths_the_chunks_do_not_divide(
        window):
    """At Sq 301 and q_chunk 128 the reference raises (it reshapes into 2
    equal chunks); the port splits q into 2 unequal chunks and computes the
    same attention as one chunk would."""
    q = torch.from_numpy(_f32((2, 301, 4, 16), 1))
    k = torch.from_numpy(_f32((2, 301, 2, 16), 2))
    v = torch.from_numpy(_f32((2, 301, 2, 16), 3))
    pos = torch.arange(301)
    out = {qc: t_att.gqa_attention(q, k, v, q_positions=pos, k_positions=pos,
                                   window=window, q_chunk=qc)
           for qc in (128, 1024)}
    assert out[128].shape == (2, 301, 4, 16)
    np.testing.assert_allclose(out[128].numpy(), out[1024].numpy(), atol=1e-6)


# ---------------------------------------------------------- whole model

@pytest.mark.parametrize("name", DENSE)
def test_lm_forward_matches_jax(name):
    jc, tc = _cfgs(name)
    jp, tp = _params(jc, 32)
    toks = _rng(1).integers(0, jc.vocab_size, (2, 32))
    jl, _ = j_get_api(jc).forward(jc, jp, {"tokens": jnp.asarray(toks)}, J32)
    tl, aux = t_get_api(tc).forward(tc, tp, {"tokens": torch.from_numpy(toks)},
                                    T32)
    assert tl.shape == (2, 32, jc.vocab_size) and float(aux) == 0.0
    _close(tl, jl, LOGIT_ATOL)


def test_lm_prefill_decode_match_jax():
    jc, tc = _cfgs("smollm-135m")
    B, S, P = 2, 32, 24
    jp, tp = _params(jc, S)
    toks = _rng(1).integers(0, jc.vocab_size, (B, S))
    japi, tapi = j_get_api(jc), t_get_api(tc)
    jl, jcache = japi.prefill(jc, jp, jnp.asarray(toks[:, :P]), {}, S, J32)
    tl, tcache = tapi.prefill(tc, tp, torch.from_numpy(toks[:, :P]), {}, S,
                              T32)
    _close(tl, jl, LOGIT_ATOL)
    # post-rope keys reach |k| ~ 15: fp32 agreement ~3e-6 relative
    _close(tcache["units"]["b0"]["k"], jcache["units"]["b0"]["k"], 1e-4)
    for t in range(P, S):
        jl, jcache = japi.decode(jc, jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.full((B,), t, jnp.int32), J32)
        tl, tcache = tapi.decode(tc, tp, tcache, torch.from_numpy(toks[:, t:t + 1]),
                                 torch.full((B,), t), T32)
        _close(tl, jl, LOGIT_ATOL)


def _extras(cfg, b):
    """The inputs beside the tokens, as test_models_smoke.py::_batch and
    the serve CLIs make them: whisper's stub frames, a VLM's vision
    embeddings (ones x 0.1)."""
    return {k: torch.from_numpy(v)
            for k, v in request_extras(cfg, b).items()}


@pytest.mark.parametrize("name", ALL)
def test_forward_shapes_no_nan(name):
    """Twin of test_models_smoke.py::test_forward_shapes_no_nan: the
    reduced config of every arch, under the default bf16 policy."""
    _, tc = _cfgs(name)
    api = t_get_api(tc)
    params = t_init_params(api.param_defs(tc, 32),
                           torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_rng(1).integers(0, tc.vocab_size, (2, 32)))
    logits, aux = api.forward(tc, params, {"tokens": toks, **_extras(tc, 2)})
    assert logits.shape == (2, 32, tc.vocab_size)
    assert torch.isfinite(logits.float()).all() and torch.isfinite(aux)


@pytest.mark.parametrize("name", ALL)
def test_prefill_decode_matches_forward(name):
    """Twin of test_models_smoke.py::test_prefill_decode_matches_forward,
    on the port alone (same atol 2e-3; for the MoE archs the reference's
    0.5: capacity dispatch may drop tokens in the competitive full/prefill
    pass, never in decode)."""
    _, tc = _cfgs(name)
    api = t_get_api(tc)
    B, S, P = 2, 32, 24
    _, tp = _params(reduce_for_smoke(ARCHS[name]), S)
    toks = torch.from_numpy(_rng(1).integers(0, tc.vocab_size, (B, S)))
    extras = _extras(tc, B)
    full, _ = api.forward(tc, tp, {"tokens": toks, **extras}, T32)
    lg, cache = api.prefill(tc, tp, toks[:, :P], extras, S, T32)
    errs = [float((lg - full[:, P - 1]).abs().max())]
    for t in range(P, S):
        lg, cache = api.decode(tc, tp, cache, toks[:, t:t + 1],
                               torch.full((B,), t), T32)
        errs.append(float((lg - full[:, t]).abs().max()))
    tol = 0.5 if tc.moe is not None else 2e-3
    assert max(errs) < tol, (name, max(errs))


def test_lm_forward_flash_backend_matches_jax_pallas():
    """head_dim 64 and 128 tokens meet the flash contract: the JAX side runs
    the interpreted Pallas kernel, the port its kernel's plain version."""
    jc, tc = _cfgs("smollm-135m", head_dim=64)
    jp, tp = _params(jc, 128)
    toks = _rng(2).integers(0, jc.vocab_size, (1, 128))
    try:
        j_att.set_attention_backend("flash")
        t_att.set_attention_backend("flash")
        jl, _ = j_get_api(jc).forward(jc, jp, {"tokens": jnp.asarray(toks)},
                                      J32)
        tl, _ = t_get_api(tc).forward(tc, tp, {"tokens": torch.from_numpy(toks)},
                                      T32)
        assert t_att._flash_ok(torch.zeros(1, 128, 4, 64), torch.zeros(1, 128, 2, 64),
                               torch.zeros(1, 128, 2, 64), None, True)
    finally:
        j_att.set_attention_backend("chunked")
        t_att.set_attention_backend("chunked")
    _close(tl, jl, LOGIT_ATOL)


def test_count_params_matches_jax():
    """Every arch of the repo, all ten in the port."""
    from repro.models.registry import active_param_ratio as j_ratio
    from repro.models.registry import count_params as j_count_params
    from repro_torch.models.registry import active_param_ratio as t_ratio
    assert sorted(ALL) == sorted(T_ARCHS) == sorted(ARCHS)
    for name in ALL:
        assert t_count_params(T_ARCHS[name]) == j_count_params(ARCHS[name])
        assert t_ratio(T_ARCHS[name]) == j_ratio(ARCHS[name])
    assert t_count_params(T_ARCHS["smollm-135m"]) == T_ARCHS["smollm-135m"].n_params()
    assert t_count_params(T_ARCHS[HYBRID]) == 10_444_664_832
    # JAX count_params on the CPU; deepseek's dense first layer is 10944 wide
    assert t_count_params(T_ARCHS["qwen2-moe-a2.7b"]) == 14_315_636_736
    assert t_count_params(T_ARCHS["deepseek-v2-lite-16b"]) == 15_706_484_224
    # xLSTM's mLSTM head dim is proj_factor * d_model / n_heads = 1024, not
    # the config's head_dim 512; whisper's learned pos table is max_seq wide
    assert t_count_params(T_ARCHS[XLSTM]) == 2_020_321_280
    assert t_count_params(T_ARCHS[WHISPER]) == 38_020_992
    assert t_count_params(T_ARCHS[WHISPER], max_seq=4096) == 38_020_992
    assert t_ratio(T_ARCHS["smollm-135m"]) == 1.0


def test_windowed_attn_prefill_decode_ring_buffer_matches_jax():
    """A local-window layer: prefill fills the ring buffer, decode wraps it
    (attention.py's slot = pos % window) past the window size."""
    jc, tc = _cfgs("smollm-135m", window=16)
    jp = j_init_params(j_att.attn_defs(jc), jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    B, P, S = 2, 12, 30
    x = _f32((B, S, jc.d_model), 7)
    pos = np.arange(P)
    jy, jcache = j_att.attn_prefill(jc, jp, jnp.asarray(x[:, :P]),
                                    jnp.asarray(pos), S, window=16, policy=J32)
    ty, tcache = t_att.attn_prefill(tc, tp, torch.from_numpy(x[:, :P]),
                                    torch.from_numpy(pos), S, window=16,
                                    policy=T32)
    # outputs reach |y| ~ 2 and agree to ~8e-6 relative in fp32
    _close(ty, jy, 1e-4)
    for t in range(P, S):
        jy, jcache = j_att.attn_decode(jc, jp, jnp.asarray(x[:, t:t + 1]),
                                       jcache, jnp.full((B,), t, jnp.int32),
                                       policy=J32)
        ty, tcache = t_att.attn_decode(tc, tp, torch.from_numpy(x[:, t:t + 1]),
                                       tcache, torch.full((B,), t), policy=T32)
        _close(ty, jy, 1e-4)
    _close(tcache["k"], jcache["k"], 1e-4)


# ------------------------------------------------------ rg-lru + hybrid LM

@pytest.fixture(params=["scan", "kernel"])
def recurrence_backend(request):
    t_rg.set_recurrence_backend(request.param)
    try:
        yield request.param
    finally:
        t_rg.set_recurrence_backend("scan")


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    ju, tu = _both(_f32((2, 9, 64), 1))
    jw, tw = _both(_f32((4, 64), 2))
    js, ts = _both(_f32((2, 3, 64), 3)) if with_state else (None, None)
    jo, jst = j_xl._causal_conv(ju, jw, js)
    to, tst = t_xl._causal_conv(tu, tw, ts)
    _close(to, jo, 1e-5)
    _close(tst, jst, 0)


def _rglru_setup(seed=0):
    jc, tc = _cfgs(HYBRID)
    jp = j_init_params(j_rg.rglru_defs(jc), jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_apply_matches_jax(recurrence_backend, with_state):
    jc, tc, jp, tp = _rglru_setup()
    jx, tx = _both(_f32((2, 24, 64), 4))
    state = ({"conv": _f32((2, 3, 64), 5), "h": _f32((2, 64), 6)}
             if with_state else None)
    jst = state and {k: jnp.asarray(v) for k, v in state.items()}
    tst = state and {k: torch.from_numpy(v) for k, v in state.items()}
    jy, jnew = j_rg.rglru_apply(jc, jp, jx, J32, state=jst)
    ty, tnew = t_rg.rglru_apply(tc, tp, tx, T32, state=tst)
    _close(ty, jy, 1e-5)
    _close(tnew["h"], jnew["h"], 1e-5)
    _close(tnew["conv"], jnew["conv"], 1e-5)


def test_rglru_decode_matches_jax(recurrence_backend):
    """Prefill 12 tokens, then 6 one-token updates, both sides."""
    jc, tc, jp, tp = _rglru_setup(1)
    x = _f32((2, 18, 64), 7)
    _, jst = j_rg.rglru_apply(jc, jp, jnp.asarray(x[:, :12]), J32)
    _, tst = t_rg.rglru_apply(tc, tp, torch.from_numpy(x[:, :12]), T32)
    for t in range(12, 18):
        jy, jst = j_rg.rglru_decode(jc, jp, jnp.asarray(x[:, t:t + 1]), jst,
                                    J32)
        ty, tst = t_rg.rglru_decode(tc, tp, torch.from_numpy(x[:, t:t + 1]),
                                    tst, T32)
        _close(ty, jy, 1e-5)
    _close(tst["h"], jst["h"], 1e-5)


def test_rglru_state_defs_match_jax():
    jc, tc = _cfgs(HYBRID)
    jd, td = j_rg.rglru_state_defs(jc, 3), t_rg.rglru_state_defs(tc, 3)
    for key in ("conv", "h"):
        assert td[key].shape == jd[key].shape
        assert str(td[key].dtype).split(".")[-1] == jnp.dtype(jd[key].dtype).name


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, x in enumerate(tree)
                for p in _leaf_paths(x, prefix + (str(i),))]
    return [("/".join(prefix), tuple(tree.shape))]


def test_hybrid_params_carry_across_with_the_same_leaf_paths():
    jc, _ = _cfgs(HYBRID)
    jp, tp = _params(jc, 32)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(x.shape)) for path, x in flat]
    assert _leaf_paths(tp) == want
    assert sorted(tp["units"]) == ["b0", "b1", "b2"]
    assert "wx" in tp["units"]["b0"] and "attn" in tp["units"]["b2"]
    assert len(tp["tail"]) == 2 and "lm_head" in tp["embed"]


def test_hybrid_lm_forward_matches_jax(recurrence_backend):
    jc, tc = _cfgs(HYBRID)
    jp, tp = _params(jc, 32)
    toks = _rng(1).integers(0, jc.vocab_size, (2, 32))
    jl, _ = j_get_api(jc).forward(jc, jp, {"tokens": jnp.asarray(toks)}, J32)
    tl, aux = t_get_api(tc).forward(tc, tp, {"tokens": torch.from_numpy(toks)},
                                    T32)
    assert tl.shape == (2, 32, jc.vocab_size) and float(aux) == 0.0
    _close(tl, jl, LOGIT_ATOL)


def test_hybrid_lm_prefill_decode_match_jax(recurrence_backend):
    """P=24 > window 16, S=32: prefill fills the ring buffer, decode wraps
    it, and the rglru blocks carry their state through every step."""
    jc, tc = _cfgs(HYBRID)
    B, S, P = 2, 32, 24
    jp, tp = _params(jc, S)
    toks = _rng(1).integers(0, jc.vocab_size, (B, S))
    japi, tapi = j_get_api(jc), t_get_api(tc)
    jl, jcache = japi.prefill(jc, jp, jnp.asarray(toks[:, :P]), {}, S, J32)
    tl, tcache = tapi.prefill(tc, tp, torch.from_numpy(toks[:, :P]), {}, S,
                              T32)
    _close(tl, jl, LOGIT_ATOL)
    assert tcache["units"]["b2"]["k"].shape == (2, B, jc.window, 1, jc.hd)
    _close(tcache["tail"][1]["h"], jcache["tail"][1]["h"], 1e-4)
    for t in range(P, S):
        jl, jcache = japi.decode(jc, jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.full((B,), t, jnp.int32), J32)
        tl, tcache = tapi.decode(tc, tp, tcache,
                                 torch.from_numpy(toks[:, t:t + 1]),
                                 torch.full((B,), t), T32)
        _close(tl, jl, LOGIT_ATOL)
    for key in ("conv", "h"):
        _close(tcache["units"]["b1"][key], jcache["units"]["b1"][key], 1e-4)
    _close(tcache["units"]["b2"]["k"], jcache["units"]["b2"]["k"], 1e-4)


def test_hybrid_forward_flash_and_kernel_backends_match_jax_pallas():
    """head_dim 64 and 128 tokens meet the flash contract: the JAX side runs
    the interpreted Pallas flash kernel (its model always scans the
    recurrence), the port the plain versions of both of its kernels."""
    jc, tc = _cfgs(HYBRID, head_dim=64)
    jp, tp = _params(jc, 128)
    toks = _rng(2).integers(0, jc.vocab_size, (1, 128))
    try:
        j_att.set_attention_backend("flash")
        t_att.set_attention_backend("flash")
        t_rg.set_recurrence_backend("kernel")
        jl, _ = j_get_api(jc).forward(jc, jp, {"tokens": jnp.asarray(toks)},
                                      J32)
        tl, _ = t_get_api(tc).forward(tc, tp, {"tokens": torch.from_numpy(toks)},
                                      T32)
    finally:
        j_att.set_attention_backend("chunked")
        t_att.set_attention_backend("chunked")
        t_rg.set_recurrence_backend("scan")
    _close(tl, jl, LOGIT_ATOL)


def test_recurrence_backend_switch():
    assert t_rg.get_recurrence_backend() == "scan"     # the reference's
    with pytest.raises(AssertionError):
        t_rg.set_recurrence_backend("flash")


@pytest.mark.parametrize("batch", [1, 2])
def test_flash_backend_hands_the_kernel_contiguous_tensors(monkeypatch, batch):
    """The CUDA kernel takes contiguous (BH, S, hd) tensors and raises on
    others.  At B=1 ``transpose(1, 2).reshape`` returns a strided view,
    which made the flash path raise on the card for one-row batches."""
    from repro_torch.kernels import ops
    seen = []

    def checking(q, k, v, causal=True, window=0):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return ops.ref_flash_attention(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(ops, "flash_attention", checking)
    q, k, v = (torch.from_numpy(_f32((batch, 128, h, 64), i))
               for i, h in ((1, 4), (2, 1), (3, 1)))
    pos = torch.arange(128)
    try:
        t_att.set_attention_backend("flash")
        out = t_att.gqa_attention(q, k, v, q_positions=pos, k_positions=pos,
                                  window=64)
    finally:
        t_att.set_attention_backend("chunked")
    assert seen == [True] and out.shape == (batch, 128, 4, 64)
    want = t_att.gqa_attention(q, k, v, q_positions=pos, k_positions=pos,
                               window=64)
    _close(out, want.numpy(), 1e-5)
