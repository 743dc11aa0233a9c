"""The port's whisper family against the JAX package, on the CPU: the
sinusoidal table, cross-attention, the encoder, the forward, the prefill
(into the engine's buffers) and the decode of the reduced whisper-tiny
(2 encoder + 2 decoder layers, 16 frames, d_model 64, 4 heads of 16), and
its cache defs leaf by leaf.

Inputs come from numpy with a fixed seed and both sides get the same
arrays; weights are JAX-initialised and carried into the port by
``params_from_numpy``.  Everything runs in fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduce_for_smoke
from repro.models import attention as j_att
from repro.models import layers as j_layers
from repro.models import whisper as j_wh
from repro.models.params import init_params as j_init_params
from repro.models.registry import get_api as j_get_api
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce_for_smoke
from repro_torch.models import attention as t_att
from repro_torch.models import layers as t_layers
from repro_torch.models import whisper as t_wh
from repro_torch.models.params import (is_pm, params_from_numpy, tree_leaves,
                                       tree_map)
from repro_torch.models.registry import get_api as t_get_api

from test_torch_models import (J32, LOGIT_ATOL, T32, _close, _f32,
                               _leaf_paths, _rng)

WHISPER = "whisper-tiny"
# Held at 1e-5 of the reference's largest element where that exceeds 1:
# the reference's fan_in for an attention weight (d, heads, hd) is the
# head count, 4 here, so k and v reach |k| ~ 10 and cross-attention's
# scores are large; fp32 in another summation order agrees to ~4e-6 of
# that scale (as tests/test_torch_moe.py::_close_scaled holds MLA)
LAYER_RTOL = 1e-5


def _close_scaled(t, j, rtol=LAYER_RTOL):
    j = np.asarray(j, np.float32)
    _close(t, j, rtol * max(1.0, float(np.abs(j).max())))


def _cfgs():
    return (reduce_for_smoke(ARCHS[WHISPER]),
            t_reduce_for_smoke(T_ARCHS[WHISPER]))


def _params(max_seq=32):
    jc, tc = _cfgs()
    jp = j_init_params(j_get_api(jc).param_defs(jc, max_seq),
                       jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _frames(cfg, b, seed=3):
    return _f32((b, cfg.encoder.n_frames, cfg.d_model), seed) * 0.1


def test_reduced_whisper_shape():
    jc, tc = _cfgs()
    assert (tc.encoder.n_layers, tc.n_layers, tc.encoder.n_frames) == (2, 2, 16)
    assert (tc.d_model, tc.n_heads, tc.hd) == (jc.d_model, 4, 16)


@pytest.mark.parametrize("n,d", [(16, 64), (1500, 384)])
def test_sincos_table_equals_reference(n, d):
    """numpy float64, then cast: bit for bit (1500 x 384 is the full
    encoder's)."""
    assert np.array_equal(t_layers.sincos_table(n, d).numpy(),
                          np.asarray(j_layers.sincos_table(n, d)))


def test_cross_attn_forward_matches_jax():
    jc, tc = _cfgs()
    jp = j_init_params(j_att.attn_defs(jc), jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x, mem = _f32((2, 12, jc.d_model), 1), _f32((2, 16, jc.d_model), 2)
    jy = j_att.cross_attn_forward(jc, jp, jnp.asarray(x), jnp.asarray(mem),
                                  policy=J32)
    ty = t_att.cross_attn_forward(tc, tp, torch.from_numpy(x),
                                  torch.from_numpy(mem), policy=T32)
    _close_scaled(ty, jy)


def test_encode_matches_jax():
    jc, tc, jp, tp = _params()
    frames = _frames(jc, 2)
    jm = j_wh.encode(jc, jp, jnp.asarray(frames), J32)
    tm = t_wh.encode(tc, tp, torch.from_numpy(frames), T32)
    assert tm.shape == (2, jc.encoder.n_frames, jc.d_model)
    _close_scaled(tm, jm)


def test_whisper_forward_matches_jax():
    jc, tc, jp, tp = _params()
    toks = _rng(1).integers(0, jc.vocab_size, (2, 32))
    frames = _frames(jc, 2)
    jl, _ = j_wh.whisper_forward(jc, jp, {"tokens": jnp.asarray(toks),
                                          "frames": jnp.asarray(frames)}, J32)
    tl, aux = t_wh.whisper_forward(tc, tp, {"tokens": torch.from_numpy(toks),
                                            "frames": torch.from_numpy(frames)},
                                   T32)
    assert tl.shape == (2, 32, jc.vocab_size) and float(aux) == 0.0
    _close(tl, jl, LOGIT_ATOL)


def test_whisper_prefill_into_buffers_and_decode_match_jax():
    """Prefill 24 tokens into zeroed buffers of whisper_cache_defs (the
    engine's), written in place, then 8 decode steps: logits, the self
    K/V (updated in place) and the cross K/V (left as the prefill wrote
    them)."""
    jc, tc, jp, tp = _params()
    B, S, P = 2, 32, 24
    toks = _rng(1).integers(0, jc.vocab_size, (B, S))
    frames = _frames(jc, B)
    buffers = tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype),
                       t_wh.whisper_cache_defs(tc, B, S, torch.float32),
                       is_leaf=is_pm)
    jl, jcache = j_wh.whisper_prefill(jc, jp, jnp.asarray(toks[:, :P]),
                                      {"frames": jnp.asarray(frames)}, S, J32)
    tl, tcache = t_wh.whisper_prefill(tc, tp, torch.from_numpy(toks[:, :P]),
                                      {"frames": torch.from_numpy(frames)}, S,
                                      T32, cache=buffers)
    assert tcache is buffers
    _close(tl, jl, LOGIT_ATOL)
    cross = {k: v.clone() for k, v in tcache["dec"]["cross"].items()}
    for key in ("k", "v"):
        _close_scaled(tcache["dec"]["cross"][key],
                      jcache["dec"]["cross"][key])
    for t in range(P, S):
        jl, jcache = j_wh.whisper_decode(jc, jp, jcache,
                                         jnp.asarray(toks[:, t:t + 1]),
                                         jnp.full((B,), t, jnp.int32), J32)
        tl, tcache = t_wh.whisper_decode(tc, tp, tcache,
                                         torch.from_numpy(toks[:, t:t + 1]),
                                         torch.full((B,), t), T32)
        _close(tl, jl, LOGIT_ATOL)
    assert tcache is buffers
    for key in ("k", "v"):
        _close_scaled(tcache["dec"]["self"][key],
                      jcache["dec"]["self"][key])
        assert torch.equal(tcache["dec"]["cross"][key], cross[key])


def test_whisper_prefill_without_buffers_matches_with():
    """The prefill's own cache (cache=None) equals what it writes into
    the engine's buffers."""
    _, tc, _, tp = _params()
    toks = torch.from_numpy(_rng(2).integers(0, tc.vocab_size, (2, 16)))
    extras = {"frames": torch.from_numpy(_frames(tc, 2))}
    lg, own = t_wh.whisper_prefill(tc, tp, toks, extras, 32, T32)
    buffers = tree_map(lambda d: torch.full(d.shape, 7.0, dtype=d.dtype),
                       t_wh.whisper_cache_defs(tc, 2, 32, torch.float32),
                       is_leaf=is_pm)
    lg2, into = t_wh.whisper_prefill(tc, tp, toks, extras, 32, T32,
                                     cache=buffers)
    assert torch.equal(lg, lg2)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(own), tree_leaves(into)))


def test_whisper_cache_defs_match_jax_leaf_by_leaf():
    """Paths, shapes, inits and dtypes (bf16 by default, the reference's
    fixed dtype); the port's take the compute dtype."""
    jc, tc = _cfgs()
    jd = j_wh.whisper_cache_defs(jc, 3, 40)
    td = t_get_api(tc).cache_defs(tc, 3, 40)
    jl = jax.tree_util.tree_flatten_with_path(
        jd, is_leaf=lambda x: hasattr(x, "logical"))[0]
    assert [k for k, _ in _leaf_paths(td)] == [
        "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in path)
        for path, _ in jl]
    for t, (_, j) in zip(tree_leaves(td, is_leaf=is_pm), jl):
        assert t.shape == j.shape and t.init == j.init
        assert str(t.dtype).removeprefix("torch.") == jnp.dtype(j.dtype).name
    assert td["dec"]["cross"]["k"].shape == (2, 3, 16, 4, 16)
    f32 = t_wh.whisper_cache_defs(tc, 3, 40, torch.float32)
    assert f32["dec"]["self"]["k"].dtype == torch.float32


def test_whisper_params_carry_across_with_the_same_leaf_paths():
    _, _, jp, tp = _params()
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(x.shape)) for path, x in flat]
    assert _leaf_paths(tp) == want
    assert "wk" in tp["dec_blocks"]["cross_attn"]
    assert tp["enc_blocks"]["attn"]["wq"].shape[0] == 2
