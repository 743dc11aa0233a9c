"""The port's xLSTM family against the JAX package, on the CPU: the
chunkwise mLSTM (one chunk and two, with and without a carried state),
its recurrent decode, the sLSTM scan and its decode, the state defs, and
the reduced xlstm-1.3b stack end to end (16 layers: two units of 7 mLSTM
and 1 sLSTM, d_model 64, 4 heads, an mLSTM head dim of 32).

Inputs come from numpy with a fixed seed and both sides get the same
arrays; weights are JAX-initialised and carried into the port by
``params_from_numpy``.  Everything runs in fp32, where the two frameworks
differ only in summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduce_for_smoke
from repro.models import xlstm as j_xl
from repro.models.params import init_params as j_init_params
from repro.models.registry import get_api as j_get_api
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce_for_smoke
from repro_torch.models import model as t_lm
from repro_torch.models import xlstm as t_xl
from repro_torch.models.params import (is_pm, params_from_numpy, tree_leaves,
                                       tree_map)
from repro_torch.models.registry import get_api as t_get_api

from test_torch_models import (J32, T32, _close, _f32,
                               _leaf_paths, _rng)

XLSTM = "xlstm-1.3b"
# One block's outputs reach |y| ~ 6: fp32 in another summation order
# agrees to ~3e-6 of that scale over two chunks (the JAX output's own
# noise floor, 1e-7 on the input, is ~1e-6 of it), so outputs are held at
# 1e-5 of their scale.  A chunk's carry sums 256 outer products: C and n
# (|C| ~ 4) agree to ~4e-5 after two chunks, so states are held at the
# 1e-4 the stack tests hold caches to.
BLOCK_RTOL = 1e-5
STATE_ATOL = 1e-4
# The reduced stack is 16 blocks deep (two units: the pattern needs 8), and
# a 1e-7 relative change of its input grows ~1.4x a block (fp64, measured
# on these weights).  Its own fp32 noise floor (the JAX logits moved by a
# 1e-7 relative change of the embedding) is 0.6e-4 to 2.6e-4 over three
# seeds, above LOGIT_ATOL, and fp64 puts each fp32 implementation 0.7e-4
# to 1.2e-4 from the exact logits, so two can differ by twice that.  The
# stack's logits and its deep states are held at 5e-4, twice the worst
# floor; every block alone is held at BLOCK_RTOL above.
STACK_ATOL = 5e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The sLSTM loop runs thousands of tiny ops; beside the suite's other
    workers idle OpenMP threads would slow it many times over
    (tests/test_torch_chip_smoke.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _cfgs():
    return reduce_for_smoke(ARCHS[XLSTM]), t_reduce_for_smoke(T_ARCHS[XLSTM])


def _block(defs_name, seed):
    jc, tc = _cfgs()
    jp = j_init_params(getattr(j_xl, defs_name)(jc), jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _state(kind, b, seed):
    """A carried state of plausible magnitudes: m finite, n > 0 for the
    sLSTM (its cell divides by n)."""
    jc, _ = _cfgs()
    rng = _rng(seed)
    if kind == "mlstm":
        di, h, hd = j_xl._di(jc), jc.n_heads, j_xl._hd(jc)
        st = {"conv": rng.standard_normal((b, jc.conv_width - 1, di)),
              "C": rng.standard_normal((b, h, hd, hd)),
              "n": rng.standard_normal((b, h, hd)),
              "m": rng.standard_normal((b, h))}
    else:
        h, hd = jc.n_heads, jc.d_model // jc.n_heads
        st = {"c": rng.standard_normal((b, h, hd)),
              "n": rng.uniform(0.5, 2.0, (b, h, hd)),
              "h": rng.standard_normal((b, h, hd)) * 0.5,
              "m": rng.standard_normal((b, h, hd))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    return ({k: jnp.asarray(v) for k, v in st.items()},
            {k: torch.from_numpy(v.copy()) for k, v in st.items()})


def _out_close(t, j):
    j = np.asarray(j, np.float32)
    _close(t, j, BLOCK_RTOL * max(1.0, float(np.abs(j).max())))


def _states_close(t, j):
    assert sorted(t) == sorted(j)
    for key in j:
        _close(t[key], j[key], STATE_ATOL)


# ------------------------------------------------------------------ mLSTM

@pytest.mark.parametrize("b,s", [(2, 32), (1, 512)], ids=["S32", "S512"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_apply_matches_jax(b, s, with_state):
    """S = 32 is one chunk; S = 512 is two chunks of 256, the carry (C, n,
    m) crossing between them."""
    jc, tc, jp, tp = _block("mlstm_defs", 0)
    x = _f32((b, s, jc.d_model), 1)
    jst, tst = _state("mlstm", b, 2) if with_state else (None, None)
    jy, jnew = j_xl.mlstm_apply(jc, jp, jnp.asarray(x), J32, state=jst)
    ty, tnew = t_xl.mlstm_apply(tc, tp, torch.from_numpy(x), T32, state=tst)
    _out_close(ty, jy)
    _states_close(tnew, jnew)


def test_mlstm_apply_keeps_the_chunk_assertion():
    """A sequence longer than a chunk and no multiple of it raises, as the
    reference's does (repro/models/xlstm.py:100-101)."""
    jc, tc, jp, tp = _block("mlstm_defs", 0)
    x = _f32((1, 300, jc.d_model), 1)
    with pytest.raises(AssertionError):
        j_xl.mlstm_apply(jc, jp, jnp.asarray(x), J32)
    with pytest.raises(AssertionError):
        t_xl.mlstm_apply(tc, tp, torch.from_numpy(x), T32)


def test_mlstm_decode_matches_jax_and_updates_in_place():
    """Prefill 12 tokens, then 6 one-token updates on both sides; the
    port's decode writes the new state into the tensors it was given."""
    jc, tc, jp, tp = _block("mlstm_defs", 3)
    x = _f32((2, 18, jc.d_model), 4)
    _, jst = j_xl.mlstm_apply(jc, jp, jnp.asarray(x[:, :12]), J32)
    _, tst = t_xl.mlstm_apply(tc, tp, torch.from_numpy(x[:, :12]), T32)
    buffers = dict(tst)
    for t in range(12, 18):
        jy, jst = j_xl.mlstm_decode(jc, jp, jnp.asarray(x[:, t:t + 1]), jst,
                                    J32)
        ty, tst = t_xl.mlstm_decode(tc, tp, torch.from_numpy(x[:, t:t + 1]),
                                    tst, T32)
        _out_close(ty, jy)
    assert all(tst[k] is buffers[k] for k in buffers)
    _states_close(tst, jst)


def test_mlstm_chunkwise_matches_recurrent():
    """The port alone: the chunkwise form over 64 tokens equals the
    chunkwise form over the first 32 followed by 32 recurrent steps."""
    _, tc, _, tp = _block("mlstm_defs", 5)
    x = torch.from_numpy(_f32((1, 64, tc.d_model), 6))
    full, fst = t_xl.mlstm_apply(tc, tp, x, T32)
    y, st = t_xl.mlstm_apply(tc, tp, x[:, :32], T32)
    ys = [y]
    for t in range(32, 64):
        y, st = t_xl.mlstm_decode(tc, tp, x[:, t:t + 1], st, T32)
        ys.append(y)
    _out_close(torch.cat(ys, dim=1), full.numpy())
    _states_close(st, {k: v.numpy() for k, v in fst.items()})


# ------------------------------------------------------------------ sLSTM

@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_apply_matches_jax(with_state):
    jc, tc, jp, tp = _block("slstm_defs", 7)
    x = _f32((2, 16, jc.d_model), 8)
    jst, tst = _state("slstm", 2, 9) if with_state else (None, None)
    jy, jnew = j_xl.slstm_apply(jc, jp, jnp.asarray(x), J32, state=jst)
    ty, tnew = t_xl.slstm_apply(tc, tp, torch.from_numpy(x), T32, state=tst)
    _out_close(ty, jy)
    _states_close(tnew, jnew)


def test_slstm_decode_matches_jax():
    jc, tc, jp, tp = _block("slstm_defs", 10)
    x = _f32((2, 14, jc.d_model), 11)
    _, jst = j_xl.slstm_apply(jc, jp, jnp.asarray(x[:, :10]), J32)
    _, tst = t_xl.slstm_apply(tc, tp, torch.from_numpy(x[:, :10]), T32)
    for t in range(10, 14):
        jy, jst = j_xl.slstm_decode(jc, jp, jnp.asarray(x[:, t:t + 1]), jst,
                                    J32)
        ty, tst = t_xl.slstm_decode(tc, tp, torch.from_numpy(x[:, t:t + 1]),
                                    tst, T32)
        _out_close(ty, jy)
    _states_close(tst, jst)


# ------------------------------------------------------------ state defs

@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_state_defs_match_jax_leaf_by_leaf(kind):
    """Shapes, dtypes and inits of each leaf; the conv window takes the
    compute dtype (bf16 by default, the reference's fixed dtype)."""
    jc, tc = _cfgs()
    jd = getattr(j_xl, f"{kind}_state_defs")(jc, 3)
    td = getattr(t_xl, f"{kind}_state_defs")(tc, 3)
    assert sorted(td) == sorted(jd)
    for key in jd:
        assert td[key].shape == jd[key].shape, key
        assert td[key].init == jd[key].init, key
        assert str(td[key].dtype).removeprefix("torch.") == \
            jnp.dtype(jd[key].dtype).name, key
    if kind == "mlstm":
        assert t_xl.mlstm_state_defs(tc, 3, torch.float32)["conv"].dtype \
            == torch.float32


# ------------------------------------------------------------ the stack

def _stack_params(max_seq):
    jc, tc = _cfgs()
    jp = j_init_params(j_get_api(jc).param_defs(jc, max_seq),
                       jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_xlstm_params_carry_across_with_the_same_leaf_paths():
    jc, _, jp, tp = _stack_params(32)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(x.shape)) for path, x in flat]
    assert _leaf_paths(tp) == want
    assert sorted(tp["units"]) == [f"b{i}" for i in range(8)]
    hd = t_xl._hd(t_reduce_for_smoke(T_ARCHS[XLSTM]))
    assert tp["units"]["b0"]["wq"].shape == (2, 4, hd, hd)
    assert tp["units"]["b7"]["r"].shape == (2, 4, 4, 16, 16)


def test_xlstm_forward_matches_jax():
    jc, tc, jp, tp = _stack_params(32)
    toks = _rng(1).integers(0, jc.vocab_size, (2, 32))
    jl, _ = j_get_api(jc).forward(jc, jp, {"tokens": jnp.asarray(toks)}, J32)
    tl, aux = t_get_api(tc).forward(tc, tp, {"tokens": torch.from_numpy(toks)},
                                    T32)
    assert tl.shape == (2, 32, jc.vocab_size) and float(aux) == 0.0
    _close(tl, jl, STACK_ATOL)


def test_xlstm_prefill_into_buffers_and_decode_match_jax():
    """Prefill 24 tokens into the engine's kind of buffers (zeros of
    lm_cache_defs, written in place), then 8 decode steps, against the
    JAX stack; the mLSTM's C and the sLSTM's state at the end."""
    jc, tc, jp, tp = _stack_params(32)
    B, S, P = 2, 32, 24
    toks = _rng(1).integers(0, jc.vocab_size, (B, S))
    japi, tapi = j_get_api(jc), t_get_api(tc)
    buffers = tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype),
                       tapi.cache_defs(tc, B, S, torch.float32), is_leaf=is_pm)
    jl, jcache = japi.prefill(jc, jp, jnp.asarray(toks[:, :P]), {}, S, J32)
    tl, tcache = tapi.prefill(tc, tp, torch.from_numpy(toks[:, :P]), {}, S,
                              T32, cache=buffers)
    assert tcache is buffers
    _close(tl, jl, STACK_ATOL)
    _close(tcache["units"]["b0"]["C"], jcache["units"]["b0"]["C"], STACK_ATOL)
    c_ptr = tcache["units"]["b0"]["C"].data_ptr()
    for t in range(P, S):
        jl, jcache = japi.decode(jc, jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.full((B,), t, jnp.int32), J32)
        tl, tcache = tapi.decode(tc, tp, tcache,
                                 torch.from_numpy(toks[:, t:t + 1]),
                                 torch.full((B,), t), T32)
        _close(tl, jl, STACK_ATOL)
    assert tcache["units"]["b0"]["C"].data_ptr() == c_ptr
    for b, keys in (("b0", ("C", "n", "m", "conv")), ("b7", ("c", "n", "h",
                                                              "m"))):
        for key in keys:
            _close(tcache["units"][b][key], jcache["units"][b][key],
                   STACK_ATOL)


def test_xlstm_cache_defs_match_jax():
    """lm_cache_defs of the stack leaf by leaf: paths, shapes, inits and
    dtypes (the conv windows in the default compute dtype, bf16)."""
    jc, tc = _cfgs()
    jd = j_get_api(jc).cache_defs(jc, 2, 32)
    td = t_get_api(tc).cache_defs(tc, 2, 32)
    jl = jax.tree_util.tree_flatten_with_path(
        jd, is_leaf=lambda x: hasattr(x, "logical"))[0]
    assert [k for k, _ in _leaf_paths(td)] == [
        "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in path)
        for path, _ in jl]
    for t, (_, j) in zip(tree_leaves(td, is_leaf=is_pm), jl):
        assert t.shape == j.shape and t.init == j.init
        assert str(t.dtype).removeprefix("torch.") == jnp.dtype(j.dtype).name


def test_xlstm_reduced_is_sixteen_layers_of_two_units():
    _, tc = _cfgs()
    prefix, unit, n_units, tail = t_lm.stack_plan(tc)
    assert (prefix, n_units, tail) == ((), 2, ())
    assert unit == ("mlstm",) * 7 + ("slstm",) and tc.n_layers == 16
