"""The port's ServeEngine and serving CLI on the CPU, against the JAX
ServeEngine on the same weights and prompts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduce_for_smoke
from repro.distributed.sharding import make_variant
from repro.launch.mesh import make_local_mesh
from repro.models.layers import Policy as JPolicy
from repro.models.params import init_params as j_init_params
from repro.models.registry import get_api as j_get_api
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce_for_smoke
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ref_flash_attention
from repro_torch.launch import serve as t_serve
from repro_torch.models.attention import set_attention_backend
from repro_torch.models.layers import Policy as TPolicy
from repro_torch.models.params import (init_params, params_from_numpy,
                                       tree_leaves)
from repro_torch.models.registry import get_api as t_get_api
from repro_torch.serve.engine import ServeEngine as TServeEngine

T32 = TPolicy(compute=torch.float32)
# A greedy token may flip where the top-2 logits sit within float32 noise
# of each other (tests/test_substrate.py:211-222); only a gap beyond that is
# a real cache or position fault.
TIE_GAP = 1e-2


def _arch_setup(name):
    """``setup(max_seq)`` -> the reduced configs of ``name`` in both
    packages, JAX-initialised params and the port's copy of them."""
    def setup(max_seq):
        jc = reduce_for_smoke(ARCHS[name])
        tc = t_reduce_for_smoke(T_ARCHS[name])
        jp = j_init_params(j_get_api(jc).param_defs(jc, max_seq),
                           jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        return jc, tc, jp, tp
    return setup


_setup = _arch_setup("smollm-135m")
_qwen_setup = _arch_setup("qwen2-moe-a2.7b")
_deepseek_setup = _arch_setup("deepseek-v2-lite-16b")


def _agree_up_to_ties(tokens_a, tokens_b, prompts, forward_logits,
                      tie_gap=TIE_GAP):
    """Greedy streams agree until a near tie; ``forward_logits(seq)`` gives
    fp32 teacher-forced logits (B, S, V) of a prompt + generated sequence.
    After a tolerated flip the contexts differ, so the row stops there."""
    p = prompts.shape[1]
    logits = forward_logits(np.concatenate([prompts, tokens_a], axis=1))
    for b in range(tokens_a.shape[0]):
        for t in range(tokens_a.shape[1]):
            a, c = tokens_a[b, t], tokens_b[b, t]
            if a == c:
                continue
            row = logits[b, p + t - 1]
            gap = abs(float(row[a]) - float(row[c]))
            assert gap < tie_gap, (
                f"b={b} t={t}: tokens {a} vs {c}, logit gap {gap:.4f} is "
                f"beyond float32 tie noise")
            break


def test_serve_engine_tokens_match_jax_engine():
    """The JAX engine does not pass its policy on and computes in bf16
    whatever it is given (ROADMAP.md, Queue 3); the port honours fp32.
    Their greedy tokens still agree up to near ties."""
    jc, tc, jp, tp = _setup(48)
    prompts = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 8)).astype(np.int32)
    j_eng = JServeEngine(jc, jp, make_local_mesh(), make_variant("baseline"),
                         max_seq=48, policy=JPolicy(compute=jnp.float32))
    t_eng = TServeEngine(tc, tp, max_seq=48, policy=T32, device="cpu")
    j_res = j_eng.generate(prompts, 6)
    t_res = t_eng.generate(prompts, 6)
    assert t_res.tokens.shape == j_res.tokens.shape == (2, 6)

    def forward_logits(seq):
        out, _ = t_get_api(tc).forward(
            tc, tp, {"tokens": torch.from_numpy(seq.astype(np.int64))}, T32)
        return out.numpy()

    _agree_up_to_ties(t_res.tokens, j_res.tokens, prompts, forward_logits)


def test_serve_engine_greedy_matches_forward_argmax():
    """Twin of test_substrate.py::test_serve_engine_greedy_matches_forward_argmax."""
    _, tc, _, tp = _setup(48)
    api = t_get_api(tc)
    eng = TServeEngine(tc, tp, max_seq=48, policy=T32, device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, tc.vocab_size, (2, 8)).astype(np.int32)
    res = eng.generate(prompts, 6)
    assert res.tokens.shape == (2, 6)
    seq = np.concatenate([prompts, res.tokens], axis=1)
    full, _ = api.forward(tc, tp, {"tokens": torch.from_numpy(seq.astype(np.int64))},
                          T32)
    for t in range(6):
        logits = full[:, prompts.shape[1] + t - 1].numpy()
        pred = np.argmax(logits, axis=-1)
        for b in range(logits.shape[0]):
            if pred[b] == res.tokens[b, t]:
                continue
            gap = logits[b, pred[b]] - logits[b, res.tokens[b, t]]
            assert gap < tie_gap, (t, b, gap)


def test_gen_result_timing_fields():
    """prefill_s/decode_s are read after the device finished; tokens_per_s
    is b * (n_new - 1) / decode_s, as in repro/serve/engine.py:87."""
    _, tc, _, tp = _setup(32)
    eng = TServeEngine(tc, tp, max_seq=32, device="cpu")
    prompts = np.zeros((3, 8), np.int32)
    res = eng.generate(prompts, 5)
    assert res.prefill_s > 0 and res.decode_s > 0 and res.tokens_per_s > 0
    assert res.tokens_per_s == pytest.approx(3 * (5 - 1) / res.decode_s)
    assert eng.pos.tolist() == [8 + 5] * 3
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(np.zeros((1, 30), np.int32), 5)


def test_serve_cli_runs_on_cpu(capsys):
    rows = t_serve.main(["--arch", "smollm-135m", "--reduced", "--batch", "2",
                         "--prompt-len", "128", "--new-tokens", "4",
                         "--device", "cpu"])
    assert len(rows) == 1 and rows[0]["flash_launches"] == 0
    assert rows[0]["tok_per_s"] > 0
    assert '"flash_launches": 0' in capsys.readouterr().out


# ------------------------------------------------------------------ hybrid

def _hybrid_setup(max_seq):
    """The reduced recurrentgemma, with the local_attn blocks' wq and wk
    scaled by 1/4 in the shared JAX tree: the reference's fan_in makes
    the stack's fp32 noise floor exceed the tie gap otherwise
    (tests/test_torch_models.py::_tame_local_attention says by how much)."""
    jc = reduce_for_smoke(ARCHS["recurrentgemma-9b"])
    tc = t_reduce_for_smoke(T_ARCHS["recurrentgemma-9b"])
    jp = j_init_params(j_get_api(jc).param_defs(jc, max_seq),
                       jax.random.PRNGKey(0))
    attn = jp["units"]["b2"]["attn"]
    attn["wq"], attn["wk"] = attn["wq"] * 0.25, attn["wk"] * 0.25
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _fp32_forward_logits(tc, tp, extras=None):
    """fp32 teacher-forced logits (B, S, V) of a prompt + generated
    sequence through the port's forward, with the request's ``extras``
    (numpy, e.g. whisper's frames)."""
    def forward_logits(seq):
        batch = {"tokens": torch.from_numpy(seq.astype(np.int64)),
                 **{k: torch.from_numpy(v) for k, v in (extras or {}).items()}}
        out, _ = t_get_api(tc).forward(tc, tp, batch, T32)
        return out.numpy()
    return forward_logits


def test_hybrid_serve_engine_tokens_match_jax_engine():
    """Prompt 20 and 10 new tokens: decode runs past the 16-slot window.
    The JAX engine computes in bf16 whatever policy it is given
    (ROADMAP.md, Queue 3), so a flip is tolerated where the fp32 top-2 gap
    is within twice that engine's own bf16 error on its prefill logits,
    measured here (0.15-0.21 over three prompt seeds)."""
    jc, tc, jp, tp = _hybrid_setup(40)
    prompts = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 20)).astype(np.int32)
    j_eng = JServeEngine(jc, jp, make_local_mesh(), make_variant("baseline"),
                         max_seq=40, policy=JPolicy(compute=jnp.float32))
    t_eng = TServeEngine(tc, tp, max_seq=40, policy=T32, device="cpu")
    j_res = j_eng.generate(prompts, 10)
    t_res = t_eng.generate(prompts, 10)
    assert t_res.tokens.shape == j_res.tokens.shape == (2, 10)
    j_logits, _ = j_eng._prefill(j_eng.params, jnp.asarray(prompts), {})
    j_full, _ = j_get_api(jc).forward(jc, jp, {"tokens": jnp.asarray(prompts)},
                                      JPolicy(compute=jnp.float32))
    bf16_err = float(jnp.abs(j_logits.astype(jnp.float32)
                             - j_full[:, -1]).max())
    assert j_logits.dtype == jnp.bfloat16 and bf16_err < 0.5
    _agree_up_to_ties(t_res.tokens, j_res.tokens, prompts,
                      _fp32_forward_logits(tc, tp), 2 * bf16_err)


def test_hybrid_serve_engine_tokens_match_jax_fp32_greedy():
    """The same generation against a greedy loop over the JAX model's own
    fp32 prefill and decode (what the JAX engine runs once it passes its
    policy on): tokens agree up to fp32 near ties."""
    jc, tc, jp, tp = _hybrid_setup(40)
    prompts = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 20)).astype(np.int32)
    t_res = TServeEngine(tc, tp, max_seq=40, policy=T32,
                         device="cpu").generate(prompts, 10)
    japi, j32 = j_get_api(jc), JPolicy(compute=jnp.float32)
    logits, cache = japi.prefill(jc, jp, jnp.asarray(prompts), {}, 40, j32)
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    for t in range(20, 29):
        logits, cache = japi.decode(jc, jp, cache, tok,
                                    jnp.full((2,), t, jnp.int32), j32)
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    j_tokens = np.asarray(jnp.concatenate(out, axis=1))
    _agree_up_to_ties(t_res.tokens, j_tokens, prompts,
                      _fp32_forward_logits(tc, tp))


def test_hybrid_pad_cache_leaves_state_and_window_unpadded():
    """Nothing is padded: the engine's cache buffers have the shapes and
    dtypes of the prefill's own cache, leaf for leaf.  The rglru conv
    (B, cw-1, d_rnn) and h (B, d_rnn) have no seq dim, and the
    window-clipped kv is built at min(max_seq, window)."""
    _, tc, _, tp = _hybrid_setup(40)
    eng = TServeEngine(tc, tp, max_seq=40, policy=T32, device="cpu")
    prompts = np.zeros((3, 20), np.int32)
    eng.generate(prompts, 4)
    units, tail = eng.cache["units"], eng.cache["tail"]
    n_units, dr, cw = 2, tc.d_rnn, tc.conv_width
    for key in ("b0", "b1"):
        assert units[key]["conv"].shape == (n_units, 3, cw - 1, dr)
        assert units[key]["h"].shape == (n_units, 3, dr)
    assert units["b2"]["k"].shape == (n_units, 3, tc.window, 1, tc.hd)
    assert units["b2"]["v"].shape == (n_units, 3, tc.window, 1, tc.hd)
    assert [t["h"].shape for t in tail] == [(3, dr)] * 2
    _, cache = t_get_api(tc).prefill(tc, eng.params,
                                     torch.from_numpy(prompts.astype(np.int64)),
                                     {}, 40, T32)
    assert [(t.shape, t.dtype) for t in tree_leaves(eng.cache)] == \
        [(t.shape, t.dtype) for t in tree_leaves(cache)]
    assert units["b0"]["conv"].dtype == torch.float32       # T32's compute


def test_hybrid_serve_cli_runs_on_cpu(capsys):
    rows = t_serve.main(["--arch", "recurrentgemma-9b", "--reduced",
                         "--batch", "2", "--prompt-len", "128",
                         "--new-tokens", "8", "--device", "cpu"])
    assert len(rows) == 1 and rows[0]["rglru_launches"] == 0
    assert rows[0]["flash_launches"] == 0 and rows[0]["tok_per_s"] > 0
    assert '"rglru_launches": 0' in capsys.readouterr().out


# --------------------------------------------------------------------- moe

@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
def test_moe_serve_cli_runs_on_cpu(capsys, arch):
    """A prompt of 256 (one MoE group); deepseek's MLA is never flash."""
    rows = t_serve.main(["--arch", arch, "--reduced", "--batch", "2",
                         "--prompt-len", "256", "--new-tokens", "4",
                         "--device", "cpu"])
    assert len(rows) == 1 and rows[0]["flash_launches"] == 0
    assert rows[0]["tok_per_s"] > 0
    assert '"flash_launches": 0' in capsys.readouterr().out


# ------------------------------------------------- both engines in bf16

@pytest.mark.parametrize("setup,prompt_len,max_seq", [
    (_setup, 8, 48), (_hybrid_setup, 20, 40), (_qwen_setup, 8, 48),
    (_deepseek_setup, 8, 48)],
    ids=["smollm-135m", "recurrentgemma-9b", "qwen2-moe-a2.7b",
         "deepseek-v2-lite-16b"])
def test_serve_engines_agree_under_default_policy(setup, prompt_len, max_seq):
    """Both engines under DEFAULT_POLICY (bf16 compute, fp32 params) on the
    same numpy weights: there the reference computes what it is asked to,
    so prefill logits are compared like for like.  Both come out bf16.
    Both engines round activations to bf16 at every layer, but at other
    points (XLA fuses, torch rounds each op), so the tolerance is the
    reference's own bf16 rounding error: its bf16 prefill logits against
    its fp32 forward on the same prompts, measured here (smollm 0.024,
    hybrid 0.19 on these prompts; the two engines differ by 0.008 and
    0.15).  Greedy tokens agree up to near ties of twice that error."""
    jc, tc, jp, tp = setup(max_seq)
    prompts = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, prompt_len)).astype(np.int32)
    j_eng = JServeEngine(jc, jp, make_local_mesh(), make_variant("baseline"),
                         max_seq=max_seq)
    t_eng = TServeEngine(tc, tp, max_seq=max_seq, device="cpu")
    j_logits, _ = j_eng._prefill(j_eng.params, jnp.asarray(prompts), {})
    with torch.inference_mode():
        t_logits, _ = t_eng.api.prefill(
            tc, t_eng.params, torch.from_numpy(prompts.astype(np.int64)), {},
            max_seq, t_eng.policy)
    assert j_logits.dtype == jnp.bfloat16 and t_logits.dtype == torch.bfloat16
    j_full, _ = j_get_api(jc).forward(jc, jp, {"tokens": jnp.asarray(prompts)},
                                      JPolicy(compute=jnp.float32))
    j_bf16 = np.asarray(j_logits.astype(jnp.float32))
    bf16_err = float(np.abs(j_bf16 - np.asarray(j_full[:, -1])).max())
    diff = float(np.abs(t_logits.float().numpy() - j_bf16).max())
    assert 0 < bf16_err < 0.5 and diff <= bf16_err, (diff, bf16_err)

    j_res = j_eng.generate(prompts, 6)
    t_res = t_eng.generate(prompts, 6)
    assert t_res.tokens.shape == j_res.tokens.shape == (2, 6)
    _agree_up_to_ties(t_res.tokens, j_res.tokens, prompts,
                      _fp32_forward_logits(tc, tp), 2 * bf16_err)


# ------------------------------------- the engine's buffers, reused

def _requests(setup):
    """(B, P, n_new, seed) of three requests: two of one shape, then one of
    another; the hybrid's first two decode across the 16-slot window."""
    if setup is _setup:
        return [(2, 8, 6, 1), (2, 8, 6, 2), (3, 12, 6, 3)]
    return [(2, 10, 9, 1), (2, 10, 9, 2), (1, 20, 6, 3)]


def _jax_fp32_greedy(jc, jp, prompts, n_new, max_seq, extras=None):
    """Greedy tokens of the JAX model's own fp32 prefill and decode: what
    the JAX engine runs once it passes its policy on (ROADMAP.md, Queue 3),
    as test_hybrid_serve_engine_tokens_match_jax_fp32_greedy runs it; the
    prefill takes the request's ``extras`` (numpy)."""
    japi, j32 = j_get_api(jc), JPolicy(compute=jnp.float32)
    jx = {k: jnp.asarray(v) for k, v in (extras or {}).items()}
    prefill = jax.jit(lambda p, t: japi.prefill(jc, p, t, jx, max_seq, j32))
    decode = jax.jit(lambda p, c, t, pos: japi.decode(jc, p, c, t, pos, j32))
    logits, cache = prefill(jp, jnp.asarray(prompts))
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    for t in range(prompts.shape[1], prompts.shape[1] + n_new - 1):
        logits, cache = decode(jp, cache, tok,
                               jnp.full((len(prompts),), t, jnp.int32))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("setup,max_seq", [(_setup, 48), (_hybrid_setup, 40)],
                         ids=["smollm-135m", "recurrentgemma-9b"])
def test_engine_reuses_its_buffers_across_requests(setup, max_seq):
    """One engine serves two requests of one (B, P) and then one of
    another.  The second writes the first's buffers again (the cache
    leaves are the same tensors), and each request's tokens equal those of
    a fresh engine bit for bit (the engine before its buffers: nothing
    leaks from one request into the next) and the JAX package's fp32
    greedy tokens up to fp32 near ties."""
    jc, tc, jp, tp = setup(max_seq)
    eng = TServeEngine(tc, tp, max_seq=max_seq, policy=T32, device="cpu")
    leaves = []
    for b, p, n_new, seed in _requests(setup):
        prompts = np.random.default_rng(seed).integers(
            0, jc.vocab_size, (b, p)).astype(np.int32)
        res = eng.generate(prompts, n_new)
        leaves.append(tree_leaves(eng.cache))
        fresh = TServeEngine(tc, tp, max_seq=max_seq, policy=T32,
                             device="cpu").generate(prompts, n_new)
        assert res.tokens.shape == (b, n_new)
        assert np.array_equal(res.tokens, fresh.tokens)
        assert eng.pos.tolist() == [p + n_new] * b
        _agree_up_to_ties(res.tokens,
                          _jax_fp32_greedy(jc, jp, prompts, n_new, max_seq),
                          prompts, _fp32_forward_logits(tc, tp))
    assert all(x is y for x, y in zip(leaves[0], leaves[1]))
    assert not any(x is y for x, y in zip(leaves[1], leaves[2]))
    assert set(eng._batches) == {b for b, *_ in _requests(setup)}


def _raw(x):
    """(dtype, shape, bytes) of a tensor or an array: bit-identity."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return (str(x.dtype).removeprefix("torch."), tuple(x.shape),
                t.numpy().tobytes())
    a = np.asarray(x)
    return (a.dtype.name, a.shape, a.tobytes())


@pytest.mark.parametrize("setup,max_seq", [(_setup, 48), (_hybrid_setup, 40)],
                         ids=["smollm-135m", "recurrentgemma-9b"])
def test_snapshot_of_a_reused_engine_restores_in_jax(tmp_path, setup,
                                                     max_seq):
    """The serving snapshot after the second request of one shape (the
    buffers written twice) restores in the JAX package leaf for leaf, bit
    for bit, as test_torch_checkpoint.py::test_serving_snapshot_crosses_packages
    holds a single request's; ``generated`` holds both requests."""
    from repro.checkpoint import serialization as jser
    from repro.checkpoint.chunkstore import ChunkStore as JChunkStore
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro_torch.checkpoint import serialization as tser
    from repro_torch.checkpoint.manager import CheckpointManager as TManager
    _, tc, _, tp = setup(max_seq)
    eng = TServeEngine(tc, tp, max_seq=max_seq, device="cpu")
    for b, p, n_new, seed in _requests(setup)[:2]:
        eng.generate(np.random.default_rng(seed).integers(
            0, tc.vocab_size, (b, p)).astype(np.int32), n_new)
    eng.snapshot_service(TManager(tmp_path), 2)
    payload = {"cache": eng.cache, "pos": eng.pos.to(torch.int32),
               "generated": np.concatenate(eng.generated, axis=1)}
    want = {k: _raw(v) for k, v in tser._leaf_paths(payload)}
    assert want["generated"][1] == (b, 2 * n_new)
    jmgr = JManager(tmp_path)
    jmgr.store = JChunkStore(tmp_path / "chunks")   # as _jmgr, every leg
    restored, meta = jmgr.restore(jax.tree.map(lambda _: 0, payload))
    assert meta["kind"] == "serve"
    assert {k: _raw(v) for k, v in jser._leaf_paths(restored)} == want


# ------------------------------------------ replay accounting, no card

class _FakeGraph:
    """Stands in for a captured CUDA graph: ``replay`` runs the step it
    was captured from.  The launches that run counts are not the graph's:
    ``CountedGraph`` adds those."""

    def __init__(self, step):
        self.step, self.replays = step, 0

    def replay(self):
        self.replays += 1
        with ops.uncounted():
            self.step()


def _bump(**launches):
    for name, n in launches.items():
        setattr(ops, name, getattr(ops, name) + n)


def test_counted_graph_adds_its_captured_launches_on_every_replay():
    """A capture's launches come back as the graph's and leave the counters
    as they were (a capture runs nothing); launches inside ``uncounted``
    (a warm-up) are taken back off; each replay adds the graph's."""
    ops.reset_launch_counts()
    _bump(FLASH_LAUNCHES=5)
    with ops.uncounted():
        _bump(FLASH_LAUNCHES=2, RGLRU_LAUNCHES=1)
    launches = ops.capture_launches(
        lambda: _bump(FLASH_LAUNCHES=3, RGLRU_LAUNCHES=2))
    assert launches == {"FLASH_LAUNCHES": 3, "RGLRU_LAUNCHES": 2}
    assert (ops.FLASH_LAUNCHES, ops.RGLRU_LAUNCHES) == (5, 0)
    graph = _FakeGraph(lambda: _bump(FLASH_LAUNCHES=100))
    counted = ops.CountedGraph(graph, launches)
    for _ in range(4):
        counted.replay()
    assert graph.replays == 4
    assert (ops.FLASH_LAUNCHES, ops.RGLRU_LAUNCHES) == (5 + 12, 8)
    assert (ops.QUANT_LAUNCHES, ops.DEQUANT_LAUNCHES) == (0, 0)
    ops.reset_launch_counts()


def test_graphed_engine_counts_each_request_through_replays(monkeypatch):
    """The engine's graph path on the CPU, with a fake graph in place of
    the CUDA one: a request counts the flash launches its prefill graph
    holds, one a layer, through the replay (the warm-up and the capture
    count nothing); a second request of the same key captures nothing and
    counts the same; the chunked backend is another key (no flash);
    rebinding ``params`` drops every graph; and the tokens are the eager
    engine's."""
    captures = []

    def fake_capture(step):
        with ops.uncounted():
            step()                                  # the warm-up
        captures.append(step.func.__name__)
        return ops.CountedGraph(_FakeGraph(step),
                                ops.capture_launches(step))

    def flash(q, k, v, causal=True, window=0):
        _bump(FLASH_LAUNCHES=1)
        return ref_flash_attention(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(ops, "flash_attention", flash)
    cfg = dataclasses.replace(t_reduce_for_smoke(T_ARCHS["smollm-135m"]),
                              head_dim=64)        # prefill takes flash
    params = init_params(t_get_api(cfg).param_defs(cfg, 136),
                         torch.Generator().manual_seed(0), "cpu")
    eng = TServeEngine(cfg, params, max_seq=136, policy=T32, device="cpu")
    monkeypatch.setattr(eng, "_use_graphs", lambda: True)
    monkeypatch.setattr(eng, "_capture", fake_capture)
    eager = TServeEngine(cfg, params, max_seq=136, policy=T32, device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128)).astype(np.int32)
    counts = []
    try:
        for backend in ("flash", "flash", "chunked", "chunked"):
            if len(counts) == 3:
                eng.params = dict(eng.params)       # the same tensors
            set_attention_backend(backend)
            ops.reset_launch_counts()
            res = eng.generate(prompts, 4)
            counts.append((ops.FLASH_LAUNCHES, len(captures)))
            assert np.array_equal(res.tokens,
                                  eager.generate(prompts, 4).tokens)
    finally:
        set_attention_backend("chunked")
        ops.reset_launch_counts()
    n = cfg.n_layers
    assert counts == [(n, 2), (n, 2), (0, 4), (0, 6)]
    assert captures == ["_decode_step", "_prefill_step"] * 3
    assert eng.capture_s == 0.0
