"""The port's ServeEngine and serving CLI for the xLSTM and whisper
families on the CPU, against the JAX package on the same weights and
prompts; and ``generate(prompts, 0)`` against the JAX engine's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.sharding import make_variant
from repro.launch.mesh import make_local_mesh
from repro.models.layers import Policy as JPolicy
from repro.models.registry import get_api as j_get_api
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.kernels import ops
from repro_torch.launch import serve as t_serve
from repro_torch.serve.engine import ServeEngine as TServeEngine

from test_torch_serve import (T32, _agree_up_to_ties, _arch_setup,
                              _fp32_forward_logits, _jax_fp32_greedy, _setup)

XLSTM, WHISPER = "xlstm-1.3b", "whisper-tiny"
FAMILIES = [XLSTM, WHISPER]


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


def _prompts(cfg, b, p, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, p)).astype(np.int32)


# ------------------------------------------------------------ n_new = 0

def test_generate_zero_new_tokens_matches_jax_engine():
    """n_new=0 returns what the reference returns
    (repro/serve/engine.py:59-87): the prefill's greedy token as (B, 1),
    pos = P + 1, and no decode; the port used to raise ValueError."""
    jc, tc, jp, tp = _setup(32)
    prompts = _prompts(jc, 2, 8)
    j_eng = JServeEngine(jc, jp, make_local_mesh(), make_variant("baseline"),
                         max_seq=32)
    t_eng = TServeEngine(tc, tp, max_seq=32, device="cpu")
    j_res = j_eng.generate(prompts, 0)
    t_res = t_eng.generate(prompts, 0)
    assert j_res.tokens.shape == t_res.tokens.shape == (2, 1)
    assert np.array_equal(t_res.tokens, j_res.tokens)
    assert np.asarray(j_eng.pos).tolist() == t_eng.pos.tolist() == [9, 9]
    assert t_res.decode_s < 0.1
    # the next request's first token is the same request's with n_new=1
    one = TServeEngine(tc, tp, max_seq=32, device="cpu").generate(prompts, 1)
    assert np.array_equal(one.tokens, t_res.tokens)
    with pytest.raises(ValueError, match="max_seq"):
        t_eng.generate(_prompts(jc, 2, 32), 0)     # no slot for its token
    with pytest.raises(ValueError, match="at least 0"):
        t_eng.generate(prompts, -1)


def test_generate_zero_new_tokens_on_the_graph_path(monkeypatch):
    """The same on the graphed path (a fake graph replays the captured
    step on the CPU, as test_torch_serve.py's graph tests do): tokens
    (B, 1) equal to the eager engine's, pos = P + 1, and only the prefill
    replays."""
    _, tc, _, tp = _setup(32)
    replays = []

    class Graph:
        def __init__(self, step):
            self.step = step

        def replay(self):
            replays.append(self.step.func.__name__)
            self.step()

    def fake_capture(step):
        step()                                      # the warm-up
        return ops.CountedGraph(Graph(step), {})

    eng = TServeEngine(tc, tp, max_seq=32, device="cpu")
    monkeypatch.setattr(eng, "_use_graphs", lambda: True)
    monkeypatch.setattr(eng, "_capture", fake_capture)
    prompts = _prompts(tc, 2, 8)
    res = eng.generate(prompts, 0)
    eager = TServeEngine(tc, tp, max_seq=32, device="cpu").generate(prompts, 0)
    assert res.tokens.shape == (2, 1)
    assert np.array_equal(res.tokens, eager.tokens)
    assert eng.pos.tolist() == [9, 9] and replays == ["_prefill_step"]


# ------------------------------------------------------- xLSTM, whisper

_family_setup = {name: _arch_setup(name) for name in FAMILIES}


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_engine_tokens_match_jax_fp32_greedy(name):
    """The port's engine in fp32 against a greedy loop over the JAX
    model's fp32 prefill and decode, extras included: tokens agree up to
    fp32 near ties.  Prompt 8, 8 new tokens."""
    jc, tc, jp, tp = _family_setup[name](32)
    prompts, extras = _prompts(jc, 2, 8), t_serve.request_extras(jc, 2)
    res = TServeEngine(tc, tp, max_seq=32, policy=T32,
                       device="cpu").generate(prompts, 8, extras=extras)
    assert res.tokens.shape == (2, 8)
    _agree_up_to_ties(res.tokens,
                      _jax_fp32_greedy(jc, jp, prompts, 8, 32, extras),
                      prompts, _fp32_forward_logits(tc, tp, extras))


def _bf16_prefills(name, seed=1):
    """Both engines under DEFAULT_POLICY (bf16 compute) on the same numpy
    weights and prompt (8 tokens): the engines, the inputs, both prefill
    logits (bf16, as fp32) and the JAX model's fp32 forward's last row."""
    jc, tc, jp, tp = _family_setup[name](32)
    prompts, extras = _prompts(jc, 2, 8, seed), t_serve.request_extras(jc, 2)
    j_eng = JServeEngine(jc, jp, make_local_mesh(), make_variant("baseline"),
                         max_seq=32)
    t_eng = TServeEngine(tc, tp, max_seq=32, device="cpu")
    j_logits, _ = j_eng._prefill(j_eng.params, jnp.asarray(prompts), extras)
    with torch.inference_mode():
        t_logits, _ = t_eng.api.prefill(
            tc, t_eng.params, torch.from_numpy(prompts.astype(np.int64)),
            {k: torch.from_numpy(v) for k, v in extras.items()}, 32,
            t_eng.policy)
    assert j_logits.dtype == jnp.bfloat16 and t_logits.dtype == torch.bfloat16
    j_full, _ = j_get_api(jc).forward(
        jc, jp, {"tokens": jnp.asarray(prompts),
                 **{k: jnp.asarray(v) for k, v in extras.items()}},
        JPolicy(compute=jnp.float32))
    return ((jc, tc, jp, tp, j_eng, t_eng, prompts, extras),
            np.asarray(j_logits.astype(jnp.float32)),
            t_logits.float().numpy(), np.asarray(j_full[:, -1]))


def test_whisper_serve_engines_agree_under_default_policy():
    """As test_torch_serve.py::test_serve_engines_agree_under_default_policy
    holds the other families: prefill logits within the reference's own
    bf16 error on them (0.054 here; the engines differ by 0.016), greedy
    tokens up to near ties of twice it."""
    setup, j_bf16, t_bf16, f32 = _bf16_prefills(WHISPER)
    jc, tc, jp, tp, j_eng, t_eng, prompts, extras = setup
    bf16_err = float(np.abs(j_bf16 - f32).max())
    diff = float(np.abs(t_bf16 - j_bf16).max())
    assert 0 < bf16_err < 0.5 and diff <= bf16_err, (diff, bf16_err)
    j_res = j_eng.generate(prompts, 6, extras=extras)
    t_res = t_eng.generate(prompts, 6, extras=extras)
    assert t_res.tokens.shape == j_res.tokens.shape == (2, 6)
    _agree_up_to_ties(t_res.tokens, j_res.tokens, prompts,
                      _fp32_forward_logits(tc, tp, extras), 2 * bf16_err)


@pytest.mark.parametrize("seed", [1, 2])
def test_xlstm_bf16_prefill_error_is_the_references_size(seed):
    """In bf16 the reduced xLSTM stack (16 blocks, mildly chaotic:
    tests/test_torch_xlstm.py::STACK_ATOL) ends ~1 from its fp32 logits of
    ~3.4 in both packages (the reference: 0.97 and 1.02 for these seeds),
    so two bf16 engines need not agree to within the reference's error as
    the other families do.  Each engine's bf16 error is held to twice the
    reference's (the port's: 1.58 and 0.95)."""
    _, j_bf16, t_bf16, f32 = _bf16_prefills(XLSTM, seed)
    bf16_err = float(np.abs(j_bf16 - f32).max())
    port_err = float(np.abs(t_bf16 - f32).max())
    assert 0 < bf16_err < 2.0 and port_err <= 2 * bf16_err, \
        (port_err, bf16_err)


def test_xlstm_engine_reuses_its_buffers_across_requests():
    """Two requests of one shape on one engine: the second writes the
    first's state buffers again, in place (C among them), and its tokens
    equal a fresh engine's bit for bit."""
    _, tc, _, tp = _family_setup[XLSTM](32)
    eng = TServeEngine(tc, tp, max_seq=32, policy=T32, device="cpu")
    eng.generate(_prompts(tc, 2, 8, 1), 6)
    c_first = eng.cache["units"]["b0"]["C"]
    res = eng.generate(_prompts(tc, 2, 8, 2), 6)
    assert eng.cache["units"]["b0"]["C"] is c_first
    fresh = TServeEngine(tc, tp, max_seq=32, policy=T32,
                         device="cpu").generate(_prompts(tc, 2, 8, 2), 6)
    assert np.array_equal(res.tokens, fresh.tokens)


@pytest.mark.parametrize("name,prompt", [(XLSTM, 32), (WHISPER, 16)])
def test_serve_cli_runs_on_cpu(capsys, name, prompt):
    """The CLI on the CPU: xLSTM with a prompt of one chunk, whisper with
    its stub frames (the CLI's extras); neither launches a kernel there."""
    rows = t_serve.main(["--arch", name, "--reduced", "--batch", "2",
                         "--prompt-len", str(prompt), "--new-tokens", "4",
                         "--device", "cpu"])
    assert len(rows) == 1 and rows[0]["flash_launches"] == 0
    assert rows[0]["tok_per_s"] > 0
    assert '"flash_launches": 0' in capsys.readouterr().out


def test_whisper_engine_keys_its_prompt_by_the_frames():
    """The frames are part of the prefill's key (shape and dtype) and are
    copied into the engine's static input each request: a second request
    with other frames gives a fresh engine's tokens."""
    jc, tc, jp, tp = _family_setup[WHISPER](32)
    prompts = _prompts(tc, 2, 8)
    eng = TServeEngine(tc, tp, max_seq=32, policy=T32, device="cpu")
    eng.generate(prompts, 4, extras=t_serve.request_extras(tc, 2))
    other = {"frames": np.random.default_rng(5).standard_normal(
        (2, tc.encoder.n_frames, tc.d_model)).astype(np.float32)}
    res = eng.generate(prompts, 4, extras=other)
    fresh = TServeEngine(tc, tp, max_seq=32, policy=T32,
                         device="cpu").generate(prompts, 4, extras=other)
    assert np.array_equal(res.tokens, fresh.tokens)
    assert len(eng._prompts) == 1
    (key,) = eng._prompts
    assert key[1] == (("frames", (2, 16, tc.d_model), torch.float32),)
