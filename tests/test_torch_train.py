"""The port's training path against the JAX package, on the CPU.

Inputs come from numpy with a fixed seed and both sides get the same
arrays; a JAX-initialised TrainState crosses into the port through
``train_state_from_numpy`` or through a checkpoint (jax.random and
torch.Generator draw different streams).  The comparisons run under an
fp32 Policy, where the two frameworks differ only in summation order.

Adam's first step is about lr·sign(g), so a gradient element near 0 that
rounds the other way moves its parameter by up to 2·lr: gradients and the
optimiser are held to the reference on identical inputs, and after several
steps the loss trajectory, never the raw parameters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import ARCHS, reduce_for_smoke
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.distributed.sharding import make_variant
from repro.launch.mesh import make_local_mesh
from repro.models.layers import Policy as JPolicy
from repro.models.registry import get_api as j_get_api
from repro.optim import adamw as jadamw
from repro.train.loop import train as j_train
from repro.train.state import make_train_state as j_make_train_state
from repro.train.step import make_train_step as j_make_train_step
from repro.train.step import softmax_xent as j_softmax_xent
from repro_torch.checkpoint.manager import CheckpointManager as TManager
from repro_torch.checkpoint.serialization import _leaf_paths
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce_for_smoke
from repro_torch.data.pipeline import TokenPipeline as TPipeline
from repro_torch.launch import train as t_launch_train
from repro_torch.models.layers import Policy as TPolicy
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw as tadamw
from repro_torch.train.loop import train as t_train
from repro_torch.train.state import (make_train_state, train_state_from_numpy,
                                     train_state_template)
from repro_torch.train.step import (loss_and_grads, make_train_step,
                                    make_train_step_)

J32 = JPolicy(compute=jnp.float32)
T32 = TPolicy(compute=torch.float32)
HYBRID = "recurrentgemma-9b"
MOE = ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"]
XLSTM, WHISPER = "xlstm-1.3b", "whisper-tiny"
# every arch: the dense archs, the hybrid, the MoE archs, xLSTM and whisper
PORTED = ["granite-34b", "llava-next-34b", "smollm-135m", "stablelm-12b",
          "yi-9b", HYBRID] + MOE + [XLSTM, WHISPER]
# tests/test_substrate.py:22
ADAMW_RTOL = 1e-5
# fp32 in another summation order: the loss to 1e-5 relative, and each
# gradient leaf to 1e-5 of its largest element
GRAD_RTOL = 1e-5
# The reduced xLSTM stack is 16 blocks deep and mildly chaotic
# (tests/test_torch_xlstm.py::STACK_ATOL): its own gradient noise floor
# (the JAX gradients moved by a 1e-7 relative change of the params) is
# up to 8.5e-5 of a leaf's largest element, so its leaves are held at
# 2e-4 of it; under master_fp32 at one bf16 spacing, 2^-7 of the largest
# element (GRAD_RTOL's leaves: 2^-8, test_train_step_matches_reference)
XLSTM_GRAD_RTOL = 2e-4
# the last loss of a run resumed in the other package, against the
# reference's uninterrupted run: 5-6 steps of AdamW after the crossing,
# fp32; measured 4.8e-7 and 9.5e-7 (2 and 4 ulps of the loss; PERF.md)
CROSS_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops a step; beside the
    suite's other workers, idle OpenMP threads spinning at each op's
    barrier slow it many times over (tests/test_torch_chip_smoke.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _np(t):
    return t.detach().float().numpy()


def _cfgs(name):
    return reduce_for_smoke(ARCHS[name]), t_reduce_for_smoke(T_ARCHS[name])


def _tame_attention(state):
    """wq and wk of every attention block scaled by 1/4 in the shared JAX
    params (as tests/test_torch_models.py::_tame_local_attention does for
    the hybrid); for MLA, whose keys come from w_uk, wq and w_uk.  The
    reference's fan_in is shape[-2], the head count, so at smoke widths the
    scores are large and the softmax near one-hot: the stack's own fp32
    noise floor (the JAX gradients moved by a 1e-7 relative change of the
    params) is then 1.5e-5 to 3e-5 of each leaf's largest element for
    smollm-135m and 2.8e-5 for deepseek-v2-lite, above GRAD_RTOL, and no
    implementation could meet it."""
    params = state["params"]
    if "dec_blocks" in params:                        # whisper
        blocks = [params["enc_blocks"], params["dec_blocks"]]
    else:
        blocks = list(params["units"].values()) + list(params["prefix"])
    for block in blocks:
        for name in ("attn", "self_attn", "cross_attn"):
            if name in block:
                attn = block[name]
                wk = "wk" if "wk" in attn else "w_uk"
                attn["wq"], attn[wk] = attn["wq"] * 0.25, attn[wk] * 0.25
    return state


def _jax_state(jc, s, master_fp32=False):
    """The reference's TrainState as numpy, attention tamed; under
    master_fp32 its params become the fp32 master and bf16 params, as
    make_train_state(master_fp32=True) makes them."""
    st = jax.tree.map(np.asarray, j_make_train_state(jc, jax.random.PRNGKey(0),
                                                     s))
    st = _tame_attention(st)
    if master_fp32:
        st["opt"]["master"] = st["params"]
        st["params"] = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                    st["params"])
    return st


def _batch(cfg, b, s, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["vision_embeds"] = np.ones((b, cfg.n_vision_tokens, cfg.d_model),
                                         np.float32) * 0.1
    if cfg.family == "audio":
        # seeded normal stub frames: with test_models_smoke.py's constant
        # 0.1 the cross-attention gradients are ~1e-4 and their own noise
        # floor 3e-5 of that, above GRAD_RTOL; with these it is < 1e-5
        batch["frames"] = np.random.default_rng(seed + 1).standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model), dtype=np.float32)
    return batch


def _leaf_close(got, want, rtol):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(_np(got) - want).max())
    assert err <= rtol * scale, (err, scale)


# ------------------------------------------------------------------ adamw

def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((8, 4), dtype=np.float32) * scale},
            "b": [rng.standard_normal((5,), dtype=np.float32) * scale,
                  rng.standard_normal((3, 2, 2), dtype=np.float32) * scale]}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("clip_norm", [1e9, 0.05], ids=["noclip", "clip"])
def test_adamw_update_matches_reference(clip_norm):
    """Two steps from identical numpy inputs, params and moments at rtol
    1e-5 (tests/test_substrate.py:22); the second clips when clip_norm is
    0.05 (the grads' norm is ~0.06)."""
    p, g1, g2 = _tree(0), _tree(1, 0.01), _tree(2, 0.01)
    cfg_j = jadamw.AdamWCfg(clip_norm=clip_norm)
    cfg_t = tadamw.AdamWCfg(clip_norm=clip_norm)
    jp, jopt = _to_jax(p), jadamw.init_opt_state(_to_jax(p))
    tp = _to_torch(p)
    topt = tadamw.init_opt_state(tp)
    lr_j = jnp.float32(1e-3)
    lr_t = torch.tensor(1e-3, dtype=torch.float32)
    for g in (g1, g2):
        jp, jopt, jm = jadamw.adamw_update(jp, _to_jax(g), jopt, lr_j, cfg_j)
        tp, topt, tm = tadamw.adamw_update(tp, _to_torch(g), topt, lr_t, cfg_t)
        for t, j in zip(tree_leaves(tp) + tree_leaves(topt["m"])
                        + tree_leaves(topt["v"]),
                        jax.tree.leaves(jp) + jax.tree.leaves(jopt["m"])
                        + jax.tree.leaves(jopt["v"])):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=ADAMW_RTOL)
        for k in ("grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=ADAMW_RTOL)
        assert int(topt["count"]) == int(jopt["count"])
        assert topt["count"].dtype == torch.int32
    assert (float(tm["clip_scale"]) < 1.0) == (clip_norm < 1.0)


def test_cosine_schedule_matches_reference_exactly():
    """Bit for bit in fp32 at steps 0, warmup - 1, warmup and total, and
    within an ulp or two between them (cos of two libraries)."""
    base, warmup, total = 3e-4, 20, 110
    lr_j = jadamw.cosine_schedule(base, warmup, total)
    lr_t = tadamw.cosine_schedule(base, warmup, total)
    for step in (0, warmup - 1, warmup, total):
        got = lr_t(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == np.asarray(
            lr_j(jnp.int32(step))).tobytes(), step
    for step in (5, 40, 77, 200):
        np.testing.assert_allclose(
            float(lr_t(torch.tensor(step, dtype=torch.int32))),
            float(lr_j(jnp.int32(step))), rtol=1e-6)


# --------------------------------------------------------------- pipeline

@pytest.mark.parametrize("seed", [0, 5])
def test_token_pipeline_batches_are_byte_equal(seed):
    jp, tp = JPipeline(1000, 3, 17, seed=seed), TPipeline(1000, 3, 17,
                                                          seed=seed)
    for _ in range(4):
        jb, tb = jp.next_batch(), tp.next_batch()
        for k in ("tokens", "targets"):
            assert jb[k].dtype == tb[k].dtype == np.int32
            assert jb[k].tobytes() == tb[k].tobytes()
    assert tp.snapshot() == jp.snapshot()


# ------------------------------------------------------------- one step

def _jax_loss_and_grads(jc, params, batch, accum):
    api = j_get_api(jc)

    def loss_fn(p, mb):
        logits, aux = api.forward(jc, p, mb, J32, True)
        loss = j_softmax_xent(logits, mb["targets"])
        return loss + aux, (loss, aux)

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    n = batch["tokens"].shape[0] // accum
    losses, auxes, grads = [], [], []
    for i in range(accum):
        mb = {k: jnp.asarray(v[i * n:(i + 1) * n]) for k, v in batch.items()}
        (_, (loss, aux)), g = vg(params, mb)
        losses.append(float(loss))
        auxes.append(float(aux))
        grads.append(g)
    if accum == 1:
        return losses[0], auxes[0], grads[0]
    return (float(np.mean(losses)), float(np.mean(auxes)),
            jax.tree.map(lambda *gs: sum(g.astype(jnp.float32) for g in gs)
                         / accum, *grads))


@pytest.mark.parametrize("mode", ["plain", "accum2", "master_fp32",
                                  "inplace"])
@pytest.mark.parametrize("name", ["smollm-135m", HYBRID] + MOE
                         + [XLSTM, WHISPER])
def test_train_step_matches_reference(name, mode):
    """One step from one state: the JAX TrainState crosses with
    train_state_from_numpy; loss at 1e-5 relative and every gradient leaf
    at 1e-5 of its largest element against jax.value_and_grad of the
    reference's loss (fp32 Policy, remat on).  Under master_fp32 the
    params and their gradients are bf16: each gradient may round to the
    neighbouring bf16 value (2^-8 relative).  The step itself: the new
    state's tree, dtypes, counters and rng equal the reference step's, and
    its metrics agree.  "inplace" is the plain case through
    ``make_train_step_``, which writes the new state into a copy of the
    crossed state's tensors."""
    jc, tc = _cfgs(name)
    accum = 2 if mode == "accum2" else 1
    master = mode == "master_fp32"
    B, S = 4, 32
    jstate = _jax_state(jc, S, master_fp32=master)
    tstate = train_state_from_numpy(jstate, "cpu")
    batch = _batch(tc, B, S)

    j_loss, j_aux, j_grads = _jax_loss_and_grads(
        jc, _to_jax(jstate["params"]), batch, accum)
    t_loss, t_aux, t_grads = loss_and_grads(
        tc, tstate["params"], {k: torch.from_numpy(v) for k, v in batch.items()},
        policy=T32, remat=True, accum_steps=accum)
    np.testing.assert_allclose(float(t_loss), j_loss, rtol=GRAD_RTOL)
    # the MoE load-balance loss (0 for the other archs), as the MoE tests
    np.testing.assert_allclose(float(t_aux), j_aux, rtol=0, atol=1e-6)
    assert (j_aux > 0) == (tc.moe is not None)
    if name == XLSTM:
        rtol = 2.0 ** -7 if master else XLSTM_GRAD_RTOL
    else:
        rtol = 2.0 ** -8 if master else GRAD_RTOL
    jl = jax.tree.leaves(j_grads)
    assert len(tree_leaves(t_grads)) == len(jl)
    for t, j in zip(tree_leaves(t_grads), jl):
        assert t.dtype == (torch.float32 if accum > 1 or not master
                           else torch.bfloat16)
        _leaf_close(t, j, rtol)

    t_kw = dict(accum_steps=accum, policy=T32, base_lr=1e-3, warmup=2,
                master_fp32=master, max_seq=S)
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if mode == "inplace":
        t_new = tree_map(torch.clone, tstate)
        leaves = tree_leaves(t_new)
        tm = make_train_step_(tc, None, None, **t_kw)[0](t_new, t_batch)
        assert all(a is b for a, b in zip(tree_leaves(t_new), leaves))
    else:
        t_new, tm = make_train_step(tc, None, None, **t_kw)[0](tstate,
                                                                t_batch)
    np.testing.assert_allclose(float(tm["loss"]), j_loss, rtol=GRAD_RTOL)
    # the step builds a new state and leaves its input as it was
    assert int(tstate["step"]) == 0
    for t, j in zip(tree_leaves(tstate["params"]),
                    jax.tree.leaves(jstate["params"])):
        assert np.array_equal(_np(t), np.asarray(j, np.float32))
    if master:
        for p, m in zip(tree_leaves(t_new["params"]),
                        tree_leaves(t_new["opt"]["master"])):
            assert torch.equal(p, m.to(torch.bfloat16))
    if accum > 1:
        return       # the update and the state's tree are the plain case's
    j_step, _ = j_make_train_step(jc, make_local_mesh(),
                                  make_variant("baseline"), policy=J32,
                                  base_lr=1e-3, warmup=2, master_fp32=master,
                                  max_seq=S)
    j_new, jm = jax.jit(j_step)(_to_jax(jstate), _to_jax(batch))
    j_leaves = jax.tree_util.tree_flatten_with_path(j_new)[0]
    t_leaves = _leaf_paths(t_new)
    assert [k for k, _ in t_leaves] == [
        "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in path)
        for path, _ in j_leaves]
    for (key, t), (_, j) in zip(t_leaves, j_leaves):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), key
        assert tuple(t.shape) == j.shape, key
    for k in ("step", "data_cursor", "rng"):
        assert np.array_equal(t_new[k].numpy(), np.asarray(j_new[k])), k
    assert int(t_new["opt"]["count"]) == int(j_new["opt"]["count"]) == 1
    assert float(tm["lr"]) == float(jm["lr"])
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=rtol)


def _port_batch(cfg, b, s):
    return {k: torch.from_numpy(v) for k, v in _batch(cfg, b, s).items()}


@pytest.mark.parametrize("name", PORTED)
def test_train_step_runs_and_updates(name):
    """Twin of tests/test_models_smoke.py:54 for every arch whose block
    kinds the port has: bf16 DEFAULT_POLICY, remat on."""
    cfg = t_reduce_for_smoke(T_ARCHS[name])
    B, S = 2, 32
    step, _ = make_train_step(cfg, None, None, max_seq=S, base_lr=1e-3,
                              warmup=1)
    state = make_train_state(cfg, torch.Generator().manual_seed(0), S,
                             device="cpu")
    p0 = tree_leaves(state["params"])[0].clone()
    state, metrics = step(state, _port_batch(cfg, B, S))
    assert np.isfinite(float(metrics["loss"]))
    assert int(state["step"]) == 1
    assert not torch.equal(tree_leaves(state["params"])[0], p0), \
        "params must update"


def test_remat_gives_the_same_grads():
    """remat recomputes each unit's forward in the backward: the same
    gradients, bit for bit, on the CPU."""
    cfg = t_reduce_for_smoke(T_ARCHS["smollm-135m"])
    state = make_train_state(cfg, torch.Generator().manual_seed(0), 32,
                             device="cpu")
    batch = _port_batch(cfg, 2, 32)
    _, _, g1 = loss_and_grads(cfg, state["params"], batch, remat=True)
    _, _, g0 = loss_and_grads(cfg, state["params"], batch, remat=False)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1),
                                                 tree_leaves(g0)))


# -------------------------------------------------------------- the loop

def test_training_loss_decreases():
    """Twin of tests/test_system.py:17."""
    cfg = t_reduce_for_smoke(T_ARCHS["smollm-135m"])
    res = t_train(cfg, None, None, n_steps=25, global_batch=8, seq_len=32,
                  log_every=1, base_lr=3e-3, warmup=3, seed=0, device="cpu")
    first, last = res.losses[0], np.mean(res.losses[-3:])
    assert last < first - 0.1, (first, last)
    assert len(res.step_s) == res.steps_run == 25


@pytest.mark.parametrize("name", [XLSTM, WHISPER])
def test_train_loop_runs_the_recurrent_and_audio_families(name):
    """The loop over the token pipeline for xLSTM and whisper (a whisper
    batch carries the stub frames, as the reference's batch_specs give
    it): finite losses, every step run."""
    cfg = t_reduce_for_smoke(T_ARCHS[name])
    res = t_train(cfg, None, None, n_steps=3, global_batch=2, seq_len=32,
                  log_every=1, base_lr=3e-3, warmup=1, seed=0, device="cpu")
    assert res.steps_run == len(res.losses) == 3
    assert all(np.isfinite(res.losses))


def test_train_crash_resume_loss_continuity(tmp_path):
    """Twin of tests/test_checkpoint.py:395: a crash after step 7, resumed
    from the step-4 checkpoint, ends on the uninterrupted run's loss."""
    cfg = t_reduce_for_smoke(T_ARCHS["smollm-135m"])
    kw = dict(n_steps=10, global_batch=4, seq_len=32, log_every=1, seed=5,
              device="cpu")
    ref = t_train(cfg, None, None, ckpt_root=None, **kw)
    with pytest.raises(RuntimeError):
        t_train(cfg, None, None, ckpt_root=tmp_path, ckpt_every=4,
                fail_at_step=7, **kw)
    res = t_train(cfg, None, None, ckpt_root=tmp_path, ckpt_every=4, **kw)
    assert res.resumed_from == 4          # last ckpt before the injected crash
    assert res.steps_run == 6
    assert abs(res.losses[-1] - ref.losses[-1]) < 1e-6


def test_train_cli_on_cpu_resumes(tmp_path, capsys):
    argv = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    row = t_launch_train.main(argv)
    assert row["resumed_from"] is None and row["steps_run"] == 4
    row = t_launch_train.main(argv[:6] + ["6"] + argv[7:])
    assert row["resumed_from"] == 4 and row["steps_run"] == 2
    assert np.isfinite(row["final_loss"])


# ------------------------------------------------------- across packages

_KW = dict(n_steps=10, global_batch=4, seq_len=32, log_every=1, seed=5)


@pytest.fixture(scope="module")
def jax_uninterrupted():
    """The reference's uninterrupted run, fp32."""
    jc, _ = _cfgs("smollm-135m")
    return j_train(jc, make_local_mesh(), make_variant("baseline"),
                   policy=J32, **_KW)


def test_train_state_restores_bit_for_bit_across_packages(tmp_path):
    """A JAX TrainState (uint32 rng key, int32 counters, bf16 params under
    master_fp32) saved by the reference restores in the port bit for bit,
    and the port's saved state restores in JAX bit for bit."""
    jc, tc = _cfgs("smollm-135m")
    jstate = j_make_train_state(jc, jax.random.PRNGKey(3), 32,
                                master_fp32=True)
    jmgr = JManager(tmp_path / "j")
    jmgr.save(0, jstate)
    jmgr.wait()
    template = train_state_template(tc, 32, master_fp32=True)
    got, _ = TManager(tmp_path / "j").restore(template, device="cpu")
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jstate))
    tl = tree_leaves(got)
    assert got["rng"].dtype == torch.uint32
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        if j.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            assert t.view(torch.int16).numpy().tobytes() == j.tobytes()
        else:
            assert t.numpy().dtype == j.dtype and t.numpy().tobytes() == \
                j.tobytes()
    mgr = TManager(tmp_path / "t")
    mgr.save(0, got)
    mgr.wait()
    back, _ = JManager(tmp_path / "t").restore(jstate, None)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_jax_crash_resumes_in_the_port(tmp_path, jax_uninterrupted):
    """The reference trains, checkpoints step 4 and crashes after step 7;
    the port's loop resumes from its step 4 and ends within CROSS_ATOL of
    the reference's uninterrupted run."""
    jc, tc = _cfgs("smollm-135m")
    with pytest.raises(RuntimeError):
        j_train(jc, make_local_mesh(), make_variant("baseline"), policy=J32,
                ckpt_root=tmp_path, ckpt_every=4, fail_at_step=7, **_KW)
    res = t_train(tc, None, None, ckpt_root=tmp_path, ckpt_every=4,
                  policy=T32, device="cpu", **_KW)
    assert res.resumed_from == 4 and res.steps_run == 6
    diff = abs(res.losses[-1] - jax_uninterrupted.losses[-1])
    print(f"jax -> port: last-loss difference {diff!r}")
    assert diff < CROSS_ATOL


def test_port_crash_resumes_in_jax(tmp_path, jax_uninterrupted):
    """The reverse: the reference's initial state written as step 0 (by
    the reference's own manager, here in the test); the port resumes from
    it, checkpoints step 4 and crashes after step 7; the reference resumes
    from the port's step 4 and ends within CROSS_ATOL of its uninterrupted
    run."""
    jc, tc = _cfgs("smollm-135m")
    init = j_make_train_state(jc, jax.random.PRNGKey(_KW["seed"]),
                              _KW["seq_len"])
    mgr = JManager(tmp_path, keep=3)
    mgr.save(0, {"train": init, "data": {"seed": np.int64(_KW["seed"]),
                                         "cursor": np.int64(0)}},
             meta={"step": 0, "arch": jc.name, "rules": "baseline",
                   "mesh": {"data": 1, "model": 1}})
    mgr.wait()
    with pytest.raises(RuntimeError):
        t_train(tc, None, None, ckpt_root=tmp_path, ckpt_every=4,
                fail_at_step=7, policy=T32, device="cpu", **_KW)
    res = j_train(jc, make_local_mesh(), make_variant("baseline"), policy=J32,
                  ckpt_root=tmp_path, ckpt_every=4, **_KW)
    assert res.resumed_from == 4 and res.steps_run == 6
    diff = abs(res.losses[-1] - jax_uninterrupted.losses[-1])
    print(f"port -> jax: last-loss difference {diff!r}")
    assert diff < CROSS_ATOL
