"""The port's compiled train step on the CPU.

``make_train_step_`` writes the step into its state: it must give the
pure ``make_train_step``'s values bit for bit, for every family the port
trains, and copy nothing from the host once its constants exist (the
CPU's stand-in for "capturable").  ``GraphedTrainStep`` and the loop's
graphed path run here with a fake graph in place of the CUDA one, as
``tests/test_torch_serve.py`` drives the engine's: one capture, n - 1
replays, the eager loop's losses bit for bit, the flash launches counted
through the replays, a save between replays, and a crash and resume that
captures again."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ref_flash_attention
from repro_torch.models.attention import set_attention_backend
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import loop
from repro_torch.train.state import make_train_state, train_state_template
from repro_torch.train.step import (GraphedTrainStep, make_train_step,
                                    make_train_step_)

# one arch of every family the port trains (the MoE family twice: MLA)
TRAINED = ["smollm-135m", "recurrentgemma-9b", "qwen2-moe-a2.7b",
           "deepseek-v2-lite-16b", "xlstm-1.3b", "whisper-tiny"]
MODES = {"plain": {}, "accum2": {"accum_steps": 2},
         "master_fp32": {"master_fp32": True}}
B, S = 2, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Thousands of tiny ops a step: one intra-op thread, as
    tests/test_torch_train.py runs them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1))
                            .astype(np.int32))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model), dtype=np.float32))
    return batch


def _state(cfg, master_fp32=False):
    return make_train_state(cfg, torch.Generator().manual_seed(0), S,
                            master_fp32=master_fp32, device="cpu")


def _bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ------------------------------------------------------- the in-place step

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", TRAINED)
def test_inplace_step_equals_the_pure_step(name, mode):
    """Two steps from one state: every leaf and every metric of the
    in-place step equal the pure step's bit for bit, and the state's tree
    and leaf tensors are the same objects before and after."""
    cfg = reduce_for_smoke(ARCHS[name])
    kw = dict(max_seq=S, base_lr=1e-3, warmup=1, **MODES[mode])
    master = mode == "master_fp32"
    pure, inplace = make_train_step(cfg, **kw), make_train_step_(cfg, **kw)
    want = _state(cfg, master)
    got = tree_map(torch.clone, want)
    leaves = tree_leaves(got)
    for seed in (1, 2):
        batch = _batch(cfg, B, S, seed)
        want, m_want = pure(want, batch)
        m_got = inplace(got, batch)
        assert sorted(m_got) == sorted(m_want)
        for k in m_want:
            assert _bits_equal(m_got[k], m_want[k]), k
    assert all(a is b for a, b in zip(tree_leaves(got), leaves))
    assert len(tree_leaves(got)) == len(tree_leaves(want))
    assert all(_bits_equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want)))
    assert int(got["step"]) == int(got["data_cursor"]) == 2
    assert int(got["opt"]["count"]) == 2


@pytest.mark.parametrize("name", TRAINED)
def test_warm_inplace_step_copies_nothing_from_the_host(name, monkeypatch):
    """After one warm-up step, a second in-place step (two microbatches,
    fp32 master: every path of the step) runs with ``torch.tensor`` and
    ``torch.as_tensor`` refusing: a copy from the host cannot be captured
    into a CUDA graph."""
    cfg = reduce_for_smoke(ARCHS[name])
    step_ = make_train_step_(cfg, max_seq=S, base_lr=1e-3, warmup=1,
                             accum_steps=2, master_fp32=True)
    state = _state(cfg, master_fp32=True)
    step_(state, _batch(cfg, B, S, 1))
    batch = _batch(cfg, B, S, 2)

    def refuse(*args, **kwargs):
        raise AssertionError("a copy from the host inside the step")

    with monkeypatch.context() as m:
        m.setattr(torch, "tensor", refuse)
        m.setattr(torch, "as_tensor", refuse)
        metrics = step_(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(state["step"]) == 2


# ------------------------------------------- the graphed path, no card

class _FakeGraph:
    """Stands in for a captured CUDA graph: ``replay`` runs the step it
    was captured from and writes the results into the captured outputs
    (the graph's static tensors).  The launches that run counts are not
    the graph's: ``CountedGraph`` adds those."""

    def __init__(self, step, out):
        self.step, self.out, self.replays = step, out, 0

    def replay(self):
        self.replays += 1
        with ops.uncounted():
            new = self.step()
        for k, v in new.items():
            self.out[k].copy_(v)


@pytest.fixture
def graphs(monkeypatch):
    """The loop's graphed path on the CPU: ``_use_graphs`` says yes and
    ``GraphedTrainStep._record`` makes a fake graph.  As a capture, the
    fake runs the step and counts its launches, then puts the state back:
    a capture runs nothing.  Yields the fake graphs made; flash is
    counted (one launch a call) and selected."""
    made = []

    def record(self, step):
        state = step.args[0]
        saved = [t.clone() for t in tree_leaves(state)]
        out = step()
        for t, s in zip(tree_leaves(state), saved):
            t.copy_(s)
        made.append(_FakeGraph(step, out))
        return made[-1], out

    def flash(q, k, v, causal=True, window=0):
        ops.FLASH_LAUNCHES += 1
        return ref_flash_attention(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(loop, "_use_graphs", lambda dev: True)
    monkeypatch.setattr(GraphedTrainStep, "_record", record)
    monkeypatch.setattr(ops, "flash_attention", flash)
    set_attention_backend("flash")
    ops.reset_launch_counts()
    try:
        yield made
    finally:
        set_attention_backend("chunked")
        ops.reset_launch_counts()


def _flash_cfg():
    """Reduced smollm with head_dim 64, so that a 128-token step takes
    the flash path."""
    return dataclasses.replace(reduce_for_smoke(ARCHS["smollm-135m"]),
                               head_dim=64)


_LOOP = dict(global_batch=2, seq_len=128, log_every=1, base_lr=1e-3,
             warmup=2, seed=3, device="cpu")


def _eager(monkeypatch, **kw):
    """The loop's eager path, with the fake graphs' patches lifted."""
    with monkeypatch.context() as m:
        m.setattr(loop, "_use_graphs", lambda dev: False)
        return loop.train(_flash_cfg(), **_LOOP, **kw)


def test_graphed_loop_replays_one_capture(graphs, monkeypatch):
    """n steps: one capture and n - 1 replays; the losses are the eager
    loop's bit for bit; 2 x n_layers flash launches a step (the forward
    and the remat recompute), counted through the replays: the first step
    is the eager warm-up, the capture counts nothing."""
    cfg, n = _flash_cfg(), 5
    res = loop.train(cfg, n_steps=n, **_LOOP)
    launches = ops.FLASH_LAUNCHES
    ops.reset_launch_counts()
    eager = _eager(monkeypatch, n_steps=n)
    assert len(graphs) == 1 and graphs[0].replays == n - 1
    assert res.captures == 1 and eager.captures == 0
    assert res.losses == eager.losses and len(res.losses) == n
    assert launches == ops.FLASH_LAUNCHES == n * 2 * cfg.n_layers


def test_save_between_replays_holds_the_pre_replay_values(graphs,
                                                           monkeypatch,
                                                           tmp_path):
    """A checkpoint every 2 steps of 6: each one the graphed loop wrote
    restores bit-equal to the eager loop's of the same step, though the
    replays after each save write into the tensors it saved."""
    cfg = _flash_cfg()
    loop.train(cfg, n_steps=6, ckpt_root=tmp_path / "g", ckpt_every=2,
               **_LOOP)
    _eager(monkeypatch, n_steps=6, ckpt_root=tmp_path / "e", ckpt_every=2)
    assert graphs[0].replays == 5
    template = {"train": train_state_template(cfg, _LOOP["seq_len"]),
                "data": {"seed": 0, "cursor": 0}}
    for step in (2, 4, 6):
        got, want = (CheckpointManager(tmp_path / k).restore(
            template, tmp_path / k / f"step_{step:010d}", device="cpu")[0]
            for k in ("g", "e"))
        assert int(got["train"]["step"]) == step
        assert all(_bits_equal(a, b) for a, b in zip(tree_leaves(got),
                                                     tree_leaves(want)))


def test_graphed_crash_resume_captures_again(graphs, tmp_path):
    """A crash after step 7 and a resume from the step-4 checkpoint: the
    resumed run captures again over the restored tensors and ends on the
    uninterrupted graphed run's loss exactly."""
    cfg = _flash_cfg()
    ref = loop.train(cfg, n_steps=10, **_LOOP)
    with pytest.raises(RuntimeError, match="injected failure"):
        loop.train(cfg, n_steps=10, ckpt_root=tmp_path, ckpt_every=4,
                   fail_at_step=7, **_LOOP)
    res = loop.train(cfg, n_steps=10, ckpt_root=tmp_path, ckpt_every=4,
                     **_LOOP)
    assert (res.resumed_from, res.steps_run, res.captures) == (4, 6, 1)
    assert [g.replays for g in graphs] == [9, 6, 5]
    assert res.losses[-1] == ref.losses[-1]


def test_graphed_step_captures_again_when_a_leaf_is_rebound(graphs):
    """The graph holds the addresses of the state's leaves: a rebound leaf
    (or a new batch shape) drops it and captures again, and the step then
    continues from the state it is given."""
    cfg = reduce_for_smoke(ARCHS["smollm-135m"])
    step = GraphedTrainStep(cfg, device="cpu", max_seq=S, base_lr=1e-3,
                            warmup=1)
    pure = make_train_step(cfg, max_seq=S, base_lr=1e-3, warmup=1)
    state = _state(cfg)
    want = tree_map(torch.clone, state)
    for i, b in enumerate((B, B, B, 2 * B)):
        if i == 2:
            state["params"] = tree_map(torch.clone, state["params"])
        batch = _batch(cfg, b, S, i)
        state, metrics = step(state, batch)
        want, m_want = pure(want, batch)
        assert _bits_equal(metrics["loss"], m_want["loss"])
    assert step.captures == 3 and [g.replays for g in graphs] == [1, 0, 0]
    assert all(_bits_equal(a, b) for a, b in zip(tree_leaves(state),
                                                 tree_leaves(want)))
