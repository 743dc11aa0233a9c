"""chip_smoke.py without a card: it refuses to run and prints no result,
and its phases, driven on the CPU with every kernel replaced by a counting
plain version and both models narrowed to smoke widths (head_dim 64, so
prefill takes the flash path), pass.  The kernels themselves are only
checked on the card, by chip_smoke.py's kernels phase."""
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qk
from repro_torch.kernels import rglru as rk
from repro_torch.kernels.ref import (ref_dequantize_int8, ref_flash_attention,
                                     ref_quantize_int8, ref_rglru)
from repro_torch.launch import serve
from repro_torch.models import xlstm as t_xl
from repro_torch.models.attention import set_attention_backend
from repro_torch.models.rglru import set_recurrence_backend

ROOT = Path(__file__).resolve().parents[1]


def _run(script: Path, cwd: Path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    proc = _run(ROOT / "chip_smoke.py", ROOT)
    assert proc.returncode != 0 and proc.stdout == "", proc.stdout
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    proc = _run(lone, tmp_path)
    assert proc.returncode != 0 and proc.stdout == "", proc.stdout


def _counting(counter, plain):
    def fn(*args, **kwargs):
        setattr(ops, counter, getattr(ops, counter) + 1)
        return plain(*args, **kwargs)
    return fn


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "DEV", "cpu")
    tiny = dataclasses.replace(reduce_for_smoke(ARCHS["smollm-135m"]),
                               name="smoke-hd64", head_dim=64, n_layers=3)
    hybrid = dataclasses.replace(reduce_for_smoke(ARCHS["recurrentgemma-9b"]),
                                 name="smoke-hybrid-hd64", head_dim=64,
                                 window=64)
    moe = dataclasses.replace(reduce_for_smoke(ARCHS["qwen2-moe-a2.7b"]),
                              name="smoke-moe-hd64", head_dim=64)
    mla = dataclasses.replace(reduce_for_smoke(ARCHS["deepseek-v2-lite-16b"]),
                              name="smoke-mla")
    xlstm = dataclasses.replace(reduce_for_smoke(ARCHS["xlstm-1.3b"]),
                                name="smoke-xlstm")
    whisper = dataclasses.replace(reduce_for_smoke(ARCHS["whisper-tiny"]),
                                  name="smoke-whisper-hd64", head_dim=64)
    for cfg in (tiny, hybrid, moe, mla, xlstm, whisper):
        monkeypatch.setitem(ARCHS, cfg.name, cfg)
    monkeypatch.setattr(mod, "ARCH", tiny.name)
    monkeypatch.setattr(mod, "HYBRID", hybrid.name)
    monkeypatch.setattr(mod, "MOE", moe.name)
    monkeypatch.setattr(mod, "MLA", mla.name)
    monkeypatch.setattr(mod, "XLSTM", xlstm.name)
    monkeypatch.setattr(mod, "WHISPER", whisper.name)
    # chunks of 32: the parity's 64 tokens cross one, as 512 cross one of 256
    monkeypatch.setattr(t_xl, "CHUNK", 32)
    monkeypatch.setattr(mod, "XLSTM_PARITY", dict(prompt=64, split=32,
                                                  cut_seq=32, cut_prefill=24,
                                                  greedy=4))
    monkeypatch.setattr(mod, "XLSTM_SERVE",
                        dict(batch=2, prompt=64, new_tokens=4))
    monkeypatch.setattr(mod, "WHISPER_SERVE",
                        dict(batch=2, prompt=128, new_tokens=4))
    monkeypatch.setattr(mod, "WHISPER_FLASH_SHAPE",
                        dict(b=2, h=4, kv=4, s=128, hd=64))
    monkeypatch.setattr(mod, "MOE_SERVE",
                        dict(batch=2, prompt=256, new_tokens=4))
    monkeypatch.setattr(mod, "MOE_FLASH_SHAPE",
                        dict(b=2, h=4, kv=4, s=256, hd=64))
    monkeypatch.setattr(mod, "HYBRID_PARITY_PROMPT", 128)
    monkeypatch.setattr(mod, "HYBRID_SERVE",
                        dict(batch=2, prompt=128, new_tokens=4))
    monkeypatch.setattr(mod, "HYBRID_FLASH_SHAPE",
                        dict(b=2, h=4, kv=1, s=128, hd=64, window=64))
    monkeypatch.setattr(mod, "RGLRU_SHAPE", (2, 128, 64))
    monkeypatch.setattr(mod, "QUANT_N", 4096)
    monkeypatch.setattr(mod, "TRAIN", dict(batch=2, seq=128, steps=10, lr=1e-3,
                                           warmup=2, ckpt_every=4, fail_at=7,
                                           seed=0))
    # 128 tokens: flash's multiple, a length the MoE groups and the
    # 32-token xLSTM chunks divide
    monkeypatch.setattr(mod, "FAMILY_TRAIN", dict(batch=2, seq=128))
    monkeypatch.setattr(mod, "cuda_ms", lambda fn: (fn(), 1.0)[1])
    monkeypatch.setattr(mod, "REMOTE_SERVERS", "threads")

    def flash(q, k, v, causal=True, window=0):
        return ref_flash_attention(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(ops, "flash_attention",
                        _counting("FLASH_LAUNCHES", flash))
    monkeypatch.setattr(ops, "rglru", _counting("RGLRU_LAUNCHES", ref_rglru))
    monkeypatch.setattr(ops, "quantize_int8",
                        _counting("QUANT_LAUNCHES", ref_quantize_int8))
    monkeypatch.setattr(ops, "dequantize_int8",
                        _counting("DEQUANT_LAUNCHES", ref_dequantize_int8))
    monkeypatch.setattr(
        fa, "flash_attention_fwd",
        lambda q, k, v, *, causal=True, window=0, scale=None:
        ref_flash_attention(q, k, v, causal=causal, window=window))
    monkeypatch.setattr(fa, "library_tiles",
                        lambda dtype, hd: fa.TILES[(dtype, hd)])
    monkeypatch.setattr(rk, "rglru_scan",
                        lambda a, x, h0, counts=None: ref_rglru(a, x, h0))
    monkeypatch.setattr(qk, "quantize_int8", ref_quantize_int8)
    monkeypatch.setattr(qk, "dequantize_int8", ref_dequantize_int8)
    run = serve.run

    def run_on_cpu(argv):
        set_attention_backend("flash")      # what run() selects on CUDA
        set_recurrence_backend("kernel")
        return run(argv + ["--device", "cpu"])

    monkeypatch.setattr(serve, "run", run_on_cpu)
    # one intra-op thread: the phases run thousands of tiny ops (training
    # most), and with the suite's other workers on the same cores, idle
    # OpenMP threads spinning at every op's barrier slowed this test from
    # 7 s to over 100 s; with one thread it takes 20 s under that load
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield mod
    finally:
        torch.set_num_threads(threads)
        set_attention_backend("chunked")
        set_recurrence_backend("scan")


def test_chip_smoke_phases_on_cpu(smoke, capsys):
    card = "cpu rehearsal, 0 W"
    errs = smoke.phase_kernels(card)
    assert errs == {"flash_attention_fwd": {"serve": 0.0, "serve-hybrid": 0.0,
                                            "serve-parity": 0.0,
                                            "serve-parity-hybrid": 0.0,
                                            "serve-moe": 0.0,
                                            "serve-parity-moe": 0.0,
                                            "serve-whisper": 0.0,
                                            "serve-whisper-parity": 0.0,
                                            "train": 0.0},
                    "rglru_scan": {"serve-hybrid": 0.0,
                                   "serve-parity-hybrid": 0.0,
                                   "bf16-inputs": 0.0},
                    "quantize_int8": 0.0, "dequantize_int8": 0.0}
    smoke.phase_serve_parity(card)
    counts = {"serve": smoke.phase_serve(card)}
    smoke.phase_checkpoint(card)
    smoke.phase_serve_parity_hybrid(card)
    counts["serve-hybrid"] = smoke.phase_serve_hybrid(card)
    smoke.phase_snapshot_hybrid(card)
    smoke.phase_serve_parity_moe(card)
    counts["serve-moe"] = smoke.phase_serve_moe(card)
    counts["serve-mla"] = smoke.phase_serve_mla(card)
    smoke.phase_serve_parity_xlstm(card)
    counts["serve-xlstm"] = smoke.phase_serve_xlstm(card)
    counts["serve-whisper"] = smoke.phase_serve_whisper(card)
    counts["train"] = smoke.phase_train(card)
    smoke.phase_train_resume(card)
    counts["train-families"] = smoke.phase_train_families(card)
    counts["checkpoint-remote"] = smoke.phase_checkpoint_remote(card)
    # 3 attn layers; the tiny hybrid has 2 local_attn and 6 rglru blocks;
    # the tiny qwen 2 moe blocks, deepseek's MLA never takes flash; xLSTM
    # runs no kernel, the tiny whisper 2 decoder blocks take flash;
    # training launches flash twice a layer (remat), 10 steps; the
    # families' 3 graphed steps: the hybrid's 5-layer cut 1 local_attn, the
    # tiny qwen 2 blocks, the tiny whisper 2 decoder blocks; the remote
    # phase's three legs one step each, and the hybrid leg one prefill
    assert counts == {
        "serve": {"flash_attention_fwd": 3, "rglru_scan": 0,
                  "quantize_int8": 0, "dequantize_int8": 0},
        "serve-hybrid": {"flash_attention_fwd": 2, "rglru_scan": 6,
                         "quantize_int8": 0, "dequantize_int8": 0},
        "serve-moe": {"flash_attention_fwd": 2, "rglru_scan": 0,
                      "quantize_int8": 0, "dequantize_int8": 0},
        "serve-mla": {"flash_attention_fwd": 0, "rglru_scan": 0,
                      "quantize_int8": 0, "dequantize_int8": 0},
        "serve-xlstm": {"flash_attention_fwd": 0, "rglru_scan": 0,
                        "quantize_int8": 0, "dequantize_int8": 0},
        "serve-whisper": {"flash_attention_fwd": 2, "rglru_scan": 0,
                          "quantize_int8": 0, "dequantize_int8": 0},
        "train": {"flash_attention_fwd": 60, "rglru_scan": 0,
                  "quantize_int8": 0, "dequantize_int8": 0},
        "train-families": {"flash_attention_fwd": 3 * 2 * (1 + 2 + 2),
                           "rglru_scan": 0, "quantize_int8": 0,
                           "dequantize_int8": 0},
        "checkpoint-remote": {"flash_attention_fwd": 3 * 6 + 2,
                              "rglru_scan": 6, "quantize_int8": 0,
                              "dequantize_int8": 0}}
    timing = smoke.phase_timing(card)
    row = timing[("flash_attention_fwd", "serve")]
    # q + o (36x128x64) and k, v (12x128x64), bf16, over 3.35 TB/s
    assert row["bound_by"] == "bytes"
    assert row["bound_ms"] == pytest.approx(1_572_864 / 3.35e12 * 1e3)
    assert row["share_of_bound"] == pytest.approx(row["bound_ms"] / row["ms"])
    line = smoke.kernels_line(errs, counts, timing)["kernels"]
    assert [k["name"] for k in line] == ["flash_attention_fwd", "rglru_scan",
                                         "quantize_int8", "dequantize_int8"]
    assert [k["launches"] for k in line] == [119, 12, 0, 0]
    assert line[0]["launches_by_path"] == {"serve": 3, "serve-hybrid": 2,
                                           "serve-moe": 2, "serve-mla": 0,
                                           "serve-xlstm": 0,
                                           "serve-whisper": 2, "train": 60,
                                           "train-families": 30,
                                           "checkpoint-remote": 20}
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(k) and (ROOT / k["source"]).exists() for k in line)
    flash = line[0]
    assert set(flash["instantiations"]) == {"bfloat16", "float32"}
    assert "tensor cores" in flash["instantiations"]["bfloat16"]
    assert all({"tflops", "share_of_bound"} <= set(at)
               for at in flash["at_shapes"].values())
    rglru = line[1]
    assert set(rglru["at_shapes"]) == {"serve-hybrid", "serve-parity-hybrid",
                                       "bf16-inputs"}
    assert rglru["max_abs_err"] == 0.0 and rglru["launches"] == 12
    scratch = timing[("rglru_scan", "serve-hybrid")]["scratch"]
    assert scratch["tiles"] == 2 * 2 * 1       # 2 chunks x 2 rows x 1 tile
    assert {"serving_ms", "counting_ms"} <= set(scratch)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"phase"')]
    assert [ln["phase"] for ln in lines] == [
        "kernels", "serve-parity", "serve", "checkpoint",
        "serve-parity-hybrid", "serve-hybrid", "snapshot-hybrid",
        "serve-parity-moe", "serve-moe", "serve-mla", "serve-parity-xlstm",
        "serve-xlstm", "serve-whisper", "train", "train-resume",
        "train-families", "checkpoint-remote", "timing"]
    assert all(ln["ok"] for ln in lines)
    phase = {ln["phase"]: ln for ln in lines}
    # the smollm snapshot: k and v of the stacked cache, pos, generated
    assert phase["serve"]["snapshot"]["n_leaves"] == 4
    for name in ("serve", "serve-hybrid", "serve-moe", "serve-mla",
                 "serve-xlstm", "serve-whisper"):
        _check_graph_fields(phase[name])
    _check_moe_phases(phase, smoke)
    _check_family_phases(phase, smoke)
    assert phase["snapshot-hybrid"]["capture_s"] == 0.0
    ckpt = phase["checkpoint"]
    assert ckpt["leaves_equal"] and ckpt["resave"]["last_bytes_written"] == 0
    assert ckpt["resave"]["last_bytes_referenced"] == ckpt["param_bytes"]
    snap = phase["snapshot-hybrid"]
    assert snap["prefill_launches"] == {"flash": 2, "rglru": 6}
    assert snap["leaves_equal"] and snap["tokens_equal"]
    assert snap["logits_max_abs_diff"] == 0.0
    assert len(snap["continuation_tokens"][0]) == smoke.SNAPSHOT_CONTINUE
    train = phase["train"]
    assert train["flash_launches_per_step"] == train["expected_per_step"] == 6
    assert train["last_loss"] < train["first_loss"]
    assert train["tok_per_s"] == pytest.approx(256 / train["step_s"])
    assert max(train["flash_grad_gap_at_train_shape"].values()) == 0.0
    assert train["step_grads_at_cut"]["grad_gap"] <= smoke.PARITY_TOL
    _check_train_graph_fields(train)
    resume = phase["train-resume"]
    assert (resume["resumed_from"], resume["steps_after_resume"]) == (4, 6)
    assert resume["last_loss_diff"] == 0.0
    assert resume["train_state"]["leaves_equal"]
    assert resume["train_state"]["rng_dtype"] == "torch.uint32"
    assert resume["captures"] == {"uninterrupted": 0, "resumed": 0}
    _check_train_families(phase["train-families"], smoke)
    _check_remote_phase(phase["checkpoint-remote"])


def test_chip_smoke_elastic_phase_on_cpu(smoke, capsys, monkeypatch):
    """The elastic phase at smoke widths: a 4-rank CPU world saves, this
    process restores onto its 1-rank mesh and serves (3 flash launches, one
    per layer), a 2-rank world restores the tree under both layouts."""
    monkeypatch.setattr(smoke, "ELASTIC", dict(smoke.ELASTIC, new_tokens=4))
    counts = smoke.phase_elastic("cpu rehearsal, 0 W")
    assert counts == {"flash_attention_fwd": 3, "rglru_scan": 0,
                      "quantize_int8": 0, "dequantize_int8": 0}
    line = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith('{"phase": "elastic"'))
    assert line["ok"]
    save, restore, serve = line["save"], line["restore"], line["serve"]
    assert sorted(r["rank"] for r in save["per_rank"]) == [0, 1, 2, 3]
    # the ranks at data coordinate 1 hold replicas and write nothing
    assert all((r["bytes_written"] > 0) == (r["coord"][0] == 0)
               for r in save["per_rank"])
    assert save["raw_bytes_in_manifest"] == line["param_bytes"]
    embed = save["windows"]["embed/embedding"]
    assert [w for w, _ in embed] == [[[0, 128], [0, 64]], [[128, 256],
                                                           [0, 64]]]
    assert restore["leaves_equal"] and restore["meta"] == {
        "source_world": {"n_devices": 4},
        "restored_onto": {"devices": 1, "mesh": {"data": 1, "model": 1}},
        "topology_changed": True, "generation": 0}
    assert serve["tokens_equal"] and serve["logits_equal"]
    assert [r["rank"] for r in line["reverse"]] == [0, 1]
    for r in line["reverse"]:
        assert r["baseline"]["mesh"] == {"data": 1, "model": 2}
        assert r["fsdp"]["mesh"] == {"data": 2, "model": 1}
        assert r["baseline"]["leaves_equal"] and r["fsdp"]["leaves_equal"]


def test_chip_smoke_sharded_phase_on_cpu(smoke, capsys, monkeypatch):
    """The sharded phase at smoke widths: the hybrid through the engine on
    this process's 1-rank mesh beside the plain engine over the same
    storage (one flash launch per local_attn block, one RG-LRU launch per
    rglru block, through local_map), bit-equal captured and uncaptured; a
    fresh process's first DTensor; a 2-rank CPU world at the smoke widths
    (the card's run adds a 4-rank one), cut to 2 layers, each rank
    holding its windows."""
    monkeypatch.setattr(smoke, "SHARDED", dict(
        smoke.SHARDED, new_tokens=4, worlds=((2, (1, 2)),)))
    counts = smoke.phase_sharded("cpu rehearsal, 0 W")
    kinds = ARCHS[smoke.HYBRID].layer_kinds()
    assert counts == {"flash_attention_fwd": kinds.count("local_attn"),
                      "rglru_scan": kinds.count("rglru"),
                      "quantize_int8": 0, "dequantize_int8": 0}
    line = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith('{"phase": "sharded"'))
    assert line["ok"] and line["storage_shared"]
    assert line["tokens_equal"] and line["logits_equal"]
    assert line["uncaptured_tokens_equal"]
    for name in ("plain", "sharded"):
        assert line[name]["decode_step_ms"] > 0
        assert line[name]["uncaptured_decode_step_ms"] > 0
    assert line["first_dtensor"]["first_op_s"] > 0
    runs = line["worlds"]["runs"]
    assert [(w["ranks"], w["mesh"]) for w in runs] == [
        (2, {"data": 1, "model": 2})]
    for w in runs:
        for r in w["per_rank"]:
            assert r["tokens_equal"] and len(r["block_max_abs_diff"]) == 2
            assert r["param_bytes"] == r["param_window_bytes"] \
                < r["param_bytes_whole"]
            assert r["cache_bytes"] == r["cache_window_bytes"]
            # the smoke widths' 4 heads divide model = 2 (dim 2 of the
            # stacked (L, D, H, hd) wq)
            assert "Shard(dim=2)" in r["split"]["wq"]


def test_chip_smoke_elastic_phase_fails_on_a_corrupted_shard(smoke, capsys,
                                                             monkeypatch):
    """One element of rank 1's restored shard changed in the 2-rank world:
    that rank's comparison, and with it the phase, fails."""
    monkeypatch.setattr(smoke, "ELASTIC", dict(smoke.ELASTIC, new_tokens=4))
    monkeypatch.setattr(smoke, "CORRUPT_RANK", 1)
    with pytest.raises(smoke.PhaseFailed, match="elastic"):
        smoke.phase_elastic("cpu rehearsal, 0 W")
    line = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith('{"phase": "elastic"'))
    assert line["restore"]["leaves_equal"] and line["serve"]["tokens_equal"]
    assert [(r["baseline"]["leaves_equal"], r["fsdp"]["leaves_equal"])
            for r in line["reverse"]] == [(True, True), (False, False)]


def _check_train_graph_fields(train):
    """The train line's graph fields, as the CPU runs them: the loop is
    eager there (no capture), so the graphed-vs-eager check holds the pure
    step's run against the pure and the in-place eager runs; the eager
    step and the loop's step each timed and profiled."""
    assert train["captures"] == 0 and train["capture_s"] == 0.0
    assert train["reserved_bytes"] is None
    check = train["graphed_vs_eager"]
    assert check["equal"] and check["losses_equal"] and check["launches_equal"]
    assert check["leaves_equal"] == {"pure": True, "inplace": True}
    assert set(check["runs"]) == {"pure", "inplace", "graphed"}
    runs = check["runs"]
    assert check["steps"] == len(runs["graphed"]["losses"]) == 3
    assert runs["graphed"]["launches"]["flash_attention_fwd"] == 3 * 6
    assert check["nondeterministic_ops"] == []
    ways = train["step_before_after"]
    assert set(ways) == {"eager", "graphed"}
    assert train["step_s_before"] == ways["eager"]["step_s"] > 0
    assert train["step_s_after"] == ways["graphed"]["step_s"] > 0
    for way in ways.values():
        assert len(way["step_s_all"]) == 3
        assert way["profile"]["wall_s"] > 0 and way["profile"]["top"]


def _check_train_families(line, smoke):
    """train-families: every family's graphed run (eager here) against its
    eager in-place run, losses, launches and leaves equal; the hybrid's 0
    RG-LRU launches; each family at its depth cut."""
    fams = line["families"]
    assert list(fams) == [smoke.HYBRID, smoke.MOE, smoke.MLA, smoke.XLSTM,
                          smoke.WHISPER]
    assert [f["cut_layers"] for f in fams.values()] == [5, 2, 2, 8, None]
    for f in fams.values():
        assert f["equal"] and f["leaves_equal"] == {"inplace": True}
        assert f["steps"] == 3 and (f["batch"], f["seq"]) == (2, 128)
        assert all(map(math.isfinite, f["runs"]["graphed"]["losses"]))
    assert fams[smoke.HYBRID]["runs"]["graphed"]["launches"][
        "rglru_scan"] == 0
    assert line["launches"]["flash_attention_fwd"] == 30


def test_chip_smoke_failed_train_capture_fails_the_phase(smoke, monkeypatch):
    """A capture that fails in the loop's graphed step raises out of the
    phase: nothing falls back to the eager step, and no phase catches it
    (``main`` catches only ``PhaseFailed``, and exits non-zero on either).
    Driven on the CPU with the graphed path selected and a capture that
    fails."""
    from repro_torch.train import loop
    from repro_torch.train.step import GraphedTrainStep

    def fail(self, step):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(loop, "_use_graphs", lambda dev: True)
    monkeypatch.setattr(GraphedTrainStep, "_record", fail)
    with pytest.raises(RuntimeError, match="stream is capturing"):
        smoke.phase_train_families("cpu rehearsal, 0 W")
    assert not torch.are_deterministic_algorithms_enabled()


def _check_graph_fields(line):
    """A serve line's graph checks, as the CPU runs them: the eager steps
    (no capture), a second request counting what the first did, both
    requests bit-equal to their uncaptured runs, and a profile of one
    decode step and one prefill both ways."""
    assert line["capture_s"] == 0.0 and not line["recaptured"]
    assert line["tokens_equal"] == line["logits_equal"] == [True, True]
    assert line["logits_max_abs_diff"] == [0.0, 0.0]
    second = line["second_request"]
    assert second["launches"] == line["launches"]
    assert second["prefill_s"] > 0 and second["decode_s"] > 0
    assert second["decode_step_ms"] == pytest.approx(
        second["decode_s"] / (line["new_tokens"] - 1) * 1e3)
    assert line["uncaptured"]["prefill_s"] > 0
    assert line["uncaptured"]["decode_step_ms"] > 0
    profiles = line["profiles"]
    assert set(profiles) == {"decode", "prefill"}
    for ways in profiles.values():
        assert set(ways) == {"uncaptured", "captured"}
        assert all(w["wall_s"] > 0 and w["device_ops"] is None
                   and w["top"] for w in ways.values())


def _check_moe_phases(phase, smoke):
    """serve-parity-moe: every block held (the tiny qwen's 2), routing
    compared on each moe block; serve-moe and serve-mla: the decode step
    beside its weight-read bound; serve-mla: absorbed against expanded MLA
    on both layers, the compressed cache smaller than an expanded one, and
    the snapshot's leaves (c_kv and k_rope of the prefix block and of the
    stacked units, pos, generated)."""
    parity = phase["serve-parity-moe"]
    assert parity["blocks"] == {"moe": 2}
    assert parity["prefill_launches"] == {"flash": 2, "rglru": 0}
    assert len(parity["routing_flips"]) == 2
    assert parity["block_max_abs_diff"]["moe"] <= smoke.PARITY_TOL
    assert parity["prompt"] == 512                      # two MoE groups
    for name in ("serve-moe", "serve-mla"):
        bound = phase[name]["decode_bound"]
        assert 0 < bound["bound_ms"] and bound["weight_bytes"] > 0
        assert bound["state_bytes"] > 0          # the K/V or MLA cache read
        assert bound["share_of_bound"] == pytest.approx(
            bound["bound_ms"] / phase[name]["second_request"]["decode_step_ms"])
    mla = phase["serve-mla"]
    absorbed = mla["absorbed_vs_expanded"]
    assert absorbed["layers"] == 2
    assert absorbed["max_diff_over_scale"] <= smoke.PARITY_TOL
    assert absorbed["max_abs_diff"] <= smoke.PARITY_TOL    # at smoke widths
    assert len(absorbed["per_layer"]["noise_floor"]) == 2
    assert mla["cache"]["compressed_bytes"] < mla["cache"]["expanded_bytes"]
    assert mla["snapshot"]["valid"]
    assert mla["snapshot"]["n_leaves"] == 2 * 2 + 2


def _check_family_phases(phase, smoke):
    """serve-parity-xlstm: every block of the tiny xLSTM (14 mLSTM and 2
    sLSTM) held, the chunkwise form over two chunks against one chunk and
    recurrent steps, end to end at the one-unit cut, card against CPU
    (here both the CPU); serve-xlstm: the sLSTM and mLSTM blocks' share of
    the prefill, the state a decode step reads and writes; serve-whisper:
    its fp32 parity (2 decoder blocks, 2 flash launches), the snapshot's
    cross K/V."""
    parity = phase["serve-parity-xlstm"]
    blocks = parity["blocks"]
    assert (blocks["mlstm"]["blocks"], blocks["slstm"]["blocks"]) == (14, 2)
    assert all(r["held"] and r["max_abs_diff"] <= smoke.REFERENCE_TOL
               for r in blocks.values())
    cut = parity["cut"]
    assert cut["layers"] == 8 and cut["held"] and not cut["bad_flips"]
    assert cut["logits_diff"] <= smoke.REFERENCE_TOL
    assert cut["card_vs_cpu_logits_diff"] == 0.0    # both on the CPU here
    assert len(cut["tokens_engine"][0]) == 4
    assert not any(parity["launches"].values())
    xlstm = phase["serve-xlstm"]
    assert xlstm["launches"] == {k: 0 for k in xlstm["launches"]}
    times = xlstm["block_times"]
    assert times["prefill_ms"]["uncaptured"] > 0
    assert times["prefill_ms"]["captured"] is None              # no card
    assert (times["mlstm"]["blocks"], times["slstm"]["blocks"]) == (14, 2)
    for kind in ("mlstm", "slstm"):
        assert times[kind]["block_ms"]["uncaptured"] > 0
        assert times[kind]["block_ms"]["captured"] is None     # no card
        assert times[kind]["share_of_prefill"]["uncaptured"] > 0
    bound = xlstm["decode_bound"]
    assert bound["state_bytes"] > 0 and bound["weight_bytes"] > 0
    whisper = phase["serve-whisper"]
    assert whisper["parity"]["held"] and whisper["parity"]["blocks"] == 2
    assert whisper["parity"]["prefill_launches"] == 2
    assert whisper["launches"]["flash_attention_fwd"] == 2
    assert whisper["snapshot"]["valid"]
    assert whisper["snapshot"]["cross_leaves"] == ["cache/dec/cross/k",
                                                   "cache/dec/cross/v"]
    # k, v of the self and the cross cache, stacked; pos, generated
    assert whisper["snapshot"]["n_leaves"] == 4 + 2


def test_chip_smoke_decode_bound_counts_weights_and_state(smoke):
    """decode_bound on tiny engines: the weights once, the input
    embedding left out unless tied (whisper's lm_head reads it all); the
    state the step moves: an xLSTM block's C, n, m and conv window read
    and written, a K/V cache read up to P + n_new/2 slots and one slot
    written, whisper's cross K/V read whole."""
    import numpy as np
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.models.registry import get_api
    from repro_torch.serve.engine import ServeEngine

    def engine(name, b, p, max_seq, **extras):
        cfg = ARCHS[name]
        params = init_params(get_api(cfg).param_defs(cfg, max_seq),
                             torch.Generator().manual_seed(0), "cpu")
        eng = ServeEngine(cfg, params, max_seq=max_seq, device="cpu")
        eng.generate(np.zeros((b, p), np.int32), 2, extras=extras)
        return eng

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    eng = engine("smoke-xlstm", 2, 8, 16)
    bound = smoke.decode_bound(eng, 2, 8, 4)
    emb = eng.params["embed"]["embedding"]
    assert bound["weight_bytes"] == nbytes(eng.params) - emb.numel() * 2
    assert bound["state_bytes"] == 2 * nbytes(eng._batches[2].cache)
    assert bound["bound_ms"] == pytest.approx(
        (bound["weight_bytes"] + bound["state_bytes"]) / 3.35e12 * 1e3)
    cfg = ARCHS["smoke-whisper-hd64"]
    eng = engine(cfg.name, 2, 8, 16, frames=np.zeros(
        (2, cfg.encoder.n_frames, cfg.d_model), np.float32))
    assert cfg.tie_embeddings
    bound = smoke.decode_bound(eng, 2, 8, 4)
    assert bound["weight_bytes"] == nbytes(eng.params)
    cache = eng._batches[2].cache["dec"]
    slot = cache["self"]["k"].numel() // 16 * 2          # bf16, 16 slots
    assert bound["state_bytes"] == (nbytes(cache["cross"])
                                    + 2 * slot * (8 + 4 / 2 + 1))


def _check_remote_phase(remote):
    """The checkpoint-remote line: every leg restored bit-equal cold and
    warm, the unchanged re-save uploaded nothing, a cold restore fetched
    exactly the checkpoint's bytes, every leg's step gave one loss, and
    the sharded leg survived its killed server and reported it down."""
    legs = remote["legs"]
    assert list(legs) == ["local", "remote", "sharded"]
    assert remote["losses_equal"] and len(set(remote["step_losses"].values())) == 1
    for kind, leg in legs.items():
        assert leg["ok"] and leg["cold_equal"] and leg["warm_equal"], kind
        assert {"save_s", "resave_s", "restore_cold_s", "restore_warm_s",
                "bytes_uploaded", "bytes_referenced_remote",
                "remote_transfer_fraction", "disk_free_bytes"} <= set(leg)
    assert legs["local"]["resave"]["last_bytes_written"] == 0
    for kind in ("remote", "sharded"):
        leg = legs[kind]
        assert leg["resave"]["last_bytes_uploaded"] == 0
        assert leg["resave_remote_transfer_fraction"] == 0.0
        assert leg["bytes_uploaded"] > 0
        assert leg["bytes_fetched_cold"] == \
            leg["bytes_referenced_by_checkpoint"]
        assert leg["bytes_fetched_warm"] == 0
        assert len(leg["server_stats"]) == len(leg["servers"])
        assert all(w["round_trips"] > 0
                   for w in leg["round_trips"]["writer"])
    sharded = legs["sharded"]
    assert len(sharded["servers"]) == 3
    assert sharded["down_after_kill"] == [sharded["killed_server"]]
    assert sharded["after_kill_equal"]
    assert [h["up"] for h in sharded["store_health"]] == [True] * 3
    hybrid = remote["hybrid"]
    assert hybrid["ok"] and hybrid["leaves_equal"] and hybrid["tokens_equal"]
    assert hybrid["bytes_fetched_cold"] == \
        hybrid["bytes_referenced_by_checkpoint"]


def test_chip_smoke_sharded_leg_survives_a_killed_shard(smoke, capsys):
    """The checkpoint-remote phase alone: its sharded leg SIGKILLs (here:
    stops) one of three servers, restores bit-equal from an empty cache
    through the other two, reports that server down, and the phase
    passes."""
    counts = smoke.phase_checkpoint_remote("cpu rehearsal, 0 W")
    assert counts["flash_attention_fwd"] == 3 * 6 + 2
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phase"] == "checkpoint-remote" and line["ok"]
    _check_remote_phase(line)
    down = [h for h in line["legs"]["sharded"]["store_health_after_kill"]
            if not h["up"]]
    assert len(down) == 1 and down[0]["cooldown_s"] > 0


def test_chip_smoke_dead_single_server_fails_the_phase(smoke, monkeypatch,
                                                       capsys):
    """A single chunk server that is dead when the remote leg saves makes
    the phase fail: the save raises, no checkpoint-remote line is printed
    ok, nothing falls back to a local directory."""
    start = smoke._start_servers

    def dead_when_alone(n, root):
        servers = start(n, root)
        if n == 1:
            servers[0].kill()
        return servers

    monkeypatch.setattr(smoke, "_start_servers", dead_when_alone)
    with pytest.raises(RuntimeError, match="async checkpoint write failed") \
            as info:
        smoke.phase_checkpoint_remote("cpu rehearsal, 0 W")
    assert isinstance(info.value.__cause__, ConnectionError)
    assert '"checkpoint-remote"' not in capsys.readouterr().out


def test_chip_smoke_bounds_at_the_serving_shapes(smoke):
    """The bounds the timing phase reports, at the full serving shapes."""
    ms, by, n_bytes, _ = smoke.rglru_bound(2, 2560, 4096)
    # a, x and h_seq (2x2560x4096 fp32) plus h0 and h_last (2x4096 fp32)
    assert (n_bytes, by) == (251_658_240 + 65_536, "bytes")
    assert ms == pytest.approx(n_bytes / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.0751, abs=5e-5)
    # B = 1 (serve-parity-hybrid): half of it
    ms, by, n_bytes, _ = smoke.rglru_bound(1, 2560, 4096)
    assert (n_bytes, by) == (125_829_120 + 32_768, "bytes")
    assert ms == pytest.approx(0.0376, abs=5e-5)
    # bf16 a and x, fp32 h: 2 + 2 + 4 bytes an element
    ms, by, n_bytes, _ = smoke.rglru_bound(2, 2560, 4096, 2)
    assert (n_bytes, by) == (167_772_160 + 65_536, "bytes")
    assert ms == pytest.approx(0.0501, abs=5e-5)
    for dequant in (False, True):
        ms, by, n_bytes, _ = smoke.quant_bound(50_331_648, 256, dequant)
        assert (n_bytes, by) == (252_444_672, "bytes")
        assert ms == pytest.approx(0.0754, abs=5e-5)
    assert smoke.attention_pairs(2560, 2048) == 3_146_752
    ms, by, n_bytes, flops = smoke.flash_bound(32, 2, 2560, 256, 2048)
    assert (n_bytes, flops, by) == (89_128_960, 4 * 256 * 3_146_752 * 32,
                                    "operations")
    assert ms == pytest.approx(0.104, abs=5e-4)
    # the fp32 kernel at serve-parity-hybrid's shape (B=1) on the CUDA
    # cores: 5.16e10 FLOP at 67 TFLOP/s
    ms, by, n_bytes, flops = smoke.flash_bound(16, 1, 2560, 256, 2048, 4,
                                               smoke.FP32_FLOP_PER_S)
    assert (n_bytes, flops, by) == (89_128_960, 4 * 256 * 3_146_752 * 16,
                                    "operations")
    assert flops == pytest.approx(5.16e10, rel=1e-3)
    assert ms == pytest.approx(0.769, abs=5e-4)
    # and at smollm-135m's serve-parity shape (B=2): operations bind too
    ms, by, n_bytes, flops = smoke.flash_bound(18, 6, 128, 64, 0, 4,
                                               smoke.FP32_FLOP_PER_S)
    assert (n_bytes, flops, by) == (1_572_864, 4 * 64 * 8256 * 18,
                                    "operations")
    assert ms == pytest.approx(flops / 67e12 * 1e3)


@pytest.mark.parametrize("shape,ms,tflops,share", [
    # recurrentgemma-9b prefill: 1.031e11 FLOP over the window, bound 0.104 ms
    ((32, 2, 2560, 256, 2048), 0.5, 206.2, 0.2085),
    # smollm-135m prefill: bound by its 1.57 MB, 0.00047 ms
    ((36, 12, 128, 64, 0), 0.03, 2.536, 0.01565)],
    ids=["recurrentgemma-9b", "smollm-135m"])
def test_chip_smoke_achieved_rates_at_the_serving_shapes(smoke, shape, ms,
                                                         tflops, share):
    """The timing phase's TFLOP/s, TB/s and share of the bound, from a
    kernel time and the work that the bound counts."""
    bound_ms, _, n_bytes, flops = smoke.flash_bound(*shape)
    got = smoke.achieved(ms, flops, n_bytes, bound_ms)
    assert got["tflops"] == pytest.approx(flops / (ms * 1e-3) / 1e12)
    assert got["tflops"] == pytest.approx(tflops, rel=1e-3)
    assert got["tbps"] == pytest.approx(n_bytes / (ms * 1e-3) / 1e12)
    assert got["share_of_bound"] == pytest.approx(share, rel=1e-3)


PTXAS = """\
ptxas info    : Compiling entry function '_ZN2tc16fa_fwd_tc_kernelILi256EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc16fa_fwd_tc_kernelILi256EEEvPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 230 registers, used 1 barriers
ptxas info    : Function properties for _ZN4simt13fa_fwd_kernelILi256EEEvPKfS1_S1_Pfiiifii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 248 registers, used 1 barriers
ptxas info    : Function properties for _ZN4simt13fa_fwd_kernelILi64EEEvPKfS1_S1_Pfiiifii
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
"""


def test_chip_smoke_reads_registers_and_spills_of_each_instantiation(smoke):
    """The build phase fails on a spilling fp32 instantiation as on a bf16
    one."""
    fns = smoke.ptxas_summary(PTXAS)
    assert fns == [
        {"function": "_ZN2tc16fa_fwd_tc_kernelILi256EEEvPK13__nv_bfloat16",
         "spill_stores": 0, "spill_loads": 0, "registers": 230},
        {"function": "_ZN4simt13fa_fwd_kernelILi256EEEvPKfS1_S1_Pfiiifii",
         "spill_stores": 0, "spill_loads": 0, "registers": 248},
        {"function": "_ZN4simt13fa_fwd_kernelILi64EEEvPKfS1_S1_Pfiiifii",
         "spill_stores": 4, "spill_loads": 12, "registers": 64}]
    assert smoke.flash_spills(fns) == [
        "_ZN4simt13fa_fwd_kernelILi64EEEvPKfS1_S1_Pfiiifii"]
    found = smoke.flash_instantiations(fns)
    assert [len(found["fa_fwd_kernel"]),
            len(found["fa_fwd_tc_kernel"])] == [2, 1]


def _flash_report(spilling):
    """A ptxas report of every flash instantiation, as nvcc names them,
    where only ``spilling`` = (kernel, hd) spills."""
    lines = []
    for kernel, space, args in (
            ("fa_fwd_kernel", "4simt", "PKfS3_S3_Pfiiifii"),
            ("fa_fwd_tc_kernel", "2tc", "PK13__nv_bfloat16S4_S4_PS2_iiifii")):
        for hd in (64, 128, 256):
            spill = 8 if (kernel, hd) == spilling else 0
            lines += [f"ptxas info    : Function properties for "
                      f"_ZN55_GLOBAL__N"
                      f"__a0d8e095_22_flash_attention_fwd_cu_f72066a0{space}"
                      f"{len(kernel)}{kernel}ILi{hd}EEEv{args}",
                      f"    0 bytes stack frame, {spill} bytes spill stores, "
                      f"{spill} bytes spill loads",
                      "ptxas info    : Used 200 registers, used 1 barriers"]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("spilling", [None] + [
    (kernel, hd) for kernel in ("fa_fwd_kernel", "fa_fwd_tc_kernel")
    for hd in (64, 128, 256)], ids=str)
def test_chip_smoke_build_gate_names_each_spilling_flash_kernel(smoke,
                                                                spilling):
    fns = smoke.ptxas_summary(_flash_report(spilling))
    found = smoke.flash_instantiations(fns)
    assert {k: len(v) for k, v in found.items()} == {"fa_fwd_kernel": 3,
                                                    "fa_fwd_tc_kernel": 3}
    spills = smoke.flash_spills(fns)
    if spilling is None:
        assert spills == []
    else:
        kernel, hd = spilling
        assert len(spills) == 1
        assert f"{len(kernel)}{kernel}ILi{hd}E" in spills[0]


def test_chip_smoke_reads_shared_memory_where_ptxas_reports_it(smoke):
    report = ("ptxas info    : Function properties for _ZN12_GLOBAL__N_117"
              "rglru_scan_kernelIfEEvPKT_\n"
              "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
              "loads\n"
              "ptxas info    : Used 168 registers, used 1 barriers, 8 bytes "
              "smem, 400 bytes cmem[0]\n")
    assert smoke.ptxas_summary(report) == [
        {"function": "_ZN12_GLOBAL__N_117rglru_scan_kernelIfEEvPKT_",
         "spill_stores": 0, "spill_loads": 0, "registers": 168,
         "smem_bytes": 8}]


def test_chip_smoke_rglru_stress_cases_cross_the_tiles(smoke):
    """The stress cases straddle the kernel's chunk, leave a ragged lane
    tile, take B = 1 and S = 1, cross hundreds of chunks, and take a close
    to 1 and exact zeros of a."""
    plan = rk.rglru_plan(1, 1, 1)
    cases = smoke.RGLRU_STRESS
    assert {plan.chunk - 1, plan.chunk, plan.chunk + 1} <= {c[1] for c in cases}
    assert any(d % plan.lanes for _, _, d, _ in cases)
    assert any(d % 2 for _, _, d, _ in cases)      # bf16 rows not 4-aligned
    assert any(kind == "offset" and d % 2 == 0 for _, _, d, kind in cases)
    assert any(b == 1 for b, *_ in cases) and any(s == 1 for _, s, _, _ in cases)
    assert any(rk.rglru_plan(b, s, d).n_chunks >= 200
               for b, s, d, _ in cases)
    assert {"near-one", "zeros"} <= {c[3] for c in cases}


@pytest.mark.parametrize("dtype,misaligned", [("float32", 0),
                                              ("bfloat16", 2)])
def test_chip_smoke_offset_inputs_start_one_element_in(smoke, dtype,
                                                       misaligned):
    """The "offset" stress case hands the kernel contiguous views one
    element into their storage: bf16 rows that are not 4-byte aligned
    although D is even, so the kernel must copy them through registers."""
    import torch
    gen = torch.Generator().manual_seed(0)
    a, x, h0 = smoke._rglru_inputs(gen, 2, 3, 4, getattr(torch, dtype),
                                   "offset")
    for t in (a, x):
        assert t.is_contiguous() and t.shape == (2, 3, 4)
        assert t.storage_offset() == 1
        assert t.data_ptr() % 4 == misaligned
    assert h0.shape == (2, 4)


def _tile_kinds(sq, sk, causal, window, block_q, block_k) -> set:
    """What the q tiles x k tiles of one flash case meet, from its mask
    alone: tiles wholly masked ("skipped"), wholly kept ("full"), cut by the
    causal diagonal ("diagonal") or by a window's edge and not the diagonal
    ("window_edge"), and rows wholly masked in the first tile their q tile
    computes ("row_masked_in_first_tile": the -1e30 rows that the next
    rescale wipes)."""
    import torch
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool)
    early = torch.zeros(sq, sk, dtype=torch.bool)
    if causal:
        ok = kpos <= qpos
        if window:
            early = kpos <= qpos - window
            ok &= ~early
    kinds = set()
    for q0 in range(0, sq, block_q):
        first = True
        for k0 in range(0, sk, block_k):
            t = ok[q0:q0 + block_q, k0:k0 + block_k]
            if not t.any():
                kinds.add("skipped")
                continue
            if t.all():
                kinds.add("full")
            elif (kpos[:, k0:k0 + block_k] > qpos[q0:q0 + block_q]).any():
                kinds.add("diagonal")
            elif early[q0:q0 + block_q, k0:k0 + block_k].any():
                kinds.add("window_edge")
            if first and (~t.any(dim=1)).any():
                kinds.add("row_masked_in_first_tile")
            first = False
    return kinds


def test_chip_smoke_fp32_flash_cases_cross_the_tiles(smoke):
    """FLASH_FP32_CASES, under the fp32 kernel's tiles, take every head dim,
    cross the diagonal and a window's edge at tiles that are not the
    diagonal, skip tiles before the window, leave rows wholly masked in the
    first tile a q tile computes, and take a window no tile divides, g = 8,
    magnified scores over several key tiles and the non-causal Sq != Sk."""
    import torch
    cases = smoke.FLASH_FP32_CASES
    kinds = set()
    for bh, bkv, sq, sk, hd, causal, window, mag in cases:
        block_q, block_k = fa.TILES[(torch.float32, hd)]
        assert sq % block_q == 0 and sk % block_k == 0
        kinds |= _tile_kinds(sq, sk, causal, window, block_q, block_k)
    assert kinds == {"skipped", "full", "diagonal", "window_edge",
                     "row_masked_in_first_tile"}
    assert {c[4] for c in cases} == set(fa._HEAD_DIMS)
    tiles = {hd: fa.TILES[(torch.float32, hd)] for hd in fa._HEAD_DIMS}
    assert any(w and w % tiles[hd][0] and w % tiles[hd][1]
               for *_, hd, _, w, _ in cases)
    assert any(hd == 256 and w for *_, hd, _, w, _ in cases)
    assert any(bh // bkv == 8 and hd == 128
               for bh, bkv, _, _, hd, _, _, _ in cases)
    assert any(mag > 1 and sk >= 2 * tiles[hd][1] and sq > tiles[hd][0]
               for _, _, sq, sk, hd, _, _, mag in cases)
    assert any(not causal and sq != sk
               for _, _, sq, sk, _, causal, _, _ in cases)


def test_chip_smoke_fp32_magnified_scores_are_exact(smoke):
    """The magnified fp32 cases round q and k to integers, so that Q K^T
    is exact in fp32 in any summation order; unrounded, the plain fp32
    version alone is more than the 2e-5 tolerance from float64."""
    import torch
    worst_unrounded = 0.0
    for bh, bkv, sq, sk, hd, causal, window, mag in smoke.FLASH_FP32_CASES:
        if mag == 1:
            continue
        gen = torch.Generator().manual_seed(0)
        q, k = smoke.flash_qk(gen, "float32", bh, bkv, sq, sk, hd, mag)
        g = bh // bkv
        s32 = torch.einsum("bgqd,bkd->bgqk", q.view(bkv, g, sq, hd), k)
        s64 = torch.einsum("bgqd,bkd->bgqk", q.view(bkv, g, sq, hd).double(),
                           k.double())
        assert torch.equal(s32.double(), s64)
        gen = torch.Generator().manual_seed(0)
        q, k = (smoke._randn(gen, *shape) * mag
                for shape in ((bh, sq, hd), (bkv, sk, hd)))
        v = smoke._randn(gen, bkv, sk, hd)
        plain = ref_flash_attention(q, k, v, causal=causal, window=window)
        exact = _exact_attention(q, k, v, causal, window)
        worst_unrounded = max(worst_unrounded,
                              float((plain.double() - exact).abs().max()))
    assert worst_unrounded > smoke.TOL["float32"]


def _exact_attention(q, k, v, causal, window):
    """The same function as ref_flash_attention, in float64 throughout."""
    import torch
    bh, sq, hd = q.shape
    bkv, sk, _ = k.shape
    s = torch.einsum("bgqd,bkd->bgqk", q.double().view(bkv, bh // bkv, sq, hd),
                     k.double()) * hd ** -0.5
    if causal:
        qpos = torch.arange(sq)[:, None]
        kpos = torch.arange(sk)[None, :]
        ok = kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        s = torch.where(ok, s, -1e30)
    return torch.einsum("bgqk,bkd->bgqd", torch.softmax(s, -1),
                        v.double()).reshape(bh, sq, hd)


def test_chip_smoke_train_sharded_phase_on_cpu(smoke, capsys):
    """The train-sharded phase at smoke widths on the CPU: the loop on this
    process's 1-rank mesh under baseline and fsdp beside the plain loop
    (the pure step: no graph on the CPU), losses and final TrainStates
    bit-equal, 2 × 3 flash launches a step through ``local_map``; the
    crash after step 5 resumed on one device and on the mesh, bit-equal
    to the uninterrupted run; the eager and loop steps both ways; a
    2-rank world's step against the one-device step."""
    counts = smoke.phase_train_sharded("cpu rehearsal, 0 W")
    assert counts == {"flash_attention_fwd": 10 * 6, "rglru_scan": 0,
                      "quantize_int8": 0, "dequantize_int8": 0}
    line = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith('{"phase": "train-sharded"'))
    assert line["ok"] and line["variants"] == ["baseline", "fsdp"]
    assert set(line["runs"]) == {"plain", "baseline", "fsdp"}
    for run in line["runs"].values():
        assert run["flash_launches_per_step"] == 6 and run["captures"] == 0
        assert run["losses"] == line["runs"]["plain"]["losses"]
    assert line["states_equal"] == {"baseline": True, "fsdp": True}
    for name in ("one_device", "mesh"):
        r = line["resumed"][name]
        assert (r["resumed_from"], r["steps_run"]) == (5, 5)
        assert r["losses_equal"] and r["state_equal"]
    ba = line["step_before_after"]
    assert ba["eager"]["step_s"] > 0 and ba["graphed"]["step_s"] > 0
    world = line["world"]
    assert world["ok"] and world["mesh"] == {"data": 1, "model": 2}
    assert [r["rank"] for r in world["per_rank"]] == [0, 1]
    assert line["phase_s"] > 0


def test_chip_smoke_dryrun_phase_on_cpu(smoke, capsys):
    """The dryrun phase on the CPU (DEV is the CPU, so one cell): smollm-135m
    decode_32k through ``python -m repro_torch.launch.dryrun`` as rank 0
    of a fake 256-rank world, ok, its 31 all-reduces, its trace_s and this
    torch's version; the probe counts the rank's local product: its
    flops, modelled bytes and one temporary."""
    smoke.phase_dryrun("cpu rehearsal, 0 W")
    line = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith('{"phase": "dryrun"'))
    assert line["ok"] and line["costs_equal"]
    assert line["cell"] == {"arch": "smollm-135m", "shape": "decode_32k",
                            "mesh": "pod", "variant": "auto"}
    assert set(line["trace_s"]) == {"cpu"} and line["trace_s"]["cpu"] > 0
    assert line["torch"] == torch.__version__
    assert line["probe_want"] == {
        "flops": 2 * 64 * 4096 * 256,
        "bytes": 4 * (64 * 4096 + 4096 * 256 + 64 * 256),
        "peak_temp_bytes": 4 * 64 * 256}
    for key, want in line["probe_want"].items():
        assert line["probe"][key] == want, (key, line["probe"])
    assert line["cost"]["collective_count"] == 31 and not line["errors"]


def test_chip_smoke_dryrun_phase_fails_on_unequal_costs(smoke, monkeypatch):
    """Records that disagree between the two devices fail the phase."""
    rec = {"status": "ok", "trace_s": 1.0, "args_bytes_per_device": 1,
           "bytes_per_device": 2, "model_flops_per_device": 3.0,
           "n_params": 4, "cost": {"flops_per_device": 5.0}}
    probe = json.dumps(smoke.DRYRUN_PROBE_WANT)
    monkeypatch.setattr(smoke, "_dryrun_children", lambda out: {
        "cuda": {"rc": 0, "stdout": "", "stderr": "", "record": rec},
        "cpu": {"rc": 0, "stdout": "", "stderr": "", "record": dict(
            rec, cost={"flops_per_device": 6.0})},
        "probe": {"rc": 0, "stdout": probe, "stderr": "", "record": None}})
    with pytest.raises(smoke.PhaseFailed, match="dryrun"):
        smoke.phase_dryrun("cpu rehearsal, 0 W")


_RANKWORLD_SMOKE = dict(din=16, dh=32, dout=4, batch_per_rank=8,
                        boundary_width=64)


def test_chip_smoke_rankworld_phase_on_cpu(smoke, capsys, monkeypatch):
    """The rankworld phase at smoke widths: the smoke tree saved and
    restored onto this process's 1-rank mesh and a 4-rank world over shm
    reshaped to 3 ranks over tcp under one bump; a same-shape restart onto
    inproc bit-equal to an uninterrupted run; the boundary world's
    checkpoint drains one message a rank and its restart onto tcp is
    bit-equal to an uninterrupted run.  No kernel runs."""
    monkeypatch.setattr(smoke, "RANKWORLD",
                        dict(smoke.RANKWORLD, **_RANKWORLD_SMOKE))
    counts = smoke.phase_rankworld("cpu rehearsal, 0 W")
    assert counts == {"flash_attention_fwd": 0, "rglru_scan": 0,
                      "quantize_int8": 0, "dequantize_int8": 0}
    line = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith('{"phase": "rankworld"'))
    assert line["ok"] and line["error"] is None
    assert line["image_step"] == 6 and line["ranks"] == 4
    assert line["transports"] == ["shm", "tcp", "inproc", "tcp"]
    checks = line["checks"]
    assert checks["generations"] == [1, 1, 1, 1]
    assert checks["layers"] == ["mesh", "world"]
    assert checks["rank_map"] == {"0": 0, "1": 1, "2": 2, "3": None}
    assert checks["reshaped_world"] == 3
    assert all(checks[k] for k in (
        "leaves_on_card", "leaves_equal", "survivors_equal_images",
        "stale_rejected", "reshaped_params_equal", "same_shape_equal",
        "boundary_restart_equal"))
    # envelopes really drained into the images: one in flight a rank
    assert checks["boundary_drained"] == 4
    assert checks["boundary_cached_envelopes"] == 4
    assert checks["boundary_image_step"] == 6
    assert line["params_bytes_per_rank"] == 4 * (16 * 32 + 32 * 4)
    assert set(line["seconds"]) == {
        "mesh_save_s", "uninterrupted_s", "checkpointed_s", "reshape_s",
        "reshaped_run_s", "same_shape_s", "boundary_uninterrupted_s",
        "boundary_checkpointed_s", "boundary_restart_s"}
    assert line["boundary_drained_messages"] == 4
    assert line["drained_messages"] == 0   # the DP ring ends in its step


def _procworld_smoke(smoke, monkeypatch, **procworld):
    """RANKWORLD's MLP at smoke widths, whose 512-byte allreduce chunks
    ride the ring only below the 256 KiB crossover: lowered to 256 B."""
    from repro_torch.core import procworld as pw
    monkeypatch.setattr(smoke, "RANKWORLD",
                        dict(smoke.RANKWORLD, **_RANKWORLD_SMOKE))
    monkeypatch.setattr(smoke, "PROCWORLD",
                        dict(smoke.PROCWORLD, **procworld))
    monkeypatch.setattr(pw, "RING_PAYLOAD_MIN", 256)


def test_chip_smoke_procworld_phase_on_cpu(smoke, capsys, monkeypatch):
    """The procworld phase at smoke widths: 4 rank processes over shmring
    checkpointed at step 6 and reshaped to 3 processes over proc under one
    bump beside the smoke tree, bit-equal to a thread-world restart; the
    driver's SIGKILL at step 8 restarted from at_00000005 onto shmring,
    bit-equal to a thread-world restart; the CLI in a fresh interpreter.
    No kernel runs."""
    _procworld_smoke(smoke, monkeypatch)
    counts = smoke.phase_procworld("cpu rehearsal, 0 W")
    assert counts == {"flash_attention_fwd": 0, "rglru_scan": 0,
                      "quantize_int8": 0, "dequantize_int8": 0}
    line = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith('{"phase": "procworld"'))
    assert line["ok"] and line["error"] is None
    assert line["transports"] == ["shmring", "proc", "shm", "proc",
                                  "shmring"]
    checks = line["checks"]
    assert checks["generations"] == [1, 1, 1, 1]
    assert checks["reshaped_world"] == 3 and checks["driver_world"] == 3
    assert checks["cli_world_generation"] == [3, 1]
    assert all(checks[k] for k in (
        "pids_distinct", "exit_codes_zero", "ring_used", "leaves_equal",
        "survivors_equal_images", "reshaped_equal_thread", "sigkilled",
        "driver_equal_thread"))
    assert line["events"] == [
        "start:fresh", "fallback:[2]:RecoveryUnavailable:ledger-miss",
        "dead:[2]:gen=1", "failure:RuntimeError",
        "restart:at_00000005:world=3:gen=1", "done"]
    # 6 steps x 4 ranks x 6 ring sends of w1's 512-byte chunk (w2's
    # 128-byte chunks stay below the lowered crossover and ship inline)
    assert line["chunk_bytes"] == 512
    assert line["ring_bytes"] == 6 * 4 * 6 * 512
    assert line["ring"]["slots"] >= 4 and line["shm_free_bytes"] > 0
    assert len(line["pids"]["driver"]) == 2
    assert set(line["seconds"]) == {
        "save_s", "checkpointed_s", "reshape_s", "reshaped_run_s",
        "thread_restart_s", "driver_s", "driver_thread_restart_s",
        "kill_to_dead_s", "restart_to_done_s", "cli_s"}
    assert 0 < line["seconds"]["kill_to_dead_s"] < 10


def test_chip_smoke_procworld_phase_fails_without_a_kill(
        smoke, capsys, monkeypatch):
    """No rank is killed (the kill step lies past the run): no dead: event,
    and the phase fails."""
    _procworld_smoke(smoke, monkeypatch, kill_step=99)
    with pytest.raises(smoke.PhaseFailed, match="procworld"):
        smoke.phase_procworld("cpu rehearsal, 0 W")
    line = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith('{"phase": "procworld"'))
    assert not line["ok"] and line["error"] is None
    assert not line["checks"]["dead_event"]
    assert line["events"] == ["start:fresh", "done"]


def test_chip_smoke_rankworld_phase_fails_on_a_corrupted_image(
        smoke, capsys, monkeypatch):
    """One byte of rank 1's app part changed on disk after the checkpoint:
    the restart's digest check refuses the image, and the phase fails."""
    monkeypatch.setattr(smoke, "RANKWORLD",
                        dict(smoke.RANKWORLD, **_RANKWORLD_SMOKE))
    monkeypatch.setattr(smoke, "CORRUPT_IMAGE", 1)
    with pytest.raises(smoke.PhaseFailed, match="rankworld"):
        smoke.phase_rankworld("cpu rehearsal, 0 W")
    line = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith('{"phase": "rankworld"'))
    assert not line["ok"] and line["corrupted_chunk"].endswith(".bin")
    assert "digest mismatch" in line["error"]
