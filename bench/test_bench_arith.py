"""The frozen arithmetic on hand-worked shapes, and the trace reduction:
busy time as the union of intervals, idle gaps put down to host spans."""
import json
from pathlib import Path

import pytest

import devtrace
import roofline as R

CONF = Path(__file__).resolve().parent / "configs"
SMOLLM = json.loads((CONF / "smollm-135m.json").read_text())
DSV2 = json.loads((CONF / "deepseek-v2-lite-16b.json").read_text())


def test_attention_pairs_and_flash_bound():
    assert R.attention_pairs(4) == 10
    assert R.attention_pairs(5, window=2) == 1 + 2 + 2 + 2 + 2
    # smollm-135m's training launch: 72 q rows, 24 kv rows, 2048 x 64
    ops = 4 * 64 * (2048 * 2049 // 2) * 72
    n_bytes = (2 * 72 + 2 * 24) * 2048 * 64 * 2
    assert R.flash_bound(72, 24, 2048, 64) == pytest.approx(
        max(ops / 989e12, n_bytes / 3.35e12), rel=1e-12)
    assert R.bound(3.35e12, 1.0)[1] == "bytes"
    assert R.bound(1.0, 989e12) == (1.0, "operations")


def test_smollm_counts_by_hand():
    layer = 576 * 576 * 2 + 576 * 192 * 2 + 3 * 576 * 1536
    assert R.active_block_params(SMOLLM) == 30 * layer
    n = 30 * layer + 576 * 49152
    assert n == 134_479_872
    att = 2 * (64 + 64) * (2048 * 2049 // 2) * 9 * 30
    assert R.attention_flops(SMOLLM, 2048) == att
    assert R.train_flops(SMOLLM, 8, 2048) == 6.0 * n * 8 * 2048 + 3 * 8 * att
    assert R.prefill_flops(SMOLLM, 32, 2048) == (
        2.0 * 30 * layer * 32 * 2048 + 2.0 * 576 * 49152 * 32 + 32 * att)


def test_deepseek_active_params_match_the_published_2_4b():
    mla = (2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 128 * 2
           + 16 * 128 * 2048)
    moe = 2048 * 64 + 6 * 3 * 2048 * 1408 + 2 * 3 * 2048 * 1408
    want = 27 * mla + 3 * 2048 * 10944 + 26 * moe
    assert R.active_block_params(DSV2) == want
    assert 2.3e9 < want + R.head_params(DSV2) < 2.5e9


def test_decode_bound_bills_the_routed_experts_only():
    e = R.expert_params(DSV2)
    assert e == 3 * 2048 * 1408
    all64 = R.decode_bytes(DSV2, 16, 100.0, 26 * 64)
    none = R.decode_bytes(DSV2, 16, 100.0, 0)
    assert all64 - none == 26 * 64 * e * 2
    assert R.decode_bytes(DSV2, 16, 100.0, 26 * 50.5) - none == \
        pytest.approx(26 * 50.5 * e * 2)
    # the cache: 27 layers x 16 rows x (100 + 1) slots x (512 + 64) bf16
    one_more = R.decode_bytes(DSV2, 16, 101.0, 0) - none
    assert one_more == 27 * 16 * 576 * 2


def test_union_counts_overlap_once():
    assert devtrace.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert devtrace.union([]) == 0
    assert devtrace.idle_gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [
        (0, 1), (3, 4), (5, 6)]
    assert devtrace.idle_gaps([(0, 10)], 1, 2) == []


def test_summarize_puts_gaps_down_to_the_innermost_host_span():
    E = devtrace.Event
    events = [E("bench.slice", "slice", 0.0, 10.0),
              E("generate", "span", 0.0, 6.0),
              E("snapshot", "span", 6.0, 10.0),
              E("copy", "span", 7.0, 8.0),
              E("k1", "device", 0.5, 3.0), E("k1", "device", 2.0, 4.0),
              E("k2", "device", 4.5, 5.0), E("k2", "device", 9.0, 11.0)]
    s = devtrace.summarize(events)
    assert s.wall_s == 10.0
    assert s.busy_s == pytest.approx(3.5 + 0.5 + 1.0)
    assert s.ops == {"k1": [2, 4.5], "k2": [2, 2.5]}
    assert s.kernel("k") == (4, 7.0)
    assert s.gaps[0] == ("copy", 4.0)         # (5, 9): middle at 7
    assert sorted(s.gaps[1:]) == [("generate", 0.5), ("generate", 0.5)]
    b = s.breakdown(top=1)
    assert b == {"device_ops": [["k1", 4.5]], "idle_gaps": [["copy", 4.0]]}


def test_tracer_profiles_one_slice_on_the_cpu():
    import torch
    t = devtrace.Tracer(True, torch.device("cpu"))
    with t.slice():
        with t.span("work"):
            x = torch.randn(64, 64)
            for _ in range(3):
                x = x @ x
    assert t.summary.wall_s > 0 and t.summary.busy_s == 0
    assert t.summary.gaps[0][0] == "work"
    first = t.summary
    with t.slice():               # one slice a run
        pass
    assert t.summary is first
    off = devtrace.Tracer(False, torch.device("cpu"))
    with off.slice(), off.span("x"):
        pass
    assert off.summary is None


def _read(name, ctx):
    import harness
    mod, part = harness.reader(name)
    return mod.read(dict({"hf": SMOLLM, "wl": {}}, **ctx), part)


def test_readers_on_hand_worked_windows():
    # 10 steps of 1e13 flops in 2 s; the traced 2 steps and 0.5 s left out
    assert _read("train_mfu", {"steps": 10, "flops_per_step": 1e13,
                               "window_s": 2.0}) == pytest.approx(
        100 * 10 * 1e13 / (2.0 * 989e12))
    assert _read("train_mfu", {"steps": 10, "flops_per_step": 1e13,
                               "window_s": 2.0, "traced": 2,
                               "traced_s": 0.5}) == pytest.approx(
        100 * 8 * 1e13 / (1.5 * 989e12))
    recs = [{"decode_s": 2.55, "snapshot_s": 1.0}] * 3 + [
        {"decode_s": 9.0, "snapshot_s": 9.0, "traced": True}]
    assert _read("prefill_mfu", {"recs": recs, "prefill_flops": 1e12,
                                 "window_s": 4.0, "traced": 1,
                                 "traced_s": 1.0}) == pytest.approx(
        100 * 3 * 1e12 / (3.0 * 989e12))
    wl = {"new_tokens": 256, "prompt": 128, "batch": 16}
    assert _read("decode_step_ms.serve", {"recs": recs, "wl": wl}) == \
        pytest.approx(10.0)
    assert _read("snapshot_s.serve", {"recs": recs}) == pytest.approx(1.0)
    t, _ = R.bound(R.decode_bytes(DSV2, 16, 256.0, 1300.0),
                   R.decode_flops(DSV2, 16, 256.0))
    assert _read("decode_bound_share.serve",
                 {"recs": recs, "wl": wl, "hf": DSV2, "routed": 1300.0}) \
        == pytest.approx(100 * t / 0.010)
    assert _read("ckpt_block_s.train", {"ckpt": {"saves": 1, "drain_s": 0.25,
                                                 "snapshot_s": 1.0}}) == 1.25
    s = devtrace.Summary(wall_s=4.0, busy_s=3.0,
                         ops={"tc::fa_fwd_tc_kernel<64>": [60, 0.0078]})
    assert _read("idle_share.train", {"trace": s}) == pytest.approx(25.0)
    assert _read("flash_roofline.train", {
        "trace": s, "flash_shape": (72, 24, 2048, 64)}) == pytest.approx(
        100 * 60 * R.flash_bound(72, 24, 2048, 64) / 0.0078)
    s.ops = {}
    assert _read("flash_roofline.prefill", {
        "trace": s, "flash_shape": (72, 24, 2048, 64)}) is None
