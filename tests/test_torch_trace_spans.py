"""The port's device spans and the spans on its training and serving hot
paths (``repro_torch.core.trace.device_span``), on the CPU.

A device span on CUDA records two timing events and waits in the recorder
until the second is done; here ``torch.cuda``'s events, streams and
synchronize are replaced by a fake device clock, so that the wait, the
anchor that places a span on the host's clock, and the bound on waiting
spans are checked without a card.  Off CUDA a device span is a host span
with ``cat="device"``.  The engine's and the graphed train step's span
trees are checked at smoke widths, with fake graphs where the CPU has
none, as ``tests/test_torch_serve.py`` and
``tests/test_torch_train_graphs.py`` drive them."""
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core import trace as r_trace
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.core import trace
from repro_torch.kernels import ops
from repro_torch.models.layers import Policy
from repro_torch.models.params import init_params, tree_leaves
from repro_torch.models.registry import get_api
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import loop
from repro_torch.train.step import GraphedTrainStep

F32 = Policy(compute=torch.float32)


@pytest.fixture
def enabled(monkeypatch):
    """Tracing on, an empty ring, no anchor; the ring emptied after."""
    monkeypatch.setattr(trace, "ENABLED", True)
    monkeypatch.setattr(trace, "_ANCHORS", {})
    trace.clear()
    yield
    trace.clear()


class _Clock:
    """A fake device: each recorded event takes the device's time, which
    the test advances; an event is done once ``done_until`` has passed
    it."""

    def __init__(self):
        self.t = 100.0              # device seconds
        self.done_until = float("inf")
        self.syncs = 0
        self.events = 0


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda``'s events, streams and synchronize on a fake clock."""
    clock = _Clock()

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            clock.events += 1
            self.t = None

        def record(self, stream=None):
            self.t = clock.t

        def query(self):
            return self.t is not None and self.t <= clock.done_until

        def synchronize(self):
            clock.syncs += 1

        def elapsed_time(self, other):
            assert self.query() and other.query()
            return (other.t - self.t) * 1e3

    def sync(device=None):
        clock.syncs += 1

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: "s")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    return clock


def _spans():
    return [e for e in trace.events() if e.kind == "span"]


# ------------------------------------------------------------ device spans

def test_cpu_device_span_is_a_host_span_with_its_launch_time(enabled):
    with trace.span("outer") as outer:
        before = time.monotonic()
        with trace.device_span("work", torch.device("cpu"),
                               args={"n": 3}):
            torch.ones(64).sum()
    ev = {e.name: e for e in _spans()}["work"]
    assert isinstance(ev, trace.SpanEvent) and ev.cat == "device"
    assert ev.parent_id == outer.span_id and ev.trace_id == outer.trace_id
    assert ev.args["n"] == 3 and before <= ev.args["launch_t"] == ev.t0
    assert ev.dur > 0
    assert json.loads(json.dumps(ev.to_wire()))["cat"] == "device"


def test_cuda_device_span_waits_for_its_end_and_lands_on_the_host_clock(
        enabled, fake_cuda):
    """The first device span takes the anchor (synchronize, record, wait,
    read the host clock) and nothing else synchronizes; a span whose end
    event is not done stays out of the ring; once done it becomes a span
    whose start is the anchor's host time plus the device's time from the
    anchor, and whose duration is the device's."""
    clock = fake_cuda
    host_anchor = time.monotonic()
    with trace.device_span("a", "cuda"):
        clock.t += 0.75                     # a's device time
    syncs = clock.syncs
    assert syncs == 2                       # the anchor's two waits
    with trace.device_span("b", "cuda:0"):
        clock.t += 0.125
    assert clock.syncs == syncs             # no synchronize for a span
    clock.done_until = 100.0 + 0.6          # a started, not yet ended
    assert _spans() == []
    clock.done_until = float("inf")
    got = {e.name: e for e in _spans()}
    assert set(got) == {"a", "b"}
    anchor_host = trace._ANCHORS[0][1]
    assert host_anchor <= anchor_host <= time.monotonic()
    assert got["a"].t0 == pytest.approx(anchor_host + 0.0)
    assert got["a"].dur == pytest.approx(0.75)
    assert got["b"].t0 == pytest.approx(anchor_host + 0.75)
    assert got["b"].dur == pytest.approx(0.125)
    assert got["a"].args["launch_t"] <= got["b"].args["launch_t"]
    assert {e.cat for e in got.values()} == {"device"}
    # a later span is placed through the same anchor, taken once
    clock.t += 2.0
    with trace.device_span("c", "cuda"):
        clock.t += 0.5
    assert clock.syncs == syncs and trace._ANCHORS[0][1] == anchor_host
    c = {e.name: e for e in _spans()}["c"]
    assert c.t0 == pytest.approx(anchor_host + 2.875)
    assert c.dur == pytest.approx(0.5)


def test_a_span_reads_no_pid_and_a_forked_child_its_own(enabled,
                                                       monkeypatch):
    """The pid is read once a process: a span makes no ``getpid`` call
    (a system call, dear where they are trapped), and a forked child's
    spans carry the child's pid."""
    r, w = os.pipe()
    child = os.fork()
    if child == 0:                                  # pragma: no cover
        try:
            with trace.span("child"):
                pass
            ev = trace.events()[-1]
            os.write(w, json.dumps([ev.name, ev.pid, os.getpid()]).encode())
        finally:
            os._exit(0)
    os.close(w)
    got = json.loads(os.read(r, 256).decode())
    os.close(r)
    os.waitpid(child, 0)
    assert got[0] == "child" and got[1] == got[2] != os.getpid()

    def refuse():
        raise AssertionError("getpid called for a span")

    monkeypatch.setattr(os, "getpid", refuse)
    with trace.span("parent"):
        with trace.device_span("dev", "cpu"):
            pass
    trace.instant("mark")
    assert {e.pid for e in trace.events()} == {trace._PID}


def test_waiting_device_spans_are_bounded(enabled, fake_cuda, monkeypatch):
    """As many spans wait as the ring holds: at the bound the finished
    ones are resolved, and if none has finished the oldest is dropped."""
    rec = trace.FlightRecorder(cap=4)
    monkeypatch.setattr(trace, "_RECORDER", rec)
    fake_cuda.done_until = -1.0             # nothing finishes
    for i in range(6):
        with trace.device_span(f"s{i}", "cuda"):
            fake_cuda.t += 1.0
    assert len(rec._pending) == 4 and len(rec) == 0
    fake_cuda.done_until = float("inf")
    assert [e.name for e in rec.snapshot()] == ["s2", "s3", "s4", "s5"]
    assert not rec._pending


def test_a_device_span_inside_a_capture_is_a_host_span(enabled, fake_cuda,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with trace.device_span("captured", "cuda"):
        pass
    assert fake_cuda.events == fake_cuda.syncs == 0
    assert [(e.name, e.cat) for e in _spans()] == [("captured", "device")]


def test_disabled_tracing_builds_no_event_and_takes_no_anchor(
        monkeypatch):
    """With tracing off a device span is the shared null span: no CUDA
    event is built, no stream looked up, no synchronize made, nothing
    recorded; the engine and the train loop record nothing either."""
    def refuse(*a, **k):
        raise AssertionError("touched CUDA with tracing off")

    monkeypatch.setattr(trace, "ENABLED", False)
    trace.clear()
    for name in ("Event", "synchronize", "current_stream",
                 "is_current_stream_capturing", "current_device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    sp = trace.device_span("x", "cuda")
    assert sp is trace.span("y") is trace.device_span("z", "cuda:0")
    with sp:
        pass
    eng, prompts = _engine()
    eng.generate(prompts, 3)
    res = loop.train(_train_cfg(), None, None, n_steps=2, global_batch=2,
                     seq_len=16, log_every=1, device="cpu")
    assert len(res.step_s) == 2
    assert trace.events() == [] and trace._ANCHORS == {}


# -------------------------------------------------------- the profiler

def test_spans_stay_out_of_a_profiler_session(enabled):
    """Inside a profiler session the engine's spans are recorded as ever,
    and the profiler's trace holds no range of theirs: a reader of that
    trace counts none of the program's spans as device work."""
    eng, prompts = _engine()
    eng.generate(prompts, 3)                     # set-up, outside
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.generate(prompts, 3)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert names and not any(n.startswith(("serve.", "train."))
                             for n in names)
    assert {"serve.generate", "serve.inputs", "serve.prefill",
            "serve.decode", "serve.read"} <= {e.name for e in _spans()}


# ------------------------------------------------------- the serving engine

def _engine():
    cfg = reduce_for_smoke(ARCHS["smollm-135m"])
    params = init_params(get_api(cfg).param_defs(cfg, 40),
                         torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(cfg, params, max_seq=40, policy=F32, device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return eng, prompts


class _FakeGraph:
    def __init__(self, step):
        self.step = step

    def replay(self):
        with ops.uncounted():
            self.step()


def test_engine_span_tree(enabled, monkeypatch):
    """A request is one ``serve.generate`` span (its batch, prompt length
    and new tokens as args) over ``serve.inputs``, ``serve.prefill``,
    ``serve.decode`` (one for the request's decode steps) and
    ``serve.read``; its first request of a shape also holds one
    ``serve.capture`` a graph (decode, then prefill), and a second request
    of that shape none.  With one new token there is no decode span.  The
    tokens are the eager engine's."""
    eng, prompts = _engine()
    eager, _ = _engine()
    monkeypatch.setattr(eng, "_use_graphs", lambda: True)
    monkeypatch.setattr(eng, "_capture",
                        lambda step: ops.CountedGraph(_FakeGraph(step), {}))
    want = [eager.generate(prompts, n).tokens for n in (4, 4, 1)]
    trace.clear()
    for n_new, tokens in zip((4, 4, 1), want):
        assert np.array_equal(eng.generate(prompts, n_new).tokens, tokens)
    spans = _spans()
    gens = sorted((e for e in spans if e.name == "serve.generate"),
                  key=lambda e: e.t0)
    assert [g.args for g in gens] == [{"b": 2, "p": 16, "n_new": n}
                                      for n in (4, 4, 1)]
    kids = [sorted((e.name for e in spans if e.parent_id == g.span_id))
            for g in gens]
    assert kids[0] == ["serve.capture", "serve.capture", "serve.decode",
                       "serve.inputs", "serve.prefill", "serve.read"]
    assert kids[1] == ["serve.decode", "serve.inputs", "serve.prefill",
                       "serve.read"]
    assert kids[2] == ["serve.inputs", "serve.prefill", "serve.read"]
    caps = sorted((e for e in spans if e.name == "serve.capture"),
                  key=lambda e: e.t0)
    assert [c.args["key"].split("'")[1] for c in caps] == ["decode",
                                                           "prefill"]
    assert all(e.trace_id == g.trace_id for g in gens for e in spans
               if e.parent_id == g.span_id)
    for g in gens:
        inner = [e for e in spans if e.parent_id == g.span_id]
        assert all(g.t0 <= e.t0 and e.t0 + e.dur <= g.t0 + g.dur + 1e-6
                   for e in inner)
    assert {e.cat for e in spans if e.name in ("serve.prefill",
                                               "serve.decode")} == {"device"}


# ------------------------------------------------------- the train step

def _train_cfg():
    return reduce_for_smoke(ARCHS["smollm-135m"])


@pytest.fixture
def graphs(monkeypatch):
    """The loop's graphed path on the CPU, a fake graph in place of the
    CUDA one (``tests/test_torch_train_graphs.py``'s)."""
    def record(self, step):
        state = step.args[0]
        saved = [t.clone() for t in tree_leaves(state)]
        out = step()
        for t, s in zip(tree_leaves(state), saved):
            t.copy_(s)
        return _ReplayGraph(step, out), out

    monkeypatch.setattr(loop, "_use_graphs", lambda dev: True)
    monkeypatch.setattr(GraphedTrainStep, "_record", record)


class _ReplayGraph:
    def __init__(self, step, out):
        self.step, self.out = step, out

    def replay(self):
        with ops.uncounted():
            new = self.step()
        for k, v in new.items():
            self.out[k].copy_(v)


def test_graphed_step_spans_and_step_seconds(enabled, graphs):
    """One ``train.capture`` (the eager first step and the record), then a
    ``train.step`` device span a replay; the loop's ``step_s`` stays the
    host's wall time of each step, which holds the step's span."""
    res = loop.train(_train_cfg(), None, None, n_steps=4, global_batch=2,
                     seq_len=16, log_every=1, device="cpu")
    spans = _spans()
    caps = [e for e in spans if e.name == "train.capture"]
    steps = sorted((e for e in spans if e.name == "train.step"),
                   key=lambda e: e.t0)
    assert len(caps) == 1 and len(steps) == 3 and res.captures == 1
    assert caps[0].t0 + caps[0].dur <= steps[0].t0
    assert {e.cat for e in steps} == {"device"}
    assert len(res.step_s) == 4
    assert all(s > e.dur for s, e in zip(res.step_s[1:], steps))
    assert res.step_s[0] > caps[0].dur


def test_step_seconds_stay_the_host_clock_without_spans(graphs,
                                                        monkeypatch):
    """With tracing off the graphed step records no span: its step
    seconds are the host's."""
    monkeypatch.setattr(trace, "ENABLED", False)
    trace.clear()
    made = []
    real = loop.make_loop_step
    monkeypatch.setattr(loop, "make_loop_step", lambda *a, **k: (
        made.append(real(*a, **k)) or made[-1]))
    t0 = time.perf_counter()
    res = loop.train(_train_cfg(), None, None, n_steps=3, global_batch=2,
                     seq_len=16, log_every=1, device="cpu")
    assert len(res.step_s) == 3 and sum(res.step_s) <= (
        time.perf_counter() - t0)
    assert all(s > 0 for s in res.step_s)
    step_fn = made[0][0]
    assert isinstance(step_fn, GraphedTrainStep) and res.captures == 1
    assert trace.events() == []


# ------------------------------------------------------------ the merger

def test_merge_gives_device_spans_a_thread_and_equals_the_reference(
        enabled, tmp_path):
    """A dump without device spans merges to the reference's timeline; the
    ``device`` category has a thread of its own."""
    with trace.span("host", cat="t"):
        pass
    plain = tmp_path / "plain"
    trace.dump(role="unit", trace_dir=str(plain))
    assert trace.merge_dir(plain) == r_trace.merge_dir(plain)
    with trace.device_span("dev", "cpu"):
        pass
    both = tmp_path / "both"
    trace.dump(role="unit", trace_dir=str(both))
    evs = trace.merge_dir(both)["traceEvents"]
    tid = {e["name"]: e["tid"] for e in evs if e["ph"] == "X"}
    names = {e["tid"]: e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert tid["host"] != tid["dev"] and names[tid["dev"]] == "device"
