"""The per-layer metrics read from the program's own spans (``spans.py``
and ``metrics/{save_cost_s,step_device_ms,engine_self_ms,
graph_capture_s}.py``): each reader on span lists made here, and through
traced runs of the tiny cells on the CPU, where fake graphs stand in for
the CUDA graphs the training step and the engine capture on a card."""
import time

import pytest

import harness
import spans
import tiny
from repro_torch.core import trace, tunables
from repro_torch.kernels import ops
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import loop
from repro_torch.train.step import GraphedTrainStep

NEW = ["save_cost_s.train", "step_device_ms.train",
       "engine_self_ms.smollm-135m", "graph_capture_s"]


def read(metric: str, ctx: dict):
    mod, part = harness.reader(metric)
    return mod.read(ctx, part)


@pytest.fixture
def ring(monkeypatch):
    """An empty ring of its own, tracing on; ``add(name, t0, dur, ...)``
    puts a span in it and returns it."""
    rec = trace.FlightRecorder()
    monkeypatch.setattr(trace, "_RECORDER", rec)
    monkeypatch.setattr(trace, "ENABLED", True)
    ids = iter(range(1, 10 ** 6))

    def add(name, t0, dur, parent=None, launch=None, cat="repro"):
        ev = trace.SpanEvent(name=name, trace_id=1, span_id=next(ids),
                             parent_id=parent, t0=t0, dur=dur, pid=1,
                             cat=cat, args={} if launch is None
                             else {"launch_t": launch})
        rec.add(ev)
        return ev
    return add


def _train_spans(add, periods, durs, hold_at, write_until):
    """Steps whose device starts are ``periods`` apart, each launched 5 ms
    before its start, and a save whose snapshot ends 0.2 s after step
    ``hold_at`` is launched and whose write ends at ``write_until``."""
    t, steps = 10.0, []
    for p, d in zip(periods + [1.0], durs):
        steps.append(add("train.step", t, d, launch=t - 0.005,
                         cat="device"))
        t += p
    save = add("ckptmgr.save", steps[hold_at].t0, 0.1)
    add("ckptmgr.drain", steps[hold_at].t0, 0.1, parent=save.span_id)
    add("ckptmgr.snapshot", steps[hold_at].t0 + 0.1, 0.1,
        parent=save.span_id)
    add("ckptmgr.write", steps[hold_at].t0 + 0.2,
        write_until - steps[hold_at].t0 - 0.2, parent=save.span_id)
    return steps


def test_save_cost_and_steady_step_read_the_steps_around_the_write(ring):
    """Ten window steps after two of set-up: step 3 holds the loop for 2 s
    (the save's hold, outside the sum), steps 4-6 are launched while the
    write runs, each 0.5 s longer than the steady 1 s: 1.5 s of
    contention; the steady step is the median device time of the steps
    launched outside the write."""
    periods = [1.0, 1.0, 1.0, 1.0, 1.0, 3.0, 1.5, 1.5, 1.5, 1.0, 1.0]
    durs = [0.9] * 6 + [1.2] * 3 + [0.9] * 3
    _train_spans(ring, periods, durs, hold_at=5,
                 write_until=10.0 + sum(periods[:8]) + 0.5)
    ctx = {"steps": 10}
    assert read("save_cost_s.train", ctx) == pytest.approx(1.5)
    assert read("step_device_ms.train", ctx) == pytest.approx(900.0)
    got = spans.train_steps(ctx)
    assert got[2] == [False] * 4 + [True] * 3 + [False] * 3 and got[3]


def test_no_write_contention_reads_zero_and_no_save_reads_nothing(ring):
    periods = [1.0] * 9
    _train_spans(ring, periods, [0.9] * 10, hold_at=2,
                 write_until=10.0 + 2.5)
    ctx = {"steps": 10}
    assert read("save_cost_s.train", ctx) == pytest.approx(0.0)
    assert read("step_device_ms.train", ctx) == pytest.approx(900.0)


def test_span_readers_read_nothing_where_spans_are_missing(ring,
                                                          monkeypatch):
    """Fewer steps, requests or captures than the window had (a ring that
    evicted them, or a program without the spans), no save, a save whose
    spans are gone, or a full ring for the set-up's captures: no reading,
    never a short one.  A full ring still gives the window's readings
    while the window's spans are all there."""
    ctx = {"steps": 10, "recs": [{}] * 3}
    for m in NEW:
        assert read(m, ctx) is None
    for i in range(10):
        ring("train.step", 10.0 + i, 0.9, launch=10.0 + i, cat="device")
    assert read("save_cost_s.train", ctx) is None     # no save
    assert read("step_device_ms.train", ctx) == pytest.approx(900.0)
    assert read("save_cost_s.train", {"steps": 11}) is None
    assert read("step_device_ms.train", {"steps": 11}) is None
    ring("train.capture", 1.0, 2.0)
    assert read("graph_capture_s", ctx) == pytest.approx(2.0)
    saved = {"steps": 10, "ckpt": {"saves": 1}}
    assert read("save_cost_s.train", saved) is None
    assert read("step_device_ms.train", saved) is None
    monkeypatch.setattr(tunables, "TRACE_RING", len(trace.events()))
    assert read("graph_capture_s", ctx) is None
    assert read("step_device_ms.train", ctx) == pytest.approx(900.0)
    assert read("save_cost_s.train", ctx) is None     # still no save


def _request(add, t0, gen, prefill, decode=None):
    g = add("serve.generate", t0, gen)
    add("serve.inputs", t0, 0.001, parent=g.span_id)
    if prefill is not None:
        add("serve.prefill", t0 + 0.002, prefill, parent=g.span_id,
            launch=t0 + 0.002, cat="device")
    if decode is not None:
        add("serve.decode", t0 + 0.002 + prefill, decode, parent=g.span_id,
            launch=t0 + 0.003, cat="device")
    add("serve.read", t0 + gen - 0.001, 0.001, parent=g.span_id)
    return g


def test_engine_self_time_is_the_request_less_its_device_time(ring):
    """The warm-up request (its captures inside) is left out; the median
    over the window's three requests of the request's time less its
    prefill's and decode's device time."""
    warm = _request(ring, 1.0, 3.0, 0.14)
    ring("serve.capture", 1.01, 1.5, parent=warm.span_id)
    ring("serve.capture", 2.51, 1.2, parent=warm.span_id)
    _request(ring, 5.0, 0.15, 0.14)
    _request(ring, 6.0, 0.20, 0.14, decode=0.05)
    _request(ring, 7.0, 0.16, 0.14)
    ctx = {"recs": [{}] * 3}
    assert read("engine_self_ms.smollm-135m", ctx) == pytest.approx(10.0)
    assert read("graph_capture_s", ctx) == pytest.approx(2.7)
    _request(ring, 8.0, 0.16, None)           # its prefill span is gone
    assert read("engine_self_ms.smollm-135m", ctx) is None


# -------------------------------------------------- traced runs on the CPU

@pytest.fixture(autouse=True)
def _this_process_may_hold_jax(monkeypatch):
    """As in test_bench_cells.py: other test files of this process import
    the JAX package."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


class _FakeGraph:
    def __init__(self, step, out=None):
        self.step, self.out = step, out

    def replay(self):
        with ops.uncounted():
            new = self.step()
        for k, v in (new or {}).items():
            self.out[k].copy_(v)


@pytest.fixture
def graphs(monkeypatch):
    """The step's and the engine's graph paths on the CPU, each capture a
    fake graph that replays the step (a capture runs nothing: the state
    is put back)."""
    from repro_torch.models.params import tree_leaves

    def record(self, step):
        state = step.args[0]
        saved = [t.clone() for t in tree_leaves(state)]
        out = step()
        for t, s in zip(tree_leaves(state), saved):
            t.copy_(s)
        return _FakeGraph(step, out), out

    def capture(self, step):
        with ops.uncounted():
            step()                                  # the warm-up
        return ops.CountedGraph(_FakeGraph(step), {})

    monkeypatch.setattr(loop, "_use_graphs", lambda dev: True)
    monkeypatch.setattr(GraphedTrainStep, "_record", record)
    monkeypatch.setattr(ServeEngine, "_use_graphs", lambda self: True)
    monkeypatch.setattr(ServeEngine, "_capture", capture)
    monkeypatch.setattr(trace, "ENABLED", True)
    trace.clear()
    yield
    trace.clear()


@pytest.mark.parametrize("hf,wl,names", [
    (tiny.LLAMA, tiny.TRAIN, ["save_cost_s.train", "step_device_ms.train",
                              "graph_capture_s"]),
    (tiny.LLAMA, tiny.PREFILL, ["engine_self_ms.smollm-135m",
                                "graph_capture_s"])],
    ids=["train", "prefill"])
def test_a_traced_tiny_run_reports_the_span_metrics(graphs, hf, wl, names):
    cell = tiny.cell(hf, wl)
    cell.per_layer = cell.per_layer + [{"name": n, "unit": "u"}
                                       for n in names]
    res = harness.run_cell(cell, 2 ** 33 + 7, 0.3, True, "cpu",
                           time.perf_counter())
    assert res["correct"] is True, res["checks"]
    got = {n: res["metrics"][n]["value"] for n in names
           if n in res["metrics"]}
    assert set(got) == set(names), res["metrics"]
    assert got["graph_capture_s"] > 0
    if "step_device_ms.train" in got:
        assert got["step_device_ms.train"] > 0
    else:
        assert got["engine_self_ms.smollm-135m"] >= 0
