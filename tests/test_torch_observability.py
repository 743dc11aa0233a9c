"""The port's flight recorder and metrics (``repro_torch.core.trace``,
``repro_torch.core.metrics``) against the reference's: twins of
tests/test_observability.py.

Where the packages must agree they run side by side in this process: every
event type crosses between the two packages' wire decoders, the metrics
primitives give the reference's snapshots for the same calls, the key sets
of ``MPIJob.stats()`` and of the checkpoint managers' stats are the
reference's, and a port job's and a reference job's dumps merge into one
Chrome-trace timeline, the same JSON from either package's merger.  Each
package keeps its own recorder, so a port job never writes into the
reference's ring or the other way round."""
import json
import os
import threading

import numpy as np
import pytest

from repro.core import MPIJob as RJob
from repro.core import metrics as r_metrics
from repro.core import trace as r_trace
from repro_torch.core import MPIJob
from repro_torch.core import metrics
from repro_torch.core import trace


def _acc_app(n_elems: int = 32):
    def init(mpi):
        return {"seed": mpi.rank, "acc": np.zeros(n_elems), "steps_run": 0}

    def step(mpi, st, k):
        rng = np.random.default_rng(1000 * k + st["seed"])
        x = rng.standard_normal(n_elems)
        tot = mpi.Allreduce(x, op="sum", algo="ring")
        return {"seed": st["seed"], "acc": st["acc"] + tot,
                "steps_run": st["steps_run"] + 1}
    return init, step


@pytest.fixture
def enabled():
    """Tracing on in both packages for the test, restored after."""
    prev = trace.ENABLED, r_trace.ENABLED
    trace.set_enabled(True)
    r_trace.set_enabled(True)
    yield
    trace.set_enabled(prev[0])
    r_trace.set_enabled(prev[1])


# ------------------------------------------------------- event schema

def _samples(mod):
    return {
        "span": mod.SpanEvent(
            name="rank.ckpt", trace_id=7, span_id=11, parent_id=5,
            t0=1.25, dur=0.5, pid=4242, cat="rank", rank=2, generation=3,
            args={"step": 9, "outcome": "resumed"}),
        "instant": mod.InstantEvent(
            name="fault.rank_died", trace_id=8, span_id=None,
            parent_id=None, t=2.5, pid=4243, cat="coord", rank=1,
            generation=None, args={"error": "RankProcessDied"}),
    }


def test_every_event_type_survives_wire_roundtrip():
    """Every event type of either package is lossless through its own
    to_wire -> JSON -> from_wire and through the other package's decoder:
    a dump written by one merges in the other."""
    assert set(trace.EVENT_TYPES) == set(r_trace.EVENT_TYPES)
    ours, theirs = _samples(trace), _samples(r_trace)
    assert set(ours) == set(trace.EVENT_TYPES), \
        "new event type added without a round-trip sample"
    for kind in ours:
        wire = json.loads(json.dumps(ours[kind].to_wire()))
        assert wire == theirs[kind].to_wire()
        assert wire["kind"] == kind
        assert trace.from_wire(wire) == ours[kind]
        assert r_trace.from_wire(wire) == theirs[kind]
        back = json.loads(json.dumps(theirs[kind].to_wire()))
        assert trace.from_wire(back) == ours[kind]


def test_ring_is_bounded():
    rec, ref = trace.FlightRecorder(cap=16), r_trace.FlightRecorder(cap=16)
    for i in range(100):
        rec.add(i)
        ref.add(i)
    assert len(rec) == len(ref) == 16
    assert rec.snapshot() == ref.snapshot() == list(range(84, 100))


def test_disabled_tracing_is_noop(enabled):
    trace.set_enabled(False)
    before, ref_before = len(trace.recorder()), len(r_trace.recorder())
    assert trace.span("x") is trace.span("y")          # shared null object
    with trace.span("x") as s:
        s.end(extra=1)
    trace.instant("x")
    win = trace.BatchWindow("w")
    win.add(0.001, 3)
    win.flush()
    assert len(trace.recorder()) == before
    assert len(r_trace.recorder()) == ref_before     # rings are separate


def test_span_nesting_and_explicit_parent(enabled):
    trace.clear()
    with trace.span("outer", cat="t") as outer:
        with trace.span("inner", cat="t"):             # thread-local parent
            pass
        trace.instant("mark", cat="t")                 # ditto
    detached = trace.begin("detached", parent=outer.ctx, cat="t")
    detached.end()
    evs = {e.name: e for e in trace.recorder().snapshot()}
    assert evs["inner"].parent_id == outer.span_id
    assert evs["inner"].trace_id == outer.trace_id
    assert evs["mark"].parent_id == outer.span_id
    assert evs["detached"].parent_id == outer.span_id
    assert evs["outer"].parent_id is None


def test_dump_merge_roundtrip(tmp_path, enabled):
    """A port dump loads and merges in both packages, to the same
    timeline."""
    trace.clear()
    with trace.span("parent", cat="t", rank=0):
        with trace.span("child", cat="t", rank=0):
            pass
    path = trace.dump(role="unit", trace_dir=str(tmp_path))
    assert path is not None and path.exists()
    meta, events = trace.load_dump(path)
    assert meta["pid"] == os.getpid() and meta["role"] == "unit"
    assert {e.name for e in events} >= {"parent", "child"}
    _, ref_events = r_trace.load_dump(path)
    assert [e.to_wire() for e in ref_events] == [e.to_wire() for e in events]
    merged = trace.merge_dir(tmp_path)
    assert r_trace.merge_dir(tmp_path) == merged
    spans = {e["name"]: e for e in merged["traceEvents"] if e["ph"] == "X"}
    assert spans["child"]["args"]["parent_id"] == \
        spans["parent"]["args"]["span_id"]
    assert spans["child"]["ts"] >= spans["parent"]["ts"]


def test_dump_is_noop_without_trace_dir(monkeypatch):
    monkeypatch.delenv("REPRO_TRACE_DIR", raising=False)
    assert trace.dump(role="nowhere") is None


# --------------------------------------------------- metrics primitives

def test_metric_group_mapping_contract():
    for mod in (metrics, r_metrics):
        g = mod.MetricGroup("t", {"a": 0, "b": 1.5})
        g["a"] += 2                                  # the old stats idiom
        g["c"] = g.get("c", 0.0) + 0.25              # serialization idiom
        assert g.add("a", 3) == 5
        assert dict(g) == {"a": 5, "b": 1.5, "c": 0.25}
        assert g["b"] == 1.5 and "c" in g and len(g) == 3
        assert g.snapshot() == dict(g)
        assert g == {"a": 5, "b": 1.5, "c": 0.25}    # Mapping equality


def test_labeled_counter_bounds_its_series():
    assert metrics.OVERFLOW_LABEL == r_metrics.OVERFLOW_LABEL
    snaps = []
    for mod in (metrics, r_metrics):
        c = mod.LabeledCounter("t", max_series=3)
        for i in range(10):
            c.inc(f"label{i}")
        snaps.append(c.snapshot())
    assert snaps[0] == snaps[1]
    assert len(snaps[0]) == 4                        # 3 series + overflow
    assert snaps[0][metrics.OVERFLOW_LABEL] == 7


def test_histogram_buckets():
    snaps = []
    for mod in (metrics, r_metrics):
        h = mod.Histogram("t", buckets=(0.001, 0.01, 0.1))
        for v in (0.0005, 0.005, 0.05, 5.0):
            h.observe(v)
        snaps.append(h.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["count"] == 4
    assert snaps[0]["counts"] == [1, 1, 1, 1]        # last = +inf bucket
    assert snaps[0]["min"] == 0.0005 and snaps[0]["max"] == 5.0


def test_registry_snapshot_sees_live_groups():
    g = metrics.MetricGroup("registry_probe", {"x": 1})
    snap = metrics.REGISTRY.snapshot()
    assert any(s["name"] == "registry_probe" and s["values"] == {"x": 1}
               for s in snap)
    # each package has its own registry
    assert not any(s["name"] == "registry_probe"
                   for s in r_metrics.REGISTRY.snapshot())
    del g


def test_metric_group_snapshot_survives_concurrent_new_keys():
    """Snapshots under the group lock cannot tear while another thread
    adds fresh keys."""
    g = metrics.MetricGroup("concurrent", {"base": 0})
    stop = threading.Event()
    errors = []

    def mutate():
        i = 0
        try:
            while not stop.is_set():
                g.add(f"k{i % 512}", 1)          # fresh keys force resizes
                i += 1
        except BaseException as e:   # noqa: BLE001 - surfaced below
            errors.append(e)

    t = threading.Thread(target=mutate)
    t.start()
    try:
        for _ in range(500):
            snap = g.snapshot()
            assert snap["base"] == 0
            list(g.items())
            dict(g)
    finally:
        stop.set()
        t.join(10.0)
    assert not errors


# ------------------------------------------- stats() compatibility pins

JOB_STATS_KEYS = {"transport", "world_size", "live_ranks", "generation",
                  "coordinator", "telemetry", "stragglers", "ledger",
                  "ckpt_store"}

COORD_STATS_KEYS = {
    "drain_rounds", "drain_wall_s", "drained_messages", "checkpoints",
    "counter_reports", "empty_channel_snapshots", "stale_rejected",
    "migrations", "migrate_rounds", "migrate_pause_s", "recoveries",
    "recovery_wall_s", "recovered_ops", "rerun_ops", "recovery_cancelled"}

CKPT_MANAGER_STATS_KEYS = {
    "saves", "drain_s", "snapshot_s", "write_s", "gc_removed", "hash_s",
    "compress_s", "io_s", "bytes_written", "bytes_referenced",
    "last_bytes_written", "last_bytes_referenced", "chunks_gc_removed",
    "last_bytes_uploaded", "last_bytes_referenced_remote", "restores",
    "restore_io_s", "restore_decompress_s", "restore_device_s"}


def _stats(job_cls):
    init, step = _acc_app()
    job = job_cls(2, step, init, transport="shm")
    try:
        job.run(2, timeout=60)
        return job.stats()
    finally:
        job.stop()


def test_job_stats_keys_pinned_and_snapshot_is_plain_data():
    s, ref = _stats(MPIJob), _stats(RJob)
    assert set(s) == set(ref) == JOB_STATS_KEYS
    assert set(s["coordinator"]) == set(ref["coordinator"]) \
        == COORD_STATS_KEYS
    assert isinstance(s["coordinator"], dict)    # a snapshot, not live
    assert s["coordinator"]["counter_reports"] > 0
    plain = ("transport", "world_size", "live_ranks", "generation")
    assert {k: s[k] for k in plain} == {k: ref[k] for k in plain}
    json.dumps({k: s[k] for k in plain + ("coordinator",)})


def test_ckpt_manager_stats_keys_pinned(tmp_path):
    from repro.checkpoint.manager import CheckpointManager as RManager
    from repro_torch.checkpoint.manager import CheckpointManager
    mgr = CheckpointManager(tmp_path / "port", keep=2)
    ref = RManager(tmp_path / "ref", keep=2)
    assert set(mgr.stats.keys()) == set(ref.stats.keys()) \
        == CKPT_MANAGER_STATS_KEYS
    assert isinstance(mgr.stats, metrics.MetricGroup)
    # the serialization read-modify-write idiom keeps working
    mgr.stats["hash_s"] = mgr.stats.get("hash_s", 0.0) + 0.5
    assert mgr.stats["hash_s"] == 0.5


def test_job_stats_consistent_under_concurrent_mutation():
    """stats() against a thread bumping fresh coordinator counters."""
    init, step = _acc_app()
    job = MPIJob(2, step, init, transport="inproc")
    stop = threading.Event()
    errors = []

    def hammer():
        i = 0
        try:
            while not stop.is_set():
                job.coord.stat_add(f"dyn_{i % 256}", 1)
                i += 1
        except BaseException as e:   # noqa: BLE001 - surfaced below
            errors.append(e)

    t = threading.Thread(target=hammer)
    t.start()
    try:
        for _ in range(500):
            s = job.stats()
            assert s["world_size"] == 2
            assert COORD_STATS_KEYS <= set(s["coordinator"])
    finally:
        stop.set()
        t.join(10.0)
        job.stop()
    assert not errors


# -------------------------------------------- thread-world dump + merge

def _traced_run(job_cls, mod, tdir, ck):
    """A 2-rank shm world checkpointed at step 2 of 4, its ring dumped to
    `tdir`; the ranks' results."""
    mod.clear()
    init, step = _acc_app()
    job = job_cls(2, step, init, transport="shm")
    job.checkpoint_at(2, ck)
    out = job.run(4, timeout=60)
    path = job.dump_trace(tdir)
    job.stop()
    job.dump_trace(tdir)             # re-dumps with the flushed windows
    assert path is not None and path.exists()
    return out


def _check_timeline(merged):
    evs = merged["traceEvents"]
    spans = [e for e in evs if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    assert {"coord.ckpt_round", "coord.pending", "coord.drain",
            "coord.snapshot", "coord.resume", "rank.ckpt", "rank.drain",
            "rank.save_image", "proxy.batch"} <= names, names
    rounds = {e["args"]["span_id"] for e in spans
              if e["name"] == "coord.ckpt_round"}
    rank_ckpts = [e for e in spans if e["name"] == "rank.ckpt"]
    assert rank_ckpts
    assert all(e["args"].get("parent_id") in rounds for e in rank_ckpts)
    saves = [e for e in spans if e["name"] == "rank.save_image"]
    ckpt_ids = {e["args"]["span_id"] for e in rank_ckpts}
    assert all(e["args"].get("parent_id") in ckpt_ids for e in saves)
    ts = [e.get("ts", 0.0) for e in evs]
    assert ts == sorted(ts)          # the merger's output contract
    return spans


def test_thread_world_checkpoint_timeline(tmp_path, enabled):
    """A traced port world with one mid-run checkpoint dumps a driver ring
    whose merged timeline carries the whole span taxonomy: the coordinator
    round and phase spans, each rank's checkpoint dance nested under the
    round, the proxies' batch windows.  The reference's world dumps the
    same taxonomy, and one merge of both dumps, by either package's
    merge CLI, is one timeline that holds both."""
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    out = _traced_run(MPIJob, trace, port_dir, tmp_path / "ck_port")
    ref = _traced_run(RJob, r_trace, ref_dir, tmp_path / "ck_ref")
    assert all(out[r]["steps_run"] == 4 for r in range(2))
    for r in range(2):
        assert np.array_equal(out[r]["acc"], ref[r]["acc"])
    port_spans = _check_timeline(trace.merge_dir(port_dir))
    ref_spans = _check_timeline(r_trace.merge_dir(ref_dir))
    assert {e["name"] for e in port_spans} == {e["name"] for e in ref_spans}

    dumps = [str(p) for d in (port_dir, ref_dir)
             for p in sorted(d.glob("trace-*.jsonl"))]
    assert len(dumps) == 2
    merged = {}
    for name, mod in (("port", trace), ("ref", r_trace)):
        dest = tmp_path / f"timeline-{name}.json"
        assert mod.main(["merge", *dumps, "-o", str(dest)]) == 0
        merged[name] = json.loads(dest.read_text())
    assert merged["port"] == merged["ref"]
    both = _check_timeline(merged["port"])
    assert len(both) == len(port_spans) + len(ref_spans)
