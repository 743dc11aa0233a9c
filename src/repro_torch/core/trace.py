"""Flight recorder + cross-process tracing (DESIGN.md §16).

Every process in a world — the driver/coordinator parent, each forked
rank child, the chunk service — keeps a bounded in-memory ring of typed
trace events (spans with trace/span/parent ids + instants), appended by
the proxy batch path, the unified rank FSM, the checkpoint pipeline,
chunk-store RPCs, the coordinator's recovery sub-FSM and migration
rounds.  The ring is dumped to ``REPRO_TRACE_DIR`` as one JSON-lines
file per process on fault/abort/exit (and on demand via
``MPIJob.dump_trace()``); the merger assembles the per-process dumps
into a single Chrome-trace/Perfetto JSON timeline:

    python -m repro_torch.core.trace merge $REPRO_TRACE_DIR -o timeline.json

Design constraints, in order:

  * ``REPRO_TRACE=0`` compiles to no-ops: every emit helper checks one
    module-level flag first and returns a shared null object, so the
    disabled cost is a global load + branch.  The enabled cost is
    CI-gated (<= 5% on the proxied allreduce loop,
    BENCH_observability.json).
  * Causality beats precision: span ids parent child work under the
    coordinating operation, propagated across the proc-world socket
    boundary by piggybacking ``(trace_id, span_id)`` on the coord-state
    tuple every reply frame already carries.  Timestamps are
    CLOCK_MONOTONIC, which on Linux is one system-wide clock for every
    forked process of a world; each dump header records a paired
    ``(monotonic, wall)`` sample so the merger can place dumps from
    different boots/hosts on one wall-clock axis (§16 clock-alignment
    note).
  * The ring is bounded (``REPRO_TRACE_RING`` events, oldest evicted):
    a week-long world dumps the same size file as a ten-second test.
  * fork() inherits the parent's ring; an ``os.register_at_fork`` hook
    clears it in the child so rank dumps contain only their own events.
  * Device spans (``device_span``) time work queued on a CUDA stream
    with two timing events, never a synchronize: they wait in the
    recorder until their end event has completed and are resolved into
    ordinary spans (``cat="device"``) when the ring is read.  One anchor
    a device (an event whose completion the host saw at a known
    CLOCK_MONOTONIC time) puts them on the host spans' clock.
"""
from __future__ import annotations

import itertools
import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple, Union

from repro_torch.core import tunables

# -- enable flag -------------------------------------------------------------
# Read once from the environment; benchmarks and tests flip it at runtime
# via set_enabled().
ENABLED: bool = tunables.TRACE_ENABLED


def set_enabled(on: bool) -> None:
    global ENABLED
    ENABLED = bool(on)


# -- ids ---------------------------------------------------------------------
_rand = random.Random()
_seq = itertools.count(1)
#: this process's pid, read once and again in a forked child: where system
#: calls are trapped, ``os.getpid()`` costs ten microseconds or more a
#: call, as much as the rest of a span
_PID = os.getpid()


def _read_pid() -> None:
    global _PID
    _PID = os.getpid()


if hasattr(os, "register_at_fork"):          # pragma: no branch
    os.register_at_fork(after_in_child=_read_pid)


def _new_trace_id() -> int:
    return _rand.getrandbits(63) or 1


def _new_span_id() -> int:
    # pid-salted sequence: unique within a process, disjoint across the
    # forked children of one world (pid differs), cheap to mint
    return (_PID << 24) ^ next(_seq) ^ (_rand.getrandbits(20) << 44)


# -- typed events ------------------------------------------------------------

@dataclass
class SpanEvent:
    """A closed span: an operation with duration, parented by span id."""
    name: str
    trace_id: int
    span_id: int
    parent_id: Optional[int]
    t0: float                       # CLOCK_MONOTONIC seconds, span start
    dur: float                      # seconds
    pid: int
    cat: str = "repro"
    rank: Optional[int] = None
    generation: Optional[int] = None
    args: dict = field(default_factory=dict)

    kind = "span"

    def to_wire(self) -> dict:
        d = asdict(self)
        d["kind"] = self.kind
        return d


@dataclass
class InstantEvent:
    """A point event (a fault observed, a lifecycle edge)."""
    name: str
    trace_id: int
    span_id: Optional[int]
    parent_id: Optional[int]
    t: float                        # CLOCK_MONOTONIC seconds
    pid: int
    cat: str = "repro"
    rank: Optional[int] = None
    generation: Optional[int] = None
    args: dict = field(default_factory=dict)

    kind = "instant"

    def to_wire(self) -> dict:
        d = asdict(self)
        d["kind"] = self.kind
        return d


EVENT_TYPES = {SpanEvent.kind: SpanEvent, InstantEvent.kind: InstantEvent}


def from_wire(d: dict) -> Union[SpanEvent, InstantEvent]:
    d = dict(d)
    cls = EVENT_TYPES[d.pop("kind")]
    return cls(**d)


# -- flight recorder ---------------------------------------------------------

class FlightRecorder:
    """Bounded per-process ring of events.  ``deque.append`` is atomic
    under the GIL, so the hot emit path takes no lock; ``snapshot`` and
    ``clear`` are the only multi-step operations.

    Device spans whose end has not completed on the device wait beside
    the ring (``hold``), as many as the ring holds events; ``snapshot``
    first moves every finished one into the ring."""

    def __init__(self, cap: Optional[int] = None):
        self._buf: deque = deque(maxlen=cap or tunables.TRACE_RING)
        self._pending: deque = deque()
        self._lock = threading.Lock()

    def add(self, ev) -> None:
        self._buf.append(ev)

    def hold(self, span: "_DeviceSpan") -> None:
        """Keeps a closed device span until its end event is done; when
        as many wait as the ring holds, the finished ones are resolved and,
        if none is, the oldest is dropped."""
        with self._lock:
            if len(self._pending) >= self._buf.maxlen:
                self._resolve()
                if len(self._pending) >= self._buf.maxlen:
                    self._pending.popleft()
            self._pending.append(span)

    def _resolve(self) -> None:
        keep = deque()
        for sp in self._pending:
            if sp.done():
                self._buf.append(sp.event())
            else:
                keep.append(sp)
        self._pending = keep

    def clear(self) -> None:
        with self._lock:
            self._pending.clear()
        self._buf.clear()

    def _after_fork(self) -> None:
        """The child's empty recorder: a new lock, since a thread of the
        parent may have held the old one at the fork."""
        self._lock = threading.Lock()
        self.clear()

    def __len__(self) -> int:
        return len(self._buf)

    def snapshot(self) -> list:
        if self._pending:
            with self._lock:
                self._resolve()
        return list(self._buf)


_RECORDER = FlightRecorder()

# fork() copies the parent's ring into the child: clear it so a rank
# child's dump holds only events that happened in that rank's process
if hasattr(os, "register_at_fork"):          # pragma: no branch
    os.register_at_fork(after_in_child=_RECORDER._after_fork)


def recorder() -> FlightRecorder:
    return _RECORDER


def clear() -> None:
    _RECORDER.clear()


def events() -> list:
    """The recorded events, oldest first (a device span is placed when it
    is resolved, after the host spans that closed while it ran)."""
    return _RECORDER.snapshot()


# -- span context ------------------------------------------------------------

Ctx = Tuple[int, int]                       # (trace_id, span_id)

_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_ctx() -> Optional[Ctx]:
    """The innermost open span on THIS thread, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def _resolve_parent(parent) -> Tuple[int, Optional[int]]:
    """-> (trace_id, parent_span_id) from an explicit parent (ctx tuple
    or _Span), the thread-local stack, or a fresh root."""
    if parent is not None:
        if isinstance(parent, _Span):
            parent = parent.ctx
        elif isinstance(parent, _NullSpan):
            parent = None                    # tracing toggled mid-operation
        if parent:                           # (trace_id, span_id)
            return parent[0], parent[1]
    cur = current_ctx()
    if cur is not None:
        return cur[0], cur[1]
    return _new_trace_id(), None


class _Span:
    """An open span.  Context-manager use attaches it to the thread's
    context stack; ``begin()``/``end()`` handle use (the coordinator's
    phase spans, which open and close from different callers) does not.
    ``end`` is idempotent."""

    __slots__ = ("name", "cat", "rank", "generation", "args",
                 "trace_id", "span_id", "parent_id", "t0", "_open",
                 "_attached")

    def __init__(self, name: str, parent=None, cat: str = "repro",
                 rank: Optional[int] = None,
                 generation: Optional[int] = None,
                 args: Optional[dict] = None):
        self.name = name
        self.cat = cat
        self.rank = rank
        self.generation = generation
        self.args = dict(args) if args else {}
        self.trace_id, self.parent_id = _resolve_parent(parent)
        self.span_id = _new_span_id()
        self.t0 = time.monotonic()
        self._open = True
        self._attached = False

    @property
    def ctx(self) -> Ctx:
        return (self.trace_id, self.span_id)

    def __enter__(self) -> "_Span":
        _stack().append(self.ctx)
        self._attached = True
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._attached:
            st = _stack()
            if st and st[-1] == self.ctx:
                st.pop()
            self._attached = False
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self.end()

    def end(self, **extra) -> None:
        if not self._open:
            return
        self._open = False
        if extra:
            self.args.update(extra)
        _RECORDER.add(SpanEvent(
            name=self.name, trace_id=self.trace_id, span_id=self.span_id,
            parent_id=self.parent_id, t0=self.t0,
            dur=time.monotonic() - self.t0, pid=_PID, cat=self.cat,
            rank=self.rank, generation=self.generation, args=self.args))


# -- device spans ------------------------------------------------------------

#: device index -> (event, CLOCK_MONOTONIC seconds at which the host saw
#: it complete)
_ANCHORS: Dict[int, tuple] = {}
if hasattr(os, "register_at_fork"):          # pragma: no branch
    os.register_at_fork(after_in_child=_ANCHORS.clear)


def _take_anchor(device):
    import torch
    torch.cuda.synchronize(device)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    ev.synchronize()
    return ev, time.monotonic()


def _cuda_device(device):
    import torch
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class _DeviceSpan(_Span):
    """A span of the work queued on ``device``'s current stream inside the
    block.  On CUDA, a timing event is recorded at entry and at exit and
    the closed span waits in the recorder until the exit event is done;
    it then becomes a ``SpanEvent`` whose ``t0`` and ``dur`` are the
    device's, placed on CLOCK_MONOTONIC through the device's anchor.
    ``args["launch_t"]`` is the host's clock at entry.  Off CUDA, or
    inside a graph capture (where no timing event may be recorded), it
    is a host span.  Context-manager use only."""

    __slots__ = ("_stream", "_anchor", "_start", "_stop")

    def __init__(self, name: str, device, parent=None,
                 args: Optional[dict] = None):
        super().__init__(name, parent=parent, cat="device", args=args)
        self._start = self._stop = None
        import torch
        if torch.device(device).type != "cuda":
            return
        device = _cuda_device(device)
        if torch.cuda.is_current_stream_capturing():
            return
        self._stream = torch.cuda.current_stream(device)
        self._anchor = _ANCHORS.get(device.index)
        if self._anchor is None:
            self._anchor = _ANCHORS[device.index] = _take_anchor(device)
        self._start = torch.cuda.Event(enable_timing=True)

    def __enter__(self) -> "_DeviceSpan":
        self.t0 = time.monotonic()
        self.args["launch_t"] = self.t0
        if self._start is not None:
            self._start.record(self._stream)
        return super().__enter__()

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._start is not None:
            import torch
            self._stop = torch.cuda.Event(enable_timing=True)
            self._stop.record(self._stream)
        super().__exit__(exc_type, exc, tb)

    def end(self, **extra) -> None:
        if not self._open:
            return
        self._open = False
        self.args.update(extra)
        if self._start is None:
            _RECORDER.add(self._event(self.t0, time.monotonic() - self.t0))
        else:
            _RECORDER.hold(self)

    def done(self) -> bool:
        return self._stop is not None and self._stop.query()

    def event(self) -> SpanEvent:
        """The resolved span (its exit event done)."""
        ev, host = self._anchor
        return self._event(host + ev.elapsed_time(self._start) / 1e3,
                           self._start.elapsed_time(self._stop) / 1e3)

    def _event(self, t0: float, dur: float) -> SpanEvent:
        return SpanEvent(
            name=self.name, trace_id=self.trace_id, span_id=self.span_id,
            parent_id=self.parent_id, t0=t0, dur=dur, pid=_PID,
            cat=self.cat, rank=self.rank, generation=self.generation,
            args=self.args)


class _NullSpan:
    """Shared no-op stand-in when tracing is disabled."""

    __slots__ = ()
    ctx = None
    span_id = None
    trace_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def end(self, **extra):
        return None


_NULL = _NullSpan()


def span(name: str, parent=None, cat: str = "repro",
         rank: Optional[int] = None, generation: Optional[int] = None,
         args: Optional[dict] = None):
    """Context manager: open a span, parented under ``parent`` (a ctx
    tuple, e.g. one piggybacked off the wire) or the thread's current
    span.  No-op singleton when tracing is disabled."""
    if not ENABLED:
        return _NULL
    return _Span(name, parent=parent, cat=cat, rank=rank,
                 generation=generation, args=args)


def begin(name: str, parent=None, cat: str = "repro",
          rank: Optional[int] = None, generation: Optional[int] = None,
          args: Optional[dict] = None):
    """Open a detached span handle (not on any thread's stack): for
    operations that start and finish in different calls/threads, like
    the coordinator's FSM phases.  Close with ``handle.end()``."""
    if not ENABLED:
        return _NULL
    return _Span(name, parent=parent, cat=cat, rank=rank,
                 generation=generation, args=args)


def device_span(name: str, device, parent=None,
                args: Optional[dict] = None):
    """Context manager: a span of the work the block queues on ``device``
    (``_DeviceSpan``), parented like ``span()``.  It never synchronizes,
    except for the device's anchor, taken once a process at its first
    device span.  No-op singleton when tracing is disabled: no event is
    built and no anchor taken."""
    if not ENABLED:
        return _NULL
    return _DeviceSpan(name, device, parent=parent, args=args)


def instant(name: str, parent=None, cat: str = "repro",
            rank: Optional[int] = None, generation: Optional[int] = None,
            args: Optional[dict] = None) -> None:
    """Record a point event, parented like span()."""
    if not ENABLED:
        return
    trace_id, parent_id = _resolve_parent(parent)
    _RECORDER.add(InstantEvent(
        name=name, trace_id=trace_id, span_id=None, parent_id=parent_id,
        t=time.monotonic(), pid=_PID, cat=cat, rank=rank,
        generation=generation, args=dict(args) if args else {}))


class BatchWindow:
    """Aggregated span emitter for the proxy batch hot path.

    A span per batch would blow the overhead budget (a thread-world
    batch round trip is tens of microseconds), so the serve loop calls
    ``add(dt, ncmds)`` per replied batch and a ``proxy.batch`` span
    covering the whole window is emitted every ``every`` batches — the
    timeline shows proxy activity with per-window batch/command/busy
    counts at amortized ~1/64 of the per-batch cost.  The poll fast
    path (preallocated singleton frame) bypasses this entirely.
    """

    __slots__ = ("name", "cat", "rank", "every", "_n", "_cmds", "_busy",
                 "_t0")

    def __init__(self, name: str, rank: Optional[int] = None,
                 cat: str = "proxy", every: int = 64):
        self.name = name
        self.cat = cat
        self.rank = rank
        self.every = every
        self._n = 0
        self._cmds = 0
        self._busy = 0.0
        self._t0 = 0.0

    def add(self, dt: float, ncmds: int) -> None:
        if not ENABLED:
            return
        if self._n == 0:
            self._t0 = time.monotonic() - dt
        self._n += 1
        self._cmds += ncmds
        self._busy += dt
        if self._n >= self.every:
            self.flush()

    def flush(self) -> None:
        if self._n == 0:
            return
        t0 = self._t0
        _RECORDER.add(SpanEvent(
            name=self.name, trace_id=_new_trace_id(),
            span_id=_new_span_id(), parent_id=None, t0=t0,
            dur=time.monotonic() - t0, pid=_PID, cat=self.cat,
            rank=self.rank,
            args={"batches": self._n, "commands": self._cmds,
                  "busy_s": round(self._busy, 6)}))
        self._n = 0
        self._cmds = 0
        self._busy = 0.0


# -- dump / merge ------------------------------------------------------------

def _sanitize(role: str) -> str:
    return "".join(c if (c.isalnum() or c in "-_.") else "_" for c in role)


def dump(role: str = "proc", trace_dir: Optional[str] = None,
         ) -> Optional[Path]:
    """Write this process's ring to ``trace_dir`` (default:
    ``REPRO_TRACE_DIR``; None and unset -> no-op).  One JSON-lines file
    per (role, pid): a meta header with the paired (monotonic, wall)
    clock sample, then the events.  Rewrites in place on repeat dumps —
    the ring is a superset of the previous dump or the old events have
    been evicted either way."""
    d = trace_dir or tunables.trace_dir()
    if d is None:
        return None
    events = _RECORDER.snapshot()
    path = Path(d) / f"trace-{_sanitize(role)}-pid{os.getpid()}.jsonl"
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        meta = {"kind": "meta", "pid": os.getpid(), "role": role,
                "mono": time.monotonic(), "wall": time.time(),
                "events": len(events)}
        with open(path, "w") as f:
            f.write(json.dumps(meta, default=str) + "\n")
            for ev in events:
                f.write(json.dumps(ev.to_wire(), default=str) + "\n")
    except OSError:
        return None
    return path


def load_dump(path) -> Tuple[dict, list]:
    """-> (meta, [SpanEvent | InstantEvent, ...]) from one dump file."""
    meta: dict = {}
    events: list = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if d.get("kind") == "meta":
                meta = d
            else:
                events.append(from_wire(d))
    return meta, events


def merge_dumps(paths: Iterable) -> dict:
    """Merge per-process dumps into one Chrome-trace JSON object.

    Clock alignment: every event timestamp is CLOCK_MONOTONIC; each
    dump's meta header pairs a monotonic sample with a wall-clock one,
    so per-dump ``offset = wall - mono`` maps every event onto the
    wall-clock axis.  For the forked processes of one world the offsets
    agree to within the heartbeat-bounded skew (all processes share one
    system clock), so causal order across coordinator / ranks / chunk
    service is preserved exactly.

    Cross-process parent links (a child rank's span parented under the
    coordinator's save span via the piggybacked ctx) are rendered as
    Chrome flow events so Perfetto draws the arrows.
    """
    dumps = []
    for p in sorted(str(p) for p in paths):
        try:
            meta, events = load_dump(p)
        except (OSError, json.JSONDecodeError, KeyError):
            continue
        dumps.append((meta, events))

    out: List[dict] = []
    span_home: Dict[int, Tuple[int, float, object]] = {}
    tids = {}

    def tid_for(ev) -> int:
        if ev.rank is not None:
            return 100 + ev.rank
        return {"proxy": 2, "chunkservice": 3, "device": 4}.get(ev.cat, 1)

    for meta, events in dumps:
        pid = meta.get("pid", 0)
        role = meta.get("role", f"pid{pid}")
        offset = meta.get("wall", 0.0) - meta.get("mono", 0.0)
        out.append({"ph": "M", "name": "process_name", "pid": pid,
                    "tid": 0, "args": {"name": f"{role} (pid {pid})"}})
        for ev in events:
            tid = tid_for(ev)
            if (pid, tid) not in tids:
                tids[(pid, tid)] = True
                tname = (f"rank {ev.rank}" if ev.rank is not None
                         else ev.cat)
                out.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": tid, "args": {"name": tname}})
            args = dict(ev.args)
            args["trace_id"] = ev.trace_id
            if ev.generation is not None:
                args["generation"] = ev.generation
            if ev.kind == "span":
                ts = (ev.t0 + offset) * 1e6
                args["span_id"] = ev.span_id
                if ev.parent_id is not None:
                    args["parent_id"] = ev.parent_id
                out.append({"ph": "X", "name": ev.name, "cat": ev.cat,
                            "ts": ts, "dur": max(ev.dur, 1e-6) * 1e6,
                            "pid": pid, "tid": tid, "args": args})
                span_home[ev.span_id] = (pid, ts, ev)
            else:
                ts = (ev.t + offset) * 1e6
                if ev.parent_id is not None:
                    args["parent_id"] = ev.parent_id
                out.append({"ph": "i", "s": "g", "name": ev.name,
                            "cat": ev.cat, "ts": ts, "pid": pid,
                            "tid": tid, "args": args})

    # flow arrows for parent links that cross a process boundary
    flow_id = itertools.count(1)
    for meta, events in dumps:
        pid = meta.get("pid", 0)
        offset = meta.get("wall", 0.0) - meta.get("mono", 0.0)
        for ev in events:
            if ev.kind != "span" or ev.parent_id is None:
                continue
            home = span_home.get(ev.parent_id)
            if home is None or home[0] == pid:
                continue
            fid = next(flow_id)
            parent_pid, parent_ts, parent_ev = home
            out.append({"ph": "s", "id": fid, "name": "ctx",
                        "cat": "flow", "ts": parent_ts,
                        "pid": parent_pid, "tid": tid_for(parent_ev)})
            out.append({"ph": "f", "id": fid, "name": "ctx",
                        "cat": "flow", "bp": "e",
                        "ts": (ev.t0 + offset) * 1e6,
                        "pid": pid, "tid": tid_for(ev)})

    out.sort(key=lambda e: (e.get("ts", 0.0), e["ph"] != "M"))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def merge_dir(trace_dir) -> dict:
    return merge_dumps(Path(trace_dir).glob("trace-*.jsonl"))


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.trace",
        description="flight-recorder dump tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    mg = sub.add_parser("merge", help="merge per-process dumps into one "
                                      "Chrome-trace/Perfetto JSON file")
    mg.add_argument("inputs", nargs="+",
                    help="dump files, or a directory of trace-*.jsonl")
    mg.add_argument("-o", "--out", default="timeline.json")
    ns = ap.parse_args(argv)
    paths: List[Path] = []
    for inp in ns.inputs:
        p = Path(inp)
        if p.is_dir():
            paths.extend(sorted(p.glob("trace-*.jsonl")))
        else:
            paths.append(p)
    merged = merge_dumps(paths)
    Path(ns.out).write_text(json.dumps(merged))
    n = sum(1 for e in merged["traceEvents"] if e["ph"] in ("X", "i"))
    print(f"merged {len(paths)} dump(s), {n} events -> {ns.out}")
    return 0


if __name__ == "__main__":          # pragma: no cover - CLI entry
    raise SystemExit(main())
