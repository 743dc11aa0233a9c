"""The traced slice of a window: ``torch.profiler`` over a few steady
steps, reduced to what the per-layer metrics read.

Busy time is the union of the device operations' intervals (kernels,
copies and sets), so work that overlaps is counted once; idle time is the
rest of the slice.  Each idle gap is put down to the innermost of the
benchmark's own host spans (``bench.<name>``, ``record_function``) that
covers its middle.  Timestamps are the profiler's, on one clock for host
and device.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "bench.slice"


@dataclass
class Event:
    name: str
    kind: str           # "device", "span" (a bench.* host span) or "slice"
    start: float        # seconds, the profiler's clock
    end: float


@dataclass
class Summary:
    wall_s: float = 0.0
    busy_s: float = 0.0
    #: name -> [launches, seconds]
    ops: dict = field(default_factory=dict)
    #: [(host span, seconds)], longest first
    gaps: list = field(default_factory=list)

    def kernel(self, fragment: str):
        """(launches, seconds) of the device ops whose name holds
        ``fragment``."""
        n = s = 0
        for name, (k, t) in self.ops.items():
            if fragment in name:
                n, s = n + k, s + t
        return n, s

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:top]
        return {"device_ops": [[n[:120], t] for n, (_, t) in ops],
                "idle_gaps": [[n, t] for n, t in self.gaps[:top]]}


def union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, hi = 0.0, None
    for a, b in sorted(intervals):
        if hi is None or a > hi:
            total += b - a
            hi = b
        elif b > hi:
            total += b - hi
            hi = b
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def summarize(events) -> Summary:
    """``events`` (``Event``s) of one slice -> its ``Summary``."""
    sl = [e for e in events if e.kind == "slice"]
    if not sl:
        return Summary()
    lo, hi = sl[0].start, sl[0].end
    dev = [(max(e.start, lo), min(e.end, hi)) for e in events
           if e.kind == "device" and e.end > lo and e.start < hi]
    out = Summary(wall_s=hi - lo, busy_s=union(dev))
    for e in events:
        if e.kind == "device":
            k = out.ops.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.end - e.start
    spans = [e for e in events if e.kind == "span"]
    named = []
    for a, b in idle_gaps(dev, lo, hi):
        mid = (a + b) / 2
        inner = [s for s in spans if s.start <= mid <= s.end]
        host = min(inner, key=lambda s: s.end - s.start).name if inner \
            else "outside the benchmark's spans"
        named.append((host, b - a))
    named.sort(key=lambda x: -x[1])
    out.gaps = named
    return out


def _times(e):
    if hasattr(e, "start_ns"):
        start = e.start_ns()
        end = e.end_ns() if hasattr(e, "end_ns") else start + e.duration_ns()
        return start * 1e-9, end * 1e-9
    start = e.start_us()
    return start * 1e-6, (start + e.duration_us()) * 1e-6


def _kind(e) -> str:
    """"device", "span", "slice" or "" (an event no metric reads).  A
    device event is a kernel, copy or set; the benchmark's own
    ``record_function`` ranges count on the host side only (the
    profiler mirrors them onto the device's timeline too)."""
    name = e.name()
    act = e.activity_type() if hasattr(e, "activity_type") else None
    on_device = "CUDA" in str(e.device_type())
    if name.startswith("bench."):
        if on_device or (act is not None and act != "user_annotation"):
            return ""
        return "slice" if name == SLICE else "span"
    if act is not None:
        return "device" if act in DEVICE_KINDS else ""
    return "device" if on_device else ""


def _kineto_events(prof) -> list:
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind:
            name = e.name()
            out.append(Event(name if kind != "span" else name[6:], kind,
                             *_times(e)))
    return out


class Tracer:
    """``slice()`` profiles its block when tracing is on (once a run);
    ``span(name)`` marks host work for the gaps' attribution."""

    def __init__(self, on: bool, device):
        self.on = on
        self.device = device
        self._prof = None
        self._summary = None
        #: host seconds the slice took, the profiler's start and stop in
        #: it (the window's rate metrics leave them out)
        self.slice_s = 0.0

    @property
    def summary(self):
        """The slice's ``Summary``, reduced on first use (after the
        window, so that the reduction is not timed in it)."""
        if self._summary is None and self._prof is not None:
            self._summary = summarize(_kineto_events(self._prof))
            self._prof = None
        return self._summary

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(f"bench.{name}")

    @contextlib.contextmanager
    def slice(self):
        if not self.on or self.slice_s:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            with record_function(SLICE):
                yield
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        self.slice_s = time.perf_counter() - t0
        self._prof = prof
