"""The program's own spans (``repro_torch.core.trace``) as the per-layer
readers take them: read in the run's process after the window, from the
flight recorder's ring.  The program records them unless ``REPRO_TRACE=0``;
a device span (``cat="device"``) carries the device's start and duration,
placed on the host spans' clock, and the host's clock at its launch
(``args["launch_t"]``).

Each helper returns None where the spans a reading needs are not all
there: a ring that has filled (``tunables.TRACE_RING`` events) has
evicted its oldest, and a program without these spans has none.  A
reader of the window's spans counts them against the window's steps or
requests; a reader of the whole process's (set-up included) asks for a
ring that has not filled.
"""
from __future__ import annotations


def events(whole: bool = False):
    """The ring's closed spans; with ``whole``, None if the ring is full
    (its oldest spans may be gone)."""
    from repro_torch.core import trace, tunables
    evs = trace.events()
    if whole and len(evs) >= tunables.TRACE_RING:
        return None
    return [e for e in evs if e.kind == "span"]


def launched(e) -> float:
    """When the host launched the span's work (a host span: its start)."""
    return e.args.get("launch_t", e.t0)


def last(evs, name: str, n: int):
    """The last ``n`` spans named ``name`` by launch, oldest first; None
    unless there are at least ``n``."""
    got = sorted((e for e in evs or () if e.name == name), key=launched)
    if n <= 0 or len(got) < n:
        return None
    return got[-n:]


def save_interval(evs):
    """(end of the snapshot, end of the write) of the last save: the
    checkpoint manager's ``ckptmgr.snapshot`` and ``ckptmgr.write`` spans
    under one ``ckptmgr.save``; None without both."""
    writes = last(evs, "ckptmgr.write", 1)
    if writes is None:
        return None
    w = writes[0]
    snap = [e for e in evs if e.name == "ckptmgr.snapshot"
            and e.parent_id == w.parent_id]
    if not snap:
        return None
    return snap[0].t0 + snap[0].dur, w.t0 + w.dur


def train_steps(ctx):
    """The window's ``train.step`` spans (the last ``ctx["steps"]``) and the
    save's interval: (steps, periods, inside, saved), where ``periods[i]``
    runs from step i's device start to step i + 1's (the last step has
    none), ``inside[i]`` says whether step i was launched between the end
    of the save's snapshot and the end of its write, and ``saved`` whether
    a save was found (without one, no step is inside).  None without the
    window's steps, or without the spans of a save the window made
    (``ctx["ckpt"]["saves"]``)."""
    evs = events()
    steps = last(evs, "train.step", ctx.get("steps", 0))
    if steps is None:
        return None
    save = save_interval(evs)
    if save is None and (ctx.get("ckpt") or {}).get("saves"):
        return None
    lo, hi = save or (float("inf"), float("-inf"))
    periods = [b.t0 - a.t0 for a, b in zip(steps, steps[1:])]
    inside = [lo <= launched(s) <= hi for s in steps]
    return steps, periods, inside, save is not None
