"""Spans in a bounded in-process flight recorder (the smallest copy of
``repro.core.trace`` that the checkpoint manager needs).

``span(...)`` is a context manager and ``begin(...)`` a detached handle
closed by ``.end(**kw)``; both take ``parent=`` (a handle, or a
``(trace_id, span_id)`` pair), ``cat=`` and ``args=``.  A closed span is
appended to a ring of ``RING`` events, the oldest evicted.  As in the
reference, tracing is on unless ``REPRO_TRACE=0``; when it is off every
call returns one shared no-op handle.

The reference's dump and merge tooling (per-process JSON-lines dumps, the
Chrome-trace merger) and its instants are not copied.
"""
from __future__ import annotations

import itertools
import os
import random
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Tuple

ENABLED: bool = os.environ.get("REPRO_TRACE", "1") != "0"
RING = 4096

_rand = random.Random()
_seq = itertools.count(1)


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
    args: dict = field(default_factory=dict)


_RECORDER: deque = deque(maxlen=RING)


def events() -> list:
    """The recorded spans, oldest first."""
    return list(_RECORDER)


def clear() -> None:
    _RECORDER.clear()


class _Span:
    """An open span; ``end`` is idempotent."""

    __slots__ = ("name", "cat", "args", "trace_id", "span_id", "parent_id",
                 "t0", "_open")

    def __init__(self, name: str, parent=None, cat: str = "repro",
                 args: Optional[dict] = None):
        self.name = name
        self.cat = cat
        self.args = dict(args) if args else {}
        # a handle gives its (trace_id, span_id); a null handle (tracing
        # switched on since it was opened) gives None: a new root
        parent = getattr(parent, "ctx", parent)
        if parent:
            self.trace_id, self.parent_id = parent
        else:
            self.trace_id, self.parent_id = _rand.getrandbits(63) or 1, None
        self.span_id = (os.getpid() << 24) ^ next(_seq)
        self.t0 = time.monotonic()
        self._open = True

    @property
    def ctx(self) -> Tuple[int, int]:
        return (self.trace_id, self.span_id)

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self.end()

    def end(self, **extra) -> None:
        if not self._open:
            return
        self._open = False
        self.args.update(extra)
        _RECORDER.append(SpanEvent(
            name=self.name, trace_id=self.trace_id, span_id=self.span_id,
            parent_id=self.parent_id, t0=self.t0,
            dur=time.monotonic() - self.t0, pid=os.getpid(), cat=self.cat,
            args=self.args))


class _NullSpan:
    """Shared no-op stand-in when tracing is disabled."""

    __slots__ = ()
    ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def end(self, **extra):
        return None


_NULL = _NullSpan()


def span(name: str, parent=None, cat: str = "repro",
         args: Optional[dict] = None):
    """Context manager: a span parented under ``parent``, or a new root."""
    if not ENABLED:
        return _NULL
    return _Span(name, parent=parent, cat=cat, args=args)


def begin(name: str, parent=None, cat: str = "repro",
          args: Optional[dict] = None):
    """A detached span handle, for an operation that ends in another call
    or thread (the manager's save ends on its writer thread).  Close with
    ``handle.end()``."""
    return span(name, parent=parent, cat=cat, args=args)
