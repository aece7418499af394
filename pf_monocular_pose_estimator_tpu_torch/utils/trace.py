"""Spans of the tracker's frame step: where a frame's host time goes.

`span(name)` wraps one layer of `Tracker.__call__` (`tracker.frame`,
`tracker.init`, `tracker.roi`, `detect`, `pf.loop`, `resample`, `refine`;
the IPE track branch's `tracker.roi`, `detect`, `ipe.check`, `refine`
and `ipe.fallback`) or of `MultiTracker.__call__` (`multi.frame`).
`ipe.check` holds the nearest-neighbour pairing and the P3P consensus
check, `ipe.fallback` the brute-force initialisation after a failed check
and its refine.  With tracing off (the default) it returns one shared
no-op context and records nothing.  With tracing on (`enable()`) each
span records

    Span(id, parent, name, frame, target, start_ns, end_ns, self_ns, syncs, uploads)

on `time.perf_counter_ns()`: `parent` is the id of the span it ran in
(None for a root), `self_ns` its time outside its child spans, `syncs` and
`uploads` the change of the frame step's `HostReads.count` and `.uploads`
over it.  A frame's span is handed the step's `HostReads`, the frame
number and the target index; a span handed none takes its parent's.  Each
span also opens a `torch.profiler.record_function` of its name, so a
running profiler shows it beside the device events.  `take()` returns
the records so far and clears them.

The recorder holds one stack of open spans: one frame step at a time,
from one thread.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

_ON = False
_RECORDS: list = []
_OPEN: list = []  # the spans entered and not yet left, innermost last
_NEXT_ID = 0
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    id: int
    parent: int | None
    name: str
    frame: int | None
    target: int | None
    start_ns: int
    end_ns: int
    self_ns: int
    syncs: int
    uploads: int


class _Open:
    __slots__ = ("id", "parent", "name", "frame", "target", "host", "annotation", "start",
                 "child_ns", "count0", "uploads0")

    def __init__(self, name, host, frame, target):
        global _NEXT_ID
        outer = _OPEN[-1] if _OPEN else None
        self.id, _NEXT_ID = _NEXT_ID, _NEXT_ID + 1
        self.parent = outer.id if outer else None
        self.name = name
        if host is None:
            host, frame, target = outer.host, outer.frame, outer.target
        self.host, self.frame, self.target = host, frame, target

    def __enter__(self):
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        self.count0, self.uploads0 = self.host.count, self.host.uploads
        self.child_ns = 0
        _OPEN.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _OPEN.pop()
        self.annotation.__exit__(*exc)
        dur = end - self.start
        if _OPEN:
            _OPEN[-1].child_ns += dur
        _RECORDS.append(Span(self.id, self.parent, self.name, self.frame, self.target,
                             self.start, end, dur - self.child_ns, self.host.count - self.count0,
                             self.host.uploads - self.uploads0))
        return False


def span(name: str, host=None, frame: int | None = None, target: int | None = None):
    """A context over one layer of the frame step: the shared no-op while
    tracing is off, else a recorded span (see the module's doc)."""
    if not _ON:
        return _OFF
    return _Open(name, host, frame, target)


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def take() -> list:
    """The spans recorded so far, in the order they ended; clears them."""
    out = list(_RECORDS)
    _RECORDS.clear()
    return out
