"""What a `torch.profiler` trace of the frame loop says about the card.

`device_busy_s` is a frozen copy of `chip_smoke.py::device_busy_us` (the
union of the trace's device spans: kernels, copies and sets) and
`kernel_name` of `chip_smoke.py::kernel_name`.  `summarise` reduces one
profiled stretch of frames to the plain numbers the per-layer readers
take, and to the `breakdown` of the result line: the device operations
that took most time, and the longest idle gaps of the card by the host
operation that was running through them.
"""

from __future__ import annotations

from collections import Counter, defaultdict


def kernel_name(full: str) -> str:
    """'void <unnamed>::k<(int)5>(float const*, int)' -> 'k<(int)5>'."""
    full = full.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
    full = full.removeprefix("void ")
    return (full.rsplit("(", 1)[0] if full.endswith(")") else full)[:60]


def device_events(prof) -> list:
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_busy_s(spans) -> float:
    """The union of (start, end) spans in µs, as seconds."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy * 1e-6


def idle_gaps(spans) -> list:
    """(start, end) µs of the gaps between the union's pieces."""
    gaps, end = [], None
    for lo, hi in sorted(spans):
        if end is not None and lo > end:
            gaps.append((end, lo))
        end = hi if end is None else max(end, hi)
    return gaps


def label_gaps(gaps: list, host_events: list) -> dict:
    """Seconds of idle gap by the innermost host operation that spans each
    gap's middle ("host, outside any operation" where none does)."""
    events = sorted(((e.time_range.start, -e.time_range.end, e.name) for e in host_events))
    stack, i, out = [], 0, defaultdict(float)
    for lo, hi in sorted(gaps):
        mid = 0.5 * (lo + hi)
        while i < len(events) and events[i][0] <= mid:
            start, neg_end, name = events[i]
            while stack and stack[-1][0] < start:
                stack.pop()
            stack.append((-neg_end, name))
            i += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        label = stack[-1][1] if stack else "host, outside any operation"
        out[label] += (hi - lo) * 1e-6
    return out


def summarise(prof, frames: int, wall_s: float) -> dict | None:
    """One profiled stretch of `frames` frames over `wall_s` seconds -> the
    trace's numbers, or None when it lists no device span."""
    dev = device_events(prof)
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    busy = device_busy_s(spans)
    if not spans or busy <= 0:
        return None
    by_name, launches = defaultdict(float), Counter()
    for e in dev:
        name = kernel_name(e.name)
        by_name[name] += (e.time_range.end - e.time_range.start) * 1e-6
        launches[name] += 1
    dev_ids = {id(e) for e in dev}
    host = [e for e in prof.events() if id(e) not in dev_ids]
    threads = Counter(e.thread for e in host)
    main = threads.most_common(1)[0][0] if threads else None
    host = [e for e in host if e.thread == main]
    gaps = label_gaps(idle_gaps(spans), host)
    return {
        "frames": frames,
        "wall_s": wall_s,
        "busy_s": busy,
        "device_ops": len(dev),
        "device_s_by_name": dict(by_name),
        "launches_by_name": dict(launches),
        "breakdown": {
            "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:10],
        },
    }
