#!/usr/bin/env python3
"""The program's own spans of the frame step, on the host's clock and
against the card's trace.

    python3 portbench/spans.py --workload uav1-100k.orbit --seed 7 [--frames 40] [--syncs 4]

runs a cell's set-up and warm-up as `run.py` does, then four stretches of
`--frames` frames: 1, unprofiled with tracing off; 3, unprofiled with
`utils/trace.py` on (its records give each layer's host wall, self time,
syncs and uploads, free of the profiler's cost); 4, profiled (CPU and
CUDA) with tracing on, so each span is a `record_function` in the trace.
In stretch 4 each device op is put down to the innermost span whose host
interval holds the runtime call that launched it (matched by correlation
id), and each idle gap of the card to the innermost span over its middle
(`tracing.label_gaps`).  The last line of standard output is one JSON
object: the table a frame by span, the tracing-on overhead (stretch 3's
wall over stretch 1's), the share of each frame's latency inside its root
span, the nesting check, and stretch 4's `host.uploads` and `host.count`
change beside the trace's `Memcpy HtoD` / `Memcpy DtoH` inside the
`tracker.frame` spans.  `--syncs N` then steps N frames under CUDA's
sync debug mode and lists each synchronising call's source line.

`measure(loop, frames)` is stretches 3 and 4 on a `run.Loop`; it returns
None for a checkout whose program has no `utils/trace.py`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from tracing import device_busy_s, idle_gaps, kernel_name, label_gaps  # noqa: E402

SPANS = ("multi.frame", "tracker.frame", "tracker.init", "tracker.roi", "detect", "pf.loop",
         "resample", "refine")
OUTSIDE = "host, outside any operation"  # tracing.label_gaps' label outside every span


def load_module(name: str):
    """`metrics/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# kernel A's kernels, the one that ends each launch, its bound
A = load_module("detect_stats_roofline")


def program_trace():
    """The program's `utils/trace.py`, or None in a checkout before it."""
    try:
        from pf_monocular_pose_estimator_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


# ------------------------------------------------------------ the records
def nesting_faults(records) -> list:
    """What breaks the frame's shape in stretch-3 records: a frame without
    exactly one root, a (frame, target) without exactly one `tracker.frame`,
    a child outside its parent, siblings that overlap."""
    by_id = {r.id: r for r in records}
    roots, frames = Counter(), Counter()
    children = defaultdict(list)
    faults = []
    for r in records:
        if r.parent is None:
            roots[r.frame] += 1
        else:
            children[r.parent].append(r)
            p = by_id.get(r.parent)
            if p is None or r.start_ns < p.start_ns or r.end_ns > p.end_ns:
                faults.append(f"{r.name} of frame {r.frame} lies outside its parent")
        if r.name == "tracker.frame":
            frames[(r.frame, r.target)] += 1
    faults += [f"frame {f} has {n} roots" for f, n in roots.items() if n != 1]
    faults += [f"frame {f} target {t} has {n} tracker.frame spans"
               for (f, t), n in frames.items() if n != 1]
    for kids in children.values():
        kids = sorted(kids, key=lambda r: r.start_ns)
        faults += [f"{a.name} and {b.name} of frame {a.frame} overlap"
                   for a, b in zip(kids, kids[1:]) if b.start_ns < a.end_ns]
    return faults


def host_table(records, frames: int) -> dict:
    """Per span name, a frame: host wall (inclusive, self) in ms, syncs and
    uploads (the change of the step's counters inside the span)."""
    rows = defaultdict(lambda: {"wall_ms": 0.0, "self_ms": 0.0, "syncs": 0.0, "uploads": 0.0,
                                "spans": 0.0})
    for r in records:
        row = rows[r.name]
        row["wall_ms"] += (r.end_ns - r.start_ns) * 1e-6 / frames
        row["self_ms"] += r.self_ns * 1e-6 / frames
        row["syncs"] += r.syncs / frames
        row["uploads"] += r.uploads / frames
        row["spans"] += 1 / frames
    return dict(rows)


def root_shares(records, latencies_s: list, first_frame: int) -> list:
    """Per frame of the stretch, the share of its latency inside its root span."""
    inside = defaultdict(int)
    for r in records:
        if r.parent is None:
            inside[r.frame] += r.end_ns - r.start_ns
    return [inside.get(first_frame + i, 0) * 1e-9 / s for i, s in enumerate(latencies_s)]


# -------------------------------------------------------------- the trace
def is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False))


def split_events(events):
    """(device ops, the program's span events, the other host events) of a
    trace; a GPU-side user annotation is not a device op."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, spans, host = [], [], []
    for e in events:
        if e.device_type == cuda:
            if not is_annotation(e):
                dev.append(e)
        elif is_annotation(e) and e.name in SPANS:
            spans.append(e)
        else:
            host.append(e)
    return dev, spans, host


def runtime_calls(host: list) -> dict:
    """Correlation id -> the runtime call of that id (a host event whose name
    starts with "cu": cudaLaunchKernel, cudaMemcpyAsync, ...)."""
    return {e.id: e for e in host if e.name.startswith("cu")}


def launch_times(dev: list, host: list) -> list:
    """Per device op the host time (µs) of the runtime call that launched it,
    matched by correlation id (not by time: the card's clock and the host's
    drift apart over a trace), or None where the trace lists no such call."""
    calls = runtime_calls(host)
    return [calls[d.id].time_range.start if d.id in calls else None for d in dev]


def innermost(points: list, spans: list) -> list:
    """For each time in `points` (µs, or None), the name of the innermost of
    the nested (start, end, name) `spans` that holds it, or None."""
    order = sorted(range(len(points)), key=lambda i: (points[i] is None, points[i] or 0.0))
    events = sorted((s, -e, n) for s, e, n in spans)
    out, stack, j = [None] * len(points), [], 0
    for i in order:
        t = points[i]
        if t is None:
            continue
        while j < len(events) and events[j][0] <= t:
            start, neg_end, name = events[j]
            while stack and stack[-1][0] < start:
                stack.pop()
            stack.append((-neg_end, name))
            j += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        out[i] = stack[-1][1] if stack else None
    return out


def device_table(events, frames: int) -> dict:
    """One profiled stretch with tracing on -> per span name, a frame:
    device µs, device ops and idle ms, with the copies inside `tracker.frame`
    spans and kernel A's device time inside `detect` spans."""
    dev, span_events, host = split_events(events)
    times = launch_times(dev, host)
    intervals = [(e.time_range.start, e.time_range.end, e.name) for e in span_events]
    owners = innermost(times, intervals)
    in_frame = innermost(times, [s for s in intervals if s[2] == "tracker.frame"])
    rows = defaultdict(lambda: {"device_us": 0.0, "device_ops": 0.0, "idle_ms": 0.0})
    copies = Counter()
    a_s, a_launches, blurs = 0.0, 0, 0
    for e, owner, framed in zip(dev, owners, in_frame):
        dur = e.time_range.end - e.time_range.start
        row = rows[owner or OUTSIDE]
        row["device_us"] += dur / frames
        row["device_ops"] += 1 / frames
        if framed and e.name.startswith("Memcpy "):
            copies[" ".join(e.name.split()[:2])] += 1
        name = kernel_name(e.name).split("<")[0]
        if owner == "detect" and name in A.KERNELS:
            a_s += dur * 1e-6
            a_launches += name in A.LAST
            blurs += name == A.BLUR
    gaps = label_gaps(idle_gaps([(e.time_range.start, e.time_range.end) for e in dev]),
                      span_events)
    for name, s in gaps.items():
        rows[name]["idle_ms"] += s * 1e3 / frames
    return {
        "rows": dict(rows),
        "memcpy_in_frames": dict(copies),
        "device_ops": len(dev),
        "launches_found": sum(t is not None for t in times),
        "busy_s": device_busy_s([(e.time_range.start, e.time_range.end) for e in dev]),
        # #2 (threshold_blur) ran where detect shows more blurs than A launches
        "detect_stats": {"device_s": a_s, "launches": a_launches, "full_frame": blurs > a_launches},
    }


# ------------------------------------------------------------ the stretches
def timed(loop, frames: int) -> tuple[float, list]:
    loop.sync()
    t0 = time.perf_counter()
    lat = [loop.frame()[0] for _ in range(frames)]
    loop.sync()
    return time.perf_counter() - t0, lat


def counters(loop) -> tuple:
    from pf_monocular_pose_estimator_tpu_torch.ops.detect_kernel import detect_stats

    host = loop.step.host
    return host.count, host.uploads, detect_stats.pixels, detect_stats.launches


def measure(loop, frames: int, attempts: int = 3, baseline_wall_s: float | None = None):
    """Stretch 3 (unprofiled, tracing on) and stretch 4 (profiled, tracing
    on, retaken up to `attempts` times when it lists no device op) -> their
    summary, or None without the program's spans."""
    from torch.profiler import ProfilerActivity, profile

    trace = program_trace()
    if trace is None:
        return None
    trace.take()
    trace.enable()
    try:
        first = loop.step.frames
        wall3, lat = timed(loop, frames)
        records = trace.take()
        out = {"frames": frames, "stretch3_wall_s": wall3, "host": host_table(records, frames),
               "root_share": root_shares(records, lat, first),
               "nesting_faults": nesting_faults(records)[:10]}
        if baseline_wall_s:
            out["overhead"] = wall3 / baseline_wall_s
        for _ in range(attempts):
            loop.sync()
            before = counters(loop)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(frames):
                    loop.frame()
                loop.sync()
                wall4 = time.perf_counter() - t0
            after = counters(loop)
            trace.take()
            table = device_table(prof.events(), frames)
            if table["device_ops"]:
                break
        else:
            return dict(out, stretch4=None)
    finally:
        trace.disable()
    syncs, uploads, pixels, launches = (b - a for a, b in zip(before, after))
    table.update(wall_s=wall4, syncs=syncs, uploads=uploads, pixels=pixels,
                 detect_stats_launches=launches)
    out["stretch4"] = table
    return out


def rows(summary: dict) -> dict:
    """The table a frame, by span name: host wall and self (ms), device µs,
    device ops, idle ms, syncs, uploads."""
    host = summary["host"]
    dev = (summary.get("stretch4") or {}).get("rows", {})
    out = {}
    for name in (*SPANS, OUTSIDE):
        h, d = host.get(name, {}), dev.get(name, {})
        if not h and not d:
            continue
        out[name] = {k: h.get(k) for k in ("wall_ms", "self_ms")}
        out[name].update({k: d.get(k, 0.0) for k in ("device_us", "device_ops", "idle_ms")})
        out[name].update({k: h.get(k) for k in ("syncs", "uploads")})
    return out


def sync_sources(loop, frames: int) -> dict:
    """Step `frames` frames under `torch.cuda.set_sync_debug_mode("warn")` ->
    "file:line function" (the innermost frame of the program's package
    outside `utils/sync.py`, else the warning's own place) -> the
    synchronising calls made there: reads, and uploads from pageable memory."""
    import traceback
    import warnings

    import torch

    out = Counter()

    def count(message, category, filename, lineno, file=None, line=None):
        mine = [f for f in traceback.extract_stack()
                if "pf_monocular_pose_estimator_tpu_torch/" in f.filename
                and not f.filename.endswith("utils/sync.py")]
        where = (f"{mine[-1].filename.split('pf_monocular_pose_estimator_tpu_torch/')[-1]}:"
                 f"{mine[-1].lineno} {mine[-1].name}" if mine else f"{filename}:{lineno}")
        out[where] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = count
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(frames):
                loop.frame()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(out.most_common())


def main(argv=None) -> int:
    import torch

    import run
    from generator import make_traffic
    from reference.geometry.camera import Camera as RefCamera

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, default=run.PROFILE_FRAMES)
    ap.add_argument("--syncs", type=int, default=0,
                    help="then list the synchronising calls of this many frames by source line")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--particles", type=int, default=None, help="shrink the cell (CPU runs)")
    ap.add_argument("--warmup", type=int, default=None)
    args = ap.parse_args(argv)
    if program_trace() is None:
        print("spans.py: the program has no utils/trace.py", file=sys.stderr)
        return 3
    cell = run.load_cell(args.workload)
    config = cell["config"]
    device = torch.device(args.device)
    step, state, markers_t, settings = run.build(config, args.seed, device, args.particles)
    c = config["camera"]
    ref_cam = RefCamera.create(c["fx"], c["fy"], c["cx"], c["cy"], c["dist"], c["width"],
                               c["height"])
    traffic = make_traffic(cell["mix"], ref_cam, markers_t, args.seed, device)
    loop = run.Loop(step, state, traffic, device)
    for _ in range(traffic.warmup_frames if args.warmup is None else args.warmup):
        loop.frame()
    wall1, lat1 = timed(loop, args.frames)
    summary = measure(loop, args.frames, baseline_wall_s=wall1)
    out = {"workload": args.workload, "seed": args.seed, "n_particles": settings["n_particles"],
           "stretch1_wall_s": wall1, "overhead": summary.get("overhead"),
           "rows": rows(summary)}
    s4 = summary.get("stretch4") or {}
    out["uploads_vs_htod"] = [s4.get("uploads"), s4.get("memcpy_in_frames", {}).get("Memcpy HtoD")]
    out["syncs_vs_dtoh"] = [s4.get("syncs"), s4.get("memcpy_in_frames", {}).get("Memcpy DtoH")]
    shares = summary["root_share"]
    out["root_share"] = {"median": statistics.median(shares), "min": min(shares)}
    out["nesting_faults"] = summary["nesting_faults"]
    a = dict(s4.get("detect_stats", {}), pixels=s4.get("pixels"),
             launches_counted=s4.get("detect_stats_launches"))
    if a.get("launches") and a.get("launches_counted") and not a["full_frame"]:
        least = A.detect_stats_bound(a["pixels"] / a["launches_counted"])
        a["roofline"] = 100.0 * least / (a["device_s"] / a["launches"])
    out["detect_stats"] = a
    out["launches_found"] = [s4.get("launches_found"), s4.get("device_ops")]
    out["frame_ms_stretch1"] = statistics.median(lat1) * 1e3
    if args.syncs:
        out["sync_sources"] = sync_sources(loop, args.syncs)
    out["card"] = run.card() if device.type == "cuda" else {}
    for name, r in out["rows"].items():
        print(f"{name:14s} " + " ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                                         for k, v in r.items()), file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
