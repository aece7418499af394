"""The frame step's spans and copy counters (`utils/trace.py`, `utils/sync.py`).

Spans nest with their parents' ids, self time is the span's time outside
its children, and with tracing off `span()` is one shared no-op that
records nothing and calls no profiler.  On an init frame and two tracked
frames of the golden sequence (2,000 particles, the CPU twins) the spans
come in the frame's order, tracing changes no tensor, and the counters
read their stated constants: `host.count` as before the uploads were
counted, `host.uploads` one a host value put on the device.  On an IPE
tracker (`use_particle_filter=False`, 64 particles) an init frame, four
tracked frames and one frame whose predicted pose is moved 5 cm, so that
it detects again on the whole frame, the consensus check fails and the
brute-force fallback runs, record the
IPE spans in the frame's order with no nesting fault, and tracing changes
no tensor, count or upload there either.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.ops import detect_kernel as dk
from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
from pf_monocular_pose_estimator_tpu_torch.tracker import step as step_mod
from pf_monocular_pose_estimator_tpu_torch.utils import FailFlag, TrackerConfig, cuda_lib, trace
from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key
from pf_monocular_pose_estimator_tpu_torch.utils.sync import HostReads, upload

BENCH = Path(__file__).resolve().parents[1] / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import spans as bench_spans  # noqa: E402

torch.set_num_threads(2)

N = 2_000
FRAMES = 3
CONFIG = dict(n_particles=N, min_blob_area=8.0, pf_max_retries=8, roi_particle_subsample=128)
# per frame of the golden sequence: the init frame, a tracked frame whose
# ROI does not fit the 192x256 crop (full-frame detection), a tracked frame
# on the crop
SPAN_ORDER = [
    ["tracker.frame", "tracker.init", "detect"],
    ["tracker.frame", "tracker.roi", "detect", "pf.loop", "resample", "refine"],
    ["tracker.frame", "tracker.roi", "detect", "pf.loop", "resample", "refine"],
]
# device -> host reads a frame, as the tracker counted them before uploads
# were counted
SYNCS = [4, 5, 5]
# host -> device uploads a frame.  A tracked frame on the crop: t, the
# frame's fail flag and update flag (3); the prediction's two homogeneous
# rows (2); the ROI's full-frame box (1); the detection's crop ROI, blur
# taps and crop offset, one copy (1); each PF pass's inflation and marker
# count (2); the teleport guard's flag, the motion prior's rows and falloff,
# the lane count (4); the accepted flags (2); the refine's update flag (1:
# the fused refine uploads no weight cap); the four counters (4); the
# brute-force flag and the published pose's inverse row (2).  The
# full-frame detection copies its taps the same way (1); the init frame
# runs its own branch.
UPLOADS = [50, 22, 22]
IPE = dict(use_particle_filter=False, n_particles=64, min_blob_area=8.0)
IPE_FRAMES = 6
# the frame whose predicted pose is moved 5 cm along x: its ROI holds too few
# LEDs, so it detects again on the whole frame, and its pairs fail the check
IPE_FALLBACK = 5
IPE_TRACKED = ["tracker.frame", "tracker.roi", "detect", "ipe.check", "refine"]
IPE_SPAN_ORDER = ([["tracker.frame", "tracker.init", "detect"]] + [IPE_TRACKED] * 4
                  + [["tracker.frame", "tracker.roi", "detect", "detect", "ipe.check",
                      "ipe.fallback"]])


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def golden_tracker(config: dict):
    """(golden sequence, a CPU tracker of `config` on its camera and markers)."""
    d = np.load(os.path.join(os.path.dirname(__file__), "golden", "golden_sequence.npz"))
    cam = Camera.create(float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
                        np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))
    markers = np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1)
    return d, make_tracker(cam, torch.from_numpy(markers), torch.ones(5, dtype=torch.bool),
                           TrackerConfig(**config), device="cpu")


def run_golden(tracing: bool) -> dict:
    d, step = golden_tracker(CONFIG)
    state = TargetState.create(N, prng_key(0), device="cpu")
    out = {"states": [], "results": [], "syncs": [], "uploads": []}
    launches0 = (dk.detect_stats.launches, dk.detect_stats.pixels)
    if tracing:
        trace.enable()
    for i in range(FRAMES):
        c0, u0 = step.host.count, step.host.uploads
        state, res = step(state, torch.from_numpy(d["frames"][i]), float(d["times"][i]))
        out["states"].append(state)
        out["results"].append(res)
        out["syncs"].append(step.host.count - c0)
        out["uploads"].append(step.host.uploads - u0)
    trace.disable()
    out["spans"] = trace.take()
    out["launches"] = (dk.detect_stats.launches - launches0[0],
                       dk.detect_stats.pixels - launches0[1])
    return out


@pytest.fixture(scope="module")
def runs():
    return {False: run_golden(False), True: run_golden(True)}


def run_ipe(tracing: bool) -> dict:
    d, step = golden_tracker(IPE)
    state = TargetState.create(IPE["n_particles"], prng_key(0), device="cpu")
    counts = step_mod.ipe_counts
    out = {"states": [], "results": [], "syncs": [], "uploads": []}
    counts0 = [getattr(counts, k) for k in type(counts).__slots__]
    if tracing:
        trace.enable()
    for i in range(IPE_FRAMES):
        if i == IPE_FALLBACK:
            pred = state.predicted_pose.clone()
            pred[0, 3] += 0.05
            state = dataclasses.replace(state, predicted_pose=pred,
                                        it_since_initialized=torch.tensor(1, dtype=torch.int32))
        c0, u0 = step.host.count, step.host.uploads
        state, res = step(state, torch.from_numpy(d["frames"][i]), float(d["times"][i]))
        out["states"].append(state)
        out["results"].append(res)
        out["syncs"].append(step.host.count - c0)
        out["uploads"].append(step.host.uploads - u0)
    trace.disable()
    out["spans"] = trace.take()
    out["counts"] = [getattr(counts, k) - v for k, v in zip(type(counts).__slots__, counts0)]
    return out


@pytest.fixture(scope="module")
def ipe_runs():
    return {False: run_ipe(False), True: run_ipe(True)}


def test_spans_nest_and_self_time_excludes_children():
    host = HostReads()
    trace.enable()
    with host, trace.span("tracker.frame", host, 7, 1):
        host(torch.zeros(1))
        with trace.span("tracker.roi"):
            upload(1.0, "cpu")
            time.sleep(0.002)
        with trace.span("pf.loop"):
            with trace.span("detect"):
                host(torch.zeros(1))
                time.sleep(0.002)
            upload([1.0, 2.0], "cpu")
    trace.disable()
    spans = {s.name: s for s in trace.take()}
    assert set(spans) == {"tracker.frame", "tracker.roi", "pf.loop", "detect"}
    root, roi, loop, det = (spans[n] for n in ("tracker.frame", "tracker.roi", "pf.loop",
                                                "detect"))
    assert root.parent is None and roi.parent == root.id and loop.parent == root.id
    assert det.parent == loop.id
    assert all(s.frame == 7 and s.target == 1 for s in spans.values())
    dur = {n: s.end_ns - s.start_ns for n, s in spans.items()}
    assert det.self_ns == dur["detect"] and roi.self_ns == dur["tracker.roi"]
    assert loop.self_ns == dur["pf.loop"] - dur["detect"]
    assert root.self_ns == dur["tracker.frame"] - dur["tracker.roi"] - dur["pf.loop"]
    assert (root.syncs, root.uploads) == (2, 2)
    assert (roi.syncs, roi.uploads, loop.syncs, loop.uploads, det.syncs) == (0, 1, 1, 1, 1)
    assert trace.take() == []


def test_tracing_off_is_one_shared_noop(monkeypatch):
    def no_profiler(*a, **k):
        raise AssertionError("a span called the profiler with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", no_profiler)
    first = trace.span("tracker.frame", HostReads(), 0, 0)
    assert first is trace.span("detect") is trace.span("refine")
    with first, trace.span("detect"):
        pass
    assert trace.take() == []


@pytest.mark.parametrize("tracing", [False, True])
def test_spans_reach_a_cpu_profiler_only_while_tracing(tracing):
    from torch.profiler import ProfilerActivity, profile

    if tracing:
        trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("tracker.frame", HostReads(), 0, 0), trace.span("detect"):
            torch.ones(3).sum()
    trace.disable()
    found = {"tracker.frame", "detect"} & {e.name for e in prof.events()}
    assert found == ({"tracker.frame", "detect"} if tracing else set())


def test_tracker_spans_come_in_the_frames_order(runs):
    spans = runs[True]["spans"]
    for f, want in enumerate(SPAN_ORDER):
        got = sorted((s for s in spans if s.frame == f), key=lambda s: s.start_ns)
        assert [s.name for s in got] == want, f
        root = got[0]
        assert root.parent is None and root.target == 0
        assert sum(s.end_ns - s.start_ns for s in got if s.parent == root.id) + root.self_ns \
            == root.end_ns - root.start_ns
        for s in got[1:]:
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        assert root.syncs == SYNCS[f] and root.uploads == UPLOADS[f]


def test_tracing_changes_no_tensor(runs):
    off, on = runs[False], runs[True]
    for a, b in zip(off["states"] + off["results"], on["states"] + on["results"]):
        for field in dataclasses.fields(a):
            x, y = getattr(a, field.name), getattr(b, field.name)
            assert torch.equal(x, y), field.name
    assert (off["syncs"], off["uploads"]) == (on["syncs"], on["uploads"])
    assert off["launches"] == on["launches"]


@pytest.mark.parametrize("tracing", [False, True])
def test_counters_per_frame(runs, tracing):
    assert runs[tracing]["syncs"] == SYNCS
    assert runs[tracing]["uploads"] == UPLOADS


def test_put_counts_host_values_and_other_devices_only():
    host = HostReads()
    on_device = torch.ones(2)
    assert host.put(on_device, "cpu") is on_device and host.uploads == 0
    assert torch.equal(host.put([1, 2], "cpu", torch.int64), torch.tensor([1, 2]))
    assert torch.equal(host.put(np.float32(0.5), "cpu"), torch.tensor(0.5))
    assert host.uploads == 2 and host.count == 0
    assert upload(3.0, "cpu").dtype == torch.float32 and host.uploads == 2
    with host:
        upload(3.0, "cpu")
        upload(on_device, "cpu")
    assert host.uploads == 3


def test_detect_stats_pixels_grow_by_each_launch(monkeypatch):
    class Lib:
        def pfmpe_detect_stats_scratch(self, h, w, sweeps, topk):
            return 64

        def pfmpe_detect_stats(self, *args):
            return 0

    monkeypatch.setattr(cuda_lib, "require_cuda", lambda *a: None)
    monkeypatch.setattr(cuda_lib, "library", lambda *a: Lib())
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda t: 0)
    taps = dk.gaussian_taps(1.0)
    prm = torch.empty(7 + taps.size, device="meta")
    launches, pixels = dk.detect_stats.launches, dk.detect_stats.pixels
    for h, w in ((192, 256), (64, 48), (192, 256)):
        dk.detect_stats(torch.empty((h, w), device="meta"), prm, taps.size)
    assert dk.detect_stats.launches - launches == 3
    assert dk.detect_stats.pixels - pixels == 2 * 192 * 256 + 64 * 48


def test_ipe_spans_come_in_the_frames_order(ipe_runs):
    spans = ipe_runs[True]["spans"]
    for f, want in enumerate(IPE_SPAN_ORDER):
        got = sorted((s for s in spans if s.frame == f), key=lambda s: s.start_ns)
        assert [s.name for s in got] == want, f
        root = got[0]
        if f:  # every IPE stage is a child of the frame (the init frame nests detect)
            assert all(s.parent == root.id for s in got[1:]), f
        assert root.syncs == ipe_runs[True]["syncs"][f]
        assert root.uploads == ipe_runs[True]["uploads"][f]
    assert bench_spans.nesting_faults(spans) == []
    flags = [int(r.fail_flag) for r in ipe_runs[True]["results"]]
    assert flags == [int(FailFlag.INIT_SUCCESS)] + [int(FailFlag.PF_SUCCESS)] * 4 + [
        int(FailFlag.INIT_SUCCESS)]
    # frames, full-frame retries, checks, fallbacks, Gauss-Newton iterations
    assert ipe_runs[True]["counts"] == [5, 1, 5, 1, 5 * TrackerConfig().gn_max_iterations]


def test_ipe_tracing_off_records_nothing(ipe_runs):
    assert ipe_runs[False]["spans"] == []


def test_ipe_tracing_changes_no_tensor(ipe_runs):
    off, on = ipe_runs[False], ipe_runs[True]
    for a, b in zip(off["states"] + off["results"], on["states"] + on["results"]):
        for field in dataclasses.fields(a):
            x, y = getattr(a, field.name), getattr(b, field.name)
            assert torch.equal(x, y), field.name
    assert (off["syncs"], off["uploads"], off["counts"]) == (on["syncs"], on["uploads"],
                                                             on["counts"])
