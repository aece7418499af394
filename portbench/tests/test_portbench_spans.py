"""CPU tests of `portbench/spans.py` and the `detect_stats_roofline` reader.

    python -m pytest portbench/tests/test_portbench_spans.py -q

Device ops are put down to the innermost program span on fabricated
trace events, GPU-side user annotations are dropped, idle gaps go to the
span over their middle; the stretch-3 records are checked for their
shape; the reader's arithmetic and its None cases.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402
import spans  # noqa: E402
from pf_monocular_pose_estimator_tpu_torch.utils.trace import Span  # noqa: E402

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device=CPU, id=0, annotation=False):
    return SimpleNamespace(name=name, device_type=device, id=id, is_user_annotation=annotation,
                           thread=1, time_range=SimpleNamespace(start=start, end=end))


def fabricated():
    """One frame: tracker.frame [0, 100] over detect [10, 40] and pf.loop
    [50, 80]; four kernels and a copy launched at 15 (detect), 20 (detect,
    the copy), 55 (pf.loop), 90 (the frame's own) and 150 (outside)."""
    return [
        ev("tracker.frame", 0, 100, annotation=True),
        ev("detect", 10, 40, annotation=True),
        ev("pf.loop", 50, 80, annotation=True),
        ev("cudaLaunchKernel", 15, 16, id=1),
        ev("cudaMemcpyAsync", 20, 21, id=2),
        ev("cudaLaunchKernel", 55, 56, id=3),
        ev("aten::mul", 86, 95, id=4),  # an operation whose id a kernel shares
        ev("cudaLaunchKernel", 90, 91, id=4),
        ev("cudaLaunchKernel", 150, 151, id=5),
        ev("void label_kernel(float const*, int)", 200, 210, CUDA, id=1),
        ev("Memcpy HtoD (Pageable -> Device)", 210, 211, CUDA, id=2),
        ev("void pf_step_kernel<5>(float*)", 230, 250, CUDA, id=3),
        ev("vectorized_elementwise_kernel", 260, 262, CUDA, id=4),
        ev("reduce_kernel", 300, 304, CUDA, id=5),
        ev("detect", 200, 211, CUDA, annotation=True),  # a GPU-side user annotation
    ]


def test_device_ops_fall_to_the_innermost_span():
    t = spans.device_table(fabricated(), frames=1)
    rows = t["rows"]
    assert t["device_ops"] == 5 and t["launches_found"] == 5
    assert rows["detect"]["device_ops"] == 2 and rows["detect"]["device_us"] == 11
    assert rows["pf.loop"]["device_us"] == 20
    assert rows["tracker.frame"]["device_us"] == 2
    assert rows[spans.OUTSIDE]["device_us"] == 4
    assert t["memcpy_in_frames"] == {"Memcpy HtoD": 1}
    assert t["busy_s"] == pytest.approx(37e-6)
    assert t["detect_stats"] == {"device_s": pytest.approx(10e-6), "launches": 0,
                                 "full_frame": False}


def test_idle_gaps_fall_to_the_span_over_their_middle():
    events = [ev("tracker.frame", 0, 100, annotation=True), ev("refine", 40, 60, annotation=True),
              ev("a", 0, 10, CUDA, id=1), ev("b", 30, 70, CUDA, id=2),
              ev("c", 100, 110, CUDA, id=3), ev("d", 200, 210, CUDA, id=4)]
    rows = spans.device_table(events, frames=2)["rows"]
    # gaps: [10, 30] mid 20 (tracker.frame), [70, 100] mid 85 (tracker.frame),
    # [110, 200] mid 155 (outside); per frame of two
    assert rows["tracker.frame"]["idle_ms"] == pytest.approx(25e-3)
    assert rows[spans.OUTSIDE]["idle_ms"] == pytest.approx(45e-3)
    assert "refine" not in rows or rows["refine"]["idle_ms"] == 0


def test_device_ops_match_their_runtime_call_by_id_not_by_time():
    # the card's clock may read earlier than the host's launch
    events = [ev("tracker.frame", 0, 100, annotation=True), ev("detect", 10, 40, annotation=True),
              ev("cudaLaunchKernel", 20, 21, id=7), ev("k", 5, 8, CUDA, id=7),
              ev("k", 50, 60, CUDA, id=8)]
    t = spans.device_table(events, frames=1)
    assert t["launches_found"] == 1 and t["rows"]["detect"]["device_ops"] == 1
    assert t["rows"][spans.OUTSIDE]["device_ops"] == 1


def test_kernel_a_time_and_launches_inside_detect():
    events = [ev("tracker.frame", 0, 100, annotation=True), ev("detect", 10, 40, annotation=True)]
    names = ["threshold_blur_kernel", "label_kernel", "stats_kernel<16>", "topk_merge_kernel<64>"]
    for i, n in enumerate(names):
        events += [ev("cudaLaunchKernel", 11 + i, 12 + i, id=i + 1),
                   ev(f"void {n}(int)", 100 + 10 * i, 105 + 10 * i, CUDA, id=i + 1)]
    a = spans.device_table(events, frames=1)["detect_stats"]
    assert a == {"device_s": pytest.approx(20e-6), "launches": 1, "full_frame": False}
    events += [ev("cudaLaunchKernel", 30, 31, id=9), ev("void threshold_blur_kernel(int)", 300,
                                                         301, CUDA, id=9)]
    assert spans.device_table(events, frames=1)["detect_stats"]["full_frame"]


def rec(id, parent, name, frame, start, end, self_ns=None, target=0, syncs=0, uploads=0):
    return Span(id, parent, name, frame, target, start, end,
                end - start if self_ns is None else self_ns, syncs, uploads)


def good_records():
    return [rec(1, 0, "detect", 0, 10, 40), rec(2, 0, "pf.loop", 0, 50, 80, syncs=1, uploads=2),
            rec(0, None, "tracker.frame", 0, 0, 100, self_ns=40, syncs=5, uploads=23),
            rec(4, 3, "detect", 1, 110, 150),
            rec(3, None, "tracker.frame", 1, 100, 200, self_ns=60, syncs=5, uploads=23)]


@pytest.mark.parametrize("fault, records", [
    (None, good_records()),
    ("overlap", good_records()[:1] + [rec(2, 0, "pf.loop", 0, 30, 80)] + good_records()[2:]),
    ("outside", good_records()[:3] + [rec(4, 3, "detect", 1, 90, 150)] + good_records()[4:]),
    ("roots", good_records() + [rec(5, None, "tracker.frame", 1, 300, 400)]),
])
def test_nesting_faults(fault, records):
    faults = spans.nesting_faults(records)
    assert (faults == []) == (fault is None)
    if fault:
        assert any(fault in f for f in faults), faults


def test_host_table_and_root_share_arithmetic():
    rows = spans.host_table(good_records(), frames=2)
    assert rows["tracker.frame"]["wall_ms"] == pytest.approx(100e-6)
    assert rows["tracker.frame"]["self_ms"] == pytest.approx(50e-6)
    assert rows["detect"]["wall_ms"] == pytest.approx(35e-6)
    assert rows["tracker.frame"]["uploads"] == 23 and rows["pf.loop"]["syncs"] == 0.5
    # the layers' walls and the frame's self time make up the frame's wall
    parts = sum(r["wall_ms"] for n, r in rows.items() if n != "tracker.frame")
    frame = rows["tracker.frame"]
    assert parts + frame["self_ms"] == pytest.approx(frame["wall_ms"])
    assert spans.root_shares(good_records(), [200e-9, 100e-9], 0) == pytest.approx([0.5, 1.0])


def test_rows_table():
    summary = {"host": spans.host_table(good_records(), 2),
               "stretch4": {"rows": {
                   "detect": {"device_us": 3.0, "device_ops": 2.0, "idle_ms": 0.1},
                   spans.OUTSIDE: {"device_us": 1.0, "device_ops": 1.0, "idle_ms": 4.0}}}}
    table = spans.rows(summary)
    assert list(table) == ["tracker.frame", "detect", "pf.loop", spans.OUTSIDE]
    assert table["detect"]["device_us"] == 3.0 and table["detect"]["uploads"] == 0
    assert table["pf.loop"]["device_ops"] == 0.0 and table[spans.OUTSIDE]["wall_ms"] is None
    assert set(table["detect"]) == {"wall_ms", "self_ms", "device_us", "device_ops", "idle_ms",
                                    "syncs", "uploads"}


def test_measure_reads_nothing_without_the_programs_spans(monkeypatch):
    monkeypatch.setattr(spans, "program_trace", lambda: None)
    assert spans.measure(SimpleNamespace(), 4) is None


def roofline_run(**by_name):
    launches = {n: c for n, (c, _) in by_name.items()}
    seconds = {n: s for n, (_, s) in by_name.items()}
    return {"trace": {"launches_by_name": launches, "device_s_by_name": seconds, "frames": 40}}


@pytest.fixture
def counters(monkeypatch):
    def set_counters(pixels, launches):
        counter = SimpleNamespace(launches=launches)
        if pixels is not None:
            counter.pixels = pixels
        monkeypatch.setitem(sys.modules, "pf_monocular_pose_estimator_tpu_torch.ops.detect_kernel",
                            SimpleNamespace(detect_stats=counter))
    return set_counters


def test_detect_stats_roofline_arithmetic_and_none_cases(counters):
    read = run.load_reader("detect_stats_roofline")
    ok = roofline_run(**{"threshold_blur_kernel": (40, 40 * 5e-6), "label_kernel": (40, 40 * 6e-6),
                         "stats_kernel<16>": (40, 40 * 20e-6),
                         "topk_merge_kernel<64>": (40, 40 * 2.6e-6)})
    counters(200 * 192 * 256, 200)
    least = (48 * 192 * 256 + 8 * 16) / 3.35e12
    assert read(ok) == pytest.approx(100 * least / 33.6e-6)
    assert read(ok) == pytest.approx(2.096, abs=1e-3)
    counters(None, 200)  # a program without the pixel counter
    assert read(ok) is None
    counters(200 * 192 * 256, 200)
    full = roofline_run(**{"threshold_blur_kernel": (41, 1e-4),
                           "topk_merge_kernel<64>": (40, 1e-4)})
    assert read(full) is None
    assert read({"trace": None}) is None
    assert read(roofline_run(pf_step_kernel=(40, 1e-4))) is None


def test_the_new_metric_is_declared_beside_the_accepted_ones():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    m = next(x for x in bench["per_layer"] if x["name"] == "detect_stats_roofline")
    assert m["unit"] == "%"
    assert m["layer"] == next(x["layer"] for x in bench["per_layer"]
                              if x["name"] == "detect.device_us_per_frame")
    assert m["workloads"] == [w["name"] for w in bench["workloads"]]


def test_spans_tool_on_the_cpu(capsys):
    assert spans.main(["--workload", "uav1-100k.orbit", "--seed", str(2**33 + 5), "--device",
                       "cpu", "--particles", "2000", "--warmup", "4", "--frames", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["nesting_faults"] == []
    table = out["rows"]
    assert list(table)[:2] == ["tracker.frame", "tracker.roi"]
    assert table["tracker.frame"]["syncs"] == 5.0 and table["tracker.frame"]["uploads"] >= 23
    parts = sum(r["wall_ms"] for n, r in table.items() if n not in ("tracker.frame", spans.OUTSIDE))
    assert parts + table["tracker.frame"]["self_ms"] == pytest.approx(
        table["tracker.frame"]["wall_ms"])
    assert 0.9 < out["root_share"]["median"] <= 1.0
