"""CPU tests of the benchmark harness (`portbench/`).

    python -m pytest portbench/tests -q

They drive a run's code path on the CPU at a small particle count, on the
port's plain twins (`run.run_cell` skips the look for a card that
`run.main` makes), and hold the traffic, the arithmetic of the metrics and
the result line.  The tests marked `cuda` run a cell on the card and skip
without one.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import generator  # noqa: E402
import run  # noqa: E402
import tracing  # noqa: E402
from judge import Sampler  # noqa: E402
from reference.track import READINGS  # noqa: E402

SMALL = dict(n_particles=2000, warmup_frames=4, max_frames=6)


def bench_json() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_config_mix_and_metric_is_found_by_name():
    b = bench_json()
    for w in b["workloads"]:
        cell = run.load_cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["mix"]["name"] == w["traffic"]
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
        assert cell["per_layer"], w["name"]
        for m in cell["per_layer"]:
            assert callable(run.load_reader(m["name"]))
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["limits"]) == set(READINGS)


def test_orbit_repeats_without_a_jump():
    mix = generator.load_mix(BENCH / "traffic" / "orbit.json")
    period = mix["period_frames"]
    for layout in mix["layouts"].values():
        for tgt in layout:
            p0, p1 = generator.orbit_pose(0, period, tgt), generator.orbit_pose(1, period, tgt)
            np.testing.assert_array_equal(generator.orbit_pose(period, period, tgt), p0)
            steps = [np.abs(generator.orbit_pose(k + 1, period, tgt)
                            - generator.orbit_pose(k, period, tgt)).max() for k in range(period)]
            wrap = np.abs(p0 - generator.orbit_pose(period - 1, period, tgt)).max()
            assert wrap <= 1.05 * max(steps)
            assert np.abs(p1 - p0).max() > 0


def test_seed_changes_the_order_not_the_frames():
    cell = run.load_cell("uav1-100k.orbit")
    cam = _ref_camera(cell["config"])
    markers = [run.homogeneous(m) for m in cell["config"]["markers"]]
    mix = dict(cell["mix"], period_frames=8)
    a = generator.make_traffic(mix, cam, markers, 3, "cpu")
    b = generator.make_traffic(mix, cam, markers, 2**31 + 5, "cpu")
    assert a.frames.dtype == torch.uint8 and a.frames.shape == (8, 480, 752)
    assert torch.equal(a.frames, b.frames)
    assert a.drawn.all()


def _small_traffic(**outliers):
    cell = run.load_cell("uav1-100k.orbit")
    mix = dict(cell["mix"], period_frames=8, **outliers)
    markers = [run.homogeneous(m) for m in cell["config"]["markers"]]
    return generator.make_traffic(mix, _ref_camera(cell["config"]), markers, 3, "cpu")


def test_outliers_are_drawn_into_the_frames():
    clean = _small_traffic()
    lit = clean.frames.double().sum(dim=(1, 2))
    occl = _small_traffic(occluded_leds=1)
    assert not occl.drawn.any()
    share = occl.frames.double().sum(dim=(1, 2)) / lit
    assert torch.all((share > 0.6) & (share < 0.95)), share
    assert torch.equal(occl.frames, _small_traffic(occluded_leds=1).frames)
    false = _small_traffic(false_blobs={"count": 2, "min_px": 8, "max_px": 40})
    assert false.drawn.all()
    share = false.frames.double().sum(dim=(1, 2)) / lit
    assert torch.all((share > 1.2) & (share < 1.5)), share
    drop = _small_traffic(dropout={"every": 4, "frames": 2})
    dark = drop.frames.double().sum(dim=(1, 2)) == 0
    assert dark.tolist() == [True, True, False, False] * 2
    assert drop.drawn[:, 0].tolist() == [False, False, True, True] * 2


@pytest.mark.parametrize("change", [{"loop": "open"}, {"loop": None}, {"occlusions": 1}])
def test_a_mix_asking_for_what_is_not_implemented_is_refused(tmp_path, change):
    mix = dict(generator.load_mix(BENCH / "traffic" / "orbit.json"), **change)
    path = tmp_path / "mix.json"
    path.write_text(json.dumps(mix))
    with pytest.raises(SystemExit):
        generator.load_mix(path)


def _ref_camera(config):
    c = config["camera"]
    return run.RefCamera.create(c["fx"], c["fy"], c["cx"], c["cy"], c["dist"], c["width"],
                                c["height"])


@pytest.mark.parametrize("workload", ["uav1-100k.orbit", "uav2-50k.orbit"])
def test_uint8_frames_track_the_orbit_and_judge_correct(workload):
    out = run.run_cell(run.load_cell(workload), 2**33 + 11, 600.0, False, "cpu",
                       n_particles=2000, warmup_frames=12, max_frames=8)
    res, info = out["result"], out["info"]
    assert res["failed"] == 0 and res["attempted"] == 8
    for t in info["trajectory"].values():
        assert t["ate_mm"] < 20.0 and t["orientation_deg"] < 3.0
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0.0 for c in res["checks"].values())


def test_end_to_end_arithmetic():
    lat = [0.010 + 0.001 * i for i in range(20)]
    v = run.end_to_end(lat, 2.0, 5.5)
    assert v["frames_per_s"] == 10.0
    assert v["pose_est_ms_p95"] == pytest.approx(float(np.percentile(np.asarray(lat) * 1e3, 95)))
    assert v["pose_est_ms_p95"] == pytest.approx(28.05)
    assert v["setup_s"] == 5.5
    assert math.isnan(run.end_to_end([], 1.0, 1.0)["pose_est_ms_p95"])


def _event(name, start, end, cuda, thread=1):
    dev = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=dev, thread=thread,
                           time_range=SimpleNamespace(start=start, end=end))


def test_trace_summary_and_breakdown():
    events = [
        _event("aten::item", 0, 100, False),  # a sync: the card idles 40-90 inside it
        _event("aten::_local_scalar_dense", 50, 95, False),
        _event("void pf_step_kernel<5, 16>(float const*)", 10, 40, True),
        _event("void <unnamed>::stats_kernel(int const*)", 90, 95, True),
        _event("Memcpy DtoH", 95, 96, True),
        _event("aten::add", 120, 130, False),
        _event("void add_kernel(float*)", 140, 150, True),
    ]
    prof = SimpleNamespace(events=lambda: events)
    s = tracing.summarise(prof, frames=2, wall_s=0.5)
    assert s["busy_s"] == pytest.approx(46e-6)
    assert s["device_ops"] == 4
    assert s["launches_by_name"]["pf_step_kernel<5, 16>"] == 1
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["aten::_local_scalar_dense"] == pytest.approx(50e-6)
    assert gaps["host, outside any operation"] == pytest.approx(44e-6)
    assert len(s["breakdown"]["device_ops"]) <= 10
    run_rec = {"trace": s, "window": {"frames": 4, "syncs": 22, "pf_launches": 5},
               "cell": {"n_particles": 100_000, "n_markers": 5, "n_targets": 1},
               "unprofiled_wall_s": 0.4}
    vals = {m: run.load_reader(m)(run_rec) for m in (
        "tracker.syncs_per_frame", "tracker.device_ops_per_frame", "detect.device_us_per_frame",
        "pf_step_roofline", "pf.passes_per_frame", "device.busy_ms_per_frame",
        "device.idle_share")}
    assert vals["tracker.syncs_per_frame"] == 5.5
    assert vals["tracker.device_ops_per_frame"] == 2.0
    assert vals["detect.device_us_per_frame"] == pytest.approx(2.5)
    assert vals["pf_step_roofline"] == pytest.approx(100 * 100_000 * 132 / 3.35e12 / 30e-6)
    assert vals["pf.passes_per_frame"] == 1.25
    assert vals["device.busy_ms_per_frame"] == pytest.approx(0.023)
    assert vals["device.idle_share"] == pytest.approx(100 * (1 - 23e-6 / 0.2))
    assert tracing.summarise(SimpleNamespace(events=lambda: events[:2]), 1, 1.0) is None


def test_result_line_format():
    out = run.run_cell(run.load_cell("uav1-100k.orbit"), 1, 600.0, False, "cpu", **SMALL)
    res = out["result"]
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"frames_per_s", "pose_est_ms_p95", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_sampler_keeps_the_longest_and_resampling_frames():
    s = Sampler(2**32 + 3)
    frames = [{"k": k} for k in range(200)]
    for f in frames:
        s.offer(f, passes=3 if f["k"] == 57 else 1, resampled=f["k"] % 10 == 0,
                off_path=f["k"] in (31, 131, 171))
    kept = s.frames()
    assert any(f["k"] == 57 for f in kept)
    assert sum(f["k"] % 10 == 0 for f in kept) >= 4
    assert {31, 131, 171} <= {f["k"] for f in kept}
    assert [f["k"] for f in kept] == sorted({f["k"] for f in kept})


def test_refuses_to_run_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "uav1-100k.orbit",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_no_jax_in_the_harness_and_no_program_in_the_reference():
    jaxish = "{'jax', 'jaxlib', 'flax', 'pf_monocular_pose_estimator_tpu'}"
    code = ("import sys; sys.path[:0] = [{b!r}, {r!r}]\n"
            "import importlib, pkgutil, reference\n"
            "for m in pkgutil.walk_packages(reference.__path__, 'reference.'):\n"
            "    importlib.import_module(m.name)\n"
            "top = {{m.split('.')[0] for m in sys.modules}}\n"
            "assert not top & {j}, top & {j}\n"
            "assert 'pf_monocular_pose_estimator_tpu_torch' not in top\n"
            "import run, judge, generator, tracing, roofline\n"
            "top = {{m.split('.')[0] for m in sys.modules}}\n"
            "assert not top & {j}, top & {j}\n"
            "print('clean')\n").format(b=str(BENCH), r=str(ROOT), j=jaxish)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr
    assert "clean" in p.stdout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_a_bare_checkout_of_the_benchmark_refuses(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "uav1-100k.orbit",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_most_resampled_is_the_resamplers_pick():
    from reference.pf.soa import pick_lane, stratified_resample_soa
    from reference.pf.step_kernel import resample_gather
    from reference.track import most_resampled

    gen = torch.Generator().manual_seed(5)
    for n, key in ((1000, (0, 7)), (4096, (3, 2**32 - 1))):
        bank = torch.rand((16, n), generator=gen)
        bank[12:] = torch.tensor([0.0, 0.0, 0.0, 1.0])[:, None]
        w = torch.rand(n, generator=gen) ** 8
        w = w / w.sum()
        anc, _, most = stratified_resample_soa(key, w)
        want = pick_lane(bank, most).reshape(4, 4)
        assert torch.equal(most_resampled(resample_gather(bank, anc), want), want)
