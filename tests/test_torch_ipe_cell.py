"""The benchmark cell `uav1-100k-ipe64.orbit` by name (`portbench/`, CPU).

The cell is the upstream's legacy IPE deployment (`use_particle_filter`
false) on `uav1-100k`'s camera and markers.  Its configuration file is
checked against `BENCHMARK.json` and the reference's readings; then the
cell runs on the CPU at a small size (`run.run_cell`, 8 warm-up frames, 6
in the window) in a process of its own, since `correct` is false in any
process that holds jax (this one does, through `tests/conftest.py`).  A
sound run is correct with every comparison 0, and its IPE counters read
`gn_max_iterations` Gauss-Newton iterations a frame, no fallback and no
full-frame detection.  With the consensus check made to fail on every
frame the program re-initialises where the reference tracks: the run is
not correct and `ipe.fallback_share` reads 100.  The readers give None on a
program without the counters (a checkout from before them).

    python tests/test_torch_ipe_cell.py sound|check_fails

runs the cell that way and prints its result, the readers' values and the
counters as one JSON line.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
CELL = "uav1-100k-ipe64.orbit"
CONFIG = "uav1-100k-ipe64"
METRICS = ("ipe.gn_iterations_per_frame", "ipe.fallback_share", "ipe.full_frame_share")
SIZE = dict(warmup_frames=8, max_frames=6)
SEED = 2**31 + 2021
STEP = "pf_monocular_pose_estimator_tpu_torch.tracker.step"


def bench_modules():
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    import run
    from reference.track import READINGS

    return run, READINGS


def run_here(mode: str) -> dict:
    """Run the cell in this process (`mode` "sound" or "check_fails")."""
    import torch

    torch.set_num_threads(2)
    run, _ = bench_modules()
    step_mod = importlib.import_module(STEP)
    if mode == "check_fails":
        check = step_mod.check_correspondences

        def fails(*a, **k):
            r = check(*a, **k)
            return r._replace(success=torch.zeros_like(r.success))

        step_mod.check_correspondences = fails
    out = run.run_cell(run.load_cell(CELL), SEED, 600.0, False, "cpu", **SIZE)
    counts = step_mod.ipe_counts
    return {"result": out["result"],
            "info": {k: out["info"][k] for k in ("judged_flags", "window_flags", "modules_held")},
            "readers": {m: run.load_reader(m)({}) for m in METRICS},
            "counts": {k: getattr(counts, k) for k in type(counts).__slots__}}


def in_own_process(mode: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, __file__, mode], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


# ------------------------------------------------------------------ tests
if __name__ != "__main__":
    import pytest

    @pytest.fixture(scope="module")
    def runs():
        procs = {mode: in_own_process(mode) for mode in ("sound", "check_fails")}
        out = {}
        for mode, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-4000:]
            out[mode] = json.loads(stdout.strip().splitlines()[-1])
        return out

    def test_cell_loads_by_name():
        run, _ = bench_modules()
        cell = run.load_cell(CELL)
        assert cell["workload"]["config"] == CONFIG and cell["workload"]["chips"] == 1
        assert cell["workload"]["traffic"] == "orbit"
        assert cell["config"]["entry"] == "make_tracker"
        assert cell["config"]["tracker"]["use_particle_filter"] is False
        assert [m["name"] for m in cell["per_layer"]] == [*METRICS, "detect.epilogue_share"]
        assert [m["name"] for m in cell["end_to_end"]] == ["frames_per_s", "pose_est_ms_p95",
                                                           "setup_s"]

    def test_limits_cover_every_reading():
        run, readings = bench_modules()
        limits = run.load_cell(CELL)["config"]["limits"]
        assert set(limits) == set(readings)
        assert all(limits[k] == 0 for k in ("det_slots", "flags", "carried"))
        assert all(limits[k] >= 0 for k in readings)

    def test_configuration_matches_benchmark():
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        (entry,) = [c for c in bench["configs"] if c["name"] == CONFIG]
        config = json.loads((ROOT / entry["file"]).read_text())
        assert config["name"] == CONFIG
        assert config["reduced"] == entry["reduced"] == []
        assert config["source"] == entry["source"]
        uav1 = json.loads((BENCH / "configs" / "uav1-100k.json").read_text())
        assert config["camera"] == uav1["camera"] and config["markers"] == uav1["markers"]

    def test_sound_run_is_correct(runs):
        res, info = runs["sound"]["result"], runs["sound"]["info"]
        assert res["correct"], res["checks"]
        assert all(c["value"] == 0 for c in res["checks"].values()), res["checks"]
        assert res["failed"] == 0 and res["attempted"] == SIZE["max_frames"]
        assert info["modules_held"] == []
        assert info["judged_flags"].get("INIT_SUCCESS") == 1
        assert set(info["window_flags"]) == {"PF_SUCCESS"}

    def test_gn_iterations_per_frame_is_gn_max_iterations(runs):
        from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig

        assert TrackerConfig().gn_max_iterations == 25
        assert runs["sound"]["readers"]["ipe.gn_iterations_per_frame"] == 25.0
        counts = runs["sound"]["counts"]
        # every frame but the first (the init branch) is an IPE frame
        assert counts["frames"] == counts["checked"] == sum(SIZE.values()) - 1

    @pytest.mark.parametrize("mode,share", [("sound", 0.0), ("check_fails", 100.0)])
    def test_fallback_share(runs, mode, share):
        assert runs[mode]["readers"]["ipe.fallback_share"] == share

    def test_full_frame_share_reads_0_on_the_orbit(runs):
        assert runs["sound"]["readers"]["ipe.full_frame_share"] == 0.0
        assert runs["sound"]["counts"]["full_frame"] == 0

    def test_check_failing_run_is_not_correct(runs):
        res = runs["check_fails"]["result"]
        assert not res["correct"]
        assert res["checks"]["flags"]["value"] > res["checks"]["flags"]["limit"], res["checks"]
        assert runs["check_fails"]["readers"]["ipe.gn_iterations_per_frame"] == 25.0

    @pytest.mark.parametrize("metric", METRICS)
    def test_readers_without_counters_give_none(monkeypatch, metric):
        import pf_monocular_pose_estimator_tpu_torch.tracker.step as step_mod

        run, _ = bench_modules()
        read = run.load_reader(metric)
        monkeypatch.delattr(step_mod, "ipe_counts")
        assert read({}) is None
        monkeypatch.setattr(step_mod, "ipe_counts", step_mod.IpeCounts(), raising=False)
        assert read({}) is None

    def test_gn_iterations_read_0_where_none_ran(monkeypatch):
        import pf_monocular_pose_estimator_tpu_torch.tracker.step as step_mod

        run, _ = bench_modules()
        counts = step_mod.IpeCounts()
        counts.frames = counts.checked = 4
        monkeypatch.setattr(step_mod, "ipe_counts", counts)
        assert run.load_reader("ipe.gn_iterations_per_frame")({}) == 0.0
        assert run.load_reader("ipe.fallback_share")({}) == 0.0

    def test_gn_iterations_not_counted_where_the_kernel_launched(monkeypatch):
        """`ipe_counts.gn_iterations` counts the Gauss-Newton iterations run
        from the host: a refine whose `refine_pose` call launched the kernel
        adds none.  Four IPE golden frames on the CPU, with the wrapper made
        to count a launch around its plain twin, and without."""
        import numpy as np
        import torch

        import pf_monocular_pose_estimator_tpu_torch.tracker.step as step_mod
        from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
        from pf_monocular_pose_estimator_tpu_torch.pf import refine_kernel
        from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
        from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
        from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

        d = np.load(ROOT / "tests" / "golden" / "golden_sequence.npz")
        cam = Camera.create(float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
                            np.asarray(d["dist"], np.float32), int(d["width"]),
                            int(d["height"]))
        markers = np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1)
        real = refine_kernel.refine_pose

        def launched(*a, **k):
            out = real(*a, **k)
            real.launches += 1
            return out

        monkeypatch.setattr(real, "launches", real.launches)
        counted = {}
        for mode in ("launched", "twin"):
            if mode == "launched":
                monkeypatch.setattr(step_mod, "refine_pose", launched)
            else:
                monkeypatch.setattr(step_mod, "refine_pose", real)
            monkeypatch.setattr(step_mod, "ipe_counts", step_mod.IpeCounts())
            step = make_tracker(cam, torch.from_numpy(markers), torch.ones(5, dtype=torch.bool),
                                TrackerConfig(use_particle_filter=False, n_particles=64,
                                              min_blob_area=8.0), device="cpu")
            state = TargetState.create(64, prng_key(0), device="cpu")
            for i in range(4):
                state, res = step(state, torch.from_numpy(d["frames"][i]), float(d["times"][i]))
                assert bool(res.pose_updated), (mode, i)
            counted[mode] = step_mod.ipe_counts
        # frame 0 initialises; frames 1-3 are IPE frames, each refined once
        assert counted["launched"].frames == counted["launched"].checked == 3
        assert counted["launched"].gn_iterations == 0
        assert counted["twin"].gn_iterations == 3 * TrackerConfig().gn_max_iterations


if __name__ == "__main__":
    print(json.dumps(run_here(sys.argv[1])), flush=True)
