"""`accuracy_torch.py`, the port's accuracy matrix, against
`benchmarks/accuracy.py`, the JAX script, on the CPU.

`run_single` at config0's settings (300 particles, 6 frames) and config3's
sequential four-target step (300 particles a target, 3 frames) hold to the
JAX script's own code on each side's orbit: the same keys, tracked
fraction and re-initialisations equal, ATE and median error within 0.05
mm, orientation error within 0.05 deg.  config2's two configurations equal
the reference's field by field.  `main`'s report carries exactly the JAX
script's keys, and `--device cuda` raises without a card.
tests/test_torch_config.py reads the script's import lines: no jax,
nothing of the JAX package, `benchmarks/`, `bench.py` or `chip_smoke.py`."""

import ast
import dataclasses
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.accuracy import run_single as ref_run_single
from pf_monocular_pose_estimator_tpu.io.metrics import absolute_trajectory_error as ref_ate
from pf_monocular_pose_estimator_tpu.io.synthetic import default_camera as ref_default_camera
from pf_monocular_pose_estimator_tpu.io.synthetic import demo_markers as ref_demo_markers
from pf_monocular_pose_estimator_tpu.io.synthetic import make_orbit_sequence as ref_orbit
from pf_monocular_pose_estimator_tpu.tracker.multi import create_states as ref_create_states
from pf_monocular_pose_estimator_tpu.tracker.multi import make_multi_tracker as ref_multi_tracker
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as RefConfig
from pf_monocular_pose_estimator_tpu_torch.io.synthetic import (default_camera, demo_markers,
                                                                make_orbit_sequence)
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import accuracy_torch  # noqa: E402

torch.set_num_threads(2)

N = 300
BASE = dict(min_blob_area=8.0, pf_max_retries=8)


def _orbits(frames: int):
    """(reference camera, markers, sequence), (the port's, on the CPU)."""
    cam, markers = ref_default_camera(), ref_demo_markers()
    cam_t, markers_t = default_camera("cpu"), demo_markers("cpu")
    return ((cam, markers, ref_orbit(cam, markers, num_frames=frames, fps=50.0)),
            (cam_t, markers_t, make_orbit_sequence(cam_t, markers_t, num_frames=frames, fps=50.0,
                                                   device="cpu")))


def _same_row(got: dict, want: dict):
    assert list(got) == list(want)
    assert got["tracked_fraction"] == want["tracked_fraction"]
    for name in ("ate_mm", "median_err_mm"):
        if name in want:
            assert abs(got[name] - want[name]) <= 0.05, (name, got[name], want[name])
    if "orientation_err_deg" in want:
        assert abs(got["orientation_err_deg"] - want["orientation_err_deg"]) <= 0.05
    if "reinits" in want:
        assert got["reinits"] == want["reinits"]
    if "ate_mm_per_target" in want:
        assert np.allclose(got["ate_mm_per_target"], want["ate_mm_per_target"], rtol=0, atol=0.05)


def test_run_single_config0_against_jax():
    (cam, markers, seq), (cam_t, markers_t, seq_t) = _orbits(6)
    want = ref_run_single(cam, markers, RefConfig(n_particles=N, **BASE), seq)
    got = accuracy_torch.run_single(cam_t, markers_t, TrackerConfig(n_particles=N, **BASE), seq_t)
    print(f"port {got}\nreference {want}")
    assert got["tracked_fraction"] == 1.0
    _same_row(got, want)


def test_config3_sequential_targets_against_jax():
    """`benchmarks/accuracy.py`'s config3 block (make_multi_tracker without
    `sequential`, whose default is the per-target `lax.map`) at 300
    particles a target over 3 frames."""
    (cam, markers, seq), (cam_t, markers_t, seq_t) = _orbits(3)
    cfg = RefConfig(n_particles=N, **BASE)
    mstep = ref_multi_tracker(cam, jnp.broadcast_to(markers, (4, markers.shape[0], 4)),
                              jnp.ones((4, markers.shape[0]), bool), cfg)
    states = ref_create_states(4, cfg.n_particles)
    est, upd = [], []
    for i in range(seq.frames.shape[0]):
        states, res = mstep(states, seq.frames[i], seq.times[i])
        est.append(np.asarray(res.pose))
        upd.append(np.asarray(res.pose_updated))
    est, upd, gt = np.stack(est), np.stack(upd), np.asarray(seq.poses)
    want = {"tracked_fraction": round(float(upd.mean()), 3),
            "ate_mm_per_target": [round(ref_ate(est[:, k], gt, upd[:, k]) * 1000, 3)
                                  for k in range(4)]}
    got = accuracy_torch.run_targets(cam_t, markers_t, TrackerConfig(n_particles=N, **BASE), seq_t)
    print(f"port {got}\nreference {want}")
    assert got["tracked_fraction"] == 1.0
    _same_row(got, want)


def test_config2_configs_equal_the_reference():
    """The faulted row's and the parity row's configs, as the JAX script
    builds them (`dataclasses.replace` on the base; `reference_parity`)."""
    cfg2, cfg2p = accuracy_torch.faulted_configs(TrackerConfig(**BASE))
    base = RefConfig(**BASE)
    faults = dict(number_of_occlusions=1, number_of_false_detections=2)
    want2 = dataclasses.replace(base, n_particles=50_000, **faults)
    want2p = RefConfig.reference_parity(n_particles=50_000, min_blob_area=base.min_blob_area,
                                        pf_max_retries=base.pf_max_retries, **faults)
    for got, want in ((cfg2, want2), (cfg2p, want2p)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert cfg2 != cfg2p


def _jax_report_keys() -> set:
    """Every key of the report `benchmarks/accuracy.py` prints: its rows
    (`report[...]`) and the keys of the dicts it builds."""
    keys = set()
    for node in ast.walk(ast.parse((ROOT / "benchmarks" / "accuracy.py").read_text())):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
        if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
                and node.value.id == "report" and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys


def _keys(tree) -> set:
    if isinstance(tree, dict):
        return set(tree) | set().union(*(_keys(v) for v in tree.values()))
    if isinstance(tree, list):
        return set().union(*(_keys(v) for v in tree)) if tree else set()
    return set()


def test_main_report_has_the_jax_scripts_keys(monkeypatch, capsys):
    """`main` on the CPU over 2 frames, every tracker cut to 64 particles:
    the printed report is the returned one, with the JAX script's rows and
    keys, five seeds on both config2 rows."""
    def cut(fn):
        return lambda camera, markers, config, seq, *a, **k: fn(
            camera, markers, dataclasses.replace(config, n_particles=64), seq, *a, **k)

    monkeypatch.setattr(accuracy_torch, "run_single", cut(accuracy_torch.run_single))
    monkeypatch.setattr(accuracy_torch, "run_targets", cut(accuracy_torch.run_targets))
    report = accuracy_torch.main(["--device", "cpu", "--frames", "2"])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(report))
    assert list(report) == ["config0_1k_clean", "config1_10k", "config2_50k_outliers",
                            "config2_50k_outliers_reference_parity", "config3_4targets_25k"]
    assert _keys(report) == _jax_report_keys()
    for row in ("config2_50k_outliers", "config2_50k_outliers_reference_parity"):
        assert report[row]["seeds"] == 5 and len(report[row]["per_seed"]) == 5
    assert len(report["config3_4targets_25k"]["ate_mm_per_target"]) == 4


def test_defaults_and_cuda_without_a_card_raises(monkeypatch):
    """`--device cuda` (the default) never falls back to the CPU."""
    args = accuracy_torch.parse_args([])
    assert (args.device, args.frames) == ("cuda", 40)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        accuracy_torch.main(["--frames", "2"])
