"""The comparison that decides `correct` on the IPE track branch (CPU).

The configuration is built here and is no cell of `BENCHMARK.json`:
`uav1-100k`'s camera and markers with the tracker settings of
`configs/experiments/ipe_legacy.yaml` (`use_particle_filter=False`, 64
particles, `min_blob_area` 8), the upstream's legacy iterative pose
estimation.  Runs of it on the orbit, on the CPU (`run.run_cell`), come
out correct when sound and not correct under the control (the reference
rounded to bfloat16 in the program's place) and under each planted fault:
a step that returns its state unchanged, a key or a previous pose handed
on as given, a start that the seed does not give, a pose moved where the
Gauss-Newton produces it, and a consensus check that fails every frame, so
the program re-initialises where the reference tracks.  One more test steps
the program from a state whose predicted pose lies past the
nearest-neighbour tolerance, so that both sides take the brute-force
fallback, and sees every reading 0.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402
from generator import make_traffic  # noqa: E402
from judge import judge  # noqa: E402
from reference.geometry.camera import Camera as RefCamera  # noqa: E402
from reference.track import READINGS  # noqa: E402
import pf_monocular_pose_estimator_tpu_torch.tracker.step as step_mod  # noqa: E402

IPE = {"use_particle_filter": False, "n_particles": 64, "min_blob_area": 8.0}
SIZE = dict(warmup_frames=8, max_frames=6)
SEED = 2**31 + 91
AFTER = SIZE["warmup_frames"]


def ipe_cell() -> dict:
    cell = copy.deepcopy(run.load_cell("uav1-100k.orbit"))
    cell["config"]["name"] = "uav1-ipe64"
    cell["config"]["tracker"] = dict(IPE)
    return cell


def run_ipe(control=None) -> dict:
    return run.run_cell(ipe_cell(), SEED, 600.0, False, "cpu", control, **SIZE)


def over(res) -> set:
    return {k for k, c in res["checks"].items() if c["value"] > c["limit"]}


def test_sound_ipe_run_is_correct():
    out = run_ipe()
    res, info = out["result"], out["info"]
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values()), res["checks"]
    assert info["judged_flags"].get("INIT_SUCCESS") == 1
    assert info["judged_flags"].get("PF_SUCCESS", 0) >= 1


def test_ipe_control_is_not_correct():
    res = run_ipe("bf16")["result"]
    assert not res["correct"]
    assert {"det_px", "pose_mm"} <= over(res), res["checks"]


class Broken:
    """A step that, from the window on, hands back `mend(state given,
    state made, result)` instead of what it made."""

    def __init__(self, step, mend):
        self.step, self.mend, self.host = step, mend, step.host

    def __call__(self, state, image, t):
        new, res = self.step(state, image, t)
        if self.step.frames <= AFTER:
            return new, res
        return self.mend(state, new, res)


def unchanged(state, new, res):
    return state, dataclasses.replace(res, pose=state.current_pose,
                                      pose_updated=state.pose_updated,
                                      fail_flag=state.fail_flag)


def field_as_given(name):
    return lambda state, new, res: (dataclasses.replace(new, **{name: getattr(state, name)}), res)


@pytest.mark.parametrize("mend,reading", [(unchanged, "carried"), (field_as_given("key"), "carried"),
                                          (field_as_given("previous_pose"), "pose_mm")],
                         ids=["state_unchanged", "key_as_given", "stale_previous_pose"])
def test_ipe_step_broken_is_not_correct(monkeypatch, mend, reading):
    build = run.build

    def broken(*a, **k):
        step, *rest = build(*a, **k)
        return (Broken(step, mend), *rest)

    monkeypatch.setattr(run, "build", broken)
    res = run_ipe()["result"]
    assert not res["correct"]
    assert reading in over(res), res["checks"]


def test_ipe_start_not_from_the_seed_is_not_correct(monkeypatch):
    build = run.build

    def other_key(config, seed, *a, **k):
        step, state, *rest = build(config, seed, *a, **k)
        other = build(config, seed + 1, *a, **k)[1]
        return (step, dataclasses.replace(state, key=other.key), *rest)

    monkeypatch.setattr(run, "build", other_key)
    res = run_ipe()["result"]
    assert not res["correct"]
    assert "carried" in over(res), res["checks"]


def test_ipe_pose_altered_where_produced_is_not_correct(monkeypatch):
    refine = step_mod.gauss_newton_refine

    def moved(*a, **k):
        r = refine(*a, **k)
        pose = r.pose.clone()
        pose[0, 3] += 5e-3
        return r._replace(pose=pose)

    monkeypatch.setattr(step_mod, "gauss_newton_refine", moved)
    res = run_ipe()["result"]
    assert not res["correct"]
    assert "pose_mm" in over(res), res["checks"]


def test_ipe_check_failing_every_frame_is_not_correct(monkeypatch):
    check = step_mod.check_correspondences

    def fails(*a, **k):
        r = check(*a, **k)
        return r._replace(success=torch.zeros_like(r.success))

    monkeypatch.setattr(step_mod, "check_correspondences", fails)
    out = run_ipe()
    res = out["result"]
    assert not res["correct"]
    assert "flags" in over(res), res["checks"]
    assert out["info"]["window_flags"].get("INIT_SUCCESS", 0) >= 1


def test_ipe_fallback_matches_the_program():
    """The predicted pose moved 5 cm sideways (~20 px at 1.5 m) with the
    track not yet mature, so no marker's nearest detection lies within 7
    px: the consensus check fails and both sides re-initialise."""
    config = ipe_cell()["config"]
    device = torch.device("cpu")
    step, state, markers_t, settings = run.build(config, SEED, device)
    c = config["camera"]
    cam = RefCamera.create(c["fx"], c["fy"], c["cx"], c["cy"], c["dist"], c["width"], c["height"])
    traffic = make_traffic(run.load_cell("uav1-100k.orbit")["mix"], cam, markers_t, SEED, device)
    loop = run.Loop(step, state, traffic, device)
    for _ in range(6):
        loop.frame()
    pred = loop.state.predicted_pose.clone()
    pred[0, 3] += 0.05
    loop.state = dataclasses.replace(loop.state, predicted_pose=pred,
                                     it_since_initialized=torch.tensor(1, dtype=torch.int32))
    rec = loop.frame(keep=True)[3]
    readings = judge([rec], lambda i: traffic.frames[i], config, markers_t, device, None,
                     settings, None)
    assert readings.branches == {"INIT_SUCCESS": 1}, readings.branches
    assert {k: readings.values[k] for k in READINGS} == dict.fromkeys(READINGS, 0.0)
    assert np.all(rec["packed"][:, 16] == 1)
