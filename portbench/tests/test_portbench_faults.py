"""The comparison that decides `correct` fails what it must (CPU).

Each test drives a run of `uav1-100k.orbit` on the CPU at 2,000
particles past the look for a card (`run.run_cell`), with the timed path
broken underneath, and sees `correct` come out false: the control (the
reference rounded to bfloat16 in the program's place), a step that
returns its state unchanged, a step that hands on one field of its state
(the key, a time, the previous pose) as it was given, a start from a state
that the seed does not give, the PF weights of half the particles left
out (the others' normalised over the rest), and a published pose moved
where the fused refine (`refine_frame`) produces it.  A sound run of the
same size comes out true.  The cells run on one card, so no exchange
between cards can be left out.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402
import pf_monocular_pose_estimator_tpu_torch.tracker.step as step_mod  # noqa: E402

SIZE = dict(n_particles=2000, warmup_frames=8, max_frames=6)
SEED = 2**31 + 77


def run_small(control=None):
    return run.run_cell(run.load_cell("uav1-100k.orbit"), SEED, 600.0, False, "cpu", control,
                        **SIZE)["result"]


def test_sound_run_is_correct():
    res = run_small()
    assert res["correct"], res["checks"]


def test_control_is_not_correct():
    res = run_small("bf16")
    assert not res["correct"]
    failed = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert {"det_px", "bank", "weights", "pose_mm"} <= set(failed), res["checks"]


class Unchanged:
    """A step that, from the window on, returns the state it was given."""

    def __init__(self, step, after: int):
        self.step, self.after, self.host = step, after, step.host

    def __call__(self, state, image, t):
        new, res = self.step(state, image, t)
        if self.step.frames <= self.after:
            return new, res
        return state, dataclasses.replace(res, pose=state.current_pose,
                                          pose_updated=state.pose_updated,
                                          fail_flag=state.fail_flag)


def test_state_left_unchanged_is_not_correct(monkeypatch):
    build = run.build

    def broken(*a, **k):
        step, *rest = build(*a, **k)
        return (Unchanged(step, SIZE["warmup_frames"]), *rest)

    monkeypatch.setattr(run, "build", broken)
    res = run_small()
    assert not res["correct"]
    assert res["checks"]["bank"]["value"] > res["checks"]["bank"]["limit"]


class Stale:
    """A step that, from the window on, hands on one field of the state as
    it was given."""

    def __init__(self, step, after: int, field: str):
        self.step, self.after, self.field, self.host = step, after, field, step.host

    def __call__(self, state, image, t):
        new, res = self.step(state, image, t)
        if self.step.frames <= self.after:
            return new, res
        return dataclasses.replace(new, **{self.field: getattr(state, self.field)}), res


@pytest.mark.parametrize("field,reading", [("key", "carried"), ("time_current", "carried"),
                                           ("previous_pose", "pose_mm")])
def test_a_field_not_handed_on_is_not_correct(monkeypatch, field, reading):
    build = run.build

    def broken(*a, **k):
        step, *rest = build(*a, **k)
        return (Stale(step, SIZE["warmup_frames"], field), *rest)

    monkeypatch.setattr(run, "build", broken)
    res = run_small()
    assert not res["correct"]
    assert res["checks"][reading]["value"] > res["checks"][reading]["limit"], res["checks"]


def test_a_start_not_from_the_seed_is_not_correct(monkeypatch):
    build = run.build

    def other_key(config, seed, *a, **k):
        step, state, *rest = build(config, seed, *a, **k)
        other = build(config, seed + 1, *a, **k)[1]
        return (step, dataclasses.replace(state, key=other.key), *rest)

    monkeypatch.setattr(run, "build", other_key)
    res = run_small()
    assert not res["correct"]
    assert res["checks"]["carried"]["value"] > 0


def test_half_the_particles_left_out_is_not_correct(monkeypatch):
    fused = step_mod.fused_propagate_weight

    def half(*a, **k):
        bank, w = fused(*a, **k)
        w = w.clone()
        w[w.shape[0] // 2:] = 0.0
        return bank, w

    monkeypatch.setattr(step_mod, "fused_propagate_weight", half)
    res = run_small()
    assert not res["correct"]
    assert res["checks"]["weights"]["value"] > res["checks"]["weights"]["limit"]


@pytest.mark.parametrize("shift_m", [5e-3])
def test_pose_altered_where_produced_is_not_correct(monkeypatch, shift_m):
    refine = step_mod.refine_frame

    def moved(*a, **k):
        r = refine(*a, **k)
        pose = r.pose.clone()
        pose[0, 3] += shift_m
        return r._replace(pose=pose)

    monkeypatch.setattr(step_mod, "refine_frame", moved)
    res = run_small()
    assert not res["correct"]
    assert res["checks"]["pose_mm"]["value"] > res["checks"]["pose_mm"]["limit"]
