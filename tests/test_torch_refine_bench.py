"""The fused refine under the benchmark's comparison (`portbench/`, CPU).

Runs of `uav1-100k.orbit` on the CPU at 2,000 particles (`run.run_cell`,
the plain twins): a sound run reads every comparison within its limit, and
a published pose moved by 5 mm where the fused refine (`refine_frame`)
produces it reads `pose_mm` over its limit.  (`correct` itself is false in
any process that holds jax, as this one does; `portbench/tests` runs the
harness in a process of its own.)  The engagement metric
`refine.fused_share` reads the wrapper's counters.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1] / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import run as bench_run  # noqa: E402
import pf_monocular_pose_estimator_tpu_torch.tracker.step as step_mod  # noqa: E402
from pf_monocular_pose_estimator_tpu_torch.pf import refine_kernel  # noqa: E402

SIZE = dict(n_particles=2000, warmup_frames=8, max_frames=6)
SEED = 2**31 + 77


@pytest.fixture(scope="module", autouse=True)
def one_traffic():
    """The runs here share one cell and one seed, so they share its frames:
    `make_traffic` renders the period once for the module."""
    made = {}
    real = bench_run.make_traffic

    def make_once(mix, camera, markers_t, seed, device):
        key = (json.dumps(mix, sort_keys=True), seed, str(device))
        if key not in made:
            made[key] = real(mix, camera, markers_t, seed, device)
        return made[key]

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(bench_run, "make_traffic", make_once)
        yield


def run_small():
    return bench_run.run_cell(bench_run.load_cell("uav1-100k.orbit"), SEED, 600.0, False, "cpu",
                              None, **SIZE)["result"]


def test_sound_run_reads_within_every_limit():
    checks = run_small()["checks"]
    assert checks and all(c["value"] <= c["limit"] for c in checks.values()), checks


def test_pose_moved_in_the_fused_refine_is_caught(monkeypatch):
    real = step_mod.refine_frame

    def moved(*a, **k):
        r = real(*a, **k)
        pose = r.pose.clone()
        pose[0, 3] += 5e-3
        return r._replace(pose=pose)

    monkeypatch.setattr(step_mod, "refine_frame", moved)
    checks = run_small()["checks"]
    assert checks["pose_mm"]["value"] > checks["pose_mm"]["limit"]


def _fused_share():
    spec = importlib.util.spec_from_file_location("fused_share",
                                                  BENCH / "metrics" / "refine.fused_share.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("calls,launches,want", [(0, 0, None), (40, 40, 100.0), (40, 0, 0.0)])
def test_fused_share_reads_the_wrappers_counters(monkeypatch, calls, launches, want):
    """100 x launches / calls over the process; None before any call, and on
    a program whose refine_kernel module has no `refine_frame`."""
    monkeypatch.setattr(refine_kernel.refine_frame, "calls", calls)
    monkeypatch.setattr(refine_kernel.refine_frame, "launches", launches)
    read = _fused_share()
    assert read({}) == want
    monkeypatch.setitem(sys.modules, refine_kernel.__name__, SimpleNamespace())
    assert read({}) is None
