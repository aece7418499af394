"""Fault l: does the port's free-running 480-frame orbit part from the
reference's by rounding only?  `bench.py`'s run (the demo constellation on
the default camera, `make_orbit_sequence` over 480 frames at 50 fps,
min_blob_area 8, pf_max_retries 8, roi_particle_subsample 128), at 5,000
particles, stepped frame by frame: each port frame starts from the
reference's state before it, converted (`utils/convert.py`), so the two
trackers draw from the same key on the same bank and see the same frame.

Per-frame bars (tests/test_torch_tracker.py's): the fail flag, the update,
the counters and the next key equal; the pose within 0.05 mm and 0.1 deg
(0.1 mm on frame 0, the init).  The first 15 frames run in tier-1; all 480
are the `slow` case (~4 min on the CPU).

Where a frame's pose misses the tight bar, the bar there is the
reference's own sensitivity, measured as tests/test_torch_uav_target_stepwise.py
measures it: the reference's Gauss-Newton (`pf/refine.py` under vmap, its
CPU path) on the port's inputs of that frame, each nudged by one float32
ulp; the port's pose must lie within the largest move.  Every other bar
stays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.io.synthetic import default_camera as ref_default_camera
from pf_monocular_pose_estimator_tpu.io.synthetic import demo_markers as ref_demo_markers
from pf_monocular_pose_estimator_tpu.io.synthetic import make_orbit_sequence
from pf_monocular_pose_estimator_tpu.pf.refine import gauss_newton_refine as ref_gn
from pf_monocular_pose_estimator_tpu.tracker import TargetState as RefState
from pf_monocular_pose_estimator_tpu.tracker import make_tracker as ref_make_tracker
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as RefConfig
import pf_monocular_pose_estimator_tpu_torch.tracker.step as port_step
from pf_monocular_pose_estimator_tpu_torch.tracker import make_tracker
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig, convert

torch.set_num_threads(2)

CONFIG = dict(n_particles=5_000, min_blob_area=8.0, pf_max_retries=8, roi_particle_subsample=128)
FRAMES = 480
TIER1_FRAMES = 15
COUNTERS = ("it_since_initialized", "uncertainty", "degraded_frames", "coast_frames")


class _Reference:
    """The reference tracker over `bench.py`'s orbit, extended on demand:
    `states[i]` is its state before frame i, `results[i]` frame i's."""

    def __init__(self):
        camera, markers = ref_default_camera(), ref_demo_markers()
        seq = make_orbit_sequence(camera, markers, num_frames=FRAMES, fps=50.0)
        self.frames, self.times = np.asarray(seq.frames), np.asarray(seq.times)
        self.ref_camera, self.ref_markers = camera, markers
        self.camera = convert.camera_from_reference(camera._asdict())
        self.markers = torch.from_numpy(np.asarray(markers))
        self.step = ref_make_tracker(camera, markers, jnp.ones(markers.shape[0], bool),
                                     RefConfig(**CONFIG))
        self.states = [RefState.create(CONFIG["n_particles"], jax.random.PRNGKey(0))]
        self.results = []
        self.gn = {}  # (iters, tol) -> the reference's vmapped Gauss-Newton

    def upto(self, n: int):
        while len(self.results) < n:
            i = len(self.results)
            state, res = self.step(self.states[i], jnp.asarray(self.frames[i]),
                                   jnp.asarray(self.times[i]))
            self.states.append(state)
            self.results.append(res)
        return self


@pytest.fixture(scope="module")
def reference():
    return _Reference()


def _fields(state) -> dict:
    return {n: (np.asarray(v) if n != "exposure" else v) for n, v in state._asdict().items()}


def _pose_gap(a, b):
    """(translation gap, rotation gap in deg), in float64; the angle from the
    chordal distance |Ra - Rb| = 2 sqrt(2) sin(angle / 2)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / (2 * np.sqrt(2))
    return float(np.linalg.norm(a[:3, 3] - b[:3, 3])), float(np.degrees(2 * np.arcsin(min(chord, 1))))


def _ulp_sensitivity(ref: _Reference, gn_args, pose) -> tuple:
    """How far one float32 ulp in its inputs moves the reference's
    Gauss-Newton on the port's inputs of a frame, for the hypothesis whose
    port result is `pose` -> (largest translation move, largest rotation
    move in deg)."""
    poses0, det, dfm, masks, iters, tol = (np.asarray(a) if torch.is_tensor(a) else a
                                           for a in gn_args)
    ids = np.broadcast_to(np.arange(dfm.shape[1])[None, :, None], (*dfm.shape, 1))
    corrs = jnp.asarray(np.concatenate([ids, dfm[..., None]], -1).astype(np.int32))
    if (iters, tol) not in ref.gn:
        ref.gn[iters, tol] = jax.jit(jax.vmap(
            lambda p, d, c, m: ref_gn(ref.ref_camera, p, ref.ref_markers, d, c, m, iters, tol),
            in_axes=(0, None, 0, 0)))
    run = ref.gn[iters, tol]
    base = np.asarray(run(jnp.asarray(poses0), jnp.asarray(det), corrs, jnp.asarray(masks)).pose)
    h = int(np.argmin([_pose_gap(pose, b)[0] for b in base]))
    moves = []
    for sign in (1, -1):
        nudged = (poses0 + sign * np.spacing(np.abs(poses0)), det)
        for p, d in (nudged, (poses0, det + sign * np.spacing(np.abs(det)))):
            out = run(jnp.asarray(p.astype(np.float32)), jnp.asarray(d.astype(np.float32)), corrs,
                      jnp.asarray(masks))
            moves.append(_pose_gap(np.asarray(out.pose)[h], base[h]))
    return max(m[0] for m in moves), max(m[1] for m in moves)


def _check_stepwise(ref: _Reference, n_frames: int, monkeypatch):
    """-> {frame: (the port's gap, the reference's one-ulp moves)} for the
    frames whose pose misses the tight bar but lies within the reference's
    own sensitivity there; every other frame meets the tight bars."""
    ref.upto(n_frames)
    gn_args = []
    real_gn = port_step.gauss_newton_refine_batched

    def spy(camera, poses0, markers_h, det_xy, dfm, masks, iters, tol):
        gn_args[:] = [poses0, det_xy, dfm, masks, iters, tol]
        return real_gn(camera, poses0, markers_h, det_xy, dfm, masks, iters, tol)

    monkeypatch.setattr(port_step, "gauss_newton_refine_batched", spy)
    step = make_tracker(ref.camera, ref.markers, torch.ones(ref.markers.shape[0], dtype=torch.bool),
                        TrackerConfig(**CONFIG), device="cpu")
    sensitive = {}
    for i in range(n_frames):
        state = convert.state_from_reference(_fields(ref.states[i]))
        got_state, got = step(state, torch.from_numpy(ref.frames[i]), float(ref.times[i]))
        want, want_state = ref.results[i], ref.states[i + 1]
        assert int(got.fail_flag) == int(want.fail_flag), f"frame {i}: flag"
        assert bool(got.pose_updated) == bool(want.pose_updated), f"frame {i}: update"
        back = convert.state_to_reference(got_state)
        np.testing.assert_array_equal(back["key"], np.asarray(want_state.key), f"frame {i}")
        for name in COUNTERS:
            assert int(back[name]) == int(np.asarray(getattr(want_state, name))), (i, name)
        gap = _pose_gap(got.pose.numpy(), np.asarray(want.pose))
        if gap[0] < (1e-4 if i == 0 else 5e-5) and gap[1] < 0.1:
            continue
        assert i > 0, f"frame 0: {gap}"
        bar = _ulp_sensitivity(ref, gn_args, got.pose.numpy())
        sensitive[i] = (gap, bar)
        assert gap[0] <= bar[0] and gap[1] <= bar[1], f"frame {i}: {gap} beyond {bar}"
    assert all(bool(r.pose_updated) for r in ref.results[:n_frames])
    return sensitive


def test_orbit_stepwise_first_frames(reference, monkeypatch):
    """Frames 0-14 (the init and 14 PF frames), every one within the tight
    per-frame bars."""
    assert _check_stepwise(reference, TIER1_FRAMES, monkeypatch) == {}


@pytest.mark.slow
def test_orbit_stepwise_all_frames(reference, monkeypatch):
    """All 480 frames: 476 within the tight bars; frames 54, 137, 185 and
    416 within the reference's own one-ulp sensitivity, which exceeds the
    tight bar on each.  Their poses are barely determined: the largest
    eigenvalue of the reference's covariance is 2.5-32 there, at most 0.86
    on every other frame."""
    sensitive = _check_stepwise(reference, FRAMES, monkeypatch)
    eig = [np.linalg.eigvalsh(np.asarray(r.covariance, np.float64)).max()
           for r in reference.results]
    for i, (gap, bar) in sensitive.items():
        print(f"frame {i}: the port {gap[0] * 1e3:.4f} mm, {gap[1]:.4f} deg off; the "
              f"reference's one-ulp move up to {bar[0] * 1e3:.4f} mm, {bar[1]:.4f} deg; "
              f"covariance eigenvalue {eig[i]:.2f}")
    rest = max(e for i, e in enumerate(eig) if i not in sensitive)
    print(f"largest covariance eigenvalue on every other frame: {rest:.2f}")
    assert sorted(sensitive) == [54, 137, 185, 416], sensitive
    for i, (gap, bar) in sensitive.items():
        assert bar[0] > 5e-5 or bar[1] > 0.1, (i, bar)
        assert eig[i] > 1.0, (i, eig[i])
    assert rest <= 1.0
