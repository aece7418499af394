"""Fault k: does the port's free-running uav_target replay part from the
reference's by rounding only?  configs/experiments/uav_target.yaml's run
(the demo constellation on the mvBlueFOX calibration, a synthetic orbit of
60 frames at 50 fps from seed 0, 20,000 particles, pf_max_retries 8,
min_blob_area 8) stepped frame by frame: each port frame starts from the
reference's state before it, converted (`utils/convert.py`), as
tests/test_torch_tracker.py's `test_one_frame_from_converted_state` does on
the golden, so the two trackers draw from the same key on the same bank.

Per-frame bars (tests/test_torch_tracker.py's): the fail flag, the update,
the counters and the next key equal; the pose within 0.05 mm and 0.1 deg
(0.1 mm on frame 0, the init).  The first 15 frames run in tier-1; all 60
are the `slow` case.

One frame of the 60 (54) publishes a pose that its data do not determine:
three LEDs are seen, every three-pair hypothesis converges to another P3P
solution ~91 mm away and is rejected as non-local, and the winner binds
two pairs, four equations for six unknowns, solved with 1e-8 damping.  The
reference's covariance there is singular (largest eigenvalue 34 against
<= 0.12 on every other frame), and its own Gauss-Newton moves 0.26-0.68
mm when one float32 ulp moves its start pose or its detections.  On such
a frame the pose bar is that sensitivity, measured here: the reference's
Gauss-Newton (as it runs on the CPU, `pf/refine.py` under vmap) on the
port's inputs, each nudged by one ulp; the port's pose must lie within the
largest move.  Every other bar stays."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.io.markers import load_camera_calibration as ref_camera
from pf_monocular_pose_estimator_tpu.io.markers import load_marker_positions as ref_markers
from pf_monocular_pose_estimator_tpu.io.synthetic import make_orbit_sequence
from pf_monocular_pose_estimator_tpu.pf.refine import gauss_newton_refine as ref_gn
from pf_monocular_pose_estimator_tpu.tracker import TargetState as RefState
from pf_monocular_pose_estimator_tpu.tracker import make_tracker as ref_make_tracker
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as RefConfig
import pf_monocular_pose_estimator_tpu_torch.tracker.step as port_step
from pf_monocular_pose_estimator_tpu_torch.pf.refine_kernel import frame_hypotheses
from pf_monocular_pose_estimator_tpu_torch.io.experiment import load_experiment
from pf_monocular_pose_estimator_tpu_torch.tracker import make_tracker
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig, convert

torch.set_num_threads(2)

EXPERIMENT = os.path.join(os.path.dirname(__file__), "..", "configs", "experiments",
                          "uav_target.yaml")
TIER1_FRAMES = 15
COUNTERS = ("it_since_initialized", "uncertainty", "degraded_frames", "coast_frames")
SINGULAR_EIG = 1.0  # a covariance eigenvalue above it: the pose is not determined


class _Reference:
    """The reference tracker over the experiment's sequence, extended on
    demand: `states[i]` is its state before frame i, `results[i]` frame i's.
    The sequence is rendered only as far as a case replays it; a longer case
    renders it anew and restarts the chain, so every state comes from the
    frames it keeps."""

    def __init__(self):
        exp = load_experiment(EXPERIMENT)
        self.run = exp["run"]
        self.config = exp["tracker"]
        camera = ref_camera(exp["camera"])
        markers = jnp.asarray(ref_markers(exp["markers"], exp["markers_per_object"])[0])
        self.ref_camera, self.ref_markers = camera, markers
        self.camera = convert.camera_from_reference(camera._asdict())
        self.markers = torch.from_numpy(np.asarray(markers))
        self.step = ref_make_tracker(camera, markers, jnp.ones(markers.shape[0], bool),
                                     RefConfig(**self.config))
        self.frames = self.times = ()

    def upto(self, n: int):
        if n > len(self.frames):
            run = self.run
            seq = make_orbit_sequence(self.ref_camera, self.ref_markers, num_frames=n,
                                      fps=run["fps"], seed=run["seed"])
            self.frames, self.times = np.asarray(seq.frames), np.asarray(seq.times)
            self.states = [RefState.create(self.config["n_particles"],
                                           jax.random.PRNGKey(run["seed"]))]
            self.results = []
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
    rel = a[:3, :3] @ b[:3, :3].T
    ang = np.degrees(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1)))
    return float(np.linalg.norm(a[:3, 3] - b[:3, 3])), float(ang)


def _ulp_sensitivity(ref: _Reference, gn_args, pose) -> tuple:
    """How far one float32 ulp in its inputs moves the reference's
    Gauss-Newton (vmapped `pf/refine.py::gauss_newton_refine`, its CPU path)
    on the port's inputs of a frame, for the hypothesis whose port result is
    `pose` -> (largest translation move, largest rotation move in deg)."""
    poses0, det, dfm, masks, iters, tol = (np.asarray(a) if torch.is_tensor(a) else a
                                           for a in gn_args)
    ids = np.broadcast_to(np.arange(dfm.shape[1])[None, :, None], (*dfm.shape, 1))
    corrs = jnp.asarray(np.concatenate([ids, dfm[..., None]], -1).astype(np.int32))
    run = jax.vmap(lambda p, d, c, m: ref_gn(ref.ref_camera, p, ref.ref_markers, d, c, m, iters,
                                             tol), in_axes=(0, None, 0, 0))
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
    """-> the frames whose pose the data do not determine, each with the
    port's gap and the reference's one-ulp moves."""
    ref.upto(n_frames)
    gn_args = []
    real_refine = port_step.refine_frame

    def spy(scal, pre_gn, mark, marker_mask, det_xy, det_mask, tol_pf, *rest):
        # the Gauss-Newton inputs of the fused refine: its hypotheses from pre_gn
        iters, tol, hypotheses = rest[3], rest[4], rest[-1]
        dfm = frame_hypotheses(scal, pre_gn, mark, marker_mask, det_xy, det_mask, tol_pf,
                               hypotheses)
        poses0 = pre_gn[None].expand(dfm.shape[0], 4, 4)
        gn_args[:] = [poses0, det_xy, dfm, (dfm >= 0) & marker_mask[None, :], iters, tol]
        return real_refine(scal, pre_gn, mark, marker_mask, det_xy, det_mask, tol_pf, *rest)

    monkeypatch.setattr(port_step, "refine_frame", spy)
    step = make_tracker(ref.camera, ref.markers, torch.ones(ref.markers.shape[0], dtype=torch.bool),
                        TrackerConfig(**ref.config), device="cpu")
    undetermined = {}
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
        eig = np.linalg.eigvalsh(np.asarray(want.covariance, np.float64)).max()
        if i > 0 and eig > SINGULAR_EIG:
            bar = _ulp_sensitivity(ref, gn_args, got.pose.numpy())
            undetermined[i] = (gap, bar)
            assert gap[0] <= bar[0] and gap[1] <= bar[1], f"frame {i}: {gap} beyond {bar}"
            continue
        assert gap[0] < (1e-4 if i == 0 else 5e-5) and gap[1] < 0.1, f"frame {i}: {gap}"
    assert all(bool(r.pose_updated) for r in ref.results[:n_frames])
    return undetermined


def test_uav_target_stepwise_first_frames(reference, monkeypatch):
    """Frames 0-14 (the init and 14 PF frames), every one within the
    tight per-frame bars."""
    assert _check_stepwise(reference, TIER1_FRAMES, monkeypatch) == {}


@pytest.mark.slow
def test_uav_target_stepwise_all_frames(reference, monkeypatch):
    """All 60 frames: 59 within the tight bars, frame 54 (undetermined)
    within the reference's own one-ulp sensitivity, which exceeds the tight
    bar there (so the tight bar cannot hold on it)."""
    undetermined = _check_stepwise(reference, reference.run["frames"], monkeypatch)
    assert list(undetermined) == [54], undetermined
    gap, bar = undetermined[54]
    assert bar[0] > 5e-5, bar
