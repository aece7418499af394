"""The teleport guard (`jump_translation_radius`) of the port's tracker
against the JAX tracker.

With a radius above 0 the reference publishes the constant-velocity
prediction instead of a Gauss-Newton pose farther than the radius from it,
and raises the jump flag, while the prediction is trustworthy: a mature
track whose predicted step is shorter than half the radius
(`tracker/step.py`, `pred_trustworthy` and the guard after the rotation
jump test).  On the golden sequence the predicted step is never that short,
so the frames here carry retimed stamps: frames 5 and 9 arrive a tenth of
a frame interval after their predecessor, so the prediction moves ~0.5 mm
while the object moves ~3 mm.  At a radius of 2.2 mm the guard then fires
on both frames, on both sides (the GN pose lies 2.6-2.8 mm from the
prediction there; no other tracked frame predicts a step below 2.1 mm).
The bars are `test_torch_tracker.py::test_trajectory_against_jax`'s."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera
from pf_monocular_pose_estimator_tpu.tracker import TargetState as RefState
from pf_monocular_pose_estimator_tpu.tracker import make_tracker as ref_make_tracker
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as RefConfig
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
from pf_monocular_pose_estimator_tpu_torch.utils.flags import FailFlag
from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

torch.set_num_threads(2)

N = 2_000
N_FRAMES = 11
RETIMED = (5, 9)  # frames stamped a tenth of an interval after the previous one
RADIUS = 0.0022


def _golden():
    d = np.load(os.path.join(os.path.dirname(__file__), "golden", "golden_sequence.npz"))
    cam = (float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
           np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))
    markers = np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1)
    times = np.array(d["times"][:N_FRAMES], np.float64)
    for k in RETIMED:
        times[k] = times[k - 1] + 0.1 * (times[k] - times[k - 1])
    return d["frames"][:N_FRAMES], times, cam, markers


def _jax_replay(radius):
    frames, times, cam, markers = _golden()
    step = ref_make_tracker(RefCamera.create(*cam), jnp.asarray(markers), jnp.ones(5, bool),
                            RefConfig(n_particles=N, min_blob_area=8.0, pf_max_retries=8,
                                      jump_translation_radius=radius))
    state = RefState.create(N, jax.random.PRNGKey(0))
    poses, flags = [], []
    for frame, t in zip(frames, times):
        state, res = step(state, jnp.asarray(frame, jnp.float32), jnp.asarray(t))
        poses.append(np.asarray(res.pose))
        flags.append(int(res.fail_flag))
    return np.stack(poses), np.asarray(flags)


def _port_replay(radius):
    frames, times, cam, markers = _golden()
    step = make_tracker(Camera.create(*cam), torch.from_numpy(markers),
                        torch.ones(5, dtype=torch.bool),
                        TrackerConfig(n_particles=N, min_blob_area=8.0, pf_max_retries=8,
                                      jump_translation_radius=radius), device="cpu")
    state = TargetState.create(N, prng_key(0), device="cpu")
    poses, flags = [], []
    for frame, t in zip(frames, times):
        state, res = step(state, torch.from_numpy(frame), float(t))
        assert bool(res.pose_updated)
        poses.append(res.pose.numpy())
        flags.append(int(res.fail_flag))
    return np.stack(poses), np.asarray(flags)


@pytest.mark.parametrize("radius", [RADIUS, 0.0])
def test_teleport_guard_against_jax(radius):
    """Radius 2.2 mm: the guard fires on the retimed frames on both sides and
    the published pose is the prediction.  Radius 0.0 (the default): no
    frame is flagged, the GN pose is published as before.  Either way poses
    and fail flags agree with the JAX tracker."""
    ref_poses, ref_flags = _jax_replay(radius)
    poses, flags = _port_replay(radius)
    jumped = np.flatnonzero(flags == int(FailFlag.PF_JUMP)).tolist()
    if radius > 0.0:
        assert jumped == list(RETIMED), f"the guard fired on frames {jumped}"
    else:
        assert not jumped, f"frames {jumped} flagged with the guard off"
    np.testing.assert_array_equal(flags, ref_flags)
    d_t = np.linalg.norm(ref_poses[:, :3, 3] - poses[:, :3, 3], axis=-1)
    rel = np.einsum("tij,tkj->tik", ref_poses[:, :3, :3], poses[:, :3, :3])
    ang = np.degrees(np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert d_t[0] < 1e-4, f"frame 0 differs by {d_t[0] * 1e3:.4f} mm"
    assert d_t.max() < 5e-5, f"max {d_t.max() * 1e3:.4f} mm at frame {d_t.argmax()}"
    assert ang.max() < 0.1, f"max {ang.max():.3f} deg at frame {ang.argmax()}"
