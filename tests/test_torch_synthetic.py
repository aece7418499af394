"""The port's synthetic renderer and trajectory metrics (`io/synthetic.py`,
`io/metrics.py`) against the JAX package's and its committed goldens.

The renderer takes the reference's random draws in the reference's order,
builds the poses on the host through the port's `exp_se3`, and draws in
torch in the precision numpy gives each step.  Float32 `exp` and `sin` /
`cos` differ between libraries by an ulp: a pose element may sit up to
1.2e-7 (one float32 ulp at the ~1.5 m distance) from the golden's, a splat one ulp from the reference's, and a frame cast
to uint8 one level from the golden's at a few pixels (none on this CPU)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.io import metrics as ref_metrics
from pf_monocular_pose_estimator_tpu.io import synthetic as ref
from pf_monocular_pose_estimator_tpu_torch.geometry import exp_se3
from pf_monocular_pose_estimator_tpu_torch.io import (
    absolute_trajectory_error,
    default_camera,
    demo_markers,
    make_orbit_sequence,
    make_realistic_sequence,
    make_two_target_sequence,
    orientation_error_deg,
    render_frame,
    second_markers,
)

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _levels(frames: torch.Tensor, golden: np.ndarray):
    got = frames.numpy().astype(np.uint8).astype(np.int16)
    diff = np.abs(got - golden.astype(np.int16))
    return int(diff.max()), int((diff > 0).sum())


def test_constants_equal_the_reference():
    np.testing.assert_array_equal(demo_markers("cpu").numpy(), np.asarray(ref.demo_markers()))
    np.testing.assert_array_equal(second_markers("cpu").numpy(), np.asarray(ref.second_markers()))
    cam, want = default_camera("cpu"), ref.default_camera()
    for name in ("fx", "fy", "cx", "cy", "dist"):
        np.testing.assert_array_equal(getattr(cam, name).numpy(), np.asarray(getattr(want, name)))
    assert (cam.width, cam.height) == (want.width, want.height)


@pytest.mark.parametrize("seed", [0, 1])
def test_render_frame_against_the_reference(seed):
    """A random pose with marker 2 masked out, on the default camera: within
    1e-4 of the reference (4 float32 ulps at the splat peak of ~255)."""
    rng = np.random.default_rng(seed)
    twist = np.concatenate([rng.normal(0, 0.05, 3), rng.normal(0, 0.3, 3)]).astype(np.float32)
    pose = exp_se3(torch.from_numpy(twist))
    pose[2, 3] += 1.2
    mask = np.array([True, True, False, True, True])
    want = np.asarray(ref.render_frame(ref.default_camera(), jnp.asarray(pose.numpy()),
                                       ref.demo_markers(), 1.6, marker_mask=jnp.asarray(mask)))
    got = render_frame(default_camera("cpu"), pose, demo_markers("cpu"), 1.6,
                       marker_mask=torch.from_numpy(mask)).numpy()
    assert got.shape == (480, 752) and got.dtype == np.float32
    assert (want > 100).sum() > 40, "the splats must be on the frame"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    unmasked = render_frame(default_camera("cpu"), pose, demo_markers("cpu"), 1.6).numpy()
    assert (unmasked > got + 1.0).any(), "the masked marker must be missing"


def test_orbit_sequence_against_the_reference():
    """`run_multihost`'s sequence: poses within 1.2e-7, frames within the
    shift that gives a splat (2e-3)."""
    want = ref.make_orbit_sequence(ref.default_camera(), ref.demo_markers(), num_frames=3)
    got = make_orbit_sequence(default_camera("cpu"), demo_markers("cpu"), num_frames=3,
                              device="cpu")
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), rtol=0, atol=1.2e-7)
    np.testing.assert_allclose(got.frames.numpy(), np.asarray(want.frames), rtol=0, atol=2e-3)
    np.testing.assert_array_equal(got.times.numpy(), np.asarray(want.times))


def test_realistic_sequence_against_the_golden():
    """The first 8 frames of tests/golden/realistic_sequence.npz (seed 4):
    within one uint8 level, poses within 1.2e-7."""
    d = np.load(os.path.join(GOLDEN, "realistic_sequence.npz"))
    seq = make_realistic_sequence(default_camera("cpu"), demo_markers("cpu"), num_frames=8,
                                  seed=4, device="cpu")
    worst, n_diff = _levels(seq.frames, d["frames"][:8])
    assert worst <= 1, f"{n_diff} pixels differ, by up to {worst} levels"
    np.testing.assert_allclose(seq.poses.numpy(), d["poses"][:8], rtol=0, atol=1.2e-7)
    np.testing.assert_array_equal(seq.times.numpy(), d["times"][:8])
    np.testing.assert_array_equal(seq.markers_h[:, :3].numpy(), d["markers"])


def test_two_target_sequence_against_the_golden():
    """The first 4 frames of tests/golden/two_uav_sequence.npz (seed 2):
    poses within 1.2e-7, frames within one uint8 level (all 60 frames are
    regenerated on the card by chip_smoke.py)."""
    d = np.load(os.path.join(GOLDEN, "two_uav_sequence.npz"))
    seq = make_two_target_sequence(default_camera("cpu"), demo_markers("cpu"),
                                   second_markers("cpu"), num_frames=4, seed=2, device="cpu")
    assert seq.poses.shape == (4, 2, 4, 4) and seq.markers_h.shape == (2, 5, 4)
    np.testing.assert_allclose(seq.poses.numpy(), d["poses"][:4], rtol=0, atol=1.2e-7)
    np.testing.assert_array_equal(seq.times.numpy(), d["times"][:4])
    worst, n_diff = _levels(seq.frames, d["frames"][:4])
    assert worst <= 1, f"{n_diff} pixels differ, by up to {worst} levels"


def test_metrics_equal_the_reference():
    rng = np.random.default_rng(5)
    gt = exp_se3(torch.from_numpy(rng.normal(0, 0.3, (12, 6)).astype(np.float32))).numpy()
    est = exp_se3(torch.from_numpy(rng.normal(0, 0.3, (12, 6)).astype(np.float32))).numpy()
    mask = rng.uniform(size=12) > 0.3
    for m in (None, mask, np.zeros(12, bool)):
        assert absolute_trajectory_error(est, gt, m) == ref_metrics.absolute_trajectory_error(
            est, gt, m)
        assert orientation_error_deg(est, gt, m) == ref_metrics.orientation_error_deg(est, gt, m)
