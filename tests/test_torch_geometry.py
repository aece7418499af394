"""SE(3) and camera ops of the port against the JAX package (float32 on
the CPU on both sides; tolerances are a few float32 ulps of the values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.geometry import align as ref_align
from pf_monocular_pose_estimator_tpu.geometry import camera as ref_cam
from pf_monocular_pose_estimator_tpu.geometry import se3 as ref_se3
from pf_monocular_pose_estimator_tpu_torch.geometry import align, camera, se3

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def twists():
    rng = np.random.default_rng(1)
    tw = rng.normal(0, 0.4, (64, 6)).astype(np.float32)
    tw[:4, 3:] = 0.0  # the small-angle branch
    tw[4:8, 3:] *= 1e-5
    return tw


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_exp_log_inverse(twists):
    want = np.asarray(ref_se3.exp_se3(jnp.asarray(twists)))
    got = se3.exp_se3(_t(twists)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(se3.log_se3(_t(want)).numpy(),
                               np.asarray(ref_se3.log_se3(jnp.asarray(want))), rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(se3.inverse(_t(want)).numpy(),
                               np.asarray(ref_se3.inverse(jnp.asarray(want))), rtol=1e-6, atol=1e-6)


def test_predict_constant_velocity(twists):
    poses = np.asarray(ref_se3.exp_se3(jnp.asarray(twists)))
    for dt_past, dt_future in ((0.05, 0.05), (0.1, 0.033), (0.0, 0.05)):
        want = ref_se3.predict_constant_velocity(
            jnp.asarray(poses[:-1]), jnp.asarray(poses[1:]), jnp.float32(dt_past),
            jnp.float32(dt_future))
        got = se3.predict_constant_velocity(_t(poses[:-1]), _t(poses[1:]),
                                            torch.tensor(dt_past), torch.tensor(dt_future))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_camera_project_distort_undistort_bearings(twists):
    dist = [-0.3, 0.12, 1e-3, -5e-4, -0.02]
    rc = ref_cam.Camera.create(420.0, 418.0, 376.0, 240.0, dist)
    pc = camera.Camera.create(420.0, 418.0, 376.0, 240.0, dist)
    pose = np.array(ref_se3.exp_se3(jnp.asarray(twists[:8] * 0.2)))
    pose[:, 2, 3] += 1.5
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.normal(0, 0.1, (6, 3)), np.ones((6, 1))], 1).astype(np.float32)
    want = np.asarray(ref_cam.project(rc, jnp.asarray(pose)[:, None], jnp.asarray(pts)))
    got = camera.project(pc, _t(pose)[:, None], _t(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)  # pixels

    pix = rng.uniform([0, 0], [752, 480], (200, 2)).astype(np.float32)
    for fn_ref, fn in ((ref_cam.distort_pixels, camera.distort_pixels),
                       (ref_cam.undistort_pixels, camera.undistort_pixels)):
        np.testing.assert_allclose(fn(pc, _t(pix)).numpy(), np.asarray(fn_ref(rc, jnp.asarray(pix))),
                                   rtol=0, atol=2e-3)
    np.testing.assert_allclose(camera.bearing_vectors(pc, _t(pix)).numpy(),
                               np.asarray(ref_cam.bearing_vectors(rc, jnp.asarray(pix))),
                               rtol=0, atol=1e-6)


def test_umeyama(twists):
    rng = np.random.default_rng(3)
    src = rng.normal(0, 0.1, (4, 5, 3)).astype(np.float32)
    pose = np.asarray(ref_se3.exp_se3(jnp.asarray(twists[8:12])))
    dst = src @ pose[:, :3, :3].transpose(0, 2, 1) + pose[:, None, :3, 3]
    w = np.ones((4, 5), np.float32)
    w[1, 2] = 0.0
    want = np.asarray(ref_align.umeyama_rigid(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    got = align.umeyama_rigid(_t(src), _t(dst), _t(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, pose, rtol=0, atol=1e-5)
