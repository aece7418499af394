"""Init branch pieces against the JAX package: quartic and P3P on random
triples, `initialise` on the detections of golden frame 0, and the
short-P3P recovery.  Both sides get the same detections (taken from the
reference's detector), so the comparison isolates the init search."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera
from pf_monocular_pose_estimator_tpu.ops.blob import BlobParams as RefBlobParams
from pf_monocular_pose_estimator_tpu.ops.blob import find_leds as ref_find_leds
from pf_monocular_pose_estimator_tpu.solvers import p3p_kneip as ref_p3p
from pf_monocular_pose_estimator_tpu.solvers import p3p_object_to_camera as ref_p3p_inv
from pf_monocular_pose_estimator_tpu.solvers import solve_quartic as ref_quartic
from pf_monocular_pose_estimator_tpu.tracker.initialise import initialise as ref_initialise
from pf_monocular_pose_estimator_tpu.tracker.short_p3p import short_p3p as ref_short_p3p
from pf_monocular_pose_estimator_tpu.utils.config import TrackerConfig as RefConfig
from pf_monocular_pose_estimator_tpu.utils.dynamic import DynamicParams as RefDynamic
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.ops.blob import Detections
from pf_monocular_pose_estimator_tpu_torch.solvers import p3p_kneip, p3p_object_to_camera, solve_quartic
from pf_monocular_pose_estimator_tpu_torch.tracker.initialise import initialise
from pf_monocular_pose_estimator_tpu_torch.tracker.short_p3p import short_p3p
from pf_monocular_pose_estimator_tpu_torch.utils import DynamicParams, TrackerConfig

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frame0():
    d = np.load(os.path.join(os.path.dirname(__file__), "golden", "golden_sequence.npz"))
    args = (float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
            np.asarray(d["dist"], np.float32))
    ref_cam, cam = RefCamera.create(*args), Camera.create(*args)
    markers = np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1)
    roi = jnp.asarray([0.0, 0.0, 752.0, 480.0])
    ref_det = ref_find_leds(jnp.asarray(d["frames"][0], jnp.float32), roi,
                            RefBlobParams(min_blob_area=8.0), ref_cam)
    det = Detections(*(torch.from_numpy(np.array(x)) for x in ref_det))
    return dict(d=d, ref_cam=ref_cam, cam=cam, markers=markers, ref_det=ref_det, det=det)


def test_quartic_and_p3p_match_reference():
    rng = np.random.default_rng(0)
    coeffs = rng.normal(size=(64, 5)).astype(np.float32)
    np.testing.assert_allclose(solve_quartic(torch.from_numpy(coeffs)).numpy(),
                               np.asarray(ref_quartic(jnp.asarray(coeffs))), rtol=1e-3, atol=1e-3)
    # triples seen from a camera in front of the points: every solution
    world = rng.normal(0, 0.1, (32, 3, 3)).astype(np.float32)
    cam_pts = world + np.float32([0.0, 0.0, 1.5])
    feats = (cam_pts / np.linalg.norm(cam_pts, axis=-1, keepdims=True)).astype(np.float32)
    sols, ok = p3p_kneip(torch.from_numpy(feats), torch.from_numpy(world))
    rsols, rok = ref_p3p(jnp.asarray(feats), jnp.asarray(world))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    got = p3p_object_to_camera(sols).numpy()
    want = np.asarray(ref_p3p_inv(rsols))
    finite = np.isfinite(want).all(axis=(-1, -2)) & np.isfinite(got).all(axis=(-1, -2))
    assert finite.mean() > 0.9
    # float32 Kneip P3P is ill-conditioned on some triples (near-double
    # quartic roots): two evaluation orders move a solution by up to ~1e-2,
    # so the sides agree loosely entry by entry, and both recover the truth
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=3e-2)
    truth = np.float32([0, 0, 1.5])
    for sol in (got, want):
        t_err = np.abs(np.nan_to_num(sol[..., :3, 3], nan=9.0) - truth).max(-1).min(-1)
        assert np.median(t_err) < 1e-3


def test_initialise_on_golden_frame0(frame0):
    """Same correspondences, flags and seeds; the pose to 0.1 mm."""
    config = TrackerConfig(n_particles=256, min_blob_area=8.0)
    ref_config = RefConfig(n_particles=256, min_blob_area=8.0)
    bank = np.tile(np.eye(4, dtype=np.float32).reshape(16, 1), (1, 256))
    prefer = np.zeros(13, np.float32)
    want = jax.jit(lambda det, b, p: ref_initialise(
        frame0["ref_cam"], det, jnp.asarray(frame0["markers"]), jnp.ones(5, bool), b, ref_config,
        RefDynamic.from_config(ref_config), prefer_near=p))(
            frame0["ref_det"], jnp.asarray(bank), jnp.asarray(prefer))
    got = initialise(frame0["cam"], frame0["det"], torch.from_numpy(frame0["markers"]),
                     torch.ones(5, dtype=torch.bool), torch.from_numpy(bank), config,
                     DynamicParams.from_config(config), prefer_near=torch.from_numpy(prefer))
    assert bool(got.success) and bool(want.success)
    assert int(got.flag) == int(want.flag)
    np.testing.assert_array_equal(got.det_for_marker.numpy(), np.asarray(want.det_for_marker))
    np.testing.assert_allclose(got.pose.numpy()[:3, 3], np.asarray(want.pose)[:3, 3], atol=1e-4)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-3)
    np.testing.assert_allclose(got.bank.numpy(), np.asarray(want.bank), atol=1e-3)
    gt = frame0["d"]["poses"][0]
    assert np.linalg.norm(got.pose.numpy()[:3, 3] - gt[:3, 3]) < 0.01


def test_short_p3p_matches_reference(frame0):
    det, ref_det = frame0["det"], frame0["ref_det"]
    markers = frame0["markers"]
    gt = frame0["d"]["poses"][0]
    pts = (gt @ markers.T)[:3]
    uv = np.stack([float(frame0["d"]["fx"]) * pts[0] / pts[2] + float(frame0["d"]["cx"]),
                   float(frame0["d"]["fy"]) * pts[1] / pts[2] + float(frame0["d"]["cy"])], 1)
    xy = np.asarray(ref_det.xy)
    det_of = np.argmin(np.linalg.norm(uv[:, None] - xy[None, :5], axis=-1), axis=1)
    pairs = np.stack([np.arange(3), det_of[:3]], 1).astype(np.int32)
    config = TrackerConfig(n_particles=64, min_blob_area=8.0)
    ref_config = RefConfig(n_particles=64, min_blob_area=8.0)
    bank = np.tile(np.eye(4, dtype=np.float32).reshape(16, 1), (1, 64))
    want = jax.jit(lambda det_, p, b: ref_short_p3p(
        frame0["ref_cam"], det_, jnp.asarray(markers), jnp.ones(5, bool), p, b, ref_config,
        RefDynamic.from_config(ref_config)))(ref_det, jnp.asarray(pairs), jnp.asarray(bank))
    got = short_p3p(frame0["cam"], det, torch.from_numpy(markers), torch.ones(5, dtype=torch.bool),
                    torch.from_numpy(pairs), torch.from_numpy(bank), config,
                    DynamicParams.from_config(config))
    assert bool(got.success) == bool(want.success)
    assert int(got.flag) == int(want.flag)
    np.testing.assert_array_equal(got.det_for_marker.numpy(), np.asarray(want.det_for_marker))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-3)
    np.testing.assert_allclose(got.bank.numpy(), np.asarray(want.bank), atol=1e-3)
