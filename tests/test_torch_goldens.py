"""The committed goldens other than golden_sequence.npz, through the port:
`realistic_sequence.npz` (120 uint8 frames with clutter) against the JAX
tracker with `configs/experiments/realistic_golden.yaml`'s settings, the
settings `chip_smoke.py` replays it with, and `opencv_camera_golden.npz`
against the port's camera model (tests/test_golden_opencv.py's bounds)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.io.experiment import load_experiment
from pf_monocular_pose_estimator_tpu.io.markers import (load_camera_calibration,
                                                        load_marker_positions)
from pf_monocular_pose_estimator_tpu.tracker import TargetState as RefState
from pf_monocular_pose_estimator_tpu.tracker import make_tracker as ref_make_tracker
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as RefConfig
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.geometry.camera import (distort_pixels, project,
                                                                   undistort_pixels)
from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)
ROOT = os.path.dirname(HERE)
EXPERIMENT = os.path.join(ROOT, "configs", "experiments", "realistic_golden.yaml")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_realistic_settings_equal_the_yaml():
    """chip_smoke.py's realistic replay runs the yaml's `tracker:` block, its
    camera and its markers (the npz's markers are the yaml's)."""
    smoke = _chip_smoke()
    exp = load_experiment(EXPERIMENT)
    assert smoke.REALISTIC == exp["tracker"]
    ref_cam = load_camera_calibration(exp["camera"])
    cam = smoke.REALISTIC_CAMERA
    for name in ("fx", "fy", "cx", "cy"):
        assert np.float32(cam[name]) == np.asarray(getattr(ref_cam, name)), name
    np.testing.assert_array_equal(np.asarray(cam["dist"], np.float32), np.asarray(ref_cam.dist))
    assert (cam["width"], cam["height"]) == (ref_cam.width, ref_cam.height)
    markers = load_marker_positions(exp["markers"], exp["markers_per_object"])[0]
    d = np.load(smoke.REALISTIC_GOLDEN)
    np.testing.assert_array_equal(markers[:, :3], d["markers"])
    assert os.path.samefile(exp["run"]["sequence"], smoke.REALISTIC_GOLDEN)


def test_realistic_first_frames_against_jax():
    """The first 10 frames of the realistic golden with the yaml's settings:
    flags and `pose_updated` equal, poses within tests/test_torch_tracker.py's
    bars (frame 0: 0.1 mm; every frame: 0.05 mm and 0.1 deg)."""
    smoke = _chip_smoke()
    d = dict(np.load(smoke.REALISTIC_GOLDEN))
    c = smoke.REALISTIC_CAMERA
    args = (c["fx"], c["fy"], c["cx"], c["cy"], np.asarray(c["dist"], np.float32), c["width"],
            c["height"])
    markers = np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1)
    ref_cam = load_camera_calibration(load_experiment(EXPERIMENT)["camera"])
    ref_step = ref_make_tracker(ref_cam, jnp.asarray(markers), jnp.ones(5, bool),
                                RefConfig(**smoke.REALISTIC))
    step = make_tracker(Camera.create(*args), torch.from_numpy(markers),
                        torch.ones(5, dtype=torch.bool), TrackerConfig(**smoke.REALISTIC),
                        device="cpu")
    n = smoke.REALISTIC["n_particles"]
    ref_state = RefState.create(n, jax.random.PRNGKey(0))
    state = TargetState.create(n, prng_key(0), device="cpu")
    for i in range(10):
        ref_state, want = ref_step(ref_state, jnp.asarray(d["frames"][i], jnp.float32),
                                   jnp.asarray(d["times"][i]))
        state, got = step(state, torch.from_numpy(d["frames"][i]), float(d["times"][i]))
        assert int(got.fail_flag) == int(want.fail_flag), f"frame {i}"
        assert bool(got.pose_updated) == bool(want.pose_updated), f"frame {i}"
        p, q = got.pose.numpy(), np.asarray(want.pose)
        d_t = np.linalg.norm(p[:3, 3] - q[:3, 3])
        assert d_t < (1e-4 if i == 0 else 5e-5), f"frame {i}: {d_t * 1e3:.4f} mm"
        cos = np.clip((np.trace(p[:3, :3] @ q[:3, :3].T) - 1) / 2, -1, 1)
        assert np.degrees(np.arccos(cos)) < 0.1, f"frame {i}"


@pytest.fixture(scope="module")
def opencv():
    d = np.load(os.path.join(HERE, "golden", "opencv_camera_golden.npz"))
    cam = Camera.create(float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
                        np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))
    return d, cam


def _f32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_opencv_forward_distortion(opencv):
    d, cam = opencv
    err = np.abs(distort_pixels(cam, _f32(d["undistorted_pixels"])).numpy()
                 - d["distorted_pixels"]).max()
    assert err < 0.01, f"distort_pixels is {err} px from OpenCV"


def test_opencv_undistortion(opencv):
    """0.15 px to OpenCV's truncated iteration; the round trip is the
    exactness check (5e-3 px)."""
    d, cam = opencv
    out = undistort_pixels(cam, _f32(d["distorted_pixels"]))
    err = np.abs(out.numpy() - d["undistorted_back"]).max()
    assert err < 0.15, f"undistort_pixels is {err} px from OpenCV"
    rt = np.abs(distort_pixels(cam, out).numpy() - d["distorted_pixels"]).max()
    assert rt < 5e-3, f"undistort is not the inverse of distort: {rt} px"


def test_opencv_projection(opencv):
    d, cam = opencv
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = d["rotation"]
    pose[:3, 3] = d["translation"]
    markers = np.concatenate([d["markers"], np.ones((len(d["markers"]), 1))], 1)
    uv = project(cam, _f32(pose), _f32(markers))
    err_u = np.abs(uv.numpy() - d["projected_undistorted"]).max()
    assert err_u < 0.01, f"undistorted projection is {err_u} px from OpenCV"
    err_d = np.abs(distort_pixels(cam, uv).numpy() - d["projected_distorted"]).max()
    assert err_d < 0.01, f"distorted projection is {err_d} px from OpenCV"
