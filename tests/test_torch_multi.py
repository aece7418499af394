"""Multi-target tracking: the port's `tracker/multi.py` against the JAX
package's, in both of the reference's forms (`lax.map` and `vmap`).

The scene: two targets on the 160x96 camera of tests/test_parallel.py, the
demo constellation and the first four markers of the second one, padded to
M = 5 so one mask has a False; 256 particles, 4 frames.  A back-projection
tolerance of 2 px keeps the four-marker target's brute-force init off the
other constellation's five LEDs (at 5 px it locks onto them, in the JAX
tracker as in the port).  Each port frame steps from the reference's
converted states, so the comparison is per frame: flags and detections
equal, poses within tests/test_torch_tracker.py's bars (0.1 mm on frame 0,
then 0.05 mm and 0.1 deg).  The JAX steps compile once each, side by
side, in a module fixture."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera
from pf_monocular_pose_estimator_tpu.io.markers import load_camera_calibration, load_marker_positions
from pf_monocular_pose_estimator_tpu.io.experiment import load_experiment
from pf_monocular_pose_estimator_tpu.io.synthetic import second_markers as ref_second_markers
from pf_monocular_pose_estimator_tpu.tracker.multi import create_states as ref_create_states
from pf_monocular_pose_estimator_tpu.tracker.multi import make_multi_tracker as ref_multi_tracker
from pf_monocular_pose_estimator_tpu.tracker.multi import pad_marker_sets as ref_pad
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as RefConfig
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera, exp_se3
from pf_monocular_pose_estimator_tpu_torch.io import demo_markers, render_frame, second_markers
from pf_monocular_pose_estimator_tpu_torch.tracker import (
    create_states,
    make_multi_tracker,
    pad_marker_sets,
    target_state,
)
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig, convert

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERA = dict(fx=150.0, fy=150.0, cx=80.0, cy=48.0, width=160, height=96)
N = 256
N_FRAMES = 4
CONFIG = dict(n_particles=N, threshold_value=150.0, min_blob_area=3.0, pf_max_retries=4,
              max_detections=12, max_correspondence_candidates=8, roi_particle_subsample=16,
              init_cluster_radius=25.0, init_cluster_min=4, back_projection_pixel_tolerance=2.0)
FORMS = {"sequential": True, "batched": False}


def _scene():
    """Marker sets, masks, frames (N_FRAMES, 96, 160) and ground truth
    (N_FRAMES, 2, 4, 4), rendered with the port on the CPU."""
    markers, masks = pad_marker_sets([demo_markers("cpu"), second_markers("cpu")[:4]])
    cam = Camera.create(**CAMERA)
    frames, poses = [], []
    for i in range(N_FRAMES):
        pa = exp_se3(torch.tensor([-0.25 + 0.004 * i, 0.0, 0.0, 0.1, -0.1, 0.05 + 0.01 * i]))
        pb = exp_se3(torch.tensor([0.25, 0.01 * i, 0.0, 0.2, -0.1, 0.1]))
        pa[2, 3] += 1.0
        pb[2, 3] += 1.1
        frame = sum(render_frame(cam, p, markers[k], 1.5, marker_mask=masks[k])
                    for k, p in enumerate((pa, pb)))
        frames.append(torch.clamp(frame, 0.0, 255.0).numpy())
        poses.append(torch.stack([pa, pb]).numpy())
    return markers, masks, np.stack(frames), np.stack(poses)


def _fields(state) -> dict:
    return {k: (np.asarray(v) if k != "exposure" else v) for k, v in state._asdict().items()}


@pytest.fixture(scope="module")
def scene():
    markers, masks, frames, poses = _scene()
    return dict(markers=markers, masks=masks, frames=frames, poses=poses)


@pytest.fixture(scope="module")
def reference(scene):
    """The JAX multi-tracker in both forms: per frame the states before it
    and the results.  Compiling the two forms is most of this file's time,
    so they compile side by side."""
    first = ref_create_states(2, N, 0, (CAMERA["width"], CAMERA["height"]))
    frames = [jnp.asarray(f) for f in scene["frames"]]
    times = [jnp.asarray(0.02 * (i + 1), jnp.float32) for i in range(N_FRAMES)]

    def compiled(sequential):
        step = ref_multi_tracker(RefCamera.create(**CAMERA), jnp.asarray(scene["markers"].numpy()),
                                 jnp.asarray(scene["masks"].numpy()), RefConfig(**CONFIG),
                                 sequential=sequential)
        return step.lower(first, frames[0], times[0]).compile()

    with ThreadPoolExecutor(len(FORMS)) as pool:
        steps = dict(zip(FORMS, pool.map(compiled, FORMS.values())))
    out = {}
    for name, step in steps.items():
        states, before, results = first, [], []
        for i in range(N_FRAMES):
            before.append(states)
            states, res = step(states, frames[i], times[i])
            results.append(jax.tree_util.tree_map(np.asarray, res))
        out[name] = dict(before=before + [states], results=results)
    return out


def test_pad_marker_sets_equal_the_reference():
    sets = [np.asarray(demo_markers("cpu")), np.asarray(second_markers("cpu"))[:4],
            np.asarray(second_markers("cpu"))[:3]]
    want_m, want_k = ref_pad(sets)
    got_m, got_k = pad_marker_sets(sets)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    assert got_m.dtype == torch.float32 and got_k.dtype == torch.bool
    assert (got_m[1, 4:, 3] == 1.0).all() and (got_m[2, 3:, 3] == 1.0).all()
    np.testing.assert_array_equal(np.asarray(ref_second_markers()), second_markers("cpu").numpy())


def test_create_states_equal_the_reference():
    """Keys are `split(prng_key(seed), T)` as `jax.random.split`; every leaf
    carries the target axis and equals the reference's."""
    ref = ref_create_states(3, 64, 7, (160, 96))
    got = create_states(3, 64, 7, (160, 96), device="cpu")
    assert got.key.shape == (3, 2) and got.bank.shape == (3, 16, 64)
    back = convert.state_to_reference(got)
    for name, value in _fields(ref).items():
        if name == "exposure":
            for g, w in zip(back[name], value):
                np.testing.assert_array_equal(g, np.asarray(w))
            continue
        np.testing.assert_array_equal(back[name], value, err_msg=name)
        assert back[name].dtype == value.dtype, name
    for t in range(3):
        assert torch.equal(target_state(got, t).key, got.key[t])


@pytest.mark.parametrize("form", list(FORMS))
def test_multi_tracker_against_the_reference(scene, reference, form):
    """Each frame from the reference's converted states: fail flags, updates,
    detection counts and masks equal; poses within 0.1 mm on frame 0, then
    0.05 mm and 0.1 deg; the states' keys and counters equal.  Both targets
    initialise on frame 0 and track after it."""
    ref = reference[form]
    step = make_multi_tracker(Camera.create(**CAMERA), scene["markers"], scene["masks"],
                              TrackerConfig(**CONFIG), sequential=FORMS[form], device="cpu")
    for i in range(N_FRAMES):
        states = convert.state_from_reference(_fields(ref["before"][i]))
        got, res = step(states, torch.from_numpy(scene["frames"][i]), 0.02 * (i + 1))
        want = ref["results"][i]
        np.testing.assert_array_equal(res.fail_flag.numpy(), want.fail_flag, err_msg=f"frame {i}")
        np.testing.assert_array_equal(res.pose_updated.numpy(), want.pose_updated)
        np.testing.assert_array_equal(res.num_detections.numpy(), want.num_detections)
        np.testing.assert_array_equal(res.detections_mask.numpy(), want.detections_mask)
        pose = res.pose.numpy()
        d_t = np.linalg.norm(pose[:, :3, 3] - want.pose[:, :3, 3], axis=-1)
        rel = np.einsum("tij,tkj->tik", pose[:, :3, :3], want.pose[:, :3, :3])
        ang = np.degrees(np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)))
        assert d_t.max() < (1e-4 if i == 0 else 5e-5), f"frame {i}: {d_t * 1e3} mm"
        assert ang.max() < 0.1, f"frame {i}: {ang} deg"
        back, after = convert.state_to_reference(got), _fields(ref["before"][i + 1])
        for name in ("key", "it_since_initialized", "uncertainty", "fail_flag"):
            np.testing.assert_array_equal(back[name], after[name], err_msg=f"frame {i} {name}")
        err = np.linalg.norm(pose[:, :3, 3] - scene["poses"][i][:, :3, 3], axis=-1)
        assert err.max() < 0.02, f"frame {i}: {err} m from the ground truth"
    assert [int(f) for f in ref["results"][0].fail_flag] == [0, 0]
    assert (ref["results"][-1].fail_flag == 10).all()
    assert step.host.count / step.frames > 0


def test_chip_smoke_two_uav_settings_equal_the_yaml():
    """chip_smoke.py's two-target replays run configs/experiments/
    two_uav_bag.yaml's `tracker:` block, its camera, its markers (split
    5 + 5: the port's demo and second constellations) and its sequence."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    exp = load_experiment(os.path.join(ROOT, "configs", "experiments", "two_uav_bag.yaml"))
    assert smoke.TWO_UAV == exp["tracker"]
    ref_cam = load_camera_calibration(exp["camera"])
    cam = smoke.TWO_UAV_CAMERA
    for name in ("fx", "fy", "cx", "cy"):
        assert np.float32(cam[name]) == np.asarray(getattr(ref_cam, name)), name
    np.testing.assert_array_equal(np.asarray(cam["dist"], np.float32), np.asarray(ref_cam.dist))
    assert (cam["width"], cam["height"]) == (ref_cam.width, ref_cam.height)
    markers = load_marker_positions(exp["markers"], exp["markers_per_object"])
    for got, want in zip(markers, (demo_markers("cpu"), second_markers("cpu"))):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
    assert os.path.samefile(exp["run"]["sequence"], smoke.TWO_UAV_GOLDEN)
