"""Online exposure control and observer ego-motion against the JAX package:
`ops/exposure.py::exposure_control` step for step, `_ego_motion` on stale,
fresh and singular observer poses, and the tracker with `use_cam_pos`
over 20 golden frames whose observer pose arrives one frame late."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera
from pf_monocular_pose_estimator_tpu.geometry.se3 import exp_se3 as ref_exp_se3
from pf_monocular_pose_estimator_tpu.ops.exposure import ExposureState as RefExposureState
from pf_monocular_pose_estimator_tpu.ops.exposure import exposure_control as ref_exposure_control
from pf_monocular_pose_estimator_tpu.tracker import TargetState as RefState
from pf_monocular_pose_estimator_tpu.tracker import make_tracker as ref_make_tracker
from pf_monocular_pose_estimator_tpu.tracker.step import _ROT_CAM as REF_ROT_CAM
from pf_monocular_pose_estimator_tpu.tracker.step import _ego_motion as ref_ego_motion
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as RefConfig
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.ops.exposure import ExposureState, exposure_control
from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
from pf_monocular_pose_estimator_tpu_torch.tracker.step import _ROT_CAM, _ego_motion
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_sequence.npz")


def test_exposure_control_equal_over_many_steps():
    """2,400 steps of random blob-area fractions (a dim stretch, then a
    bright one, some frames without detections, the two thresholds hit
    exactly): both counters and the exposure equal the reference's after
    every step, and both the increase and the decrease fire."""
    rng = np.random.default_rng(0)
    steps = 2400
    roi_area = rng.uniform(2000.0, 60000.0, steps).astype(np.float32)
    frac = np.where(np.arange(steps) < 1200, rng.uniform(0.0, 0.02, steps),
                    rng.uniform(0.03, 0.06, steps)).astype(np.float32)
    frac[::97] = np.float32(0.013)
    frac[::89] = np.float32(0.037)
    area_sum = (frac * roi_area).astype(np.float32)
    any_det = rng.random(steps) < 0.9
    ref_step = jax.jit(lambda s, a, r, d: ref_exposure_control(s, a, r, 2000.0, d))
    ref = RefExposureState.create(2000.0)
    got = ExposureState(torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int32),
                        torch.tensor(2000.0))
    seen = set()
    for i in range(steps):
        ref = ref_step(ref, jnp.asarray(area_sum[i]), jnp.asarray(roi_area[i]),
                       jnp.asarray(any_det[i]))
        got = exposure_control(got, torch.tensor(area_sum[i]), torch.tensor(roi_area[i]), 2000.0,
                               torch.tensor(bool(any_det[i])))
        want = (int(ref.counter_increase), int(ref.counter_decrease), float(ref.exposure_us))
        assert (int(got.counter_increase), int(got.counter_decrease),
                float(got.exposure_us)) == want, f"step {i}"
        assert got.counter_increase.dtype == torch.int32 and got.exposure_us.dtype == torch.float32
        seen.add(want[2])
    assert {2400.0, 2000.0} <= seen, f"exposures seen: {sorted(seen)}"


def _pose(rng, scale=0.2):
    twist = rng.normal(0.0, scale, 6).astype(np.float32)
    p = np.array(ref_exp_se3(jnp.asarray(twist)))
    p[2, 3] += 1.0
    return p


@pytest.mark.parametrize("case", ["fresh", "stale_new", "stale_old", "singular", "first"])
def test_ego_motion_matches_reference(case):
    """cam_move_inv and the four observer fields of the state within 1e-5
    of the reference's `_ego_motion`: an observer pose newer than the last
    (stale: older than the frame, so the motion is extrapolated; fresh: as
    new as the frame, so it is not), one no newer than the last, a singular
    one (taken as the identity), and the first one a track sees.  Only the
    fresh pose leaves the camera unmoved."""
    assert np.array_equal(np.asarray(_ROT_CAM), REF_ROT_CAM)
    rng = np.random.default_rng(["fresh", "stale_new", "stale_old", "singular",
                                 "first"].index(case))
    fields = dict(obs_cam_old=_pose(rng), change_cam_pose=_pose(rng, 0.01),
                  time_obs_act=np.float32(0.30), cam_time_shift=np.float32(0.02),
                  time_current=np.float32(0.32))
    t, obs_time, obs_pose = np.float32(0.34), np.float32(0.32), _pose(rng, 0.05)
    if case == "fresh":
        obs_time = t
    elif case == "stale_old":
        obs_time = np.float32(0.28)
    elif case == "singular":
        obs_pose = np.zeros((4, 4), np.float32)
    elif case == "first":
        fields.update(obs_cam_old=np.eye(4, dtype=np.float32),
                      change_cam_pose=np.eye(4, dtype=np.float32), time_obs_act=np.float32(0.0),
                      cam_time_shift=np.float32(1.0))
    ref_state = RefState.create(8)._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    want_inv, want = ref_ego_motion(ref_state, jnp.asarray(t), jnp.asarray(obs_pose),
                                    jnp.asarray(obs_time), RefConfig(use_cam_pos=True))
    state = TargetState.create(8, device="cpu").replace(
        **{k: torch.from_numpy(np.array(v)) for k, v in fields.items()})
    got_inv, got = _ego_motion(state, torch.tensor(t), torch.from_numpy(obs_pose),
                               torch.tensor(obs_time))
    np.testing.assert_allclose(got_inv.numpy(), np.asarray(want_inv), atol=1e-5)
    for name in ("obs_cam_old", "change_cam_pose", "time_obs_act", "cam_time_shift"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-5, err_msg=name)
    moved = np.abs(got_inv.numpy() - np.eye(4)).max()
    assert (moved > 1e-4) == (case != "fresh"), moved


N = 5_000
EGO = dict(n_particles=N, min_blob_area=8.0, pf_max_retries=8, use_cam_pos=True)


def observer(d, i):
    """The observer pose and time given with frame i: the pose of frame
    i - 1 (one frame late), built so that the object stands still in the
    world, cam_world = gt_0 @ inv(gt_{i-1}), through the mounting rotation."""
    j = max(i - 1, 0)
    gt = d["poses"].astype(np.float64)
    cam_world = gt[0] @ np.linalg.inv(gt[j])
    return (cam_world @ np.linalg.inv(REF_ROT_CAM)).astype(np.float32), np.float32(d["times"][j])


def test_ego_replay_against_jax():
    """20 golden frames with `use_cam_pos` and the late observer poses: the
    port's tracker against the JAX tracker at tests/test_torch_tracker.py's
    bars (frame 0: 0.1 mm; every frame: 0.05 mm and 0.1 deg, same flags),
    with the observer's motion non-trivial (change_cam_pose ~8e-3 from the
    identity) and the state's observer fields within 1e-5 of the
    reference's at the end."""
    d = dict(np.load(GOLDEN))
    args = (float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
            np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))
    markers = np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1)
    ref_step = ref_make_tracker(RefCamera.create(*args), jnp.asarray(markers), jnp.ones(5, bool),
                                RefConfig(**EGO))
    step = make_tracker(Camera.create(*args), torch.from_numpy(markers),
                        torch.ones(5, dtype=torch.bool), TrackerConfig(**EGO), device="cpu")
    ref_state = RefState.create(N, jax.random.PRNGKey(0))
    state = TargetState.create(N, prng_key(0), device="cpu")
    for i in range(20):
        obs_pose, obs_time = observer(d, i)
        ref_state, want = ref_step(ref_state, jnp.asarray(d["frames"][i], jnp.float32),
                                   jnp.asarray(d["times"][i]), obs_pose=jnp.asarray(obs_pose),
                                   obs_time=jnp.asarray(obs_time))
        state, got = step(state, torch.from_numpy(d["frames"][i]), float(d["times"][i]),
                          torch.from_numpy(obs_pose), float(obs_time))
        assert bool(got.pose_updated) and int(got.fail_flag) == int(want.fail_flag), f"frame {i}"
        p, q = got.pose.numpy(), np.asarray(want.pose)
        d_t = np.linalg.norm(p[:3, 3] - q[:3, 3])
        assert d_t < (1e-4 if i == 0 else 5e-5), f"frame {i}: {d_t * 1e3:.4f} mm"
        cos = np.clip((np.trace(p[:3, :3] @ q[:3, :3].T) - 1) / 2, -1, 1)
        assert np.degrees(np.arccos(cos)) < 0.1, f"frame {i}"
    for name in ("obs_cam_old", "change_cam_pose", "time_obs_act", "cam_time_shift"):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(ref_state, name)), atol=1e-5, err_msg=name)
    assert np.abs(state.change_cam_pose.numpy() - np.eye(4)).max() > 1e-3
