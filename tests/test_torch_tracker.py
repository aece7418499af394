"""The slice end to end: the port's tracker against the golden sequence
and against the JAX tracker.

The JAX tracker runs on the CPU, where it takes its XLA paths (reflect
blur borders, detection-major greedy ties, box-count ranking, pre-drawn
noise whose affine XLA contracts into an FMA); the port follows the
Pallas semantics (zero borders, marker-major ties, exact counts, the
counter-stream draws with every product rounded).  On these clean frames
the detections agree, so frame 0 (the init branch) agrees to 0.1 mm; the
PF frames then differ only by float32 rounding of the draws, which moves
particles by ~1e-9 and can reorder near-tied weights (bounds below)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu.geometry.camera import Camera as RefCamera
from pf_monocular_pose_estimator_tpu.io.metrics import absolute_trajectory_error, orientation_error_deg
from pf_monocular_pose_estimator_tpu.tracker import TargetState as RefState
from pf_monocular_pose_estimator_tpu.tracker import make_tracker as ref_make_tracker
from pf_monocular_pose_estimator_tpu.utils import TrackerConfig as RefConfig
from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig, convert
from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

torch.set_num_threads(2)

N = 5_000  # tests/test_golden_sequence.py's replay config
CONFIG = dict(n_particles=N, min_blob_area=8.0, pf_max_retries=8)


@pytest.fixture(scope="module")
def golden():
    d = dict(np.load(os.path.join(os.path.dirname(__file__), "golden", "golden_sequence.npz")))
    args = (float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
            np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]))
    markers = np.concatenate([d["markers"], np.ones((5, 1), np.float32)], 1)
    return dict(d=d, ref_cam=RefCamera.create(*args), cam=Camera.create(*args), markers=markers)


@pytest.fixture(scope="module")
def jax_run(golden):
    """The reference tracker over the sequence: poses and every state."""
    d = golden["d"]
    step = ref_make_tracker(golden["ref_cam"], jnp.asarray(golden["markers"]), jnp.ones(5, bool),
                            RefConfig(**CONFIG))
    state = RefState.create(N, jax.random.PRNGKey(0))
    poses, states = [], [state]
    for i in range(len(d["frames"])):
        state, res = step(state, jnp.asarray(d["frames"][i], jnp.float32), jnp.asarray(d["times"][i]))
        poses.append(np.asarray(res.pose))
        states.append(state)
    return dict(step=step, poses=np.stack(poses), states=states)


@pytest.fixture(scope="module")
def port_run(golden):
    d = golden["d"]
    step = make_tracker(golden["cam"], torch.from_numpy(golden["markers"]),
                        torch.ones(5, dtype=torch.bool), TrackerConfig(**CONFIG), device="cpu")
    state = TargetState.create(N, prng_key(0), device="cpu")
    poses, updated = [], []
    for i in range(len(d["frames"])):
        state, res = step(state, torch.from_numpy(d["frames"][i]), float(d["times"][i]))
        poses.append(res.pose.numpy())
        updated.append(bool(res.pose_updated))
    return dict(step=step, poses=np.stack(poses), updated=np.asarray(updated))


def test_port_replays_golden_sequence(golden, port_run):
    """tests/test_golden_sequence.py's bars, through the port."""
    upd = port_run["updated"]
    assert upd.all(), f"untracked frames: {np.flatnonzero(~upd)}"
    ate = absolute_trajectory_error(port_run["poses"], golden["d"]["poses"], upd)
    ori = orientation_error_deg(port_run["poses"], golden["d"]["poses"], upd)
    assert ate < 0.01, f"ATE {ate * 1e3:.2f} mm"
    assert ori < 1.5, f"orientation error {ori:.2f} deg"
    step = port_run["step"]
    # syncs: counters, ROI, count, gates + one per PF pass (<= 8), never more
    assert step.host.count / step.frames <= 4 + 8 + 2


def test_trajectory_against_jax(jax_run, port_run):
    """Frame 0 (init): 0.1 mm.  Later frames: 0.05 mm and 0.1 deg.  Every
    frame ends in GN from the same bound pairs, which lands on the same
    optimum whichever near-tied particle seeded it; measured on this CPU:
    0.0006 mm at frame 0, at most 0.0022 mm and 0.028 deg over the 60
    frames (the filter's own error to ground truth is ~1.7 mm ATE)."""
    ref, got = jax_run["poses"], port_run["poses"]
    d_t = np.linalg.norm(ref[:, :3, 3] - got[:, :3, 3], axis=-1)
    assert d_t[0] < 1e-4, f"frame 0 differs by {d_t[0] * 1e3:.4f} mm"
    rel = np.einsum("tij,tkj->tik", ref[:, :3, :3], got[:, :3, :3])
    ang = np.degrees(np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert d_t.max() < 5e-5, f"max {d_t.max() * 1e3:.4f} mm at frame {d_t.argmax()}"
    assert ang.max() < 0.1, f"max {ang.max():.3f} deg at frame {ang.argmax()}"


# name -> (overrides, frames replayed).  The ESS gate first fires on frame
# 12 at 5k particles and the decode first falls back on frame 16, so the
# resampling switches replay 17 frames; the others 6 (init + 5 PF frames).
SWITCHES = {
    # the slice configuration: XLA propagation + kernel E, sort-free resampling (kernel F)
    "slice": (dict(use_fused_pf_kernel=False, use_pallas_resample=True), 17),
    "straight_pf_kernel": (dict(use_folded_pf_kernel=False), 6),
    "closed_form_resample": (dict(use_closed_form_resample=True), 17),
    "vmapped_gn": (dict(use_pallas_gn=False), 6),
    "xla_weight": (dict(use_fused_pf_kernel=False, use_pallas_weight=False), 6),
}


@pytest.mark.parametrize("name", list(SWITCHES))
def test_switch_replay_against_jax(golden, jax_run, name):
    """Each single-device switch over the first frames against the JAX
    tracker.  On the CPU the JAX tracker ignores the Pallas-only switches
    (`tracker/step.py:191,309,720,770` gate on the backend), so its default
    run is the reference for them; `use_closed_form_resample` changes the
    assignment only in CDF ulp pockets (pinned exactly in
    test_torch_resample.py).  Bars: every frame updated, poses within 1e-4
    (tests/test_pallas_resample.py's bar between resampler switches) on
    the translation, 0.1 deg on the rotation (this file's bar)."""
    d = golden["d"]
    overrides, n_frames = SWITCHES[name]
    step = make_tracker(golden["cam"], torch.from_numpy(golden["markers"]),
                        torch.ones(5, dtype=torch.bool), TrackerConfig(**CONFIG, **overrides),
                        device="cpu")
    state = TargetState.create(N, prng_key(0), device="cpu")
    poses = []
    for i in range(n_frames):
        state, res = step(state, torch.from_numpy(d["frames"][i]), float(d["times"][i]))
        assert bool(res.pose_updated), f"frame {i} not updated"
        poses.append(res.pose.numpy())
    got, ref = np.stack(poses), jax_run["poses"][:n_frames]
    d_t = np.linalg.norm(ref[:, :3, 3] - got[:, :3, 3], axis=-1)
    rel = np.einsum("tij,tkj->tik", ref[:, :3, :3], got[:, :3, :3])
    ang = np.degrees(np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert d_t.max() < 1e-4, f"max {d_t.max() * 1e3:.4f} mm at frame {d_t.argmax()}"
    assert ang.max() < 0.1, f"max {ang.max():.3f} deg at frame {ang.argmax()}"
    if name == "slice":
        assert step.decoded_frames and step.fallback_frames, "the decode and its fallback both run"


def _resampled_frame(states):
    """First mature tracked frame on which the reference resampled."""
    for k in range(3, len(states) - 1):
        after = states[k + 1]
        if int(after.it_since_initialized) == 2 and not np.array_equal(
                np.asarray(after.resampled), np.asarray(after.bank)):
            return k
    raise AssertionError("the reference never resampled")


def test_one_frame_from_converted_state(golden, jax_run):
    """One tracked frame from the reference's state, converted: the same
    key gives the same draws, so pose, weights and ancestors agree."""
    d = golden["d"]
    k = _resampled_frame(jax_run["states"])
    ref_state = jax_run["states"][k]
    fields = {n: (np.asarray(v) if n != "exposure" else v) for n, v in ref_state._asdict().items()}
    state = convert.state_from_reference(fields)
    step = make_tracker(golden["cam"], torch.from_numpy(golden["markers"]),
                        torch.ones(5, dtype=torch.bool), TrackerConfig(**CONFIG), device="cpu")
    got, res = step(state, torch.from_numpy(d["frames"][k]), float(d["times"][k]))
    want = jax_run["states"][k + 1]

    assert bool(res.pose_updated)
    back = convert.state_to_reference(got)
    np.testing.assert_array_equal(back["key"], np.asarray(want.key))
    for name in ("it_since_initialized", "uncertainty", "fail_flag", "degraded_frames"):
        assert int(back[name]) == int(np.asarray(getattr(want, name))), name
    # pose: GN converges to the same optimum from the same bound pairs
    np.testing.assert_allclose(back["current_pose"], np.asarray(want.current_pose), atol=2e-4)
    # weights: the same particles scored with ulp-different draws
    np.testing.assert_allclose(back["weights"], np.asarray(want.weights), rtol=0, atol=2e-6)
    # ancestors: the resampled bank picks the same parents slot for slot
    # except where ulp-different weights move a CDF entry across a draw
    same = np.abs(back["resampled"] - np.asarray(want.resampled)).max(axis=0) < 1e-4
    assert same.mean() > 0.99, same.mean()


def test_state_round_trip_after_tracking(jax_run):
    ref_state = jax_run["states"][10]
    fields = {n: (np.asarray(v) if n != "exposure" else v) for n, v in ref_state._asdict().items()}
    back = convert.state_to_reference(convert.state_from_reference(fields))
    for name, value in ref_state._asdict().items():
        if name == "exposure":
            for got, want in zip(back[name], value):
                np.testing.assert_array_equal(got, np.asarray(want))
            continue
        np.testing.assert_array_equal(back[name], np.asarray(value), err_msg=name)
