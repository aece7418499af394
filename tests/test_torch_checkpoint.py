"""Checkpoint and resume of the port's tracker state (`utils/checkpoint.py`):
a resumed run is bit for bit the uninterrupted one, as
tests/test_state_and_ego.py:33 holds the JAX package's, for a single and a
two-target state and for a sharded state saved whole; a checkpoint of
another structure raises."""

import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu_torch.geometry import exp_se3
from pf_monocular_pose_estimator_tpu_torch.io import default_camera, demo_markers, render_frame
from pf_monocular_pose_estimator_tpu_torch.parallel import (
    make_mesh,
    make_sharded_tracker,
    shard_target_state,
    unshard_target_state,
)
from pf_monocular_pose_estimator_tpu_torch.tracker import (
    TargetState,
    create_states,
    make_multi_tracker,
    make_tracker,
)
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig, load_state, save_state
from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key
from test_torch_parallel_multi import CONFIG as MULTI
from test_torch_parallel_multi import _scene

torch.set_num_threads(2)

ONES5 = torch.ones(5, dtype=torch.bool)


def _assert_states_equal(a: TargetState, b: TargetState):
    for name, value in vars(a).items():
        other = getattr(b, name)
        assert value.dtype == other.dtype and value.device == other.device, name
        assert torch.equal(value, other), name


@pytest.fixture(scope="module")
def frames():
    """tests/test_state_and_ego.py's frames: one pose rendered four times."""
    pose = exp_se3(torch.tensor([0.02, 0.0, 0.0, 0.1, -0.1, 0.2]))
    pose[2, 3] += 1.4
    frame = render_frame(default_camera("cpu"), pose, demo_markers("cpu"))
    return [frame] * 4


def test_checkpoint_roundtrip_resumes_identically(tmp_path, frames):
    config = TrackerConfig(n_particles=300, min_blob_area=8.0, pf_max_retries=4)
    step = make_tracker(default_camera("cpu"), demo_markers("cpu"), ONES5, config, device="cpu")
    state = TargetState.create(config.n_particles, prng_key(5), device="cpu")
    for i in range(2):
        state, _ = step(state, frames[i], 0.02 * (i + 1))
    path = str(tmp_path / "ckpt.npz")
    save_state(path, state)
    restored = load_state(path, TargetState.create(config.n_particles, device="cpu"))
    _assert_states_equal(restored, state)

    s1, r1 = step(state, frames[2], 0.06)
    s2, r2 = step(restored, frames[2], 0.06)
    assert bool(r1.pose_updated)
    assert torch.equal(r1.pose, r2.pose)
    _assert_states_equal(s1, s2)


def test_two_target_checkpoint_resumes_identically(tmp_path):
    """tests/test_torch_parallel_multi.py's two-target scene (one marker set
    padded): saved after frame 1, resumed over frames 2-3."""
    cam, markers, masks, scene = _scene(4)
    step = make_multi_tracker(cam, markers, masks, TrackerConfig(**MULTI), device="cpu")
    state = create_states(2, MULTI["n_particles"], 0, (160, 96), device="cpu")
    for i in range(2):
        state, _ = step(state, scene[i], 0.02 * (i + 1))
    path = str(tmp_path / "multi.npz")
    save_state(path, state)
    restored = load_state(path, create_states(2, MULTI["n_particles"], 9, (160, 96),
                                              device="cpu"))
    _assert_states_equal(restored, state)
    for i in (2, 3):
        state, r1 = step(state, scene[i], 0.02 * (i + 1))
        restored, r2 = step(restored, scene[i], 0.02 * (i + 1))
        assert r1.pose_updated.all(), f"frame {i}: {r1.fail_flag}"
        assert torch.equal(r1.pose, r2.pose)
    _assert_states_equal(restored, state)


def test_sharded_state_saved_whole_resumes_identically(tmp_path, frames):
    """A state sharded over a local mesh of 2 is saved after
    `unshard_target_state` and cut again after loading."""
    config = TrackerConfig(n_particles=256, min_blob_area=8.0, pf_max_retries=4,
                           resample_min_ess=0.0)
    mesh = make_mesh(2)
    step = make_sharded_tracker(default_camera("cpu"), demo_markers("cpu"), ONES5, config, mesh,
                                device="cpu")
    state = shard_target_state(TargetState.create(256, prng_key(3), device="cpu"), mesh)
    for i in range(2):
        state, _ = step(state, frames[i], 0.02 * (i + 1))
    path = str(tmp_path / "sharded.npz")
    save_state(path, unshard_target_state(state, mesh))
    restored = shard_target_state(load_state(path, TargetState.create(256, device="cpu")), mesh)
    _assert_states_equal(restored, state)
    s1, r1 = step(state, frames[2], 0.06)
    s2, r2 = step(restored, frames[2], 0.06)
    assert torch.equal(r1.pose, r2.pose)
    _assert_states_equal(s1, s2)


def test_wrong_structure_raises(tmp_path):
    single = TargetState.create(64, device="cpu")
    path = str(tmp_path / "single.npz")
    save_state(path, single)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_state(path, create_states(2, 64, device="cpu"))  # single vs multi-target
    with pytest.raises(ValueError, match="structure mismatch"):
        load_state(path, TargetState.create(128, device="cpu"))  # another particle count
    other_dtype = single.replace(uncertainty=single.uncertainty.to(torch.int64))
    with pytest.raises(ValueError, match="structure mismatch"):
        load_state(path, other_dtype)
    plain = str(tmp_path / "plain.npz")
    np.savez(plain, leaf_0=np.zeros(3))
    with pytest.raises(ValueError, match="no structure record"):
        load_state(plain, single)
    # the right structure loads onto `like`'s device and dtypes
    back = load_state(path, single)
    _assert_states_equal(back, single)
