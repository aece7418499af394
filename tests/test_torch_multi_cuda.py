"""Multi-target tracking on the card: what only the card can show.

Marked `cuda`; each test skips when torch sees no GPU.  On the GPU machine:

    python -m pytest --noconftest tests/test_torch_multi_cuda.py -m cuda -q

The scene and configuration are tests/test_torch_parallel_multi.py's (two
targets on the 160x96 camera, one with a padded marker set, 12 detection
slots), here with the kernels instead of their plain twins."""

import dataclasses

import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu_torch.parallel import (
    make_mesh,
    make_sharded_multi_tracker,
    shard_target_state,
)
from pf_monocular_pose_estimator_tpu_torch.pf import step_kernel as sk
from pf_monocular_pose_estimator_tpu_torch.tracker import create_states, make_multi_tracker
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig, load_state, save_state
from test_torch_parallel_multi import CONFIG, N, RING, _scene

pytestmark = pytest.mark.cuda
N_FRAMES = 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _replay(step, state, frames, dev, first: int = 0):
    rows = []
    for i, frame in enumerate(frames):
        state, res = step(state, frame.to(dev), 0.02 * (first + i + 1))
        rows.append((res.fail_flag.cpu().numpy(), res.pose.cpu().numpy()))
    return rows, state


def test_multi_tracker_forms_equal_on_card(dev):
    """Both forms launch kernel B for every target and give the same poses
    bit for bit; both targets initialise, then track."""
    cam, markers, masks, frames = _scene(N_FRAMES)
    out = {}
    for sequential in (True, False):
        step = make_multi_tracker(cam, markers, masks, TrackerConfig(**CONFIG),
                                  sequential=sequential, device=dev)
        sk.pf_step.launches = 0
        out[sequential] = _replay(step, create_states(2, N, 0, (160, 96), device=dev), frames,
                                  dev)[0]
        assert sk.pf_step.launches >= 2 * (N_FRAMES - 1)
    for (fa, pa), (fb, pb) in zip(out[True], out[False]):
        assert np.array_equal(fa, fb) and np.array_equal(pa, pb)
    assert (out[True][0][0] == 0).all() and (out[True][-1][0] == 10).all()


def test_sharded_multi_tracker_on_card_matches_sequential(dev):
    """make_mesh(2, target_shards=2) on the card against the card's
    sequential multi-tracker: flags equal, poses within 1e-4."""
    cam, markers, masks, frames = _scene(N_FRAMES)
    config = TrackerConfig(**CONFIG)
    mesh = make_mesh(2, target_shards=2)
    sharded = make_sharded_multi_tracker(cam, markers, masks, config, mesh, device=dev, **RING)
    state = shard_target_state(create_states(2, N, 0, (160, 96), device=dev), mesh, batched=True)
    got, last = _replay(sharded, state, frames, dev)
    assert last.bank.shape == (2, 2, 16, N // 2) and last.bank.is_cuda
    plain = make_multi_tracker(cam, markers, masks, config, device=dev)
    want, _ = _replay(plain, create_states(2, N, 0, (160, 96), device=dev), frames, dev)
    for i, ((fg, pg), (fw, pw)) in enumerate(zip(got, want)):
        assert np.array_equal(fg, fw), f"frame {i}: {fg} vs {fw}"
        np.testing.assert_allclose(pg, pw, atol=1e-4, err_msg=f"frame {i}")


def test_multi_checkpoint_resumes_identically_on_card(dev, tmp_path):
    cam, markers, masks, frames = _scene(N_FRAMES)
    step = make_multi_tracker(cam, markers, masks, TrackerConfig(**CONFIG), device=dev)
    _, state = _replay(step, create_states(2, N, 0, (160, 96), device=dev), frames[:2], dev)
    path = str(tmp_path / "multi.npz")
    save_state(path, state)
    loaded = load_state(path, create_states(2, N, 3, (160, 96), device=dev))
    rows_a, end_a = _replay(step, state, frames[2:], dev, 2)
    rows_b, end_b = _replay(step, loaded, frames[2:], dev, 2)
    for (fa, pa), (fb, pb) in zip(rows_a, rows_b):
        assert np.array_equal(fa, fb) and np.array_equal(pa, pb)
    for f in dataclasses.fields(end_a):
        assert torch.equal(getattr(end_a, f.name), getattr(end_b, f.name)), f.name
