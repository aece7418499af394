"""What the card's kernels take, checked where a tracker is built.

On a CUDA device `make_tracker`, `make_multi_tracker`,
`make_sharded_tracker` and `make_sharded_multi_tracker` raise a ValueError
that names the limit, before anything reaches the card, for a configuration
outside the kernels' ranges (`tracker.step.check_card_limits`: 1-32 markers
for B, E and D, 1-128 detections for B and E, 0-32 sweeps and a top-k of
1-min(128, crop pixels) for A); on the CPU the same configurations build
and step.  Within the ranges the check passes: the two-UAV marker file
loaded as one object (M = 10), 12 detections, 32 sweeps, top-k 128."""

import os

import pytest
import torch

from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
from pf_monocular_pose_estimator_tpu_torch.io import load_marker_positions
from pf_monocular_pose_estimator_tpu_torch.parallel import (
    make_mesh,
    make_sharded_multi_tracker,
    make_sharded_tracker,
)
from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_multi_tracker
from pf_monocular_pose_estimator_tpu_torch.tracker import make_tracker
from pf_monocular_pose_estimator_tpu_torch.tracker.step import check_card_limits
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

CAM = Camera.create(420.0, 418.0, 376.0, 240.0)
TWO_UAV_MARKERS = os.path.join(os.path.dirname(__file__), "..", "configs",
                               "two_uav_marker_positions.yaml")

# (config overrides, marker rows, the limit the message names)
BEYOND = {
    "detections": (dict(max_detections=129), 5, "K <= 128"),
    "markers": ({}, 33, "M <= 32"),
    "sweeps": (dict(cc_sweeps=33), 5, "sweeps <= 32"),
    "topk_over_crop": (dict(roi_crop=(8, 12), max_detections=97), 5, r"min\(128, pixels\)"),
}


def _markers(m):
    g = torch.Generator().manual_seed(m)
    return torch.cat([torch.randn(m, 3, generator=g) * 0.08, torch.ones(m, 1)], 1)


def _builders(m, config, device):
    markers, mask = _markers(m), torch.ones(m, dtype=torch.bool)
    return {
        "make_tracker": lambda: make_tracker(CAM, markers, mask, config, device=device),
        "make_multi_tracker": lambda: make_multi_tracker(CAM, markers[None], mask[None], config,
                                                         device=device),
        "make_sharded_tracker": lambda: make_sharded_tracker(CAM, markers, mask, config,
                                                             make_mesh(2), device=device),
        "make_sharded_multi_tracker": lambda: make_sharded_multi_tracker(
            CAM, markers[None], mask[None], config, make_mesh(2), device=device),
    }


@pytest.mark.parametrize("case", list(BEYOND))
def test_card_trackers_raise_at_construction(case):
    overrides, m, limit = BEYOND[case]
    config = TrackerConfig(n_particles=64, **overrides)
    for name, build in _builders(m, config, "cuda").items():
        with pytest.raises(ValueError, match=limit):
            build()


@pytest.mark.parametrize("case", list(BEYOND))
def test_cpu_trackers_take_the_same_configurations(case):
    """The CPU builds every form and steps a frame with no blob."""
    overrides, m, _ = BEYOND[case]
    config = TrackerConfig(n_particles=64, **overrides)
    steps = _builders(m, config, "cpu")
    for build in steps.values():
        build()
    step = steps["make_tracker"]()
    state, res = step(TargetState.create(64, prng_key(0), device="cpu"),
                      torch.zeros(480, 752), 0.0)
    assert not bool(res.pose_updated)


def test_limits_admit_the_wide_shapes():
    markers = load_marker_positions(TWO_UAV_MARKERS)[0]
    assert markers.shape == (10, 4)  # one object of ten markers
    check_card_limits(TrackerConfig(max_detections=12), markers.shape[0])
    check_card_limits(TrackerConfig(max_detections=128, cc_sweeps=32), 32)
    check_card_limits(TrackerConfig(max_detections=1, cc_sweeps=0), 1)
    check_card_limits(TrackerConfig(max_detections=96, roi_crop=(8, 12)), 5)
