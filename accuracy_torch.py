#!/usr/bin/env python3
"""Accuracy matrix of the PyTorch + CUDA port over the BASELINE.json configs.

The port's counterpart of `benchmarks/accuracy.py`, with its rows, JSON
keys and rounding: ATE, orientation error and tracked fraction on the
synthetic orbit (752x480, the demo constellation, 50 fps) for
  config0: one target, clean frames, 1,000 particles;
  config1: 10,000 particles, the full detect -> init -> PF pipeline;
  config2: one occlusion and two false detections a frame, 50,000
           particles, seeds 0-4; again at strict reference parity;
  config3: four targets of 25,000 particles, one after another on each
           frame (`make_multi_tracker`'s default `sequential=True`).

The oracle is the sequence's ground truth; the bar is the reference's
behavioural contract: initialise, track every frame, mm-scale ATE,
recover after faults.  `wall_s` is the host's clock around the frame loop,
the card synchronised at both ends.

    python3 accuracy_torch.py                 # on the card, 40 frames
    python3 accuracy_torch.py --device cpu --frames 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from pf_monocular_pose_estimator_tpu_torch.io.metrics import (absolute_trajectory_error,
                                                              orientation_error_deg)
from pf_monocular_pose_estimator_tpu_torch.io.synthetic import (default_camera, demo_markers,
                                                                make_orbit_sequence)
from pf_monocular_pose_estimator_tpu_torch.tracker import (TargetState, create_states,
                                                           make_multi_tracker, make_tracker)
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

N_SEEDS = 5


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu (the plain twins, for tests)")
    ap.add_argument("--frames", type=int, default=40)
    return ap.parse_args(argv)


def device_of(name: str) -> torch.device:
    """`name` as a device; `cuda` raises when torch sees no card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a GPU and torch sees none; "
                           "pass --device cpu to run the plain twins on the CPU")
    return device


def fence(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def track(step, state, seq):
    """Step `state` through the sequence -> (flags, updated, poses) as numpy
    arrays over the frames (a multi-target step adds a target axis after the
    frame axis) and the loop's wall seconds, the card synchronised at both
    ends."""
    device = seq.frames.device
    flags, updated, poses = [], [], []
    fence(device)
    t0 = time.perf_counter()
    for i in range(seq.frames.shape[0]):
        state, res = step(state, seq.frames[i], seq.times[i])
        flags.append(res.fail_flag)
        updated.append(res.pose_updated)
        poses.append(res.pose)
    fence(device)
    wall = time.perf_counter() - t0
    return (torch.stack(flags).cpu().numpy(), torch.stack(updated).cpu().numpy().astype(bool),
            torch.stack(poses).cpu().numpy(), wall)


def run_single(camera, markers, config: TrackerConfig, seq, seed: int = 0) -> dict:
    """One target through the sequence from `prng_key(seed)` -> the row of
    `benchmarks/accuracy.py::run_single`."""
    device = seq.frames.device
    step = make_tracker(camera, markers, torch.ones(markers.shape[0], dtype=torch.bool), config,
                        device=device)
    state = TargetState.create(config.n_particles, prng_key(seed), device=device)
    flags, upd, est, wall = track(step, state, seq)
    gt = seq.poses.cpu().numpy()
    err = np.linalg.norm(est[upd][:, :3, 3] - gt[upd][:, :3, 3], axis=-1) * 1000
    return {
        "tracked_fraction": round(float(upd.mean()), 3),
        "ate_mm": round(absolute_trajectory_error(est, gt, upd) * 1000, 3),
        "median_err_mm": round(float(np.median(err)), 3) if upd.any() else None,
        "orientation_err_deg": round(orientation_error_deg(est, gt, upd), 3),
        "reinits": sum(1 for f in flags[1:] if f == 0),
        "wall_s": round(wall, 1),
    }


def faulted_configs(base: TrackerConfig) -> tuple[TrackerConfig, TrackerConfig]:
    """config2 (the engine's defaults) and config2 at strict reference parity
    (every engine extension off), each with one occlusion and two false
    detections a frame at 50,000 particles."""
    faults = dict(number_of_occlusions=1, number_of_false_detections=2)
    return (dataclasses.replace(base, n_particles=50_000, **faults),
            TrackerConfig.reference_parity(n_particles=50_000, min_blob_area=base.min_blob_area,
                                           pf_max_retries=base.pf_max_retries, **faults))


def run_targets(camera, markers, config: TrackerConfig, seq, n_targets: int = 4) -> dict:
    """config3: `n_targets` targets with the same constellation, stepped one
    after another on each frame -> the row of `benchmarks/accuracy.py`."""
    device = seq.frames.device
    markers_t = markers.expand(n_targets, *markers.shape)
    masks_t = torch.ones(n_targets, markers.shape[0], dtype=torch.bool)
    step = make_multi_tracker(camera, markers_t, masks_t, config, device=device)
    states = create_states(n_targets, config.n_particles, device=device)
    _, upd, est, _ = track(step, states, seq)  # (frames, targets, ...)
    gt = seq.poses.cpu().numpy()
    ates = [absolute_trajectory_error(est[:, k], gt, upd[:, k]) * 1000 for k in range(n_targets)]
    return {
        "tracked_fraction": round(float(upd.mean()), 3),
        "ate_mm_per_target": [round(a, 3) for a in ates],
    }


def seeded_row(runs: list, with_median: bool) -> dict:
    n = len(runs)
    row = {"seeds": n,
           "tracked_fraction_mean": round(sum(r["tracked_fraction"] for r in runs) / n, 3)}
    if with_median:
        row["median_err_mm_mean"] = round(sum(r["median_err_mm"] for r in runs) / n, 3)
    row["per_seed"] = runs
    return row


def main(argv=None) -> dict:
    """Run every row, print the report as `benchmarks/accuracy.py` does and
    return it."""
    args = parse_args(argv)
    device = device_of(args.device)
    camera = default_camera(device)
    markers = demo_markers(device)
    seq = make_orbit_sequence(camera, markers, num_frames=args.frames, fps=50.0, device=device)

    base = TrackerConfig(min_blob_area=8.0, pf_max_retries=8)
    report = {}
    report["config0_1k_clean"] = run_single(
        camera, markers, dataclasses.replace(base, n_particles=1_000), seq)
    report["config1_10k"] = run_single(
        camera, markers, dataclasses.replace(base, n_particles=10_000), seq)
    # fault patterns are seeded, so one seed's tracked fraction is
    # high-variance: five seeds, as the JAX script
    cfg2, cfg2p = faulted_configs(base)
    report["config2_50k_outliers"] = seeded_row(
        [run_single(camera, markers, cfg2, seq, seed=s) for s in range(N_SEEDS)], True)
    report["config2_50k_outliers_reference_parity"] = seeded_row(
        [run_single(camera, markers, cfg2p, seq, seed=s) for s in range(N_SEEDS)], False)
    report["config3_4targets_25k"] = run_targets(
        camera, markers, dataclasses.replace(base, n_particles=25_000), seq)

    print(json.dumps(report, indent=2), flush=True)
    return report


if __name__ == "__main__":
    main()
