"""Tracker state and per-frame result (port of `tracker/state.py`).

Dataclasses of tensors on the tracker's device, field for field the
reference's `TargetState` / `FrameResult`.  Two differences:
  * `key` is the threefry key as a (2,) int64 CPU tensor of 32-bit words —
    key splitting is host work (see utils/prng.py), so it never costs a
    device round trip;
  * the reference's `ExposureState` is flattened into three fields
    (`exposure_counter_increase`, `exposure_counter_decrease`,
    `exposure_us`), which `ops/exposure.py` advances.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import prng


@dataclasses.dataclass
class TargetState:
    key: torch.Tensor  # (2,) int64 on the CPU, threefry words
    current_pose: torch.Tensor  # (4, 4)
    previous_pose: torch.Tensor
    predicted_pose: torch.Tensor
    covariance: torch.Tensor  # (6, 6)
    bank: torch.Tensor  # (16, N) SoA particle bank
    resampled: torch.Tensor  # (16, N)
    weights: torch.Tensor  # (N,)
    it_since_initialized: torch.Tensor  # int32
    uncertainty: torch.Tensor  # int32
    degraded_frames: torch.Tensor  # int32
    coast_frames: torch.Tensor  # int32
    resample_clipped: torch.Tensor  # int32
    roi: torch.Tensor  # (4,) [x0, y0, w, h]
    time_current: torch.Tensor  # float32
    time_previous: torch.Tensor
    fail_flag: torch.Tensor  # int32
    pose_updated: torch.Tensor  # bool
    num_gn_iterations: torch.Tensor  # int32
    obs_cam_old: torch.Tensor  # (4, 4)
    change_cam_pose: torch.Tensor  # (4, 4)
    time_obs_act: torch.Tensor
    cam_time_shift: torch.Tensor
    exposure_counter_increase: torch.Tensor  # int32
    exposure_counter_decrease: torch.Tensor  # int32
    exposure_us: torch.Tensor  # float32

    @classmethod
    def create(cls, n_particles: int, key=None, image_size=(752, 480), device="cuda",
               expose_time_base: float = 2000.0) -> "TargetState":
        """Initial state on `device` (the card unless asked otherwise)."""
        if key is None:
            key = prng.prng_key(0)
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)

        def eye():
            return torch.eye(4, **f32)

        return cls(
            key=torch.tensor([int(key[0]), int(key[1])], dtype=torch.int64),
            current_pose=eye(),
            previous_pose=eye(),
            predicted_pose=eye(),
            covariance=torch.eye(6, **f32),
            bank=eye().reshape(16, 1).repeat(1, n_particles),
            resampled=eye().reshape(16, 1).repeat(1, n_particles),
            weights=torch.full((n_particles,), 1.0 / n_particles, **f32),
            it_since_initialized=torch.zeros((), **i32),
            uncertainty=torch.zeros((), **i32),
            degraded_frames=torch.zeros((), **i32),
            coast_frames=torch.zeros((), **i32),
            resample_clipped=torch.zeros((), **i32),
            roi=torch.tensor([0.0, 0.0, float(image_size[0]), float(image_size[1])], **f32),
            time_current=torch.zeros((), **f32),
            time_previous=torch.tensor(-1.0, **f32),
            fail_flag=torch.tensor(-10, **i32),
            pose_updated=torch.zeros((), dtype=torch.bool, device=device),
            num_gn_iterations=torch.zeros((), **i32),
            obs_cam_old=eye(),
            change_cam_pose=eye(),
            time_obs_act=torch.zeros((), **f32),
            cam_time_shift=torch.tensor(1.0, **f32),
            exposure_counter_increase=torch.zeros((), **i32),
            exposure_counter_decrease=torch.zeros((), **i32),
            exposure_us=torch.tensor(expose_time_base, **f32),
        )

    def replace(self, **changes) -> "TargetState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class FrameResult:
    pose: torch.Tensor  # (4, 4) object -> camera
    pose_inverse: torch.Tensor
    covariance: torch.Tensor
    pose_updated: torch.Tensor
    fail_flag: torch.Tensor
    num_detections: torch.Tensor
    num_gn_iterations: torch.Tensor
    used_brute_force: torch.Tensor
    detections_xy: torch.Tensor
    detections_mask: torch.Tensor
    detections_occluded: torch.Tensor
    detections_injected: torch.Tensor
    roi: torch.Tensor
    best_weight: torch.Tensor
    blob_area_sum: torch.Tensor
    exposure_us: torch.Tensor
    resample_clipped: torch.Tensor
