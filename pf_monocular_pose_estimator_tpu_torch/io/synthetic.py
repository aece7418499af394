"""Synthetic LED sequences (port of `io/synthetic.py`).

Gaussian LED splats drawn at the *distorted* pixel positions of a
ground-truth trajectory, so detection -> undistortion -> estimation runs
end to end.  The random draws are the reference's: one
`np.random.default_rng(seed)` consumed in the same order, so phases,
clutter, distractors and gain jitter are the same numbers.  Poses are
built on the host (`_orbit_pose`: a float32 twist through `exp_se3` on the
CPU); the pixel work runs in torch on the sequence's device, in the
precision the reference's numpy gives each step (float64 where a numpy
float64 scalar enters, float32 elsewhere).  Float32 `exp` differs between
libraries by an ulp, so a frame cast to uint8 may sit one level from the
reference's at a few pixels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.camera import Camera, distort_pixels, project
from ..geometry.se3 import exp_se3


def render_frame(camera: Camera, pose: torch.Tensor, markers_h: torch.Tensor,
                 blob_sigma: float = 1.6, intensity: float = 255.0, background: float = 0.0,
                 marker_mask: torch.Tensor | None = None) -> torch.Tensor:
    """One (H, W) float32 frame of LED splats on `pose`'s device.

    pose: (4, 4) object->camera; markers_h: (M, 4) homogeneous; a marker
    is drawn when it lies 5 cm or more in front of the camera and
    `marker_mask` (M,) keeps it."""
    dev = pose.device
    camera = camera.to(dev)
    markers_h = markers_h.to(dev)
    uv_d = distort_pixels(camera, project(camera, pose, markers_h))
    in_front = (pose[:3, :] @ markers_h.T)[2] > 0.05
    if marker_mask is not None:
        in_front = in_front & marker_mask.to(dev)
    xs = torch.arange(camera.width, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(camera.height, dtype=torch.float32, device=dev)[None, :, None]
    dx = xs - uv_d[:, 0][:, None, None]
    dy = ys - uv_d[:, 1][:, None, None]
    r2 = dx * dx + dy * dy
    splats = intensity * torch.exp(-r2 / (2.0 * blob_sigma ** 2))
    splats = torch.where(in_front[:, None, None], splats, torch.zeros((), device=dev))
    return torch.clamp(background + torch.sum(splats, dim=0), 0.0, 255.0)


class SyntheticSequence(NamedTuple):
    """A rendered sequence with ground truth, on one device."""

    frames: torch.Tensor  # (T, H, W) float32
    poses: torch.Tensor  # (T, 4, 4) object->camera ground truth; (T, 2, 4, 4) for two targets
    times: torch.Tensor  # (T,)
    markers_h: torch.Tensor  # (M, 4); (2, M, 4) for two targets


def _orbit_pose(ti: float, phase: float, distance: float, orbit_radius: float,
                spin_rate: float) -> np.ndarray:
    """(4, 4) float32: the orbit-and-spin pose at time `ti`."""
    ang = 2 * np.pi * 0.15 * ti + phase
    twist = np.array(
        [
            orbit_radius * np.cos(ang),
            orbit_radius * 0.6 * np.sin(ang),
            0.15 * np.sin(0.7 * ang),
            0.25 * np.sin(spin_rate * ti),
            0.25 * np.cos(spin_rate * ti * 0.9),
            spin_rate * ti * 0.3,
        ],
        dtype=np.float32,
    )
    pose = exp_se3(torch.from_numpy(twist)).numpy()
    pose[2, 3] += distance
    return pose


def make_orbit_sequence(camera: Camera, markers_h, num_frames: int = 60, fps: float = 50.0,
                        distance: float = 1.5, orbit_radius: float = 0.25, spin_rate: float = 0.8,
                        blob_sigma: float = 1.6, seed: int = 0,
                        device="cuda") -> SyntheticSequence:
    """A smooth orbit-and-spin trajectory in front of the camera (~1-2 m
    range), rendered on `device` (the card unless asked otherwise)."""
    t = np.arange(num_frames) / fps
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi)
    poses = torch.from_numpy(np.stack([_orbit_pose(ti, phase, distance, orbit_radius, spin_rate)
                                       for ti in t])).to(device)
    markers_h = torch.as_tensor(markers_h, dtype=torch.float32).to(device)
    frames = torch.stack([render_frame(camera, p, markers_h, blob_sigma) for p in poses])
    return SyntheticSequence(frames=frames,
                             poses=poses,
                             times=torch.from_numpy(t.astype(np.float32)).to(device),
                             markers_h=markers_h)


def _splat(xs, ys, cx, cy, sx, sy, theta, peak) -> torch.Tensor:
    """One anisotropic Gaussian splat on the (H, W) grid, float64.

    The offsets `xs - cx`, `ys - cy` are taken in the dtype of `xs` / `ys`
    (float32 for a float32 centre, as numpy takes them; the caller passes
    float64 grids for a float64 centre); the rotation, its cos / sin being
    numpy float64 scalars in the reference, is float64."""
    c, s = float(np.cos(theta)), float(np.sin(theta))
    ox = (xs - cx).double()
    oy = (ys - cy).double()
    du = ox * c + oy * s
    dv = -ox * s + oy * c
    return float(peak) * torch.exp(-0.5 * ((du / sx) ** 2 + (dv / sy) ** 2))


def _accumulate(frame32: torch.Tensor, splat64: torch.Tensor) -> torch.Tensor:
    """numpy's in-place `float32 += float64`: added in float64, stored as float32."""
    return (frame32.double() + splat64).float()


def make_realistic_sequence(camera: Camera, markers_h, num_frames: int = 120, fps: float = 50.0,
                            distance: float = 1.4, blob_sigma: float = 1.6, seed: int = 0,
                            shutter_fraction: float = 0.35, exposure_swing: float = 0.10,
                            device="cuda") -> SyntheticSequence:
    """Recorded-footage-style frames: the clean orbit plus what a real IR
    camera adds -- a smooth ambient gradient, static hot patches (over the
    area cap) and streaks (over the shape ratios), three moving LED-like
    distractors, motion blur (each LED integrated over the shutter along
    its inter-frame path), 1/z^2 falloff with per-LED gain, a slow exposure
    oscillation with per-frame jitter, and uint8 quantisation.

    Deterministic in `seed`; frames are float32 holding uint8 values, on
    `device` (the card unless asked otherwise)."""
    t = np.arange(num_frames) / fps
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi)
    h, w = camera.height, camera.width
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs64, ys64 = xs.double(), ys.double()

    poses = np.stack([_orbit_pose(ti, phase, distance, 0.25, 0.8) for ti in t]).astype(np.float32)

    # static background: wide dim glows, big hot patches, bright streaks
    bg = torch.zeros((h, w), dtype=torch.float32, device=device)
    for _ in range(3):
        bg = _accumulate(bg, _splat(xs, ys, rng.uniform(0, w), rng.uniform(0, h),
                                    rng.uniform(120, 300), rng.uniform(120, 300), 0.0,
                                    rng.uniform(25, 60)))
    hot = torch.zeros((h, w), dtype=torch.float32, device=device)
    for _ in range(3):
        hot = _accumulate(hot, _splat(xs, ys, rng.uniform(0.1 * w, 0.9 * w),
                                      rng.uniform(0.1 * h, 0.9 * h), rng.uniform(7, 14),
                                      rng.uniform(7, 14), 0.0, 255.0))
    for _ in range(2):
        hot = _accumulate(hot, _splat(xs, ys, rng.uniform(0.1 * w, 0.9 * w),
                                      rng.uniform(0.1 * h, 0.9 * h), rng.uniform(6, 12),
                                      rng.uniform(0.9, 1.3), rng.uniform(0, np.pi), 255.0))

    # moving LED-like distractors
    n_distract = 3
    d_start = np.stack([rng.uniform(0.05 * w, 0.95 * w, n_distract),
                        rng.uniform(0.05 * h, 0.95 * h, n_distract)], axis=1)
    d_vel = rng.uniform(-40, 40, (n_distract, 2))  # px/s

    markers_cpu = torch.as_tensor(markers_h, dtype=torch.float32).cpu()
    m = markers_cpu.shape[0]
    led_gain = rng.uniform(0.9, 1.0, m).astype(np.float32)
    cam_cpu = camera.to("cpu")
    blur_samples = 5

    def led_pixels(pose):
        p = torch.from_numpy(pose)
        uv_d = distort_pixels(cam_cpu, project(cam_cpu, p, markers_cpu))
        z = (p[:3, :] @ markers_cpu.T)[2]
        return uv_d.numpy(), z.numpy()

    frames = torch.zeros((num_frames, h, w), dtype=torch.float32, device=device)
    frame_base = bg + hot
    for i in range(num_frames):
        frame = frame_base
        uv1, z1 = led_pixels(poses[i])
        uv0, _ = led_pixels(poses[max(i - 1, 0)])
        for k in range(blur_samples):
            a = 1.0 - shutter_fraction * (k / max(blur_samples - 1, 1))
            uv = a * uv1 + (1 - a) * uv0  # float32, as numpy computes it
            for j in range(m):
                if z1[j] <= 0.05:
                    continue
                peak = 255.0 * led_gain[j] * min((distance / max(z1[j], 0.3)) ** 2, 1.3)
                frame = _accumulate(frame, _splat(xs, ys, float(uv[j, 0]), float(uv[j, 1]),
                                                  blob_sigma, blob_sigma, 0.0,
                                                  peak / blur_samples))
        dpos = d_start + d_vel * t[i]
        dpos[:, 0] = np.abs(dpos[:, 0]) % (2 * w)
        dpos[:, 1] = np.abs(dpos[:, 1]) % (2 * h)
        dpos[:, 0] = np.where(dpos[:, 0] >= w, 2 * w - 1 - dpos[:, 0], dpos[:, 0])
        dpos[:, 1] = np.where(dpos[:, 1] >= h, 2 * h - 1 - dpos[:, 1], dpos[:, 1])
        for dxy in dpos:  # float64 centres: the offsets are float64 too
            frame = _accumulate(frame, _splat(xs64, ys64, float(dxy[0]), float(dxy[1]),
                                              blob_sigma, blob_sigma, 0.0, 255.0))
        gain = 1.0 + exposure_swing * np.sin(2 * np.pi * 0.3 * t[i]) + rng.normal(0, 0.015)
        frame = torch.clamp(frame.double() * float(gain), 0.0, 255.0)
        frames[i] = frame.to(torch.uint8).float()  # quantise like a sensor (truncation)

    return SyntheticSequence(frames=frames, poses=torch.from_numpy(poses).to(device),
                             times=torch.from_numpy(t.astype(np.float32)).to(device),
                             markers_h=markers_cpu.to(device))


def make_two_target_sequence(camera: Camera, markers_a, markers_b, num_frames: int = 60,
                             fps: float = 50.0, distance: float = 1.5, separation: float = 0.45,
                             blob_sigma: float = 1.6, seed: int = 0,
                             device="cuda") -> SyntheticSequence:
    """Two targets with distinct marker sets orbiting side by side in the same
    frames.  Poses (T, 2, 4, 4); `markers_h` stacks the two sets (2, M, 4)."""
    t = np.arange(num_frames) / fps
    rng = np.random.default_rng(seed)
    phase_a = rng.uniform(0, 2 * np.pi)
    phase_b = rng.uniform(0, 2 * np.pi)

    poses = np.zeros((num_frames, 2, 4, 4), np.float32)
    for i, ti in enumerate(t):
        pa = _orbit_pose(ti, phase_a, distance, 0.18, 0.8)
        pb = _orbit_pose(ti, phase_b, distance + 0.15, 0.15, 0.6)
        pa[0, 3] -= separation / 2
        pb[0, 3] += separation / 2
        poses[i, 0] = pa
        poses[i, 1] = pb

    poses_d = torch.from_numpy(poses).to(device)
    markers_a = torch.as_tensor(markers_a, dtype=torch.float32).to(device)
    markers_b = torch.as_tensor(markers_b, dtype=torch.float32).to(device)
    frames = torch.stack([
        torch.clamp(render_frame(camera, poses_d[i, 0], markers_a, blob_sigma)
                    + render_frame(camera, poses_d[i, 1], markers_b, blob_sigma), 0.0, 255.0)
        for i in range(num_frames)])
    return SyntheticSequence(frames=frames, poses=poses_d,
                             times=torch.from_numpy(t.astype(np.float32)).to(device),
                             markers_h=torch.stack([markers_a, markers_b]))


def _homogeneous(pts: list) -> np.ndarray:
    pts = np.asarray(pts, dtype=np.float32)
    return np.concatenate([pts, np.ones((pts.shape[0], 1), np.float32)], axis=1)


def demo_markers(device="cuda") -> torch.Tensor:
    """(5, 4): a non-coplanar 5-LED cloud in the demo YAML's size class (its
    first four points from that file; the fifth chosen to keep every wrong
    permutation's reprojection residual large)."""
    return torch.from_numpy(_homogeneous([
        [0.0714, 0.0800, 0.0622],
        [0.0400, -0.0912, 0.0317],
        [-0.0647, -0.0879, 0.0830],
        [-0.0558, -0.0165, 0.0534],
        [0.0, 0.12, 0.0],
    ])).to(device)


def second_markers(device="cuda") -> torch.Tensor:
    """(5, 4): a second, geometrically distinct constellation for two-target
    runs, scaled and mirrored relative to `demo_markers` so neither set's
    correspondence search validates on the other's detections."""
    return torch.from_numpy(_homogeneous([
        [-0.1330, 0.0574, 0.0294],
        [0.0882, 0.1218, 0.1036],
        [0.1148, -0.0714, 0.0490],
        [-0.0336, -0.1316, 0.1232],
        [0.0070, 0.0210, -0.0630],
    ])).to(device)


def default_camera(device="cuda") -> Camera:
    """752x480 mvBlueFOX-class intrinsics with plumb-bob distortion."""
    return Camera.create(fx=621.75, fy=621.39, cx=404.95, cy=238.26,
                         dist=[-0.36, 0.13, 0.0005, -0.0005, 0.0], width=752, height=480,
                         device=device)
