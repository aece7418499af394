"""The traffic generator: LED frames of periodic orbits, from a mix's file.

A mix (`traffic/<name>.json`) gives how frames are handed to the tracker
(`loop`, one of LOOPS), the period in frames, the frame rate, the warm-up
length, the splat's sigma and peak, and per number of targets the orbit of
each: six twist components, each `[amplitude, cycles, phase]` of
`amplitude * sin(cycles * 2 pi k / period + phase)`, through `exp_se3` and
shifted by `offset`.  Every component makes whole cycles over the period,
so the trajectory repeats without a jump at frame `period`.

Optional keys put outliers into the frames, drawn from `pattern_seed` (0
when absent), so that every run sees the same frames:
  * `occluded_leds`: that many LEDs of each target left undrawn in every
    frame, chosen uniformly per frame;
  * `false_blobs`: `{"count", "min_px", "max_px"}`, that many spurious
    splats a frame, each at a uniform distance in [min_px, max_px] and a
    uniform angle from a drawn LED chosen uniformly;
  * `dropout`: `{"every", "frames"}`, no LED drawn in the first `frames`
    frames of every `every`.
A key the generator does not know is refused, so that a mix cannot ask for
what is not rendered.

`render_frame` and the twist-to-pose step are frozen copies of
`pf_monocular_pose_estimator_tpu_torch/io/synthetic.py::render_frame` and
`::_orbit_pose`, on the reference's frozen geometry.  Frames are rendered
on the device in float32, rounded to uint8 as a mono camera delivers them,
and held in pinned host memory.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from reference.geometry.camera import Camera, distort_pixels, project
from reference.geometry.se3 import exp_se3


def render_frame(camera: Camera, pose: torch.Tensor, markers_h: torch.Tensor,
                 blob_sigma: float = 1.6, intensity: float = 255.0,
                 background: float = 0.0) -> torch.Tensor:
    """One (H, W) float32 frame of LED splats on `pose`'s device; a marker
    is drawn when it lies 5 cm or more in front of the camera."""
    dev = pose.device
    uv_d = distort_pixels(camera, project(camera, pose, markers_h))
    in_front = (pose[:3, :] @ markers_h.T)[2] > 0.05
    xs = torch.arange(camera.width, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(camera.height, dtype=torch.float32, device=dev)[None, :, None]
    dx = xs - uv_d[:, 0][:, None, None]
    dy = ys - uv_d[:, 1][:, None, None]
    r2 = dx * dx + dy * dy
    splats = intensity * torch.exp(-r2 / (2.0 * blob_sigma ** 2))
    splats = torch.where(in_front[:, None, None], splats, torch.zeros((), device=dev))
    return torch.clamp(background + torch.sum(splats, dim=0), 0.0, 255.0)


def orbit_pose(k: int, period: int, target: dict) -> np.ndarray:
    """(4, 4) float32: target's pose at frame k of the periodic orbit."""
    u = 2.0 * math.pi * (k % period) / period
    twist = np.array([a * math.sin(c * u + p) for a, c, p in target["terms"]], np.float32)
    pose = exp_se3(torch.from_numpy(twist)).numpy()
    pose[:3, 3] += np.asarray(target["offset"], np.float32)
    return pose


LOOPS = ("closed",)  # the next frame is handed over once the previous pose is on the host
KEYS = {"name", "loop", "period_frames", "fps", "warmup_frames", "blob_sigma", "peak", "layouts",
        "pattern_seed", "occluded_leds", "false_blobs", "dropout"}


def splats(camera: Camera, uv: torch.Tensor, blob_sigma: float, intensity: float) -> torch.Tensor:
    """(H, W) float32 sum of splats at distorted pixels uv (B, 2), as
    `render_frame` draws an LED."""
    dev = uv.device
    xs = torch.arange(camera.width, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(camera.height, dtype=torch.float32, device=dev)[None, :, None]
    dx = xs - uv[:, 0][:, None, None]
    dy = ys - uv[:, 1][:, None, None]
    return torch.sum(intensity * torch.exp(-(dx * dx + dy * dy) / (2.0 * blob_sigma ** 2)), dim=0)


class Traffic(NamedTuple):
    """One period of frames and what they show."""

    frames: torch.Tensor  # (P, H, W) uint8, pinned host memory
    poses: np.ndarray  # (P, T, 4, 4) ground truth, object -> camera
    drawn: np.ndarray  # (P, T) bool: every LED of the target is drawn, in the frame
    fps: float
    warmup_frames: int
    start: int  # the frame of the period that the run starts at


def load_mix(path: Path) -> dict:
    """A mix's parameters; a loop or key that is not implemented is refused."""
    with open(path) as f:
        mix = json.load(f)
    unknown = set(mix) - KEYS
    if unknown:
        raise SystemExit(f"{path.name}: keys the generator does not implement: {sorted(unknown)}")
    if mix.get("loop") not in LOOPS:
        raise SystemExit(f"{path.name}: loop {mix.get('loop')!r} is not one of {LOOPS}")
    return mix


def outliers(mix: dict, period: int, n_markers: list) -> tuple[list, list]:
    """(drawn, false): per frame, each target's (M,) bool of LEDs drawn, and
    the (target, marker, distance px, angle) of each spurious splat."""
    rng = np.random.default_rng(int(mix.get("pattern_seed", 0)))
    occluded = int(mix.get("occluded_leds", 0))
    fb = mix.get("false_blobs", {"count": 0})
    drop = mix.get("dropout", {"every": 1, "frames": 0})
    drawn, false = [], []
    for k in range(period):
        masks = []
        for m in n_markers:
            mask = np.ones(m, bool)
            mask[rng.choice(m, occluded, replace=False)] = False
            masks.append(mask & ((k % int(drop["every"])) >= int(drop["frames"])))
        drawn.append(masks)
        false.append([])
        for _ in range(int(fb["count"])):
            i = int(rng.integers(0, len(n_markers)))
            lit = np.flatnonzero(masks[i])
            if lit.size:
                false[-1].append((i, int(rng.choice(lit)), float(rng.uniform(fb["min_px"],
                                  fb["max_px"])), float(rng.uniform(0.0, 2.0 * math.pi))))
    return drawn, false


def make_traffic(mix: dict, camera: Camera, markers_t: list, seed: int, device) -> Traffic:
    """Render one period of `mix` for the targets' marker sets (each (M, 4)
    homogeneous) on `device`; the seed sets the frame the run starts at, so
    every seed sees the same frames in another order."""
    period = int(mix["period_frames"])
    layout = mix["layouts"][str(len(markers_t))]
    poses = np.stack([[orbit_pose(k, period, tgt) for tgt in layout] for k in range(period)])
    poses_d = torch.from_numpy(poses).to(device)
    markers_d = [torch.as_tensor(m, dtype=torch.float32).to(device) for m in markers_t]
    cam = camera.to(device)
    frames = torch.empty((period, cam.height, cam.width), dtype=torch.uint8)
    frames = frames.pin_memory() if torch.device(device).type == "cuda" else frames
    lit, false = outliers(mix, period, [m.shape[0] for m in markers_t])
    uv_all = [distort_pixels(cam, project(cam, poses_d[:, i], m)) for i, m in enumerate(markers_d)]
    for k in range(period):
        img = torch.zeros((cam.height, cam.width), device=device)
        for i, m in enumerate(markers_d):
            keep = torch.from_numpy(lit[k][i]).to(device)
            img = img + render_frame(cam, poses_d[k, i], m[keep], mix["blob_sigma"], mix["peak"])
        if false[k]:
            uv = torch.stack([uv_all[i][k, j] + torch.tensor([r * math.cos(a), r * math.sin(a)],
                                                             device=device)
                              for i, j, r, a in false[k]])
            img = img + splats(cam, uv, mix["blob_sigma"], mix["peak"])
        frames[k].copy_(torch.round(torch.clamp(img, 0.0, 255.0)).to(torch.uint8))
    drawn = np.zeros((period, len(markers_t)), bool)
    for i, m in enumerate(markers_d):
        uv = uv_all[i].cpu().numpy()  # (P, M, 2)
        z = torch.einsum("pij,mj->pmi", poses_d[:, i, :3, :], m)[..., 2].cpu().numpy()
        inside = ((uv[..., 0] >= 0) & (uv[..., 0] <= cam.width - 1) & (uv[..., 1] >= 0)
                  & (uv[..., 1] <= cam.height - 1) & (z > 0.05))
        drawn[:, i] = (inside & np.stack([lit[k][i] for k in range(period)])).all(axis=1)
    start = int(np.random.default_rng(seed & (2**64 - 1)).integers(0, period))
    return Traffic(frames, poses, drawn, float(mix["fps"]), int(mix["warmup_frames"]), start)
