"""Annotated-frame rendering in host numpy (port of `io/viz.py`).

The reference's `Visualization::createVisualizationImage`: particle
orientation trivectors scaled by normalised weight, the body axes of the
estimated pose, the ROI rectangle, detections colour-coded true / injected
/ occluded, and a "lost track" banner.  The drawing is the JAX package's,
operation for operation, so the same result values give the same pixels.
A result on the card is read to the host in one copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.camera import Camera

_COLORS = {
    # detection circles, the reference's colour code: true detections
    # green (radius 5), injected yellow (radius 8), occluded red (radius 8)
    "detection": (0, 255, 0),
    "injected": (255, 255, 0),
    "occluded": (255, 0, 0),
    "axis_x": (255, 0, 0),
    "axis_y": (0, 255, 0),
    "axis_z": (0, 0, 255),
    "roi": (0, 255, 255),
    "particle": (0, 160, 255),
}

_FIELDS = ("roi", "detections_xy", "detections_mask", "detections_occluded",
           "detections_injected", "pose_updated", "pose")
_BOOL_FIELDS = {"detections_mask", "detections_occluded", "detections_injected", "pose_updated"}


def _result_on_host(result) -> dict:
    """The fields the overlay draws, as numpy, in one copy: every value is
    float32 or bool, so packing them into one float32 buffer is exact."""
    values = [getattr(result, name) for name in _FIELDS]
    flat = torch.cat([v.reshape(-1).to(torch.float32) for v in values]).cpu().numpy()
    out, offset = {}, 0
    for name, v in zip(_FIELDS, values):
        part = flat[offset:offset + v.numel()].reshape(v.shape)
        out[name] = part.astype(bool) if name in _BOOL_FIELDS else part
        offset += v.numel()
    return out


def _draw_line(img, p0, p1, color):
    h, w, _ = img.shape
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    xs = np.linspace(p0[0], p1[0], n + 1)
    ys = np.linspace(p0[1], p1[1], n + 1)
    xs = np.clip(np.round(xs).astype(int), 0, w - 1)
    ys = np.clip(np.round(ys).astype(int), 0, h - 1)
    img[ys, xs] = color


def _draw_circle(img, centre, radius, color):
    h, w, _ = img.shape
    ang = np.linspace(0, 2 * np.pi, max(int(radius * 6), 12))
    xs = np.clip(np.round(centre[0] + radius * np.cos(ang)).astype(int), 0, w - 1)
    ys = np.clip(np.round(centre[1] + radius * np.sin(ang)).astype(int), 0, h - 1)
    img[ys, xs] = color


def render_overlay(
    frame,
    camera: Camera,
    result,
    particles=None,
    weights=None,
    max_particles: int = 64,
    axis_length: float = 0.1,
) -> np.ndarray:
    """The diagnostic overlay of one frame result as an (H, W, 3) uint8 RGB array.

    frame: (H, W) grayscale; result: a tracker `FrameResult`; particles /
    weights: optional (N, 4, 4) / (N,) bank for the trivectors, of which the
    first `max_particles` are drawn.  All are tensors, on the card or the CPU.
    """
    img = np.stack([np.asarray(frame.cpu().numpy(), np.uint8)] * 3, axis=-1)
    r = _result_on_host(result)

    # ROI rectangle
    x0, y0, w, h = r["roi"]
    for a, b in [
        ((x0, y0), (x0 + w, y0)),
        ((x0 + w, y0), (x0 + w, y0 + h)),
        ((x0 + w, y0 + h), (x0, y0 + h)),
        ((x0, y0 + h), (x0, y0)),
    ]:
        _draw_line(img, a, b, _COLORS["roi"])

    # detection circles; occluded detections keep their coordinates in
    # detections_xy (mask False), so they stay drawable
    xy, mask = r["detections_xy"], r["detections_mask"]
    occluded, injected = r["detections_occluded"], r["detections_injected"]
    for i in range(xy.shape[0]):
        if occluded[i]:
            _draw_circle(img, xy[i], 8.0, _COLORS["occluded"])
        elif mask[i] and injected[i]:
            _draw_circle(img, xy[i], 8.0, _COLORS["injected"])
        elif mask[i]:
            _draw_circle(img, xy[i], 5.0, _COLORS["detection"])

    if bool(r["pose_updated"]):
        pose = r["pose"]
        fx, fy, cx, cy = torch.stack([camera.fx, camera.fy, camera.cx, camera.cy]).tolist()
        origin_h = np.array([0.0, 0.0, 0.0, 1.0])

        def proj(p4):
            pc = pose @ p4
            return (fx * pc[0] / pc[2] + cx, fy * pc[1] / pc[2] + cy)

        o = proj(origin_h)
        for axis, color in zip(np.eye(3) * axis_length, ("axis_x", "axis_y", "axis_z")):
            _draw_line(img, o, proj(np.append(axis, 1.0)), _COLORS[color])

        # particle orientation trivectors
        if particles is not None and weights is not None:
            particles = particles[:max_particles].cpu().numpy()
            wts = weights[:max_particles].cpu().numpy()
            wmax = wts.max() if wts.size and wts.max() > 0 else 1.0
            for p, wt in zip(particles, wts):
                scale = axis_length * 0.5 * float(wt / wmax)
                if scale <= 0:
                    continue
                pc = p @ origin_h
                if pc[2] <= 0.05:
                    continue
                u = fx * pc[0] / pc[2] + cx
                v = fy * pc[1] / pc[2] + cy
                tip = p @ np.array([0.0, 0.0, scale, 1.0])
                tu = fx * tip[0] / tip[2] + cx
                tv = fy * tip[1] / tip[2] + cy
                _draw_line(img, (u, v), (tu, tv), _COLORS["particle"])
    else:
        # "lost track" banner: red top border
        img[:6, :] = (255, 0, 0)

    return img
