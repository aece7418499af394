"""Pinhole camera with plumb-bob distortion (port of `geometry/camera.py`).

`T` is the object->camera transform; image points are undistorted pixel
coordinates, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Camera:
    """Intrinsics (0-d float32 tensors) + plumb-bob distortion (5,)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor
    width: int = 752
    height: int = 480

    @classmethod
    def create(cls, fx, fy, cx, cy, dist=None, width=752, height=480, device="cpu"):
        f = lambda v: torch.as_tensor(v, dtype=torch.float32).to(device)
        if dist is None:
            dist = torch.zeros(5)
        return cls(f(fx), f(fy), f(cx), f(cy), f(dist), int(width), int(height))

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, fx=self.fx.to(device), fy=self.fy.to(device), cx=self.cx.to(device),
            cy=self.cy.to(device), dist=self.dist.to(device),
        )


def project(camera: Camera, transform: torch.Tensor, points_h: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transforms x (..., M, 4) points -> (..., M, 2) pixels."""
    cam_pts = torch.einsum("...ij,...mj->...mi", transform[..., :3, :], points_h)
    z = cam_pts[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    u = camera.fx * cam_pts[..., 0] / safe_z + camera.cx
    v = camera.fy * cam_pts[..., 1] / safe_z + camera.cy
    return torch.stack([u, v], dim=-1)


def project_points(camera: Camera, transform: torch.Tensor, points_xyz: torch.Tensor
                   ) -> torch.Tensor:
    """Same as `project` for non-homogeneous (..., M, 3) points."""
    ones = torch.ones_like(points_xyz[..., :1])
    return project(camera, transform, torch.cat([points_xyz, ones], dim=-1))


def _distort_normalized(camera: Camera, x, y):
    k1, k2, p1, p2, k3 = (camera.dist[i] for i in range(5))
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def distort_pixels(camera: Camera, pixels: torch.Tensor) -> torch.Tensor:
    """Undistorted pixel coords -> distorted pixel coords (..., 2)."""
    x = (pixels[..., 0] - camera.cx) / camera.fx
    y = (pixels[..., 1] - camera.cy) / camera.fy
    xd, yd = _distort_normalized(camera, x, y)
    return torch.stack([xd * camera.fx + camera.cx, yd * camera.fy + camera.cy], dim=-1)


def undistort_pixels(camera: Camera, pixels: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Distorted pixel coords -> undistorted (OpenCV's fixed-point iteration)."""
    k1, k2, p1, p2, k3 = (camera.dist[i] for i in range(5))
    xd = (pixels[..., 0] - camera.cx) / camera.fx
    yd = (pixels[..., 1] - camera.cy) / camera.fy
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        safe = torch.where(torch.abs(radial) < 1e-12, torch.full_like(radial, 1e-12), radial)
        x = (xd - dx) / safe
        y = (yd - dy) / safe
    return torch.stack([x * camera.fx + camera.cx, y * camera.fy + camera.cy], dim=-1)


def bearing_vectors(camera: Camera, pixels: torch.Tensor) -> torch.Tensor:
    """Undistorted pixels (..., 2) -> unit bearing rays (..., 3)."""
    x = (pixels[..., 0] - camera.cx) / camera.fx
    y = (pixels[..., 1] - camera.cy) / camera.fy
    v = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)
