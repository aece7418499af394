"""Gauss-Newton pose refinement (port of `pf/refine.py`).

`gauss_newton_refine` takes one pose or a batch of them: with
`use_pallas_gn` off the init and IPE branches refine their single pose with
it and the track branch its hypotheses, the batch written out where the
reference vmaps.  With `use_pallas_gn` on (the default) both go through
`pf.refine_kernel` (`refine_pose` and `refine_frame`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import Camera, project
from ..geometry.se3 import exp_se3


def _inv3(m: torch.Tensor) -> torch.Tensor:
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = -(d * i - f * g)
    cc = d * h - e * g
    cd = -(b * i - c * h)
    ce = a * i - c * g
    cf = -(a * h - b * g)
    cg = b * f - c * e
    ch = -(a * f - c * d)
    ci = a * e - b * d
    det = a * ca + b * cb + c * cc
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    adj = torch.stack(
        [torch.stack([ca, cd, cg], -1), torch.stack([cb, ce, ch], -1),
         torch.stack([cc, cf, ci], -1)],
        dim=-2,
    )
    return adj / det[..., None, None]


def _jacobi(a: torch.Tensor):
    diag = torch.sqrt(torch.abs(torch.diagonal(a, dim1=-2, dim2=-1)))
    diag = torch.where(diag > 0, diag, torch.ones_like(diag))
    inv_d = 1.0 / diag
    return a * inv_d[..., :, None] * inv_d[..., None, :], inv_d


def _solve6_scaled(a_s: torch.Tensor, b_s: torch.Tensor) -> torch.Tensor:
    p, q, s = a_s[..., :3, :3], a_s[..., :3, 3:], a_s[..., 3:, 3:]
    p_inv = _inv3(p)
    qt_pinv = q.transpose(-1, -2) @ p_inv
    schur_inv = _inv3(s - qt_pinv @ q)
    b1, b2 = b_s[..., :3, None], b_s[..., 3:, None]
    x2 = schur_inv @ (b2 - qt_pinv @ b1)
    x1 = p_inv @ (b1 - q @ x2)
    return torch.cat([x1, x2], dim=-2)[..., 0]


def solve6_spd(a: torch.Tensor, b: torch.Tensor, refine: bool = True) -> torch.Tensor:
    """Solve 6x6 SPD normal equations by Jacobi scaling + block Schur."""
    a_s, inv_d = _jacobi(a)
    b_s = b * inv_d
    x = _solve6_scaled(a_s, b_s)
    if refine:
        r = b_s - (a_s @ x[..., None])[..., 0]
        x = x + _solve6_scaled(a_s, r)
    return x * inv_d


def inv6_spd(a: torch.Tensor) -> torch.Tensor:
    """Closed-form SPD 6x6 inverse (the same blocked-Schur scheme)."""
    a_s, inv_d = _jacobi(a)
    p, q, s = a_s[..., :3, :3], a_s[..., :3, 3:], a_s[..., 3:, 3:]
    p_inv = _inv3(p)
    qt_pinv = q.transpose(-1, -2) @ p_inv
    schur_inv = _inv3(s - qt_pinv @ q)
    top_left = p_inv + qt_pinv.transpose(-1, -2) @ schur_inv @ qt_pinv
    top_right = -qt_pinv.transpose(-1, -2) @ schur_inv
    inv_s = torch.cat(
        [torch.cat([top_left, top_right], -1),
         torch.cat([top_right.transpose(-1, -2), schur_inv], -1)],
        dim=-2,
    )
    return inv_s * inv_d[..., :, None] * inv_d[..., None, :]


class RefineResult(NamedTuple):
    pose: torch.Tensor
    covariance: torch.Tensor
    num_iterations: torch.Tensor
    final_error: torch.Tensor
    initial_error: torch.Tensor
    converged: torch.Tensor
    max_residual: torch.Tensor


def _residuals_and_normal_eqs(camera, pose, markers_h, det_xy, corr, corr_mask):
    """pose (..., 4, 4), corr (..., C, 2), corr_mask (..., C)."""
    m_idx = torch.clamp(corr[..., 0].long(), 0, markers_h.shape[0] - 1)
    d_idx = torch.clamp(corr[..., 1].long(), 0, det_xy.shape[0] - 1)
    pts = markers_h[m_idx]
    uv_pred = project(camera, pose, pts)
    zero = torch.zeros((), dtype=torch.float32, device=pose.device)
    e = torch.where(corr_mask[..., None], det_xy[d_idx] - uv_pred, zero)
    max_resid = torch.amax(torch.linalg.norm(e, dim=-1), dim=-1)

    pc = torch.einsum("...ij,...cj->...ci", pose[..., :3, :], pts)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    z2 = z * z
    fx, fy = camera.fx, camera.fy
    zeros = torch.zeros_like(z)
    j_u = torch.stack([fx / z, zeros, -fx * x / z2, -fx * x * y / z2, fx * (1 + x * x / z2),
                       -fx * y / z], dim=-1)
    j_v = torch.stack([zeros, fy / z, -fy * y / z2, -fy * (1 + y * y / z2), fy * x * y / z2,
                       fy * x / z], dim=-1)
    jac = torch.where(corr_mask[..., None, None], torch.stack([j_u, j_v], dim=-2), zero)
    a_mat = torch.einsum("...cri,...crj->...ij", jac, jac)
    b_vec = torch.einsum("...cri,...cr->...i", jac, e)
    return a_mat, b_vec, torch.sum(e * e, dim=(-2, -1)), max_resid


def gauss_newton_refine(camera: Camera, pose0: torch.Tensor, markers_h: torch.Tensor,
                        det_xy: torch.Tensor, corr: torch.Tensor, corr_mask: torch.Tensor,
                        max_iterations: int = 50, convergence_tol: float = 1e-4) -> RefineResult:
    """Refine pose0 (..., 4, 4) against corr (..., C, 2) (marker,
    detection) pairs masked by corr_mask (..., C), over a fixed iteration
    budget with a convergence mask (converged poses stop moving), then the
    divergence revert.  Each pose of a batch is refined on its own."""
    dev = pose0.device
    batch = pose0.shape[:-2]
    damping = 1e-8 * torch.eye(6, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    _, _, err0, _ = _residuals_and_normal_eqs(camera, pose0, markers_h, det_xy, corr, corr_mask)
    pose = pose0
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    n_iter = torch.zeros(batch, dtype=torch.int32, device=dev)
    for _ in range(max_iterations):
        a_mat, b_vec, _, _ = _residuals_and_normal_eqs(camera, pose, markers_h, det_xy, corr,
                                                       corr_mask)
        dt = solve6_spd(a_mat + damping, b_vec, refine=False)
        dt = torch.where(torch.isfinite(dt), dt, zero)
        new_pose = exp_se3(dt) @ pose
        now_done = done | (torch.amax(torch.abs(dt), dim=-1) <= convergence_tol)
        pose = torch.where(done[..., None, None], pose, new_pose)
        n_iter = n_iter + (~done).to(torch.int32)
        done = now_done
    a_mat, _, err_final, max_resid = _residuals_and_normal_eqs(camera, pose, markers_h, det_xy,
                                                               corr, corr_mask)
    diverged = err_final > err0
    return RefineResult(
        pose=torch.where(diverged[..., None, None], pose0, pose),
        covariance=inv6_spd(a_mat + damping),
        num_iterations=n_iter,
        final_error=torch.where(diverged, err0, err_final),
        initial_error=err0,
        converged=done,
        max_residual=max_resid,
    )
