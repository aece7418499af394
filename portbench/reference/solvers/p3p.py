# Frozen copy of pf_monocular_pose_estimator_tpu_torch/solvers/p3p.py, the port's plain
# PyTorch path, trimmed to what the benchmark's reference calls; it calls no
# kernel and no code of the program.
"""Kneip (2011) perspective-3-point, batched (port of `solvers/p3p.py`)."""

from __future__ import annotations

import torch

from ..geometry.se3 import _homogeneous
from .quartic import solve_quartic


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def _safe(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def p3p_kneip(feature_vectors: torch.Tensor, world_points: torch.Tensor):
    """Solve P3P for a bank of triples.

    feature_vectors: (..., 3, 3) unit bearing rows; world_points: (..., 3, 3).
    Returns (solutions (..., 4, 4, 4) camera->world, valid (...,) bool)."""
    p1, p2, p3 = world_points[..., 0, :], world_points[..., 1, :], world_points[..., 2, :]
    cross = torch.linalg.cross(p2 - p1, p3 - p1)
    valid = torch.linalg.norm(cross, dim=-1) > 1e-12

    f1, f2, f3 = (feature_vectors[..., i, :] for i in range(3))

    def cam_frame(f1, f2):
        e1 = f1
        e3 = _normalize(torch.linalg.cross(f1, f2))
        e2 = torch.linalg.cross(e3, e1)
        return torch.stack([e1, e2, e3], dim=-2)

    t_first = cam_frame(f1, f2)
    f3_t = torch.einsum("...ij,...j->...i", t_first, f3)
    swap = (f3_t[..., 2] > 0)[..., None]

    f1s = torch.where(swap, f2, f1)
    f2s = torch.where(swap, f1, f2)
    p1s = torch.where(swap, p2, p1)
    p2s = torch.where(swap, p1, p2)

    t_mat = cam_frame(f1s, f2s)
    f3_t = torch.einsum("...ij,...j->...i", t_mat, f3)

    n1 = _normalize(p2s - p1s)
    n3 = _normalize(torch.linalg.cross(n1, p3 - p1s))
    n2 = torch.linalg.cross(n3, n1)
    n_mat = torch.stack([n1, n2, n3], dim=-2)

    p3_n = torch.einsum("...ij,...j->...i", n_mat, p3 - p1s)
    d_12 = torch.linalg.norm(p2s - p1s, dim=-1)
    f3z = _safe(f3_t[..., 2], 1e-12)
    f_1 = f3_t[..., 0] / f3z
    f_2 = f3_t[..., 1] / f3z
    pp_1 = p3_n[..., 0]
    pp_2 = p3_n[..., 1]

    cos_beta = torch.sum(f1s * f2s, dim=-1)
    b_sq = 1.0 / torch.clamp(1.0 - cos_beta * cos_beta, min=1e-12) - 1.0
    b = torch.sign(cos_beta) * torch.sqrt(torch.clamp(b_sq, min=0.0))

    f1p2 = f_1 * f_1
    f2p2 = f_2 * f_2
    p1p2 = pp_1 * pp_1
    p1p3 = p1p2 * pp_1
    p1p4 = p1p3 * pp_1
    p2p2 = pp_2 * pp_2
    p2p3 = p2p2 * pp_2
    p2p4 = p2p3 * pp_2
    d12p2 = d_12 * d_12
    bp2 = b * b

    c0 = -f2p2 * p2p4 - p2p4 * f1p2 - p2p4
    c1 = 2.0 * p2p3 * d_12 * b + 2.0 * f2p2 * p2p3 * d_12 * b - 2.0 * f_2 * p2p3 * f_1 * d_12
    c2 = (
        -f2p2 * p2p2 * p1p2
        - f2p2 * p2p2 * d12p2 * bp2
        - f2p2 * p2p2 * d12p2
        + f2p2 * p2p4
        + p2p4 * f1p2
        + 2.0 * pp_1 * p2p2 * d_12
        + 2.0 * f_1 * f_2 * pp_1 * p2p2 * d_12 * b
        - p2p2 * p1p2 * f1p2
        + 2.0 * pp_1 * p2p2 * f2p2 * d_12
        - p2p2 * d12p2 * bp2
        - 2.0 * p1p2 * p2p2
    )
    c3 = (
        2.0 * p1p2 * pp_2 * d_12 * b
        + 2.0 * f_2 * p2p3 * f_1 * d_12
        - 2.0 * f2p2 * p2p3 * d_12 * b
        - 2.0 * pp_1 * pp_2 * d12p2 * b
    )
    c4 = (
        -2.0 * f_2 * p2p2 * f_1 * pp_1 * d_12 * b
        + f2p2 * p2p2 * d12p2
        + 2.0 * p1p3 * d_12
        - p1p2 * d12p2
        + f2p2 * p2p2 * p1p2
        - p1p4
        - 2.0 * f2p2 * p2p2 * pp_1 * d_12
        + p2p2 * f1p2 * p1p2
        + f2p2 * p2p2 * d12p2 * bp2
    )

    cos_theta = solve_quartic(torch.stack([c0, c1, c2, c3, c4], dim=-1))  # (..., 4)

    f_1r, f_2r = f_1[..., None], f_2[..., None]
    p_1r, p_2r = pp_1[..., None], pp_2[..., None]
    d12r, br = d_12[..., None], b[..., None]

    denom = _safe(-f_1r * cos_theta * p_2r / f_2r + p_1r - d12r, 1e-12)
    cot_alpha = (-f_1r * p_1r / f_2r - cos_theta * p_2r + d12r * br) / denom

    cos_theta_c = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta_c * cos_theta_c, min=0.0))
    sin_alpha = torch.sqrt(1.0 / (cot_alpha * cot_alpha + 1.0))
    cos_alpha = torch.sqrt(torch.clamp(1.0 - sin_alpha * sin_alpha, min=0.0))
    cos_alpha = torch.where(cot_alpha < 0, -cos_alpha, cos_alpha)

    scale = sin_alpha * br + cos_alpha
    c_int = torch.stack(
        [
            d12r * cos_alpha * scale,
            cos_theta_c * d12r * sin_alpha * scale,
            sin_theta * d12r * sin_alpha * scale,
        ],
        dim=-1,
    )  # (..., 4, 3)
    n_t = n_mat.transpose(-1, -2)
    centers = p1s[..., None, :] + torch.einsum("...ij,...rj->...ri", n_t, c_int)

    zeros = torch.zeros_like(cos_alpha)
    r_int = torch.stack(
        [
            torch.stack([-cos_alpha, -sin_alpha * cos_theta_c, -sin_alpha * sin_theta], dim=-1),
            torch.stack([sin_alpha, -cos_alpha * cos_theta_c, -cos_alpha * sin_theta], dim=-1),
            torch.stack([zeros, -sin_theta, cos_theta_c], dim=-1),
        ],
        dim=-2,
    )  # (..., 4, 3, 3)
    rot = torch.einsum("...ij,...rkj,...kl->...ril", n_t, r_int, t_mat)
    return _homogeneous(rot, centers), valid


def p3p_object_to_camera(solutions: torch.Tensor) -> torch.Tensor:
    """Invert Kneip camera-in-world solutions to object->camera transforms."""
    rot_t = solutions[..., :3, :3].transpose(-1, -2)
    t = -(rot_t @ solutions[..., :3, 3:4])[..., 0]
    return _homogeneous(rot_t, t)
