"""SE(3) calculus on torch tensors (port of the reference's `geometry/se3.py`).

Every op broadcasts over leading batch dimensions.  Twist layout follows
the reference: xi = [upsilon (3,), omega (3,)].
"""

from __future__ import annotations

import torch

from ..utils.sync import upload

_EPS = 1e-8


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    rows = [
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _sinc_terms(theta_sq: torch.Tensor):
    """(A, B, C) = sin t/t, (1-cos t)/t^2, (t - sin t)/t^3, Taylor-safe."""
    theta = torch.sqrt(torch.clamp(theta_sq, min=0.0))
    small = theta_sq < _EPS
    a_small = 1.0 - theta_sq / 6.0
    b_small = 0.5 - theta_sq / 24.0
    c_small = 1.0 / 6.0 - theta_sq / 120.0
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, a_small, torch.sin(safe_theta) / safe_theta)
    b = torch.where(small, b_small, (1.0 - torch.cos(safe_theta)) / torch.clamp(theta_sq, min=_EPS))
    c = torch.where(
        small, c_small,
        (safe_theta - torch.sin(safe_theta)) / torch.clamp(theta_sq * safe_theta, min=_EPS),
    )
    return a, b, c


def _homogeneous(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([rot, t[..., None]], dim=-1)  # (..., 3, 4)
    bottom = upload([0.0, 0.0, 0.0, 1.0], top.device, top.dtype).expand(top[..., :1, :].shape)
    return torch.cat([top, bottom], dim=-2)


def exp_se3(twist: torch.Tensor) -> torch.Tensor:
    """Exponential map, (..., 6) twist -> (..., 4, 4) transform."""
    ups = twist[..., :3]
    omega = twist[..., 3:]
    theta_sq = torch.sum(omega * omega, dim=-1)[..., None, None]
    om = skew(omega)
    om2 = om @ om
    a, b, c = _sinc_terms(theta_sq)
    eye = torch.eye(3, dtype=twist.dtype, device=twist.device).expand(om.shape)
    rot = eye + a * om + b * om2
    v_mat = eye + b * om + c * om2
    t = (v_mat @ ups[..., None])[..., 0]
    return _homogeneous(rot, t)


def log_se3(transform: torch.Tensor) -> torch.Tensor:
    """Logarithm map, (..., 4, 4) -> (..., 6) twist = [upsilon, omega]."""
    rot = transform[..., :3, :3]
    t = transform[..., :3, 3]
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_phi = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    phi = torch.arccos(cos_phi)
    sin_phi = torch.sin(phi)
    small = torch.abs(sin_phi) < _EPS
    scale = torch.where(small, torch.full_like(phi, 0.5), phi / torch.clamp(2.0 * sin_phi, min=_EPS))
    w_hat = (rot - rot.transpose(-1, -2)) * scale[..., None, None]
    w = torch.stack([w_hat[..., 2, 1], w_hat[..., 0, 2], w_hat[..., 1, 0]], dim=-1)

    w_sq = torch.sum(w * w, dim=-1)[..., None, None]
    w_norm = torch.sqrt(torch.clamp(w_sq, min=0.0))
    sin_w = torch.sin(w_norm)
    small_w = (w_sq < _EPS) | (torch.abs(sin_w) < _EPS)
    denom = 2.0 * w_sq * sin_w
    coef = torch.where(
        small_w,
        torch.full_like(w_sq, 1.0 / 12.0),
        (2.0 * sin_w - w_norm * (1.0 + torch.cos(w_norm)))
        / torch.where(small_w, torch.ones_like(denom), denom),
    )
    eye = torch.eye(3, dtype=transform.dtype, device=transform.device).expand(rot.shape)
    a_inv = eye - 0.5 * w_hat + coef * (w_hat @ w_hat)
    ups = (a_inv @ t[..., None])[..., 0]
    return torch.cat([ups, w], dim=-1)


def inverse(transform: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    rot_t = transform[..., :3, :3].transpose(-1, -2)
    t_new = -(rot_t @ transform[..., :3, 3:4])[..., 0]
    return _homogeneous(rot_t, t_new)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product with broadcasting over leading dims."""
    return a @ b


def rotation_rpy(angles: torch.Tensor) -> torch.Tensor:
    """(..., 3) [a, b, c] -> Rz(c) @ Ry(b) @ Rx(a) as a (..., 4, 4) transform,
    the composition order of the particle-propagation noise, in the
    reference's expression order."""
    a, b, c = angles[..., 0], angles[..., 1], angles[..., 2]
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    zeros, ones = torch.zeros_like(a), torch.ones_like(a)
    rows = [
        [cc * cb, cc * sb * sa - sc * ca, cc * sb * ca + sc * sa, zeros],
        [sc * cb, sc * sb * sa + cc * ca, sc * sb * ca - cc * sa, zeros],
        [-sb, cb * sa, cb * ca, zeros],
        [zeros, zeros, zeros, ones],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def predict_constant_velocity(
    previous_pose: torch.Tensor,
    current_pose: torch.Tensor,
    dt_past: torch.Tensor,
    dt_future: torch.Tensor,
) -> torch.Tensor:
    """Right-multiplicative prediction increment P, predicted = current @ P,
    with P = exp(log(prev^-1 @ cur) * dt_future / dt_past)."""
    delta = log_se3(inverse(previous_pose) @ current_pose)
    tiny = torch.abs(dt_past) < 1e-9
    safe_dt = torch.where(tiny, torch.ones_like(dt_past), dt_past)
    ratio = torch.where(tiny, torch.zeros_like(dt_past), dt_future / safe_dt)
    return exp_se3(delta * ratio)
