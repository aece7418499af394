# Frozen copy of pf_monocular_pose_estimator_tpu_torch/solvers/quartic.py, the port's plain
# PyTorch path, trimmed to what the benchmark's reference calls; it calls no
# kernel and no code of the program.
"""Closed-form quartic roots (Ferrari), batched (port of `solvers/quartic.py`)."""

from __future__ import annotations

import torch


def _safe(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def solve_quartic(coeffs: torch.Tensor) -> torch.Tensor:
    """Real parts of the 4 roots of A x^4 + B x^3 + C x^2 + D x + E, (..., 5) -> (..., 4)."""
    a, b, c, d, e = (coeffs[..., i] for i in range(5))
    safe_a = _safe(a, 1e-30)
    a2 = safe_a * safe_a
    a3 = a2 * safe_a
    a4 = a3 * safe_a
    b2 = b * b
    b3 = b2 * b
    b4 = b3 * b

    alpha = -3.0 * b2 / (8.0 * a2) + c / safe_a
    beta = b3 / (8.0 * a3) - b * c / (2.0 * a2) + d / safe_a
    gamma = -3.0 * b4 / (256.0 * a4) + b2 * c / (16.0 * a3) - b * d / (4.0 * a2) + e / safe_a

    cdtype = torch.complex64 if coeffs.dtype == torch.float32 else torch.complex128
    alpha_c = alpha.to(cdtype)
    beta_c = beta.to(cdtype)

    p = (-alpha * alpha / 12.0 - gamma).to(cdtype)
    q = (-alpha * alpha * alpha / 108.0 + alpha * gamma / 3.0 - beta * beta / 8.0).to(cdtype)
    r = -q / 2.0 + torch.sqrt(q * q / 4.0 + p * p * p / 27.0)
    u = r ** (1.0 / 3.0)

    u_zero = torch.abs(u) < 1e-30
    safe_u = torch.where(u_zero, torch.ones_like(u), u)
    y = torch.where(
        u_zero,
        -5.0 * alpha_c / 6.0 - q ** (1.0 / 3.0),
        -5.0 * alpha_c / 6.0 - p / (3.0 * safe_u) + u,
    )

    w = torch.sqrt(alpha_c + 2.0 * y)
    safe_w = torch.where(torch.abs(w) < 1e-30, torch.full_like(w, 1e-30), w)
    shift = (-b / (4.0 * safe_a)).to(cdtype)
    s_plus = torch.sqrt(-(3.0 * alpha_c + 2.0 * y + 2.0 * beta_c / safe_w))
    s_minus = torch.sqrt(-(3.0 * alpha_c + 2.0 * y - 2.0 * beta_c / safe_w))

    roots = torch.stack(
        [
            shift + 0.5 * (w + s_plus),
            shift + 0.5 * (w - s_plus),
            shift + 0.5 * (-w + s_minus),
            shift + 0.5 * (-w - s_minus),
        ],
        dim=-1,
    )
    return roots.real.to(coeffs.dtype)
