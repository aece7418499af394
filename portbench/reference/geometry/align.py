# Frozen copy of pf_monocular_pose_estimator_tpu_torch/geometry/align.py, the port's plain
# PyTorch path, trimmed to what the benchmark's reference calls; it calls no
# kernel and no code of the program.
"""Rigid point-cloud alignment (port of `geometry/align.py`)."""

from __future__ import annotations

import torch

from .se3 import _homogeneous


def umeyama_rigid(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """T (..., 4, 4) with dst ~= R @ src + t; src, dst (..., N, 3), weights (..., N).

    Applies the determinant sign correction (no reflections)."""
    w = weights[..., None]
    wsum = torch.clamp(torch.sum(w, dim=-2, keepdim=True), min=1e-12)
    mu_src = torch.sum(src * w, dim=-2, keepdim=True) / wsum
    mu_dst = torch.sum(dst * w, dim=-2, keepdim=True) / wsum
    src_c = (src - mu_src) * torch.sqrt(w)
    dst_c = (dst - mu_dst) * torch.sqrt(w)
    h = torch.einsum("...ni,...nj->...ij", src_c, dst_c)
    u, _, vt = torch.linalg.svd(h)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = torch.linalg.det(v @ ut)
    d = torch.ones_like(v[..., :1, :])
    d[..., 0, -1] = det
    rot = (v * d) @ ut
    t = mu_dst[..., 0, :] - (rot @ mu_src[..., 0, :, None])[..., 0]
    return _homogeneous(rot, t)
