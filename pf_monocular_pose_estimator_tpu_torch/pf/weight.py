"""Particle weighting for a few poses (port of `pf/weight.py`).

Greedy global-minimum matching with the reference's detection-major tie
order (flat index k * M + m).  The tracker uses it to recompute the pairs
of a single particle; the bank-wide weight runs inside kernel B."""

from __future__ import annotations

import torch

from ..geometry.camera import Camera, project
from ..utils.sync import upload


def weight_particles(camera: Camera, bank: torch.Tensor, markers_h: torch.Tensor,
                     marker_mask: torch.Tensor, det_xy: torch.Tensor, det_mask: torch.Tensor,
                     tol_pf, tol_init, downgrade: torch.Tensor, num_markers_score=None):
    """bank (N, 4, 4) -> (weights (N,), pairs (N, M, 2) int32, n_corr (N,) int32)."""
    n = bank.shape[0]
    m = markers_h.shape[0]
    k_cap = det_xy.shape[0]
    dev = bank.device
    big = upload(torch.finfo(torch.float32).max / 4, dev)
    if num_markers_score is None:
        num_markers_score = torch.sum(marker_mask.float())

    uv = project(camera, bank, markers_h)  # (N, M, 2)
    diff = det_xy[None, :, None, :] - uv[:, None, :, :]  # (N, K, M, 2)
    dist2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    invalid = (~det_mask)[None, :, None] | (~marker_mask)[None, None, :]
    dist2 = torch.where(invalid, big, dist2)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    weights = torch.zeros(n, dtype=torch.float32, device=dev)
    pairs = torch.full((n, m, 2), -1, dtype=torch.int32, device=dev)
    n_corr = torch.zeros(n, dtype=torch.int32, device=dev)
    used_det = torch.zeros((n, k_cap), dtype=torch.int32, device=dev)
    n_self_occ = torch.ones(n, dtype=torch.float32, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    k_iota = torch.arange(k_cap, device=dev)
    m_iota = torch.arange(m, device=dev)

    for step in range(m):
        flat = dist2.reshape(n, -1)
        min_val = torch.min(flat, dim=-1).values
        idx = torch.argmax((flat == min_val[:, None]).to(torch.int32), dim=-1)  # first minimum
        d = torch.sqrt(torch.clamp(min_val, min=0.0))
        row = idx // m  # detection
        col = idx % m  # marker
        ok = (d <= tol_pf) & ~done
        done = done | ~ok
        score = num_markers_score + ((tol_init - d) / tol_init) ** 2
        reused = torch.gather(used_det, 1, row[:, None])[:, 0] > 0
        penal_occ = torch.where(ok & reused, 3.0 * n_self_occ, zero)
        n_self_occ = n_self_occ + (ok & reused).float()
        penal_down = torch.where(ok & downgrade[col], torch.full_like(zero, 2.0), zero)
        weights = weights + torch.where(ok, score, zero) - penal_occ - penal_down
        pair = torch.stack([col, row], dim=-1).to(torch.int32)
        pairs[:, step, :] = torch.where(ok[:, None], pair, torch.full_like(pair, -1))
        n_corr = n_corr + ok.to(torch.int32)
        used_det = used_det + ((k_iota[None, :] == row[:, None]) & ok[:, None]).to(torch.int32)
        retire = (m_iota[None, None, :] == col[:, None, None]) & ok[:, None, None]
        dist2 = torch.where(retire, big, dist2)
    return weights, pairs, n_corr
