# Frozen copy of pf_monocular_pose_estimator_tpu_torch/tracker/short_p3p.py, the port's plain
# PyTorch path, trimmed to what the benchmark's reference calls; it calls no
# kernel and no code of the program.
"""Short-P3P recovery from 3 surviving pairs (port of `tracker/short_p3p.py`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import Camera, bearing_vectors, project
from ..ops.blob import Detections
from ..solvers import p3p_kneip, p3p_object_to_camera
from ..utils.config import TrackerConfig
from ..utils.dynamic import DynamicParams
from ..utils.flags import FailFlag
from .check import check_correspondences
from .init_search import correspondences_from_histogram
from .initialise import fill_bank_with_seeds, first_true, harvest_seeds


class ShortP3PResult(NamedTuple):
    success: torch.Tensor
    pose: torch.Tensor
    det_for_marker: torch.Tensor
    bank: torch.Tensor
    flag: torch.Tensor


def _votes_keeping(camera, det, markers_h, marker_mask, given_pairs, kept, bearings, tol):
    """Votes when pairs `kept` (2 rows of given_pairs) stay fixed and the
    third point runs over every (detection, marker) pair."""
    dev = det.xy.device
    k_cap, m_cap = det.xy.shape[0], markers_h.shape[0]
    kept_m, kept_d = kept[:, 0].long(), kept[:, 1].long()
    d_idx = torch.arange(k_cap, device=dev).repeat_interleave(m_cap)
    m_idx = torch.arange(m_cap, device=dev).repeat(k_cap)
    g = d_idx.shape[0]
    g_ok = (det.mask[d_idx] & marker_mask[m_idx] & (d_idx != kept_d[0]) & (d_idx != kept_d[1])
            & (m_idx != kept_m[0]) & (m_idx != kept_m[1]))
    fv = torch.stack([bearings[kept_d[0]].expand(g, 3), bearings[kept_d[1]].expand(g, 3),
                      bearings[d_idx]], dim=1)
    wp = torch.stack([markers_h[kept_m[0], :3].expand(g, 3), markers_h[kept_m[1], :3].expand(g, 3),
                      markers_h[m_idx, :3]], dim=1)
    sols, p3p_ok = p3p_kneip(fv, wp)
    t_oc = p3p_object_to_camera(sols)
    diff = torch.amax(torch.abs(sols[:, 1:] - sols[:, :-1]), dim=(-1, -2))
    not_dup = torch.cat([torch.ones((g, 1), dtype=torch.bool, device=dev), diff > 0], dim=1)
    finite = torch.isfinite(t_oc).all(dim=-1).all(dim=-1)
    sol_ok = g_ok[:, None] & p3p_ok[:, None] & not_dup & finite

    uv = project(camera, t_oc, markers_h)
    dd = det.xy[None, None, :, None, :] - uv[:, :, None, :, :]
    dist2 = torch.sum(dd * dd, dim=-1)  # (G, 4, K, M)
    k_iota = torch.arange(k_cap, device=dev)
    m_iota = torch.arange(m_cap, device=dev)
    row_ok = (det.mask[None, :] & (k_iota[None, :] != kept_d[0]) & (k_iota[None, :] != kept_d[1])
              & (k_iota[None, :] != d_idx[:, None]))
    col_ok = (marker_mask[None, :] & (m_iota[None, :] != kept_m[0])
              & (m_iota[None, :] != kept_m[1]) & (m_iota[None, :] != m_idx[:, None]))
    dist2 = torch.where(col_ok[:, None, None, :], dist2, torch.full((), 1e12, device=dev))
    min_d2 = torch.min(dist2, dim=-1).values
    nearest = torch.argmax((dist2 == min_d2[..., None]).to(torch.int32), dim=-1)
    within = (min_d2 <= tol * tol) & row_ok[:, None, :] & sol_ok[..., None]
    any_within = within.any(dim=-1)
    nn_votes = (m_iota[None, None, None, :] == nearest[..., None]) & within[..., None]
    given_onehot = torch.zeros((k_cap, m_cap), dtype=torch.int32, device=dev)
    for t in range(3):
        given_onehot[given_pairs[t, 1].long(), given_pairs[t, 0].long()] += 1
    n_any = any_within.to(torch.int32).sum()
    return nn_votes.to(torch.int32).sum(dim=(0, 1)) + given_onehot * n_any


def short_p3p(camera: Camera, det: Detections, markers_h: torch.Tensor,
              marker_mask: torch.Tensor, given_pairs: torch.Tensor, bank: torch.Tensor,
              config: TrackerConfig, dyn: DynamicParams,
              fill_seeds=fill_bank_with_seeds) -> ShortP3PResult:
    """given_pairs: (3, 2) (marker, detection); `fill_seeds` as in `initialise`."""
    dev = det.xy.device
    enough = det.count >= config.min_num_leds_detected
    bearings = bearing_vectors(camera, det.xy)
    tol = dyn.back_projection_pixel_tolerance
    hist = sum(
        _votes_keeping(camera, det, markers_h, marker_mask, given_pairs, given_pairs[list(keep)],
                       bearings, tol)
        for keep in ((0, 1), (0, 2), (1, 2))
    )
    hist_nonzero = torch.any(hist > 0)
    cands = correspondences_from_histogram(hist, det.mask, marker_mask, config,
                                           initialisation=False)
    results = check_correspondences(camera, det.xy, det.mask, markers_h, marker_mask,
                                    cands.det_for_marker, config.min_num_leds_detected, config,
                                    dyn)
    cand_success = results.success & cands.valid
    any_success = torch.any(cand_success)
    first = first_true(cand_success)
    seeds, seed_mask = harvest_seeds(results, cands.valid, first, config.max_p3p_seeds)
    new_bank = torch.where(any_success, fill_seeds(bank, seeds, seed_mask), bank)
    flag = torch.where(
        ~enough,
        int(FailFlag.SHORT_TOO_FEW_DETECTIONS),
        torch.where(
            ~hist_nonzero,
            int(FailFlag.SHORT_HISTOGRAM_FAILED),
            torch.where(
                ~torch.any(cands.valid),
                int(FailFlag.SHORT_NO_CORR_FROM_HISTOGRAM),
                torch.where(any_success, int(FailFlag.SHORT_P3P_SUCCESS), results.flag[0]),
            ),
        ),
    ).to(torch.int32)
    success = enough & hist_nonzero & any_success
    return ShortP3PResult(
        success=success,
        pose=torch.where(success, results.pose[first], torch.eye(4, device=dev)),
        det_for_marker=torch.where(success, cands.det_for_marker[first],
                                   torch.full((), -1, dtype=torch.int32, device=dev)),
        bank=new_bank,
        flag=flag,
    )
