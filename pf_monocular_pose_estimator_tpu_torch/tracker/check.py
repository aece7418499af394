"""Correspondence validation by sub-triple P3P consensus (port of
`tracker/check.py`), batched over R hypotheses at once (the reference
vmaps it)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.align import umeyama_rigid
from ..geometry.camera import Camera, bearing_vectors, project
from ..solvers import combination_table, p3p_kneip, p3p_object_to_camera
from ..utils.config import TrackerConfig
from ..utils.dynamic import DynamicParams
from ..utils.flags import FailFlag
from ..utils.sync import upload


class CheckResult(NamedTuple):
    success: torch.Tensor  # (R,) bool
    pose: torch.Tensor  # (R, 4, 4)
    seeds: torch.Tensor  # (R, S, 4, 4)
    seed_mask: torch.Tensor  # (R, S)
    num_valid: torch.Tensor  # (R,)
    flag: torch.Tensor  # (R,) int32


def check_correspondences(camera: Camera, det_xy: torch.Tensor, det_mask: torch.Tensor,
                          markers_h: torch.Tensor, marker_mask: torch.Tensor,
                          det_for_marker: torch.Tensor, min_needed, config: TrackerConfig,
                          dyn: DynamicParams) -> CheckResult:
    """Validate R correspondence hypotheses; det_for_marker (R, M)."""
    dev = det_xy.device
    m_cap = markers_h.shape[0]
    tol = dyn.back_projection_pixel_tolerance
    tol2 = tol * tol

    safe_det = torch.clamp(det_for_marker.long(), 0, det_xy.shape[0] - 1)  # (R, M)
    pair_ok = (det_for_marker >= 0) & marker_mask[None, :] & det_mask[safe_det]
    n_corr = torch.sum(pair_ok.to(torch.int32), dim=-1)
    enough = n_corr >= min_needed

    pair_xy = det_xy[safe_det]  # (R, M, 2)
    bearings = bearing_vectors(camera, pair_xy)  # (R, M, 3)

    combos = upload(combination_table(m_cap, 3), dev, torch.int64)  # (C, 3)
    combo_ok = pair_ok[:, combos].all(dim=-1)  # (R, C)
    sols, p3p_ok = p3p_kneip(bearings[:, combos], markers_h[combos][..., :3][None])
    t_oc = p3p_object_to_camera(sols)  # (R, C, 4, 4, 4)
    finite = torch.isfinite(t_oc).all(dim=-1).all(dim=-1)  # (R, C, 4)

    m_iota = torch.arange(m_cap, device=dev)
    slot_in_combo = (m_iota[None, :, None] == combos[:, None, :]).any(-1)  # (C, M)
    unused = pair_ok[:, None, :] & ~slot_in_combo[None]  # (R, C, M)
    n_unused = torch.clamp(torch.sum(unused.to(torch.int32), dim=-1), min=1)

    uv = project(camera, t_oc, markers_h)  # (R, C, 4, M, 2)
    dd = pair_xy[:, None, None, :, :] - uv
    d2 = torch.sum(dd * dd, dim=-1)  # (R, C, 4, M)
    matched = (d2 <= tol2) & unused[:, :, None, :]
    n_matched = torch.sum(matched.to(torch.int32), dim=-1)
    certainty = n_matched.float() / n_unused[..., None].float()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    err = torch.sum(torch.where(matched, d2, zero), dim=-1)  # (R, C, 4)

    sol_valid = combo_ok[..., None] & p3p_ok[..., None] & finite & (
        certainty >= dyn.certainty_threshold)
    combo_valid = sol_valid.any(dim=-1)  # (R, C)
    err_m = torch.where(sol_valid, err, torch.full((), float("inf"), device=dev))
    best = torch.argmax((err_m == torch.min(err_m, dim=-1, keepdim=True).values).to(torch.int32),
                        dim=-1)  # first minimum
    best_pose = torch.gather(
        t_oc, 2, best[..., None, None, None].expand(*best.shape, 1, 4, 4)
    )[:, :, 0]  # (R, C, 4, 4)

    cam_pts = torch.einsum("rcij,mj->rcmi", best_pose[..., :3, :], markers_h)  # (R, C, M, 3)
    n_valid = torch.sum(combo_valid.to(torch.int32), dim=-1)  # (R,)
    cloud = torch.sum(torch.where(combo_valid[..., None, None], cam_pts, zero), dim=1) / (
        torch.clamp(n_valid, min=1).float()[:, None, None])
    consensus = umeyama_rigid(markers_h[None, :, :3].expand_as(cloud), cloud,
                              marker_mask.float()[None].expand(cloud.shape[0], m_cap))

    n_total = torch.clamp(torch.sum(combo_ok.to(torch.int32), dim=-1), min=1)
    fraction_ok = n_valid.float() / n_total.float() >= dyn.valid_correspondence_threshold
    success = enough & (n_valid > 0) & fraction_ok
    flag = torch.where(
        ~enough,
        int(FailFlag.TOO_FEW_CORRESPONDENCES),
        torch.where(
            success,
            int(FailFlag.INIT_SUCCESS),
            torch.where(n_valid > 0, int(FailFlag.NOT_ENOUGH_VALID_CORR),
                        int(FailFlag.CERTAINTY_FAILED_ALL)),
        ),
    ).to(torch.int32)
    return CheckResult(success, consensus, best_pose, combo_valid & enough[:, None], n_valid,
                       flag)
