"""Brute-force combinatorial initialisation (port of `tracker/init_search.py`)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.camera import Camera, bearing_vectors, project
from ..ops.blob import Detections
from ..solvers import combination_table, p3p_kneip, p3p_object_to_camera, permutation_table
from ..utils.config import TrackerConfig
from ..utils.dynamic import DynamicParams
from ..utils.sync import upload


def topk_lowest_index(x: torch.Tensor, k: int):
    """lax.top_k over the last axis: largest first, lowest index on ties."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def brute_force_histogram(camera: Camera, det: Detections, markers_h: torch.Tensor,
                          marker_mask: torch.Tensor, config: TrackerConfig,
                          dyn: DynamicParams) -> torch.Tensor:
    """Vote histogram over (detection, marker) pairs -> (K, M) int32."""
    dev = det.xy.device
    k_cap = det.xy.shape[0]
    m_cap = markers_h.shape[0]
    combos = upload(combination_table(k_cap, 3), dev, torch.int64)  # (C, 3)
    perms = upload(permutation_table(m_cap, 3), dev, torch.int64)  # (P, 3)
    n_c, n_p = combos.shape[0], perms.shape[0]

    bearings = bearing_vectors(camera, det.xy)
    tol = dyn.back_projection_pixel_tolerance

    c_xy = det.xy[combos]  # (C, 3, 2)
    c_valid = det.mask[combos].all(dim=-1)
    pair_gate_sq = dyn.init_pair_distance_gate ** 2
    sq = lambda a: torch.sum(a * a, dim=-1)
    d01 = sq(c_xy[:, 0] - c_xy[:, 1])
    d02 = sq(c_xy[:, 0] - c_xy[:, 2])
    d12 = sq(c_xy[:, 1] - c_xy[:, 2])
    c_valid = c_valid & (d01 <= pair_gate_sq) & (d02 <= pair_gate_sq) & (d12 <= pair_gate_sq)
    centre = torch.mean(c_xy, dim=1)
    rad_sq = dyn.init_cluster_radius ** 2
    dist_centre = sq(det.xy[None, :, :] - centre[:, None, :])  # (C, K)
    in_cluster = (dist_centre < rad_sq) & det.mask[None, :]
    c_valid = c_valid & (torch.sum(in_cluster, dim=-1) >= config.init_cluster_min)

    p_valid = marker_mask[perms].all(dim=-1)

    ci = torch.arange(n_c, device=dev).repeat_interleave(n_p)
    pi = torch.arange(n_p, device=dev).repeat(n_c)
    f_combos = combos[ci]
    f_perms = perms[pi]
    f_valid = c_valid[ci] & p_valid[pi]

    sols, p3p_ok = p3p_kneip(bearings[f_combos], markers_h[f_perms][..., :3])
    t_oc = p3p_object_to_camera(sols)  # (F, 4, 4, 4)

    diff = torch.amax(torch.abs(sols[:, 1:] - sols[:, :-1]), dim=(-1, -2))  # (F, 3)
    not_dup = torch.cat([torch.ones((sols.shape[0], 1), dtype=torch.bool, device=dev), diff > 0],
                        dim=1)
    finite = torch.isfinite(t_oc).all(dim=-1).all(dim=-1)
    sol_ok = f_valid[:, None] & p3p_ok[:, None] & not_dup & finite  # (F, 4)

    uv = project(camera, t_oc, markers_h)  # (F, 4, M, 2)
    dd = det.xy[None, None, :, None, :] - uv[:, :, None, :, :]
    dist2 = sq(dd)  # (F, 4, K, M)

    k_iota = torch.arange(k_cap, device=dev)
    m_iota = torch.arange(m_cap, device=dev)
    in_combo = (k_iota[None, :, None] == f_combos[:, None, :]).any(-1)  # (F, K)
    row_ok = in_cluster[ci] & ~in_combo
    in_perm = (m_iota[None, :, None] == f_perms[:, None, :]).any(-1)  # (F, M)
    col_ok = marker_mask[None, :] & ~in_perm

    big = torch.full((), 1e12, dtype=torch.float32, device=dev)
    dist2 = torch.where(col_ok[:, None, None, :], dist2, big)
    min_d2 = torch.min(dist2, dim=-1).values
    nearest = torch.argmax((dist2 == min_d2[..., None]).to(torch.int32), dim=-1)
    within = (min_d2 <= tol * tol) & row_ok[:, None, :] & sol_ok[..., None]  # (F, 4, K)
    any_within = within.any(dim=-1)

    nn_votes = (m_iota[None, None, None, :] == nearest[..., None]) & within[..., None]
    # vote counts stay below 2**24, so float32 products are exact (CUDA has
    # no integer matmul)
    combo_onehot = (k_iota[None, :, None] == f_combos[:, None, :]).float()  # (F, K, 3)
    perm_onehot = (m_iota[None, :, None] == f_perms[:, None, :]).float()  # (F, M, 3)
    chosen = torch.einsum("fkt,fmt->fkm", combo_onehot, perm_onehot)  # (F, K, M)
    n_any = any_within.float().sum(dim=1)  # (F,)
    chosen_votes = torch.einsum("f,fkm->km", n_any, chosen).round().to(torch.int32)
    return nn_votes.to(torch.int32).sum(dim=(0, 1)).to(torch.int32) + chosen_votes


class CorrespondenceCandidates(NamedTuple):
    det_for_marker: torch.Tensor  # (R, M) int32
    probability: torch.Tensor  # (R,)
    valid: torch.Tensor  # (R,) bool


def correspondences_from_histogram(hist: torch.Tensor, det_mask: torch.Tensor,
                                   marker_mask: torch.Tensor, config: TrackerConfig,
                                   initialisation: bool) -> CorrespondenceCandidates:
    """Ranked full-correspondence hypotheses from the vote histogram."""
    dev = hist.device
    k_cap, m_cap = hist.shape
    t_cap = config.max_candidates_per_led
    r_cap = config.max_correspondence_candidates
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    h = hist.float()
    colsum = torch.sum(h, dim=0)
    rowsum = torch.sum(h, dim=1)
    denom = colsum[None, :] * rowsum[:, None]
    prob = torch.where(denom > 0, h * h / torch.clamp(denom, min=1e-12), zero)
    n_det = torch.clamp(torch.sum(det_mask.float()), min=1.0)
    n_mark = torch.clamp(torch.sum(marker_mask.float()), min=1.0)
    prob_threshold = 1.3 / (n_det * n_mark)
    prob = torch.where(prob >= prob_threshold, prob, zero)
    prob = torch.where(det_mask[:, None] & marker_mask[None, :], prob, zero)

    top_p, top_i = topk_lowest_index(prob.T, t_cap)  # (M, T)
    n_cand = torch.sum(top_p > 0, dim=-1)

    n_combo = t_cap ** m_cap
    digits = np.stack([(np.arange(n_combo) // (t_cap ** j)) % t_cap for j in range(m_cap)],
                      axis=-1)
    digits = upload(digits, dev, torch.int64)  # (n_combo, M)
    radix = torch.clamp(n_cand, min=1)[None, :]
    canonical = (digits < radix).all(dim=-1)
    has_cand = (n_cand > 0)[None, :]
    cand_prob = torch.gather(top_p, 1, digits.T).T  # (n_combo, M)
    member_prob = torch.where(has_cand, cand_prob, torch.ones((), device=dev))
    combo_prob = member_prob[:, 0]
    for j in range(1, m_cap):
        combo_prob = combo_prob * member_prob[:, j]
    combo_prob = combo_prob * canonical.float()
    cand_det = torch.where(has_cand, torch.gather(top_i, 1, digits.T).T,
                           torch.full((), -1, dtype=torch.int64, device=dev))

    if initialisation:
        same = (cand_det[:, :, None] == cand_det[:, None, :]) & (cand_det[:, :, None] >= 0)
        dup = torch.triu(same, diagonal=1).any(dim=-1).any(dim=-1)
        combo_prob = torch.where(dup, zero, combo_prob)

    total = torch.sum(combo_prob)
    combo_prob = torch.where(total > 0, combo_prob / torch.clamp(total, min=1e-12), zero)
    top_cp, top_ci = topk_lowest_index(combo_prob, r_cap)
    valid = top_cp > 0
    det_for_marker = torch.where(valid[:, None], cand_det[top_ci],
                                 torch.full((), -1, dtype=torch.int64, device=dev))
    return CorrespondenceCandidates(det_for_marker.to(torch.int32), top_cp, valid)
