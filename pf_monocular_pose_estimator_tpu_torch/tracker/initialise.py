"""Initialisation: histogram, ranked hypotheses, validation, seeds (port of
`tracker/initialise.py`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import Camera
from ..ops.blob import Detections
from ..utils.config import TrackerConfig
from ..utils.dynamic import DynamicParams
from ..utils.flags import FailFlag
from ..utils.sync import upload
from .check import check_correspondences
from .init_search import brute_force_histogram, correspondences_from_histogram


class InitResult(NamedTuple):
    success: torch.Tensor  # bool
    pose: torch.Tensor  # (4, 4)
    det_for_marker: torch.Tensor  # (M,)
    bank: torch.Tensor  # (16, N)
    flag: torch.Tensor  # int32


def argsort_stable(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).indices


def first_true(x: torch.Tensor) -> torch.Tensor:
    """jnp.argmax of a bool vector: the first True, 0 if none."""
    return torch.argmax(x.to(torch.int32))


def fill_bank_with_seeds(bank16: torch.Tensor, seeds: torch.Tensor, seed_mask: torch.Tensor,
                         lane_offset: int = 0, n_total: int | None = None) -> torch.Tensor:
    """Fill bank slots 1..N-1 by cycling the valid seeds (slot 0 keeps its
    pose); seeds (S, 4, 4), seed_mask (S,).  A shard of a bank of `n_total`
    lanes passes the global index of its first lane as `lane_offset`."""
    n_local = bank16.shape[1]
    n = n_local if n_total is None else n_total
    dev = bank16.device
    order = argsort_stable((~seed_mask).to(torch.int32))  # valid first
    seeds16 = seeds[order].reshape(-1, 16).T  # (16, S)
    seeds16 = torch.where(seed_mask[order][None, :], seeds16, torch.zeros((), device=dev))
    n_seeds = torch.sum(seed_mask.to(torch.int64))
    idx = torch.arange(n_local, device=dev) + lane_offset
    pick_idx = torch.where(n_seeds > 0, (n - 1 - idx) % torch.clamp(n_seeds, min=1),
                           torch.zeros((), dtype=torch.int64, device=dev))
    pick = seeds16[:, pick_idx]
    use = (idx > 0) & (n_seeds > 0)
    return torch.where(use[None, :], pick, bank16)


def harvest_seeds(results, cand_valid, first, s_cap: int):
    """Seeds of the candidates up to the first validated one, compacted."""
    rank = torch.arange(cand_valid.shape[0], device=cand_valid.device)
    walked = rank <= first
    seeds = results.seeds.reshape(-1, 4, 4)
    seed_mask = (results.seed_mask & (cand_valid & walked)[:, None]).reshape(-1)
    order = argsort_stable((~seed_mask).to(torch.int32))
    return seeds[order][:s_cap], seed_mask[order][:s_cap]


def initialise(camera: Camera, det: Detections, markers_h: torch.Tensor,
               marker_mask: torch.Tensor, bank: torch.Tensor, config: TrackerConfig,
               dyn: DynamicParams, prefer_near: torch.Tensor | None = None,
               fill_seeds=fill_bank_with_seeds) -> InitResult:
    """Histogram -> ranked hypotheses (+ drop-one variants) -> validation ->
    seed harvest.  prefer_near: (13,) [t (3), active, R row-major (9)].
    `fill_seeds(bank, seeds, seed_mask)` writes the seeds into the bank in
    the layout the caller keeps it in."""
    dev = det.xy.device
    m_cap = markers_h.shape[0]
    n_markers = torch.sum(marker_mask.to(torch.int32))
    if not config.use_particle_filter:
        min_needed = upload(config.min_num_leds_detected, dev, torch.int32)
    elif config.pf_init_min_markers > 0:
        min_needed = torch.clamp(n_markers, max=config.pf_init_min_markers)
    else:
        min_needed = n_markers
    enough_dets = det.count >= min_needed

    hist = brute_force_histogram(camera, det, markers_h, marker_mask, config, dyn)
    hist_nonzero = torch.any(hist > 0)
    cands = correspondences_from_histogram(hist, det.mask, marker_mask, config,
                                           initialisation=True)
    cand_dfm, cand_valid = cands.det_for_marker, cands.valid
    if config.init_drop_one_variants > 0:
        r2 = min(config.init_drop_one_variants, cand_dfm.shape[0])
        eye = torch.eye(m_cap, dtype=torch.bool, device=dev)[None]
        drop = torch.where(eye, torch.full((), -1, dtype=torch.int32, device=dev),
                           cand_dfm[:r2][:, None, :]).reshape(r2 * m_cap, m_cap)
        cand_dfm = torch.cat([cand_dfm, drop])
        cand_valid = torch.cat([cand_valid, cands.valid[:r2].repeat_interleave(m_cap)])

    results = check_correspondences(camera, det.xy, det.mask, markers_h, marker_mask, cand_dfm,
                                    min_needed, config, dyn)
    cand_success = results.success & cand_valid
    any_success = torch.any(cand_success)
    first = first_true(cand_success)
    if prefer_near is not None and config.init_consistency_radius > 0.0:
        t_err = torch.linalg.norm(results.pose[:, :3, 3] - prefer_near[None, :3], dim=-1)
        consistent = cand_success & (t_err <= config.init_consistency_radius) & (
            prefer_near[3] > 0)
        if prefer_near.shape[0] >= 13 and config.init_consistency_rotation_deg > 0.0:
            r_prev = prefer_near[4:13].reshape(3, 3)
            r_rel = torch.einsum("cij,kj->cik", results.pose[:, :3, :3], r_prev)
            tr = r_rel[:, 0, 0] + r_rel[:, 1, 1] + r_rel[:, 2, 2]
            cos_a = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
            cos_lim = torch.cos(torch.deg2rad(upload(config.init_consistency_rotation_deg, dev)))
            consistent = consistent & (cos_a >= cos_lim)
        first = torch.where(torch.any(consistent), first_true(consistent), first)
    pose = results.pose[first]
    det_for_marker = cand_dfm[first]

    seeds, seed_mask = harvest_seeds(results, cand_valid, first, config.max_p3p_seeds)
    new_bank = torch.where(any_success, fill_seeds(bank, seeds, seed_mask), bank)

    flag = torch.where(
        ~enough_dets,
        int(FailFlag.TOO_FEW_MARKERS_DETECTED),
        torch.where(
            ~hist_nonzero,
            int(FailFlag.HISTOGRAM_ALL_ZERO),
            torch.where(
                ~torch.any(cands.valid),
                int(FailFlag.NO_CORR_FROM_HISTOGRAM),
                torch.where(any_success, int(FailFlag.INIT_SUCCESS), results.flag[0]),
            ),
        ),
    ).to(torch.int32)
    success = enough_dets & hist_nonzero & any_success
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    return InitResult(
        success=success,
        pose=torch.where(success, pose, eye4),
        det_for_marker=torch.where(success, det_for_marker,
                                   torch.full((), -1, dtype=torch.int32, device=dev)),
        bank=new_bank,
        flag=flag,
    )
