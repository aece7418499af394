"""PF iteration kernel B (csrc/pf_step.cu) and resample-gather kernel C
(csrc/resample_gather.cu), each with its plain PyTorch version.

Kernel B ports `pf/pallas_step.py::fused_propagate_weight_pallas` with
its semantics: L @ T @ R compose in the kernel's FMA-free expression order,
six threefry uniforms per particle at counter `r * n_total + global_lane`
(the jax.random stream), Rz @ Ry @ Rx noise, lanes 0/1 pinned, then the
marker-major greedy weight of kernel E (`pf.weight_kernel`).  With
`want_pairs` it also returns each particle's greedy pairs and pair count
(the reference's straight variant, #4).  The reference's folded variant
(#3) is a TPU layout of the same computation (its tests pin folded ==
straight bit for bit), so `use_folded_pf_kernel` selects nothing here:
both settings run kernel B.  Kernel C ports `bank_top_pin` ->
`gather_soa` -> `bank_restore_pin` as one gather.

Kernel B's parameter vector (float32, on the bank's device):
  lr[32] (left 4x4 | right 4x4) | pin[32] (current | predicted pose)
  | prop[12] ([lo, hi] per noise row) | scal[8] (fx fy cx cy tol_pf
  tol_init num_markers_score 0) | mark[4M] (xyz per marker | 0 or 3e37)
  | dets[3K] (xy per detection | 0 or 3e37) | downg[M] (0 or 2)
"""

from __future__ import annotations

import torch

from ..utils import cuda_lib, prng
from .soa import compose_const_left, compose_const_right, noisy_rows, rotation_entries
from .weight_kernel import check_card_shape, pack_weight_params, weight_plain


def n_params(m: int, k: int) -> int:
    return 84 + 4 * m + 3 * k + m


def pack_params(left, right, current_pose, predicted_pose, lo, hi, scal, markers_h, marker_mask,
                det_xy, det_mask, downgrade) -> torch.Tensor:
    """Build kernel B's parameter vector from tensors on one device."""
    dev = det_xy.device
    f = lambda t: t.to(device=dev, dtype=torch.float32).reshape(-1)
    prop = torch.stack([f(lo), f(hi)], dim=1).reshape(-1)
    return torch.cat([
        f(left), f(right), f(current_pose), f(predicted_pose), prop,
        pack_weight_params(scal, markers_h, marker_mask, det_xy, det_mask, downgrade),
    ])


def propagate_plain(bank16: torch.Tensor, lr: torch.Tensor, pin: torch.Tensor,
                    prop: torch.Tensor, keys4, lane_offset: int = 0,
                    n_total: int | None = None) -> torch.Tensor:
    """The propagate half of kernel B with the Pallas kernel's semantics:
    base = L @ T @ R always composed (identity L / R when not tracking),
    six uniforms per particle from the threefry stream at counter
    `r * n_total + global_lane`, Rz @ Ry @ Rx noise, lanes 0 / 1 pinned.

    lr: (32,) left | right 4x4; pin: (32,) current | predicted pose;
    prop: (12,) [lo, hi] per noise row (3 angles, 3 translations);
    keys4: (k_rot0, k_rot1, k_trans0, k_trans1)."""
    n = bank16.shape[1]
    n_total = n if n_total is None else n_total
    base = compose_const_left(lr[:16].reshape(4, 4),
                              compose_const_right(bank16, lr[16:].reshape(4, 4)))
    glane = torch.arange(n, device=bank16.device, dtype=torch.int64) + lane_offset
    nz = []
    for row in range(6):
        key = keys4[0:2] if row < 3 else keys4[2:4]
        r = row if row < 3 else row - 3
        u = prng.uniform_at(key, (r * n_total + glane) & prng.MASK)
        lo, hi = prop[2 * row], prop[2 * row + 1]
        nz.append(torch.maximum(lo, u * (hi - lo) + lo))
    rows = noisy_rows(base, rotation_entries(nz[0], nz[1], nz[2]), nz[3:])
    return torch.stack([torch.where(glane == 1, pin[16 + i], torch.where(glane == 0, pin[i], v))
                        for i, v in enumerate(rows)])


def pf_step_plain(bank16: torch.Tensor, prm: torch.Tensor, keys4, m: int, k: int,
                  lane_offset: int = 0, n_total: int | None = None, want_pairs: bool = False):
    """Plain twin of `pf_step`: same expressions, same order, same draws."""
    bank_out = propagate_plain(bank16, prm[0:32], prm[32:64], prm[64:76], keys4, lane_offset,
                               n_total)
    w, pairs, n_corr = weight_plain(bank_out, prm[76:], m, k)
    return (bank_out, w, pairs, n_corr) if want_pairs else (bank_out, w)


def pf_step(bank16: torch.Tensor, prm: torch.Tensor, keys4, m: int, k: int,
            lane_offset: int = 0, n_total: int | None = None, want_pairs: bool = False):
    """One fused propagate+weight pass over a (16, N) bank -> (bank16', w (N,)),
    with `want_pairs` -> (bank16', w, pairs (M, 2, N) int32, n_corr (N,)
    int32).  Kernels #3 and #4 of the port (B).  keys4 = (k_rot0, k_rot1,
    k_trans0, k_trans1)."""
    if bank16.dtype != torch.float32 or bank16.dim() != 2 or bank16.shape[0] != 16:
        raise ValueError("pf_step: bank must be a (16, N) float32 tensor")
    if prm.dtype != torch.float32 or prm.numel() != n_params(m, k):
        raise ValueError(f"pf_step: params must hold {n_params(m, k)} float32 values")
    n = bank16.shape[1]
    n_total = n if n_total is None else n_total
    if bank16.device.type == "cpu":
        return pf_step_plain(bank16, prm, keys4, m, k, lane_offset, n_total, want_pairs)
    cuda_lib.require_cuda("pf_step", bank16, prm)
    check_card_shape("pf_step", m, k)
    lib = cuda_lib.library()
    dev = bank16.device
    out = torch.empty_like(bank16)
    w = torch.empty(n, dtype=torch.float32, device=dev)
    pairs = torch.empty((m, 2, n), dtype=torch.int32, device=dev) if want_pairs else None
    n_corr = torch.empty(n, dtype=torch.int32, device=dev) if want_pairs else None
    code = lib.pfmpe_pf_step(bank16.data_ptr(), prm.data_ptr(), n, m, k, *(int(x) for x in keys4),
                             lane_offset, n_total, out.data_ptr(), w.data_ptr(),
                             pairs.data_ptr() if want_pairs else None,
                             n_corr.data_ptr() if want_pairs else None,
                             cuda_lib.stream_ptr(bank16))
    if want_pairs:
        pf_step.pairs_launches += 1
    else:
        pf_step.launches += 1
    cuda_lib.check(code, "pfmpe_pf_step")
    return (out, w, pairs, n_corr) if want_pairs else (out, w)


pf_step.launches = 0  # weights only (the tracker's kernel B)
pf_step.pairs_launches = 0  # with pairs (the straight variant's output, #4)


def step_params(key, current_pose, predicted_pose, prediction_matrix, cam_move_inv, noise,
                fac_trans, fac_rot, tracking: bool, apply_prediction: bool, inflation: float,
                camera, markers_h, marker_mask, det_xy, det_mask, tol_pf, tol_init, downgrade,
                num_markers_score=None):
    """One PF pass's arguments as kernel B takes them -> (prm, keys4).  They
    do not depend on the lanes, so a sharded pass builds them once."""
    dev = det_xy.device
    f = lambda v: torch.as_tensor(v, dtype=torch.float32).to(dev)
    k_rot, k_trans = prng.split(key)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    left = f(cam_move_inv) if tracking else eye
    right = f(prediction_matrix) if (tracking and apply_prediction) else eye
    infl = f(inflation)
    three = torch.ones(3, dtype=torch.float32, device=dev)
    lo = torch.cat([f(noise.min_angular) * three * f(fac_rot) * infl,
                    f(noise.min_translation) * three * f(fac_trans) * infl])
    hi = torch.cat([f(noise.max_angular) * three * f(fac_rot) * infl,
                    f(noise.max_translation) * three * f(fac_trans) * infl])
    if num_markers_score is None:
        num_markers_score = torch.sum(marker_mask.float())
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    scal = torch.stack([f(camera.fx), f(camera.fy), f(camera.cx), f(camera.cy), f(tol_pf),
                        f(tol_init), f(num_markers_score), zero])
    prm = pack_params(left, right, current_pose, predicted_pose, lo, hi, scal, markers_h,
                      marker_mask, det_xy, det_mask, downgrade)
    return prm, (*k_rot, *k_trans)


def fused_propagate_weight(key, resampled16, current_pose, predicted_pose, prediction_matrix,
                           cam_move_inv, noise, fac_trans, fac_rot, tracking: bool,
                           apply_prediction: bool, inflation: float, camera, markers_h,
                           marker_mask, det_xy, det_mask, tol_pf, tol_init, downgrade,
                           num_markers_score=None, want_pairs: bool = True,
                           lane_offset: int = 0, n_total: int | None = None):
    """Counterpart of the reference's `fused_propagate_weight_pallas` (either
    variant: `folded` has no counterpart on the card) -> (bank16, weights,
    pairs (M, 2, N), n_corr (N,)), or (bank16, weights) with
    want_pairs=False.  A shard of a bank of `n_total` lanes passes the
    global index of its first lane as `lane_offset`: draws and the lane 0 / 1
    pins go by global lane."""
    prm, keys4 = step_params(key, current_pose, predicted_pose, prediction_matrix, cam_move_inv,
                             noise, fac_trans, fac_rot, tracking, apply_prediction, inflation,
                             camera, markers_h, marker_mask, det_xy, det_mask, tol_pf, tol_init,
                             downgrade, num_markers_score)
    return pf_step(resampled16.contiguous(), prm, keys4, markers_h.shape[0], det_xy.shape[0],
                   lane_offset, n_total, want_pairs)


def resample_gather_plain(bank16: torch.Tensor, anc: torch.Tensor) -> torch.Tensor:
    """Plain twin of `resample_gather`."""
    n = anc.shape[0]
    top = bank16[:12].index_select(1, anc)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=bank16.dtype,
                          device=bank16.device)[:, None].expand(4, n)
    return torch.cat([top, bottom])


def resample_gather(bank16: torch.Tensor, anc: torch.Tensor) -> torch.Tensor:
    """out[r, t] = bank16[r, anc[t]] for r < 12, rows 12-15 = (0, 0, 0, 1).
    Kernel #5/#6 of the port (with the gather between them)."""
    if bank16.dtype != torch.float32 or bank16.dim() != 2 or bank16.shape[0] != 16:
        raise ValueError("resample_gather: bank must be a (16, N) float32 tensor")
    if anc.dtype != torch.int64 or anc.dim() != 1:
        raise ValueError("resample_gather: ancestors must be a 1-D int64 tensor")
    if bank16.device.type == "cpu":
        return resample_gather_plain(bank16, anc)
    cuda_lib.require_cuda("resample_gather", bank16, anc)
    lib = cuda_lib.library()
    n = anc.shape[0]
    out = torch.empty((16, n), dtype=torch.float32, device=bank16.device)
    code = lib.pfmpe_resample_gather(bank16.data_ptr(), anc.data_ptr(), n, out.data_ptr(),
                                     cuda_lib.stream_ptr(bank16))
    resample_gather.launches += 1
    cuda_lib.check(code, "pfmpe_resample_gather")
    return out


resample_gather.launches = 0
