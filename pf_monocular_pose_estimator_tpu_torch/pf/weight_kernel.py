"""PF weight kernel E (csrc/pf_weight.cu) and its plain PyTorch version.

Kernel E ports `pf/pallas_weight.py::weight_particles_pallas` with its
semantics: the marker-major (m * K + k) M x K distance volume with the
3e37 sentinel added on masked cells, M rounds of greedy first-minimum
matching, score `nms + ((tol_init - d) / tol_init)**2` minus reuse and
downgrade penalties, and per step the (marker, detection) pair (-1 where
none formed) plus the pair count.  Kernel B (`pf.step_kernel`) runs the
same weight after its propagation; `weight_plain` is the plain version of
both.

The weight parameter vector (float32, on the bank's device) is the tail of
kernel B's:
  scal[8] (fx fy cx cy tol_pf tol_init num_markers_score 0)
  | mark[4M] (xyz per marker | 0 or 3e37) | dets[3K] (xy per detection |
  0 or 3e37) | downg[M] (0 or 2)
"""

from __future__ import annotations

import torch

from ..utils import cuda_lib

BIG = 3.0e37  # distance sentinel of masked cells (reference pf/pallas_weight.py::_BIG)
# What kernels B and E take on the card (csrc/pf_common.cuh kMaxK, kMaxM):
# every 1 <= K <= MAX_DETECTIONS and 1 <= M <= MAX_MARKERS.  K = 16 with
# 3 <= M <= 8 runs the specialised form, every other shape the wide form.
MAX_DETECTIONS = 128
MAX_MARKERS = 32


def check_card_shape(name: str, m: int, k: int) -> None:
    """Raise unless kernels B and E take M = m markers and K = k detections."""
    if not (1 <= k <= MAX_DETECTIONS and 1 <= m <= MAX_MARKERS):
        raise ValueError(f"{name}: the kernel takes 1 <= K <= {MAX_DETECTIONS} detections and "
                         f"1 <= M <= {MAX_MARKERS} markers (got K = {k}, M = {m})")


def n_weight_params(m: int, k: int) -> int:
    return 8 + 4 * m + 3 * k + m


def pack_weight_params(scal, markers_h, marker_mask, det_xy, det_mask, downgrade) -> torch.Tensor:
    """Build the weight parameter vector from tensors on one device."""
    dev = det_xy.device
    f = lambda t: t.to(device=dev, dtype=torch.float32).reshape(-1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    big = torch.full((), BIG, dtype=torch.float32, device=dev)
    return torch.cat([
        f(scal), f(markers_h[:, :3]), torch.where(marker_mask.to(dev), zero, big),
        f(det_xy), torch.where(det_mask.to(dev), zero, big),
        torch.where(downgrade.to(dev), torch.full_like(zero, 2.0), zero),
    ])


def weight_plain(bank16: torch.Tensor, wprm: torch.Tensor, m: int, k: int):
    """Plain version of `weight` (and of kernel B's weight half): the same
    expressions in the same order -> (w (N,), pairs (M, 2, N) int32,
    n_corr (N,) int32)."""
    n = bank16.shape[1]
    dev = bank16.device
    scal, mark = wprm[0:8], wprm[8:8 + 4 * m]
    dets, downg = wprm[8 + 4 * m:8 + 4 * m + 3 * k], wprm[8 + 4 * m + 3 * k:]
    rows = bank16
    fx, fy, cx, cy, tol_pf, tol_init, nms = (scal[i] for i in range(7))
    dist = []
    for mi in range(m):
        mx, my, mz = mark[3 * mi], mark[3 * mi + 1], mark[3 * mi + 2]
        mbig = mark[3 * m + mi]
        xc = rows[0] * mx + rows[1] * my + rows[2] * mz + rows[3]
        yc = rows[4] * mx + rows[5] * my + rows[6] * mz + rows[7]
        zc = rows[8] * mx + rows[9] * my + rows[10] * mz + rows[11]
        safe_z = torch.where(torch.abs(zc) < 1e-12, torch.full_like(zc, 1e-12), zc)
        u = fx * xc / safe_z + cx
        v = fy * yc / safe_z + cy
        for ki in range(k):
            du = dets[2 * ki] - u
            dv = dets[2 * ki + 1] - v
            dist.append(du * du + dv * dv + dets[2 * k + ki] + mbig)
    dist = torch.stack(dist)  # (M*K, N)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    big = torch.full((), BIG, dtype=torch.float32, device=dev)
    minus1 = torch.full((), -1, dtype=torch.int32, device=dev)
    weights = torch.zeros(n, dtype=torch.float32, device=dev)
    nself = torch.ones(n, dtype=torch.float32, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    used = torch.zeros((k, n), dtype=torch.float32, device=dev)
    pairs = torch.empty((m, 2, n), dtype=torch.int32, device=dev)
    m_of_row = (torch.arange(m * k, device=dev) // k)[:, None]
    for step in range(m):
        minv = torch.min(dist, dim=0).values
        idx = torch.argmax((dist == minv[None]).to(torch.int32), dim=0)  # first minimum
        m_sel = idx // k
        k_sel = idx - m_sel * k
        d = torch.sqrt(torch.clamp(minv, min=0.0))
        ok = (d <= tol_pf) & ~done
        done = done | ~ok
        q = (tol_init - d) / tol_init
        score = nms + q * q
        reused = torch.gather(used, 0, k_sel[None])[0]
        occ_hit = ok & (reused > 0.0)
        penal_occ = torch.where(occ_hit, 3.0 * nself, zero)
        nself = nself + torch.where(occ_hit, one, zero)
        penal_down = torch.where(ok, downg[m_sel], zero)
        weights = weights + torch.where(ok, score, zero) - penal_occ - penal_down
        pairs[step, 0] = torch.where(ok, m_sel.to(torch.int32), minus1)
        pairs[step, 1] = torch.where(ok, k_sel.to(torch.int32), minus1)
        used = used + ((torch.arange(k, device=dev)[:, None] == k_sel[None]) & ok[None]).float()
        dist = torch.where((m_of_row == m_sel[None]) & ok[None], big, dist)
    n_corr = torch.sum((pairs[:, 0] >= 0).to(torch.int32), dim=0, dtype=torch.int32)
    return weights, pairs, n_corr


def weight(bank16: torch.Tensor, wprm: torch.Tensor, m: int, k: int):
    """Weights, greedy pairs and pair counts of a (16, N) bank ->
    (w (N,), pairs (M, 2, N) int32, n_corr (N,) int32).  Kernel #9 of the
    port (E)."""
    if bank16.dtype != torch.float32 or bank16.dim() != 2 or bank16.shape[0] != 16:
        raise ValueError("weight: bank must be a (16, N) float32 tensor")
    if wprm.dtype != torch.float32 or wprm.numel() != n_weight_params(m, k):
        raise ValueError(f"weight: params must hold {n_weight_params(m, k)} float32 values")
    if bank16.device.type == "cpu":
        return weight_plain(bank16, wprm, m, k)
    cuda_lib.require_cuda("weight", bank16, wprm)
    check_card_shape("weight", m, k)
    lib = cuda_lib.library()
    n = bank16.shape[1]
    dev = bank16.device
    w = torch.empty(n, dtype=torch.float32, device=dev)
    pairs = torch.empty((m, 2, n), dtype=torch.int32, device=dev)
    n_corr = torch.empty(n, dtype=torch.int32, device=dev)
    code = lib.pfmpe_pf_weight(bank16.data_ptr(), wprm.data_ptr(), n, m, k, w.data_ptr(),
                               pairs.data_ptr(), n_corr.data_ptr(), cuda_lib.stream_ptr(bank16))
    weight.launches += 1
    cuda_lib.check(code, "pfmpe_pf_weight")
    return w, pairs, n_corr


weight.launches = 0


def weight_particles_bank(camera, bank16, markers_h, marker_mask, det_xy, det_mask, tol_pf,
                          tol_init, downgrade, num_markers_score=None):
    """Counterpart of the reference's `weight_particles_pallas` ->
    (weights (N,), pairs (M, 2, N) int32, n_corr (N,) int32)."""
    dev = bank16.device
    f = lambda v: torch.as_tensor(v, dtype=torch.float32).to(dev)
    if num_markers_score is None:
        num_markers_score = torch.sum(marker_mask.float())
    scal = torch.stack([f(camera.fx), f(camera.fy), f(camera.cx), f(camera.cy), f(tol_pf),
                        f(tol_init), f(num_markers_score), torch.zeros((), device=dev)])
    wprm = pack_weight_params(scal, markers_h, marker_mask, det_xy, det_mask, downgrade)
    return weight(bank16.contiguous(), wprm, markers_h.shape[0], det_xy.shape[0])
