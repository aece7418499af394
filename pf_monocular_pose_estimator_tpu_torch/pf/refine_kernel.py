"""Batched Gauss-Newton kernel D (csrc/gn_refine.cu), the fused refine
that runs it inside the track branch's whole refine layer, and their plain
versions.

Kernel D ports `pf/pallas_refine.py::gauss_newton_refine_pallas`: every
hypothesis runs the full iteration budget with a convergence mask, the
Jacobi-scaled block-Schur solve of `_solve6_rows`, the exp map of
`_exp_se3_rows`, then the final normal matrix, largest residual and
divergence revert.  Sums over the M pairs run in index order on both sides.
The covariance (`inv6_spd`) is computed outside the kernel, as in the
reference.

`refine_frame` is one launch of the refine layer (`tracker/step.py::
refine_hypotheses` op by op): the picked particle's greedy pairs, its 2M + 1
binding hypotheses, D's iterations on each, the feasibility pick, the jump
test and teleport guard, and the picked hypothesis's covariance.

`refine_pose` is one launch of the refine that `pf/refine.py::
gauss_newton_refine` runs op by op for the init branch and the IPE track
branch (one pose, given pairs), with the pairs' gather and the covariance,
in that function's arithmetic to the bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import cuda_lib
from .refine import RefineResult, gauss_newton_refine, inv6_spd
from .weight_kernel import MAX_DETECTIONS, MAX_MARKERS

DAMPING = 1e-8
EPS_THETA = 1e-8


def _seq_sum(terms):
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _normal_eqs(p, mx, my, mz, du, dv, mask, fx, fy, cx, cy):
    """p: 16 x (B,) pose entries; marker/pair data per pair q: (B,) or 0-d."""
    m = len(mx)
    ju, jv, ru, rv = [], [], [], []
    one = torch.ones((), dtype=torch.float32, device=fx.device)
    for q in range(m):
        pcx = p[0] * mx[q] + p[1] * my[q] + p[2] * mz[q] + p[3]
        pcy = p[4] * mx[q] + p[5] * my[q] + p[6] * mz[q] + p[7]
        pcz = p[8] * mx[q] + p[9] * my[q] + p[10] * mz[q] + p[11]
        z = torch.where(torch.abs(pcz) < 1e-12, torch.full_like(pcz, 1e-12), pcz)
        u = fx * pcx / z + cx
        v = fy * pcy / z + cy
        ru.append((du[q] - u) * mask[q])
        rv.append((dv[q] - v) * mask[q])
        iz = one / z
        x_z = pcx * iz
        y_z = pcy * iz
        zero = torch.zeros_like(z)
        ju.append([j * mask[q] for j in (fx * iz, zero, -fx * x_z * iz, -fx * x_z * y_z,
                                         fx * (1.0 + x_z * x_z), -fx * y_z)])
        jv.append([j * mask[q] for j in (zero, fy * iz, -fy * y_z * iz, -fy * (1.0 + y_z * y_z),
                                         fy * x_z * y_z, fy * x_z)])
    a = {}
    for i in range(6):
        for j in range(i, 6):
            a[(i, j)] = _seq_sum([ju[q][i] * ju[q][j] + jv[q][i] * jv[q][j] for q in range(m)])
    b = [_seq_sum([ju[q][i] * ru[q] + jv[q][i] * rv[q] for q in range(m)]) for i in range(6)]
    err = _seq_sum([ru[q] * ru[q] + rv[q] * rv[q] for q in range(m)])
    return a, b, err, ru, rv


def _inv3sym(m00, m01, m02, m11, m12, m22):
    c00 = m11 * m22 - m12 * m12
    c01 = -(m01 * m22 - m12 * m02)
    c02 = m01 * m12 - m11 * m02
    c11 = m00 * m22 - m02 * m02
    c12 = -(m00 * m12 - m01 * m02)
    c22 = m00 * m11 - m01 * m01
    det = m00 * c00 + m01 * c01 + m02 * c02
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    inv = torch.ones_like(det) / det
    return [[c00 * inv, c01 * inv, c02 * inv], [c01 * inv, c11 * inv, c12 * inv],
            [c02 * inv, c12 * inv, c22 * inv]]


def _solve6(a, b):
    s = [torch.ones_like(a[(i, i)]) / torch.sqrt(torch.clamp(torch.abs(a[(i, i)]), min=1e-30))
         for i in range(6)]

    def ah(i, j):
        i, j = (i, j) if i <= j else (j, i)
        return a[(i, j)] * s[i] * s[j]

    bh = [b[i] * s[i] for i in range(6)]
    q = [[ah(i, 3 + j) for j in range(3)] for i in range(3)]
    pi = _inv3sym(ah(0, 0), ah(0, 1), ah(0, 2), ah(1, 1), ah(1, 2), ah(2, 2))
    zero = torch.zeros_like(bh[0])
    w = [[_seq_sum([zero] + [q[k][i] * pi[k][j] for k in range(3)]) for j in range(3)]
         for i in range(3)]
    sc = [[ah(3 + i, 3 + j) - _seq_sum([zero] + [w[i][k] * q[k][j] for k in range(3)])
           for j in range(3)] for i in range(3)]
    si = _inv3sym(sc[0][0], sc[0][1], sc[0][2], sc[1][1], sc[1][2], sc[2][2])
    b1, b2 = bh[:3], bh[3:]
    rhs2 = [b2[i] - _seq_sum([zero] + [w[i][k] * b1[k] for k in range(3)]) for i in range(3)]
    x2 = [_seq_sum([zero] + [si[i][k] * rhs2[k] for k in range(3)]) for i in range(3)]
    rhs1 = [b1[i] - _seq_sum([zero] + [q[i][k] * x2[k] for k in range(3)]) for i in range(3)]
    x1 = [_seq_sum([zero] + [pi[i][k] * rhs1[k] for k in range(3)]) for i in range(3)]
    return [(x1 + x2)[i] * s[i] for i in range(6)]


def _exp_rows(dt):
    rx, ry, rz, wx, wy, wz = dt
    dev = wx.device
    c = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    th2 = wx * wx + wy * wy + wz * wz
    theta = torch.sqrt(torch.clamp(th2, min=0.0))
    small = th2 < EPS_THETA
    safe_t = torch.where(small, torch.ones_like(theta), theta)
    sin_t, cos_t = torch.sin(safe_t), torch.cos(safe_t)
    a = torch.where(small, 1.0 - th2 / c(6.0), sin_t / safe_t)
    b = torch.where(small, 0.5 - th2 / c(24.0), (1.0 - cos_t) / torch.clamp(th2, min=EPS_THETA))
    cc = torch.where(small, c(1.0) / c(6.0) - th2 / c(120.0),
                     (safe_t - sin_t) / torch.clamp(th2 * safe_t, min=EPS_THETA))
    wxx, wyy, wzz = wx * wx, wy * wy, wz * wz
    wxy, wxz, wyz = wx * wy, wx * wz, wy * wz
    r = [1.0 + b * (wxx - th2), -a * wz + b * wxy, a * wy + b * wxz,
         a * wz + b * wxy, 1.0 + b * (wyy - th2), -a * wx + b * wyz,
         -a * wy + b * wxz, a * wx + b * wyz, 1.0 + b * (wzz - th2)]
    v = [1.0 + cc * (wxx - th2), -b * wz + cc * wxy, b * wy + cc * wxz,
         b * wz + cc * wxy, 1.0 + cc * (wyy - th2), -b * wx + cc * wyz,
         -b * wy + cc * wxz, b * wx + cc * wyz, 1.0 + cc * (wzz - th2)]
    t = [v[3 * i] * rx + v[3 * i + 1] * ry + v[3 * i + 2] * rz for i in range(3)]
    return [r[0], r[1], r[2], t[0], r[3], r[4], r[5], t[1], r[6], r[7], r[8], t[2]]


def gn_refine_plain(scal, poses, mark, du, dv, mask, max_iterations: int, tol: float):
    """Plain twin of `gn_refine`; same inputs, same outputs."""
    fx, fy, cx, cy = (scal[i] for i in range(4))
    m = mark.shape[1]
    mx, my, mz = ([mark[r, q] for q in range(m)] for r in range(3))
    duq, dvq, mq = ([x[:, q] for q in range(m)] for x in (du, dv, mask))
    args = (mx, my, mz, duq, dvq, mq, fx, fy, cx, cy)
    p0 = [poses[:, i] for i in range(16)]
    _, _, err0, _, _ = _normal_eqs(p0, *args)
    p = list(p0)
    done = torch.zeros_like(err0)
    n_iter = torch.zeros_like(err0)
    one = torch.ones((), dtype=torch.float32, device=poses.device)
    zero = torch.zeros((), dtype=torch.float32, device=poses.device)
    for _ in range(max_iterations):
        a, b, _, _, _ = _normal_eqs(p, *args)
        for i in range(6):
            a[(i, i)] = a[(i, i)] + DAMPING
        dt = _solve6(a, b)
        dt = [torch.where((d == d) & (torch.abs(d) < 1e30), d, zero) for d in dt]
        e = _exp_rows(dt)
        newp = []
        for r in range(3):
            er = e[4 * r : 4 * r + 4]
            for c in range(3):
                newp.append(er[0] * p[c] + er[1] * p[4 + c] + er[2] * p[8 + c])
            newp.append(er[0] * p[3] + er[1] * p[7] + er[2] * p[11] + er[3])
        newp += p[12:16]
        step = torch.abs(dt[0])
        for d in dt[1:]:
            step = torch.maximum(step, torch.abs(d))
        now_done = torch.maximum(done, torch.where(step <= tol, one, zero))
        frozen = done > 0
        p = [torch.where(frozen, p[i], newp[i]) for i in range(16)]
        n_iter = n_iter + (1.0 - done)
        done = now_done
    a_f, _, err_f, ru, rv = _normal_eqs(p, *args)
    resid = [torch.sqrt(ru[q] * ru[q] + rv[q] * rv[q]) for q in range(m)]
    max_resid = resid[0]
    for r in resid[1:]:
        max_resid = torch.maximum(max_resid, r)
    diverged = err_f > err0
    out_pose = torch.stack([torch.where(diverged, p0[i], p[i]) for i in range(16)], dim=1)
    stats = torch.stack([err0, torch.where(diverged, err0, err_f), n_iter, max_resid, done,
                         diverged.float(), torch.zeros_like(err0), torch.zeros_like(err0)], dim=1)
    amat = torch.stack([a_f[(min(i, j), max(i, j))] for i in range(6) for j in range(6)], dim=1)
    return out_pose, stats, amat


def gn_refine(scal, poses, mark, du, dv, mask, max_iterations: int = 25, tol: float = 1e-4):
    """Batched GN over B hypotheses.  Kernel #8 of the port.

    scal (>= 4,) [fx, fy, cx, cy]; poses (B, 16); mark (3, M); du, dv,
    mask (B, M) -> (poses (B, 16), stats (B, 8) [err0, err, n_iter,
    max_resid, converged, diverged, 0, 0], normal matrix (B, 36))."""
    tensors = (scal, poses, mark, du, dv, mask)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("gn_refine: all inputs must be float32")
    b, m = du.shape
    if poses.shape != (b, 16) or mark.shape != (3, m) or dv.shape != (b, m) or mask.shape != (b, m):
        raise ValueError("gn_refine: inconsistent shapes")
    if poses.device.type == "cpu":
        return gn_refine_plain(scal, poses, mark, du, dv, mask, max_iterations, tol)
    cuda_lib.require_cuda("gn_refine", *tensors)
    if not 1 <= m <= MAX_MARKERS:
        raise ValueError(f"gn_refine: the kernel takes 1 <= M <= {MAX_MARKERS} markers (got {m})")
    lib = cuda_lib.library()
    dev = poses.device
    out_pose = torch.empty((b, 16), dtype=torch.float32, device=dev)
    stats = torch.empty((b, 8), dtype=torch.float32, device=dev)
    amat = torch.empty((b, 36), dtype=torch.float32, device=dev)
    code = lib.pfmpe_gn_refine(scal.data_ptr(), poses.data_ptr(), mark.data_ptr(), du.data_ptr(),
                               dv.data_ptr(), mask.data_ptr(), b, m, max_iterations, float(tol),
                               out_pose.data_ptr(), stats.data_ptr(), amat.data_ptr(),
                               cuda_lib.stream_ptr(poses))
    gn_refine.launches += 1
    cuda_lib.check(code, "pfmpe_gn_refine")
    return out_pose, stats, amat


gn_refine.launches = 0


def gauss_newton_refine_batched(camera, poses0: torch.Tensor, markers_h: torch.Tensor,
                                det_xy: torch.Tensor, dfm: torch.Tensor, corr_mask: torch.Tensor,
                                max_iterations: int = 25, convergence_tol: float = 1e-4
                                ) -> RefineResult:
    """Counterpart of `gauss_newton_refine_pallas`: poses0 (B, 4, 4), dfm
    (B, M) detection index per marker (-1 unbound), corr_mask (B, M)."""
    dev = poses0.device
    b = dfm.shape[0]
    scal = torch.stack([camera.fx, camera.fy, camera.cx, camera.cy]).to(dev, torch.float32)
    mark = markers_h[:, :3].T.contiguous().float()
    d_idx = torch.clamp(dfm.long(), 0, det_xy.shape[0] - 1)
    du = det_xy[:, 0][d_idx].contiguous()
    dv = det_xy[:, 1][d_idx].contiguous()
    out_pose, stats, amat = gn_refine(scal, poses0.reshape(b, 16).contiguous().float(), mark, du,
                                      dv, corr_mask.float().contiguous(), max_iterations,
                                      convergence_tol)
    eye = torch.eye(6, dtype=torch.float32, device=dev) * DAMPING
    return RefineResult(
        pose=out_pose.reshape(b, 4, 4),
        covariance=inv6_spd(amat.reshape(b, 6, 6) + eye),
        num_iterations=stats[:, 2].to(torch.int32),
        final_error=stats[:, 1],
        initial_error=stats[:, 0],
        converged=stats[:, 4] > 0,
        max_residual=stats[:, 3],
    )


# weight_particles' distance of a masked cell, and the alternative search's
CAP = torch.finfo(torch.float32).max / 4
FAR = 1e12


class FrameRefine(NamedTuple):
    """`refine_frame`'s result: the published pose (4, 4), its covariance
    (6, 6), the picked hypothesis's iterations (int32) and the jump flag
    (bool); `info` (4,) int32 holds [iterations, picked hypothesis, any
    feasible, teleported]."""

    pose: torch.Tensor
    covariance: torch.Tensor
    num_iterations: torch.Tensor
    jump: torch.Tensor
    info: torch.Tensor


def frame_hypotheses(scal, pre_gn, mark, marker_mask, det_xy, det_mask, tol_pf,
                     hypotheses: bool = True) -> torch.Tensor:
    """Steps 1-2 of `refine_frame_plain`: pre_gn's greedy pairs (each
    column's least distance and first detection, then M steps of the least
    column, the first in flat index k * M + m) and the hypotheses built from
    them -> (2M + 1 or 1, M) int64 detection per marker (-1 unbound)."""
    dev = pre_gn.device
    p = pre_gn.reshape(16)
    m, k = mark.shape[1], det_xy.shape[0]
    fx, fy, cx, cy = (scal[i] for i in range(4))
    pcx = p[0] * mark[0] + p[1] * mark[1] + p[2] * mark[2] + p[3] * mark[3]
    pcy = p[4] * mark[0] + p[5] * mark[1] + p[6] * mark[2] + p[7] * mark[3]
    pcz = p[8] * mark[0] + p[9] * mark[1] + p[10] * mark[2] + p[11] * mark[3]
    z = torch.where(torch.abs(pcz) < 1e-12, torch.full_like(pcz, 1e-12), pcz)
    u = fx * pcx / z + cx
    v = fy * pcy / z + cy
    dx = det_xy[:, 0, None] - u[None, :]
    dy = det_xy[:, 1, None] - v[None, :]
    d2 = dx * dx + dy * dy  # (K, M)
    cap = torch.full((), CAP, dtype=torch.float32, device=dev)
    cells = torch.where(det_mask[:, None] & marker_mask[None, :], d2, cap)
    cmin = torch.min(cells, dim=0).values
    ck = torch.argmax((cells == cmin[None]).to(torch.int32), dim=0)
    done = torch.any(torch.isnan(cells))  # torch.min's NaN fails the first step
    iota = torch.arange(m, device=dev)
    dfm = torch.full((m,), -1, dtype=torch.int64, device=dev)
    for _ in range(m):
        best = torch.min(cmin)
        flat = torch.min(torch.where(cmin == best, ck * m + iota, m * k))
        ok = (torch.sqrt(best) <= tol_pf) & ~done
        done = done | ~ok
        hit = (iota == flat % m) & ok
        dfm = torch.where(hit, torch.maximum(dfm, flat // m), dfm)
        cmin = torch.where(hit, cap, cmin)
        ck = torch.where(hit, 0, ck)
    if not hypotheses:
        return dfm[None]
    bound = torch.clamp(dfm, 0, k - 1)
    slots = torch.arange(k, device=dev)
    far = torch.full((), FAR, dtype=torch.float32, device=dev)
    d2a = torch.where(det_mask[:, None] & (slots[:, None] != bound[None, :]), d2, far)
    amin = torch.min(d2a, dim=0).values
    alt = torch.argmax((d2a == amin[None]).to(torch.int32), dim=0)
    alt = torch.where((amin <= tol_pf * tol_pf) & (dfm >= 0), alt, dfm)
    eye = torch.eye(m, dtype=torch.bool, device=dev)
    swap = torch.where(eye, alt[None, :], dfm[None, :])
    drop = torch.where(eye, -1, dfm[None, :])
    return torch.cat([dfm[None], swap, drop])


def _dist3(a, b):
    d = a[..., :3, 3] - b[:3, 3]
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])


def refine_frame_plain(scal, pre_gn, mark, marker_mask, det_xy, det_mask, tol_pf, jump_threshold,
                       predicted, pred_trustworthy, max_iterations: int = 25,
                       convergence_tol: float = 1e-4, residual_gate: float = 1.5,
                       step_radius: float = 0.08, jump_radius: float = 0.0,
                       hypotheses: bool = True) -> FrameRefine:
    """Plain twin of `refine_frame`; same inputs, same outputs, the same
    expressions in the kernel's order but the covariance: `inv6_spd` of every
    hypothesis, then the pick, as the layer op by op computes it.  On the card
    that is the kernel's covariance to the bit where there is more than one
    hypothesis (a batch of one takes another cuBLAS path)."""
    dev = pre_gn.device
    pre = pre_gn.reshape(4, 4)
    dfm_h = frame_hypotheses(scal, pre, mark, marker_mask, det_xy, det_mask, tol_pf, hypotheses)
    n_h = dfm_h.shape[0]
    masks = (dfm_h >= 0) & marker_mask[None, :]
    idx = torch.clamp(dfm_h, 0, det_xy.shape[0] - 1)
    poses, stats, amat = gn_refine_plain(
        scal, pre.reshape(1, 16).expand(n_h, 16), mark[:3], det_xy[:, 0][idx],
        det_xy[:, 1][idx], masks.float(), max_iterations, convergence_tol)
    poses = poses.reshape(n_h, 4, 4)
    n_pairs = torch.sum(masks, dim=-1).float()
    feasible = (stats[:, 3] <= residual_gate) & (n_pairs > 0) & (_dist3(poses, pre) <= step_radius)
    pref = n_pairs - 1e-3 * torch.arange(n_h, dtype=torch.float32, device=dev)
    pref = torch.where(feasible, pref, torch.full((), float("-inf"), device=dev))
    any_feasible = torch.any(feasible)
    best = torch.where(any_feasible, torch.argmax(pref), torch.zeros((), dtype=torch.int64,
                                                                      device=dev))
    pick = lambda x: x.index_select(0, best.reshape(1))[0]
    pose = torch.where(any_feasible, pick(poses), pre)
    jump = torch.max(torch.abs(pose[:3, :3] - pre[:3, :3])) >= jump_threshold
    teleport = torch.zeros((), dtype=torch.bool, device=dev)
    if jump_radius > 0.0:
        teleport = pred_trustworthy & (_dist3(pose, predicted) > jump_radius)
        pose = torch.where(teleport, predicted, pose)
        jump = jump | teleport
    # every hypothesis's covariance, as the layer op by op computes them (the
    # kernel computes the picked one's alone, its products summed as torch's
    # batched matmul on the card sums them)
    eye = torch.eye(6, dtype=torch.float32, device=dev) * DAMPING
    cov = pick(inv6_spd(amat.reshape(n_h, 6, 6) + eye))
    n_iter = pick(stats)[2].to(torch.int32)
    info = torch.stack([n_iter, best.to(torch.int32), any_feasible.to(torch.int32),
                        teleport.to(torch.int32)])
    return FrameRefine(pose, cov, n_iter, jump, info)


def refine_frame(scal, pre_gn, mark, marker_mask, det_xy, det_mask, tol_pf, jump_threshold,
                 predicted, pred_trustworthy, max_iterations: int = 25,
                 convergence_tol: float = 1e-4, residual_gate: float = 1.5,
                 step_radius: float = 0.08, jump_radius: float = 0.0,
                 hypotheses: bool = True) -> FrameRefine:
    """The track branch's refine layer in one launch of the fused kernel.

    scal (4,) [fx, fy, cx, cy]; pre_gn (4, 4) the picked particle's pose;
    mark (4, M) the homogeneous markers as rows x, y, z, w; marker_mask (M,)
    bool; det_xy (K, 2), det_mask (K,) bool; tol_pf, jump_threshold 0-d
    float32; predicted (4, 4) and pred_trustworthy (0-d bool) for the
    teleport guard, which runs where jump_radius > 0; 2M + 1 hypotheses, or
    the base binding alone without `hypotheses`.  CPU tensors take the plain
    twin, CUDA tensors the kernel (tensors on both raise).  `.calls` counts
    every call, `.launches` the kernel's."""
    refine_frame.calls += 1
    floats = (scal, pre_gn, mark, det_xy, tol_pf, jump_threshold, predicted)
    if any(t.dtype != torch.float32 for t in floats):
        raise ValueError("refine_frame: poses, markers, detections and tolerances must be float32")
    m, k = mark.shape[1], det_xy.shape[0]
    if (scal.shape != (4,) or pre_gn.shape != (4, 4) or mark.shape != (4, m)
            or marker_mask.shape != (m,) or det_xy.shape != (k, 2) or det_mask.shape != (k,)
            or predicted.shape != (4, 4)):
        raise ValueError("refine_frame: inconsistent shapes")
    args = (scal, pre_gn, mark, marker_mask, det_xy, det_mask, tol_pf, jump_threshold, predicted,
            pred_trustworthy, max_iterations, convergence_tol, residual_gate, step_radius,
            jump_radius, hypotheses)
    tensors = (scal, pre_gn, mark, marker_mask, det_xy, det_mask, tol_pf, jump_threshold,
               predicted, pred_trustworthy)
    if all(t.device.type == "cpu" for t in tensors):
        return refine_frame_plain(*args)
    cuda_lib.require_cuda("refine_frame", *tensors)
    if not (1 <= m <= MAX_MARKERS and 1 <= k <= MAX_DETECTIONS):
        raise ValueError(f"refine_frame: the kernel takes 1 <= M <= {MAX_MARKERS} markers and "
                         f"1 <= K <= {MAX_DETECTIONS} detections (got M = {m}, K = {k})")
    if any(t.dtype != torch.bool for t in (marker_mask, det_mask, pred_trustworthy)):
        raise ValueError("refine_frame: masks and the trust flag must be bool")
    lib = cuda_lib.library()
    dev = pre_gn.device
    out = torch.empty(52, dtype=torch.float32, device=dev)
    info = torch.empty(4, dtype=torch.int32, device=dev)
    jump = torch.empty((), dtype=torch.bool, device=dev)
    flags = (1 if hypotheses else 0) | (2 if jump_radius > 0.0 else 0)
    code = lib.pfmpe_refine_frame(
        scal.data_ptr(), pre_gn.data_ptr(), mark.data_ptr(), marker_mask.data_ptr(),
        det_xy.data_ptr(), det_mask.data_ptr(), tol_pf.data_ptr(), jump_threshold.data_ptr(),
        predicted.data_ptr(), pred_trustworthy.data_ptr(), m, k, max_iterations,
        float(convergence_tol), float(residual_gate), float(step_radius), float(jump_radius),
        flags, out.data_ptr(), info.data_ptr(), jump.data_ptr(), cuda_lib.stream_ptr(pre_gn))
    refine_frame.launches += 1
    cuda_lib.check(code, "pfmpe_refine_frame")
    return FrameRefine(out[:16].view(4, 4), out[16:].view(6, 6), info[0], jump, info)


refine_frame.launches = 0
refine_frame.calls = 0


class PoseRefine(NamedTuple):
    """`refine_pose`'s result: the refined pose (4, 4), its covariance (6, 6)
    and the iterations run (0-d int32)."""

    pose: torch.Tensor
    covariance: torch.Tensor
    num_iterations: torch.Tensor


class _Pinhole(NamedTuple):
    """The camera fields `gauss_newton_refine` reads, as 0-d tensors."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor


def refine_pose_plain(scal, pose0, mark, marker_mask, det_for_marker, det_xy,
                      max_iterations: int = 25, convergence_tol: float = 1e-4) -> PoseRefine:
    """Plain twin of `refine_pose`; same inputs, same outputs: `pf/refine.py::
    gauss_newton_refine` of the one pose, the path op by op whose arithmetic
    the kernel repeats."""
    m = mark.shape[1]
    marker_ids = torch.arange(m, dtype=torch.int32, device=pose0.device)
    corr = torch.stack([marker_ids, det_for_marker.to(torch.int32)], -1)
    res = gauss_newton_refine(_Pinhole(*scal[:4]), pose0, mark.T, det_xy, corr,
                              (det_for_marker >= 0) & marker_mask, max_iterations,
                              convergence_tol)
    return PoseRefine(res.pose, res.covariance, res.num_iterations)


def refine_pose(scal, pose0, mark, marker_mask, det_for_marker, det_xy,
                max_iterations: int = 25, convergence_tol: float = 1e-4) -> PoseRefine:
    """One pose's Gauss-Newton in one launch of `refine_pose_kernel`: what
    `gauss_newton_refine` computes op by op on the card, to the bit.

    scal (4,) [fx, fy, cx, cy]; pose0 (4, 4); mark (4, M) the homogeneous
    markers as rows x, y, z, w; marker_mask (M,) bool; det_for_marker (M,)
    int32, the detection of each marker (-1 unbound); det_xy (K, 2).  A pair
    is live where its marker is unmasked and bound.  The pose, covariance and
    iterations (0-d int32) are views of one output buffer.  CPU tensors take
    the plain twin, CUDA tensors the kernel (tensors on both raise).
    `.calls` counts every call, `.launches` the kernel's."""
    refine_pose.calls += 1
    if any(t.dtype != torch.float32 for t in (scal, pose0, mark, det_xy)):
        raise ValueError("refine_pose: the camera, pose, markers and detections must be float32")
    m, k = mark.shape[1], det_xy.shape[0]
    if (scal.shape != (4,) or pose0.shape != (4, 4) or mark.shape != (4, m)
            or marker_mask.shape != (m,) or det_for_marker.shape != (m,)
            or det_xy.shape != (k, 2)):
        raise ValueError("refine_pose: inconsistent shapes")
    tensors = (scal, pose0, mark, marker_mask, det_for_marker, det_xy)
    if all(t.device.type == "cpu" for t in tensors):
        return refine_pose_plain(scal, pose0, mark, marker_mask, det_for_marker, det_xy,
                                 max_iterations, convergence_tol)
    cuda_lib.require_cuda("refine_pose", *tensors)
    if not (1 <= m <= MAX_MARKERS and k >= 1):
        raise ValueError(f"refine_pose: the kernel takes 1 <= M <= {MAX_MARKERS} markers and a "
                         f"detection slot at least (got M = {m}, K = {k})")
    if marker_mask.dtype != torch.bool or det_for_marker.dtype != torch.int32:
        raise ValueError("refine_pose: the marker mask must be bool and det_for_marker int32")
    scal, pose0, mark, marker_mask, det_for_marker, det_xy = (t.contiguous() for t in tensors)
    lib = cuda_lib.library()
    out = torch.empty(53, dtype=torch.float32, device=pose0.device)
    code = lib.pfmpe_refine_pose(scal.data_ptr(), pose0.data_ptr(), mark.data_ptr(),
                                 marker_mask.data_ptr(), det_for_marker.data_ptr(),
                                 det_xy.data_ptr(), m, k, max_iterations, float(convergence_tol),
                                 out.data_ptr(), cuda_lib.stream_ptr(pose0))
    refine_pose.launches += 1
    cuda_lib.check(code, "pfmpe_refine_pose")
    return PoseRefine(out[:16].view(4, 4), out[16:52].view(6, 6), out[52:].view(torch.int32)[0])


refine_pose.launches = 0
refine_pose.calls = 0
