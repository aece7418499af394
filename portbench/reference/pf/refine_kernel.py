# Frozen copy of pf_monocular_pose_estimator_tpu_torch/pf/refine_kernel.py, the port's plain
# PyTorch path, for the benchmark's reference; it calls no kernel and no code of
# the program: each kernel wrapper runs its plain version on every device.
"""Batched Gauss-Newton kernel D (csrc/gn_refine.cu) and its plain version.

Ports `pf/pallas_refine.py::gauss_newton_refine_pallas`: every hypothesis
runs the full iteration budget with a convergence mask, the Jacobi-scaled
block-Schur solve of `_solve6_rows`, the exp map of `_exp_se3_rows`, then
the final normal matrix, largest residual and divergence revert.  Sums over
the M pairs run in index order on both sides.  The covariance
(`inv6_spd`) is computed outside the kernel, as in the reference.
"""

from __future__ import annotations

import torch

from .refine import RefineResult, inv6_spd

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
    return gn_refine_plain(scal, poses, mark, du, dv, mask, max_iterations, tol)


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
