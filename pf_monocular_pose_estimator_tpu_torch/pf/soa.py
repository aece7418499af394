"""Structure-of-arrays bank helpers, the reference's XLA propagation and
weight, and stratified resampling (port of `pf/soa.py`).
Layout: bank16[i * 4 + j, n] == pose_n[i, j]."""

from __future__ import annotations

import torch

from ..utils import prng
from ..utils.sync import upload


def pack(bank: torch.Tensor) -> torch.Tensor:
    """(N, 4, 4) -> (16, N)."""
    return bank.reshape(bank.shape[0], 16).T


def unpack(bank16: torch.Tensor) -> torch.Tensor:
    """(16, N) -> (N, 4, 4)."""
    return bank16.T.reshape(-1, 4, 4)


def pack_single(pose: torch.Tensor) -> torch.Tensor:
    """(4, 4) -> (16,)."""
    return pose.reshape(16)


def identity_bank16(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(16, N) bank of identity poses."""
    return torch.eye(4, dtype=dtype, device=device).reshape(16, 1).repeat(1, n)


def compose_const_left(a: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    """A @ B for a constant (4, 4) A and a (16, N) bank B."""
    rows = []
    for i in range(4):
        for j in range(4):
            acc = a[i, 0] * b16[0 * 4 + j]
            for k in range(1, 4):
                acc = acc + a[i, k] * b16[k * 4 + j]
            rows.append(acc)
    return torch.stack(rows)


def compose_const_right(a16: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B for a (16, N) bank A and a constant (4, 4) B."""
    rows = []
    for i in range(4):
        for j in range(4):
            acc = a16[i * 4 + 0] * b[0, j]
            for k in range(1, 4):
                acc = acc + a16[i * 4 + k] * b[k, j]
            rows.append(acc)
    return torch.stack(rows)


def rotation_entries(a, b, c):
    """The 9 entries of Rz(c) @ Ry(b) @ Rx(a), in the reference's
    expression order."""
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    return (
        cc * cb,
        cc * sb * sa - sc * ca,
        cc * sb * ca + sc * sa,
        sc * cb,
        sc * sb * sa + cc * ca,
        sc * sb * ca - cc * sa,
        -sb,
        cb * sa,
        cb * ca,
    )


def noisy_rows(base, rn, dts) -> list:
    """The 16 rows of base @ [Rn | dt], with Rn's 9 entries `rn` applied on
    the right and the 3 translations `dts` added, in the reference's
    expression order."""
    rows = []
    for i in range(4):
        for j in range(4):
            if j == 3:
                rows.append(base[i * 4 + 3] + dts[i] if i < 3 else base[15])
            elif i == 3:
                rows.append(base[12 + j])
            else:
                acc = base[i * 4 + 0] * rn[0 * 3 + j]
                acc = acc + base[i * 4 + 1] * rn[1 * 3 + j]
                acc = acc + base[i * 4 + 2] * rn[2 * 3 + j]
                rows.append(acc)
    return rows


def propagate_soa(key, resampled16: torch.Tensor, current_pose, predicted_pose, prediction_matrix,
                  cam_move_inv, noise, fac_trans, fac_rot, tracking: bool,
                  apply_prediction: bool, inflation, lane_offset: int = 0,
                  n_total: int | None = None) -> torch.Tensor:
    """The reference's XLA `propagate_soa` (its tracker's propagation when
    `use_fused_pf_kernel` is off): base = L @ (T @ R) when tracking with
    the prediction, L @ T when tracking without it, T itself otherwise;
    `jax.random.uniform(k, (3, N), lo, hi)` draws for the angles (k_rot)
    and translations (k_trans); Rz @ Ry @ Rx noise; lanes 0 / 1 set to the
    current and predicted poses.  A shard of a bank of `n_total` lanes
    passes the global index of its first lane as `lane_offset` and takes its
    slice of the whole bank's draws and pins."""
    dev = resampled16.device
    n = resampled16.shape[1]
    n_total = n if n_total is None else n_total
    f = lambda v: upload(v, dev)
    k_rot, k_trans = prng.split(key)
    if tracking and apply_prediction:
        base = compose_const_left(f(cam_move_inv), compose_const_right(resampled16,
                                                                       f(prediction_matrix)))
    elif tracking:
        base = compose_const_left(f(cam_move_inv), resampled16)
    else:
        base = resampled16
    infl = f(inflation)
    three = torch.ones(3, dtype=torch.float32, device=dev)
    lo_a = f(noise.min_angular) * three * f(fac_rot) * infl
    hi_a = f(noise.max_angular) * three * f(fac_rot) * infl
    lo_t = f(noise.min_translation) * three * f(fac_trans) * infl
    hi_t = f(noise.max_translation) * three * f(fac_trans) * infl
    glane = torch.arange(n, device=dev) + lane_offset
    counters = torch.arange(3, device=dev)[:, None] * n_total + glane[None, :]

    def draw(key, lo, hi):  # rows of jax.random.uniform(key, (3, n_total), lo, hi)
        return torch.maximum(lo, prng.uniform_at(key, counters) * (hi - lo) + lo)

    angles = draw(k_rot, lo_a[:, None], hi_a[:, None])
    dts = draw(k_trans, lo_t[:, None], hi_t[:, None])
    rows = noisy_rows(base, rotation_entries(angles[0], angles[1], angles[2]), dts)
    bank16 = torch.stack(rows)
    pins = (f(current_pose).reshape(16, 1), f(predicted_pose).reshape(16, 1))
    return torch.where(glane == 0, pins[0], torch.where(glane == 1, pins[1], bank16))


def project_soa(camera, bank16: torch.Tensor, markers_h: torch.Tensor) -> torch.Tensor:
    """Project M markers for all N particles -> (M, 2, N) pixel coordinates,
    in the reference's expression order."""
    x, y, z = (markers_h[:, i][:, None] for i in range(3))
    xc = bank16[0][None] * x + bank16[1][None] * y + bank16[2][None] * z + bank16[3][None]
    yc = bank16[4][None] * x + bank16[5][None] * y + bank16[6][None] * z + bank16[7][None]
    zc = bank16[8][None] * x + bank16[9][None] * y + bank16[10][None] * z + bank16[11][None]
    safe_z = torch.where(torch.abs(zc) < 1e-12, torch.full_like(zc, 1e-12), zc)
    u = camera.fx * xc / safe_z + camera.cx
    v = camera.fy * yc / safe_z + camera.cy
    return torch.stack([u, v], dim=1)


def weight_particles_soa(camera, bank16: torch.Tensor, markers_h: torch.Tensor,
                         marker_mask: torch.Tensor, det_xy: torch.Tensor, det_mask: torch.Tensor,
                         tol_pf, tol_init, downgrade: torch.Tensor, num_markers_score=None):
    """The reference's XLA `weight_particles_soa` (its weight when
    `use_pallas_weight` is off): a detection-major (k * M + m) K x M
    volume with masked cells set to finfo.max / 4, first-minimum greedy
    matching -> (weights (N,), pairs (M, 2, N) int32, n_corr (N,) int32).
    Kernels B and E break ties marker-major instead (pf.weight_kernel)."""
    m = markers_h.shape[0]
    k_cap = det_xy.shape[0]
    n = bank16.shape[1]
    dev = bank16.device
    f = lambda v: upload(v, dev)
    big = upload(torch.finfo(torch.float32).max / 4, dev)
    if num_markers_score is None:
        num_markers_score = torch.sum(marker_mask.float())
    x, y, z = (markers_h[:, i][:, None] for i in range(3))
    xc = bank16[0][None] * x + bank16[1][None] * y + bank16[2][None] * z + bank16[3][None]
    yc = bank16[4][None] * x + bank16[5][None] * y + bank16[6][None] * z + bank16[7][None]
    zc = bank16[8][None] * x + bank16[9][None] * y + bank16[10][None] * z + bank16[11][None]
    safe_z = torch.where(torch.abs(zc) < 1e-12, torch.full_like(zc, 1e-12), zc)
    u = camera.fx * xc / safe_z + camera.cx  # (M, N)
    v = camera.fy * yc / safe_z + camera.cy
    du = det_xy[:, 0][:, None, None] - u[None]  # (K, M, N)
    dv = det_xy[:, 1][:, None, None] - v[None]
    dist2 = du * du + dv * dv
    invalid = (~det_mask)[:, None, None] | (~marker_mask)[None, :, None]
    dist2 = torch.where(invalid, big, dist2)
    tol_pf, tol_init = f(tol_pf), f(tol_init)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    weights = torch.zeros(n, dtype=torch.float32, device=dev)
    pairs = torch.full((m, 2, n), -1, dtype=torch.int32, device=dev)
    n_corr = torch.zeros(n, dtype=torch.int32, device=dev)
    used_det = torch.zeros((k_cap, n), dtype=torch.int32, device=dev)
    n_self_occ = torch.ones(n, dtype=torch.float32, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    for step in range(m):
        flat = dist2.reshape(k_cap * m, n)
        min_val = torch.min(flat, dim=0).values
        idx = torch.argmax((flat == min_val[None]).to(torch.int32), dim=0)  # first minimum
        d = torch.sqrt(torch.clamp(min_val, min=0.0))
        row = idx // m  # detection
        col = idx - row * m  # marker
        ok = (d <= tol_pf) & ~done
        done = done | ~ok
        score = num_markers_score + ((tol_init - d) / tol_init) ** 2
        row_onehot = torch.arange(k_cap, device=dev)[:, None] == row[None, :]
        reused = torch.sum(torch.where(row_onehot, used_det, 0), dim=0) > 0
        penal_occ = torch.where(ok & reused, 3.0 * n_self_occ, zero)
        n_self_occ = n_self_occ + (ok & reused).float()
        penal_down = torch.where(ok & downgrade[col], torch.full_like(zero, 2.0), zero)
        weights = weights + torch.where(ok, score, zero) - penal_occ - penal_down
        pairs[step, 0] = torch.where(ok, col.to(torch.int32), -1)
        pairs[step, 1] = torch.where(ok, row.to(torch.int32), -1)
        n_corr = n_corr + ok.to(torch.int32)
        used_det = used_det + (row_onehot & ok[None, :]).to(torch.int32)
        retire = (torch.arange(m, device=dev)[None, :, None] == col[None, None, :]) & ok[None, None]
        dist2 = torch.where(retire, big, dist2)
    return weights, pairs, n_corr


def gather_soa(bank16: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Resampling gather in SoA layout: (16, N)[:, idx]."""
    return bank16.index_select(1, indices.long())


def pick_lane(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[..., idx] for one index held on the device (no host read)."""
    return arr.index_select(-1, idx.reshape(1).long()).squeeze(-1)


def hillis_steele(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the last axis with a fixed association tree
    (x[i] += x[i - k], k doubling), independent of how a scan is lowered."""
    c = x.shape[-1]
    k = 1
    while k < c:
        shifted = torch.zeros_like(x)
        shifted[..., k:] = x[..., : c - k]
        x = x + shifted
        k *= 2
    return x


def default_cdf_chunk(n: int) -> int:
    """Largest divisor of N // 8 (of N when 8 does not divide it) <= 512."""
    base = n // 8 if n % 8 == 0 and n >= 8 else n
    for d in range(min(512, base), 0, -1):
        if base % d == 0:
            return d
    return 1


def chunked_cdf_norm(weights: torch.Tensor, chunk: int) -> torch.Tensor:
    """Normalised CDF by the fixed-association chunked scheme; the uniform
    CDF (j + 1) / n when the total is not positive (exact for n <= 2**24)."""
    n = weights.shape[0]
    if n % chunk != 0:
        raise ValueError(f"chunk={chunk} must divide n={n}")
    if n > 1 << 24:
        raise ValueError("chunked_cdf_norm's uniform fallback is exact only for n <= 2**24")
    within = hillis_steele(weights.reshape(n // chunk, chunk))
    prefix_incl = hillis_steele(within[:, -1])
    total = prefix_incl[-1]
    prefix_excl = torch.cat([torch.zeros(1, dtype=weights.dtype, device=weights.device),
                             prefix_incl[:-1]])
    cdf = (prefix_excl[:, None] + within).reshape(n)
    ok = total > 0
    # divisors stay device tensors: CUDA divides by a CPU scalar through its
    # reciprocal, which is not the reference's correctly rounded quotient
    n_f = upload(float(n), weights.device, weights.dtype)
    uniform = torch.arange(1, n + 1, dtype=weights.dtype, device=weights.device) / n_f
    return torch.where(ok, cdf / torch.where(ok, total, torch.ones_like(total)), uniform)


def _merge_key(vals: torch.Tensor, tag: int) -> torch.Tensor:
    """The reference's int32 sort key bitcast(f32) << 1 | tag, wrapped to
    32 bits, held in int64 so torch can sort and search it."""
    bits = vals.contiguous().view(torch.int32).to(torch.int64)
    k = ((bits << 1) | tag) & 0xFFFFFFFF
    return torch.where(k >= 2**31, k - 2**32, k)


def stratified_resample_soa(key, weights: torch.Tensor):
    """Stratified resampling with the reference's exact assignment rule.

    The reference merges [u, cdf] in one sort of `bits << 1 | tag` keys
    (draws tagged 0 sort ahead of bit-equal cdf entries) and reads the
    ancestors and counts off the merged order.  The same values come from
    sorting each side and counting the other side's keys below each key:
      ancestors[t] = #{cdf keys < t-th smallest draw key}, clipped to N - 1
      draws_leq[r] = #{draw keys < r-th smallest cdf key}
    Returns (ancestors (N,) int64, counts (N,) int64, most (0-d int64))."""
    n = weights.shape[0]
    dev = weights.device
    cdf = chunked_cdf_norm(weights, default_cdf_chunk(n))
    eps = prng.uniform(key, (n,), device=dev)
    n_f = upload(float(n), dev)
    u = (torch.arange(n, dtype=torch.float32, device=dev) + eps) / n_f
    qk = torch.sort(_merge_key(u, 0)).values
    ck = torch.sort(_merge_key(cdf, 1)).values
    ancestors = torch.clamp(torch.searchsorted(ck, qk), 0, n - 1)
    draws_leq = torch.searchsorted(qk, ck)
    counts = torch.diff(draws_leq, prepend=torch.zeros(1, dtype=draws_leq.dtype, device=dev))
    return ancestors, counts, torch.argmax(counts)


def stratified_resample_closed(key, weights: torch.Tensor):
    """Sort-free stratified resampling (`use_closed_form_resample`): the
    same draws and assignment rule as `stratified_resample_soa`, with the
    CDF's seam pockets repaired by a cummax instead of a value sort.
    rank_j = #{draws <= cdf_j} from six threefry probes around
    floor(n * cdf_j) (exact for 8 <= n <= 2**22), then
    ancestors[i] = #{j : rank_j <= i} by one scatter-max and a cummax.
    Returns (ancestors (N,) int64, counts (N,) int32, most (0-d int64))."""
    n = weights.shape[0]
    if n < 8 or n > (1 << 22):
        return stratified_resample_soa(key, weights)
    dev = weights.device
    cdf = torch.cummax(chunked_cdf_norm(weights, default_cdf_chunk(n)), dim=0).values
    nf = upload(float(n), dev)
    k = torch.floor(cdf * nf).to(torch.int32)
    k_c = torch.clamp(k, 3, n - 3)
    rank = k_c - 3
    for d in (-3, -2, -1, 0, 1, 2):
        probe = k_c + d
        u_probe = (probe.float() + prng.uniform_at(key, probe)) / nf
        rank = rank + (u_probe <= cdf).to(torch.int32)
    iota1 = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    bins = torch.zeros(n + 1, dtype=torch.int32, device=dev).scatter_reduce(
        0, rank.long(), iota1, "amax")
    ancestors = torch.clamp(torch.cummax(bins, dim=0).values[:n], 0, n - 1).long()
    counts = torch.diff(rank, prepend=torch.zeros(1, dtype=torch.int32, device=dev))
    return ancestors, counts, torch.argmax(counts)
