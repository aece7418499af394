"""Structure-of-arrays bank helpers and stratified resampling (port of
`pf/soa.py`).  Layout: bank16[i * 4 + j, n] == pose_n[i, j]."""

from __future__ import annotations

import torch

from ..utils import prng

BIG = 3.0e37  # distance sentinel of masked cells (reference pf/pallas_weight.py::_BIG)


def unpack(bank16: torch.Tensor) -> torch.Tensor:
    """(16, N) -> (N, 4, 4)."""
    return bank16.T.reshape(-1, 4, 4)


def propagate_soa(bank16: torch.Tensor, lr: torch.Tensor, pin: torch.Tensor,
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
    t = [bank16[i] for i in range(16)]
    tr = []
    for i in range(4):
        for j in range(4):
            acc = t[i * 4 + 0] * lr[16 + 0 * 4 + j]
            for kk in range(1, 4):
                acc = acc + t[i * 4 + kk] * lr[16 + kk * 4 + j]
            tr.append(acc)
    base = []
    for i in range(4):
        for j in range(4):
            acc = lr[i * 4 + 0] * tr[0 * 4 + j]
            for kk in range(1, 4):
                acc = acc + lr[i * 4 + kk] * tr[kk * 4 + j]
            base.append(acc)

    glane = torch.arange(n, device=bank16.device, dtype=torch.int64) + lane_offset
    nz = []
    for row in range(6):
        key = keys4[0:2] if row < 3 else keys4[2:4]
        r = row if row < 3 else row - 3
        u = prng.uniform_at(key, (r * n_total + glane) & prng.MASK)
        lo, hi = prop[2 * row], prop[2 * row + 1]
        nz.append(torch.maximum(lo, u * (hi - lo) + lo))
    ca, sa = torch.cos(nz[0]), torch.sin(nz[0])
    cb, sb = torch.cos(nz[1]), torch.sin(nz[1])
    cc, sc = torch.cos(nz[2]), torch.sin(nz[2])
    rn = (
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
    rows = []
    for i in range(4):
        for j in range(4):
            if j == 3:
                v = base[i * 4 + 3] + nz[3 + i] if i < 3 else base[15]
            elif i == 3:
                v = base[12 + j]
            else:
                v = base[i * 4 + 0] * rn[0 * 3 + j]
                v = v + base[i * 4 + 1] * rn[1 * 3 + j]
                v = v + base[i * 4 + 2] * rn[2 * 3 + j]
            v = torch.where(glane == 0, pin[i * 4 + j], v)
            v = torch.where(glane == 1, pin[16 + i * 4 + j], v)
            rows.append(v)
    return torch.stack(rows)


def weight_particles_soa(bank16: torch.Tensor, scal: torch.Tensor, mark: torch.Tensor,
                         dets: torch.Tensor, downg: torch.Tensor) -> torch.Tensor:
    """The weight half of kernel B with the Pallas kernel's semantics:
    marker-major (m * K + k) M x K distance volume with the 3e37 sentinel,
    M rounds of greedy first-minimum matching, score
    `nms + ((tol_init - d) / tol_init)**2` minus reuse and downgrade
    penalties.

    scal: (8,) fx fy cx cy tol_pf tol_init num_markers_score 0; mark: (4M,)
    xyz per marker | 0 or 3e37; dets: (3K,) xy per detection | 0 or 3e37;
    downg: (M,) 0 or 2.  Returns the weights (N,)."""
    m = downg.shape[0]
    k = dets.shape[0] // 3
    n = bank16.shape[1]
    dev = bank16.device
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
    weights = torch.zeros(n, dtype=torch.float32, device=dev)
    nself = torch.ones(n, dtype=torch.float32, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    used = torch.zeros((k, n), dtype=torch.float32, device=dev)
    m_of_row = (torch.arange(m * k, device=dev) // k)[:, None]
    for _ in range(m):
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
        used = used + ((torch.arange(k, device=dev)[:, None] == k_sel[None]) & ok[None]).float()
        dist = torch.where((m_of_row == m_sel[None]) & ok[None], big, dist)
    return weights


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
    n_f = torch.tensor(float(n), dtype=weights.dtype, device=weights.device)
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
    n_f = torch.tensor(float(n), dtype=torch.float32, device=dev)
    u = (torch.arange(n, dtype=torch.float32, device=dev) + eps) / n_f
    qk = torch.sort(_merge_key(u, 0)).values
    ck = torch.sort(_merge_key(cdf, 1)).values
    ancestors = torch.clamp(torch.searchsorted(ck, qk), 0, n - 1)
    draws_leq = torch.searchsorted(qk, ck)
    counts = torch.diff(draws_leq, prepend=torch.zeros(1, dtype=draws_leq.dtype, device=dev))
    return ancestors, counts, torch.argmax(counts)
