# Frozen copy of pf_monocular_pose_estimator_tpu_torch/pf/soa.py, the port's plain
# PyTorch path, trimmed to what the benchmark's reference calls; it calls no
# kernel and no code of the program.
"""Structure-of-arrays bank helpers, the reference's XLA propagation and
weight, and stratified resampling (port of `pf/soa.py`).
Layout: bank16[i * 4 + j, n] == pose_n[i, j]."""

from __future__ import annotations

import torch

from ..utils import prng


def unpack(bank16: torch.Tensor) -> torch.Tensor:
    """(16, N) -> (N, 4, 4)."""
    return bank16.T.reshape(-1, 4, 4)


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


def stratified_resample_soa(key, weights: torch.Tensor, cdf_dtype=None):
    """Stratified resampling with the reference's exact assignment rule.

    The reference merges [u, cdf] in one sort of `bits << 1 | tag` keys
    (draws tagged 0 sort ahead of bit-equal cdf entries) and reads the
    ancestors and counts off the merged order.  The same values come from
    sorting each side and counting the other side's keys below each key:
      ancestors[t] = #{cdf keys < t-th smallest draw key}, clipped to N - 1
      draws_leq[r] = #{draw keys < r-th smallest cdf key}
    Returns (ancestors (N,) int64, counts (N,) int64, most (0-d int64)).
    (The benchmark's copy adds `cdf_dtype`: the CDF scanned in that type,
    the control's bfloat16.)"""
    n = weights.shape[0]
    dev = weights.device
    w = weights if cdf_dtype is None else weights.to(cdf_dtype)
    cdf = chunked_cdf_norm(w, default_cdf_chunk(n)).to(weights.dtype)
    eps = prng.uniform(key, (n,), device=dev)
    n_f = torch.tensor(float(n), dtype=torch.float32, device=dev)
    u = (torch.arange(n, dtype=torch.float32, device=dev) + eps) / n_f
    qk = torch.sort(_merge_key(u, 0)).values
    ck = torch.sort(_merge_key(cdf, 1)).values
    ancestors = torch.clamp(torch.searchsorted(ck, qk), 0, n - 1)
    draws_leq = torch.searchsorted(qk, ck)
    counts = torch.diff(draws_leq, prepend=torch.zeros(1, dtype=draws_leq.dtype, device=dev))
    return ancestors, counts, torch.argmax(counts)

