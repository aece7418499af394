"""Stratified resampling by search, and the closed-form draw count (port of
`pf/resample.py`, with `_count_leq_norm` of the reference's
`parallel/resample.py`).  The reference's `_auto_chunk(n, 1)` picks the
CDF chunk for one shard; it equals `default_cdf_chunk(n)` for every n
(that chunk always divides n), so the port uses the latter.

The CDF is the fixed-association chunked one of `pf.soa`, which can carry
1-ulp non-monotone pockets at chunk seams.  The reference resolves draws
with `jnp.searchsorted`, whose default method bisects with a fixed
(low, high) schedule; inside a pocket another search may pick another
lane, so `searchsorted_scan` repeats that schedule step for step.
"""

from __future__ import annotations

import math

import torch

from ..utils import prng
from ..utils.sync import upload
from .soa import chunked_cdf_norm, default_cdf_chunk


def searchsorted_scan(sorted_arr: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """`jnp.searchsorted(sorted_arr, query, side="left")` (method "scan"):
    ceil(log2(n + 1)) steps of mid = (low + high) // 2, going left where
    query <= sorted_arr[mid]; returns high (int64)."""
    n = sorted_arr.shape[0]
    low = torch.zeros(query.shape, dtype=torch.int64, device=query.device)
    high = torch.full(query.shape, n, dtype=torch.int64, device=query.device)
    for _ in range(int(math.ceil(math.log2(n + 1)))):
        mid = (low + high) // 2
        go_left = query <= sorted_arr[mid]
        low, high = torch.where(go_left, low, mid), torch.where(go_left, mid, high)
    return high


def stratified_resample(key, weights: torch.Tensor):
    """Stratified resampling over (not necessarily normalised) weights:
    u_i = (i + U[0, 1)) / N resolved to the first CDF entry >= u_i.
    Returns (ancestors (N,) int64, counts (N,) int64, most (0-d int64))."""
    n = weights.shape[0]
    dev = weights.device
    cdf = chunked_cdf_norm(weights, default_cdf_chunk(n))
    n_f = upload(float(n), dev)
    u = (torch.arange(n, dtype=torch.float32, device=dev) + prng.uniform(key, (n,), dev)) / n_f
    ancestors = torch.clamp(searchsorted_scan(cdf, u), 0, n - 1)
    counts = torch.bincount(ancestors, minlength=n)
    return ancestors, counts, torch.argmax(counts)


def effective_sample_size(weights: torch.Tensor) -> torch.Tensor:
    """ESS = (sum w)^2 / sum w^2, 0 when every weight is 0."""
    s = torch.sum(weights)
    s2 = torch.sum(weights * weights)
    return torch.where(s2 > 0, (s * s) / s2, torch.zeros_like(s))


def count_leq_norm(cdf_n: torch.Tensor, key, n: int) -> torch.Tensor:
    """#{draws u_g = fl((g + eps_g) / n) : u_g <= cdf_n} for normalised CDF
    values, by six threefry probes around floor(n * cdf_n) (exact for
    8 <= n <= 2**22).  Returns int32."""
    nf = upload(float(n), cdf_n.device, cdf_n.dtype)
    k = torch.clamp(torch.floor(cdf_n * nf).to(torch.int32), 0, n - 1)
    k_c = torch.clamp(k, 3, n - 3)
    cnt = k_c - 3
    for d in (-3, -2, -1, 0, 1, 2):
        probe = k_c + d
        u_p = (probe.to(cdf_n.dtype) + prng.uniform_at(key, probe)) / nf
        cnt = cnt + (u_p <= cdf_n).to(torch.int32)
    return torch.clamp(cnt, 0, n)
