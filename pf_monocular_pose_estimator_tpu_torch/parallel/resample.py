"""Distributed stratified resampling over the particles mesh (port of
`parallel/resample.py`): scalar collectives, a reach-limited ring, never a
gather of the bank.

  1. Width-independent CDF: per-shard fixed-size chunk sums by a
     Hillis-Steele scan, one all_gather of the N / chunk chunk sums, a scan
     of those.  Every sum's association is fixed by (N, chunk) alone, so the
     CDF, the draws and the whole assignment are bit-identical across mesh
     widths and equal to `pf.soa.stratified_resample_soa`.
  2. Copy counts per local particle by the closed-form grid inversion
     (`pf.resample.count_leq_norm`) and the shard's own draws from the
     threefry counter stream: no communication.
  3. Ancestors: each shard ppermutes the 12 varying rows of its bank block
     and its CDF block to its ring neighbours (whole blocks, or at reach 1
     the head and tail windows), counts for every draw the CDF entries of
     each block below it, and gathers the ancestor columns from the blocks
     with kernel H (`gather_kernel.ring_gather`), one launch for every
     local shard.  On a local mesh the bank blocks are the other shards'
     rows where they lie (`LocalMesh.receive`), never copied.  Draws whose
     ancestor lies beyond the reach or the window take the shard's
     most-copied particle and are counted in `clipped`; results are exact
     across widths when `clipped == 0`.

The shard body runs once over the leading axis of local shards
(`comm`), so one process holding P shards and P ranks holding one each
compute the same values.

The reference merges draws and CDF entries in one sort of `bits << 2 | code`
keys and reads, for each draw, how many entries of each block sort ahead of
it; a draw sorts ahead of a bit-equal entry, so that number is the count of
the block's entries strictly below the draw.  Here each block's keys are
sorted alone and searched with the draws' keys (side left): the same counts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..pf.resample import count_leq_norm
from ..pf.soa import default_cdf_chunk, hillis_steele
from ..utils import prng
from .comm import shard_index
from .gather_kernel import ring_gather


class DistResampleOut(NamedTuple):
    # (L, 16, S): only the 12 varying pose rows travel the ring; rows 12-15
    # of every output column are the rigid bottom row (0, 0, 0, 1)
    resampled: torch.Tensor
    counts: torch.Tensor  # (L, S) int32 global copy count per input particle
    most: torch.Tensor  # 0-d int64, the same on every rank: most-copied particle
    clipped: torch.Tensor  # 0-d int64, the same on every rank: draws beyond the reach


def ring_deltas(reach: int, p: int) -> list[int]:
    """Ring offsets [0, -1, +1, ...] deduplicated mod p (at p = 2 the +1
    neighbour is the -1 neighbour)."""
    deltas, seen = [], set()
    for d in [0] + [s * r for r in range(1, reach + 1) for s in (-1, 1)]:
        if (d % p) not in seen:
            seen.add(d % p)
            deltas.append(d)
    return deltas


def auto_chunk(n: int, p: int) -> int:
    """The canonical width-independent chunk (`default_cdf_chunk`, a
    function of N alone) when it divides this mesh's shard size; otherwise
    the largest divisor of the shard size <= 512 (agreement with the other
    resamplers then needs an explicit `cdf_chunk`)."""
    s = n // p
    canonical = default_cdf_chunk(n)
    if s % canonical == 0:
        return canonical
    for d in range(min(512, s), 0, -1):
        if s % d == 0:
            return d
    return 1


def _order_key(vals: torch.Tensor) -> torch.Tensor:
    """float32 bits as int64 in [0, 2**32): the reference's uint32 sort order."""
    return vals.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _count_below(block_cdf: torch.Tensor, u_key: torch.Tensor) -> torch.Tensor:
    """(L, S) int32: entries of each row of block_cdf (L, len) strictly below each draw."""
    keys = torch.sort(_order_key(block_cdf), dim=-1).values
    return torch.searchsorted(keys, u_key, out_int32=True)


def _resample_shards(mesh, key, w, bank16, n: int, reach: int, chunk: int, window):
    """The shard body over the local shards: w (L, S), bank16 (L, 16, S)."""
    p = mesh.size
    n_local, s = w.shape
    dev, dtype = w.device, w.dtype
    idx = shard_index(mesh, dev)[:, None]  # (L, 1)
    s_chunks, n_chunks = s // chunk, n // chunk
    use_window = window is not None and reach == 1 and p >= 2 and s >= 2
    wlen = min(int(window), s - 1) if use_window else 0

    # -- 1. width-independent chunked CDF (normalised); the chunk-sum
    # all_gather is the only collective here
    within = hillis_steele(w.reshape(n_local, s_chunks, chunk))
    all_chunk_sums = mesh.all_gather(within[..., -1]).reshape(n_chunks)
    prefix_incl = hillis_steele(all_chunk_sums)
    total = prefix_incl[-1]
    prefix_excl = torch.cat([torch.zeros(1, dtype=dtype, device=dev), prefix_incl[:-1]])
    my_chunk_off = prefix_excl.reshape(p, s_chunks)[idx[:, 0]]
    cdf = (my_chunk_off[..., None] + within).reshape(n_local, s)
    ok_total = total > 0
    safe_total = torch.where(ok_total, total, torch.ones_like(total))
    # divisors stay device tensors (see pf.soa.chunked_cdf_norm)
    nf = torch.tensor(float(n), dtype=dtype, device=dev)
    g = idx * s + torch.arange(s, device=dev)  # (L, S) global lane
    cdf_n = torch.where(ok_total, cdf / safe_total, (g + 1).to(dtype) / nf)
    # bounds_n[k]: normalised mass below shard k
    bounds_n = torch.where(ok_total, prefix_excl[::s_chunks] / safe_total,
                           (torch.arange(p, device=dev) * s).to(dtype) / nf)

    # -- 2. copy counts per local particle (closed form, elementwise): the
    # draws at or below each CDF entry, less those below the entry before it
    # (the shard's start for its first particle)
    own_start = bounds_n[idx[:, 0]][:, None]
    counts = torch.diff(count_leq_norm(torch.cat([own_start, cdf_n], dim=1), key, n), dim=1)

    # -- 3. this output window's draws (global grid, recomputed locally)
    u = (g.to(dtype) + prng.uniform_at(key, g)) / nf

    # -- 4. ring exchange: 12 varying bank rows + CDF per neighbour
    top12 = bank16[:, :12]
    if use_window:
        # the head window (first W columns) travels backward, so a shard
        # holds its forward neighbour's head; the tail window travels
        # forward with one CDF entry ahead of it, so "ancestor before the
        # window" shows.  The wrap-around edges carry no reachable draw.
        received = [list(top12), mesh.receive(top12[:, :, :wlen], -1),
                    mesh.receive(top12[:, :, s - wlen:], 1)]
        blocks_cdf = [cdf_n, mesh.ppermute(cdf_n[:, :wlen], -1),
                      mesh.ppermute(cdf_n[:, s - wlen - 1:], 1)]
    else:
        deltas = ring_deltas(reach, p)
        received = [mesh.receive(top12, d) for d in deltas]
        blocks_cdf = [mesh.ppermute(cdf_n, d) for d in deltas]
    blocks_bank = [list(shard) for shard in zip(*received)]  # per local shard

    # -- 5. per draw, the entries of each block below it
    u_key = _order_key(u)
    a_blocks = [_count_below(b, u_key) for b in blocks_cdf]

    # -- 6. each draw's source shard and position in the blocks.  True shard
    # of u: the interior shard starts strictly below it (u at a boundary
    # belongs to the shard below, matching "first CDF entry >= u")
    src_u = torch.sum(u[:, None, :] > bounds_n[1:][None, :, None], dim=1)  # (L, S) in [0, P)
    if use_window:
        a_own, a_head, a_tail = a_blocks
        own_hit = src_u == idx
        fwd_hit = ~own_hit & (u >= own_start) & (src_u == (idx + 1) % p) & (a_head < wlen)
        back_hit = ~own_hit & (u < own_start) & (src_u == (idx - 1) % p) & (a_tail >= 1)
        found = own_hit | fwd_hit | back_hit
        # positions in [own (S) | head (W) | tail (W)]; the clamp covers an
        # ulp seam that pushes the own count to S
        take_pos = torch.clamp(a_own, 0, s - 1)
        take_pos = torch.where(fwd_hit, s + a_head, take_pos)
        take_pos = torch.where(back_hit, s + wlen + (a_tail - 1), take_pos)
    else:
        take_pos = torch.zeros((n_local, s), dtype=torch.int32, device=dev)
        found = torch.zeros((n_local, s), dtype=torch.bool, device=dev)
        for i, delta in enumerate(deltas):
            hit = src_u == (idx - delta) % p
            take_pos = torch.where(hit, i * s + torch.clamp(a_blocks[i], 0, s - 1), take_pos)
            found = found | hit
    n_clipped = torch.sum(~found, dim=1)
    local_best = torch.argmax(counts, dim=1)
    take_pos = torch.where(found, take_pos, local_best[:, None].to(torch.int32))

    # -- 7. one gather for every local shard from the blocks where they lie (kernel H)
    out = ring_gather(blocks_bank, take_pos)

    # -- most-copied particle and clip count, globally: one packed all_gather
    local_max = counts.gather(1, local_best[:, None])[:, 0].to(torch.int64)
    all_packed = mesh.all_gather(torch.stack([local_max, local_best, n_clipped], dim=1))
    winner = torch.argmax(all_packed[:, 0]).reshape(1)
    most = winner[0] * s + all_packed.index_select(0, winner)[0, 1]
    return DistResampleOut(out, counts, most, torch.sum(all_packed[:, 2]))


def make_distributed_resampler(mesh, n_particles: int, reach: int = 1,
                               cdf_chunk: int | None = None, payload_window="auto"):
    """Build `resample(key, weights, bank16) -> DistResampleOut` over `mesh`,
    for weights (L, S) and bank16 (L, 16, S) in the mesh's sharded layout
    (`comm.shard_lanes`).

    cdf_chunk: the fixed CDF summation chunk (must divide the shard size);
    two resamplers agree bit for bit across mesh widths iff they use the
    same chunk and no draw is clipped.

    payload_window: reach-1 ring payload in columns: "auto" = S // 4 (covers
    up to 25% per-shard weight imbalance), an int, or None for whole blocks
    (exact under any skew the reach covers).  Ignored unless reach == 1 and
    P >= 2.  Window overflow is clamped and counted in `clipped` like reach
    overflow."""
    p = mesh.size
    if n_particles % p:
        raise ValueError(f"n_particles={n_particles} must divide over {p} shards")
    s = n_particles // p
    if cdf_chunk is None:
        cdf_chunk = auto_chunk(n_particles, p)
    if s % cdf_chunk:
        raise ValueError(f"cdf_chunk={cdf_chunk} must divide the shard size {s}")
    if not 8 <= n_particles <= (1 << 22):
        raise ValueError("closed-form grid inversion is exact only for 8 <= N <= 2^22")
    if payload_window == "auto":
        payload_window = max(s // 4, 1)

    def resample(key, weights, bank16):
        if weights.shape != (len(mesh.ranks), s) or bank16.shape != (len(mesh.ranks), 16, s):
            raise ValueError(f"resample: expected weights ({len(mesh.ranks)}, {s}) and a bank "
                             f"({len(mesh.ranks)}, 16, {s})")
        return _resample_shards(mesh, key, weights, bank16, n_particles, reach, cdf_chunk,
                                payload_window)

    return resample
