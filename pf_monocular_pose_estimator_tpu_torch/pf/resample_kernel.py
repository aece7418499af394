"""Sort-free stratified resampling (`use_pallas_resample`): the probe-rank
pre-pass in torch ops and the windowed decode kernel F
(csrc/resample_decode.cu) with its plain PyTorch version.

Ports `pf/pallas_resample.py`: `probe_rank` builds the fixed-association
chunked CDF and counts the stratified draws at or below each entry with
six threefry probes (a chunk-seam prefix-max keeps the rank monotone), so
slot t takes ancestor #{j : rank[j] <= t}.  Kernel F decodes that map for
blocks of `BLOCK` output slots inside a window of `WIN_CHUNKS` 128-lane
chunks and gathers all 16 bank rows; a block whose ancestors run past its
window clears its coverage flag, and `resample_bank` then returns the
caller's fallback (the sort path) instead, as the reference's `lax.cond`
does.  The two constants decide when that happens, so they are the
reference's semantics, not tuning.  On the card each decode block counts
its own window start (above `COUNT_IN_BLOCK_CHUNKS` chunks one launch
before the decode counts them all), stages the window's rank and reads the
bank straight from L2.
"""

from __future__ import annotations

import torch

from ..utils import cuda_lib
from .resample import count_leq_norm
from .soa import default_cdf_chunk, hillis_steele

BLOCK = 1024  # output slots per decode block (reference default)
WIN_CHUNKS = 12  # 128-lane chunks per window (reference default)
BIG_RANK = 1 << 23  # rank of lanes past N: above any rank (< 2**22) and any slot
# Up to this many 128-lane chunks (N <= 131,072) each decode block counts its
# own window start; above, one launch counts them all first (into a scratch
# buffer), since every block reading every chunk-last rank grows as N**2.
COUNT_IN_BLOCK_CHUNKS = 1024


def probe_rank(key, weights: torch.Tensor):
    """rank[j] = #{stratified draws u_t <= cdf[j]} on the fixed-association
    CDF, monotone after the seam repair -> (rank (N,) int32, counts (N,)
    int32, most (0-d int64))."""
    n = weights.shape[0]
    dev = weights.device
    chunk = default_cdf_chunk(n)
    total0 = torch.sum(weights)
    w = torch.where(total0 > 0, weights, torch.ones_like(weights))
    within = hillis_steele(w.reshape(n // chunk, chunk))
    prefix_incl = hillis_steele(within[:, -1])
    total = prefix_incl[-1]
    prefix_excl = torch.cat([torch.zeros(1, dtype=w.dtype, device=dev), prefix_incl[:-1]])
    cdf_n = ((prefix_excl[:, None] + within) / total).reshape(n)
    rank2 = count_leq_norm(cdf_n, key, n).reshape(n // chunk, chunk)
    boundary_max = torch.cummax(rank2[:, -1], dim=0).values
    floor_ = torch.cat([torch.zeros(1, dtype=rank2.dtype, device=dev), boundary_max[:-1]])
    rank = torch.maximum(rank2, floor_[:, None]).reshape(n)
    counts = torch.diff(rank, prepend=torch.zeros(1, dtype=rank.dtype, device=dev))
    return rank, counts, torch.argmax(counts)


def decode_plain(rank: torch.Tensor, bank16: torch.Tensor, block: int = BLOCK,
                 win_chunks: int = WIN_CHUNKS):
    """Plain version of `decode`, block by block as the kernel decodes ->
    (out (16, N), ok (ceil(N / block),) int32).  Lanes past N read as
    rank 2**23 and bank 0."""
    n = rank.shape[0]
    dev = rank.device
    w = win_chunks * 128
    nb = -(-n // block)
    nb128 = -(-n // 128)
    rank_p = torch.full((nb128 * 128,), BIG_RANK, dtype=torch.int32, device=dev)
    rank_p[:n] = rank
    bank_p = torch.zeros((16, nb128 * 128), dtype=bank16.dtype, device=dev)
    bank_p[:, :n] = bank16
    rank128 = rank_p.reshape(nb128, 128)[:, -1]
    t0 = torch.arange(nb, dtype=torch.int32, device=dev) * block
    c0 = torch.sum((rank128[None, :] <= t0[:, None]).to(torch.int32), dim=1)
    q = torch.clamp(c0, 0, nb128 - win_chunks).long()  # window start chunk per block
    bnd = rank128[q[:, None] + torch.arange(win_chunks, device=dev)[None, :]]  # (nb, win)
    t = t0[:, None] + torch.arange(block, dtype=torch.int32, device=dev)[None, :]  # (nb, block)
    coarse = torch.sum((bnd[:, :, None] <= t[:, None, :]).to(torch.int32), dim=1)
    cs = torch.clamp(coarse, max=win_chunks - 1).long()
    chunk0 = (q[:, None] + cs) * 128
    posc = torch.zeros_like(chunk0)
    for s in range(6, -1, -1):
        stp = 1 << s
        posc = torch.where(rank_p[chunk0 + posc + stp - 1] <= t, posc + stp, posc)
    pos = torch.where(coarse >= win_chunks, torch.full_like(posc, w), cs * 128 + posc)
    src = (q[:, None] * 128 + torch.clamp(pos, max=w - 1)).reshape(-1)[:n]
    t_last = torch.clamp(t0 + block, max=n) - 1
    ok = (bnd[:, -1] > t_last).to(torch.int32)
    return bank_p.index_select(1, src), ok


def decode(rank: torch.Tensor, bank16: torch.Tensor, block: int = BLOCK,
           win_chunks: int = WIN_CHUNKS):
    """Windowed decode of a monotone rank (N,) int32 into the resampled
    (16, N) bank -> (out, ok (ceil(N / block),) int32 per-block coverage).
    Kernel #10 of the port (F).  Needs N >= win_chunks * 128."""
    if bank16.dtype != torch.float32 or bank16.dim() != 2 or bank16.shape[0] != 16:
        raise ValueError("decode: bank must be a (16, N) float32 tensor")
    n = bank16.shape[1]
    if rank.dtype != torch.int32 or rank.shape != (n,):
        raise ValueError("decode: rank must be an (N,) int32 tensor")
    if n < win_chunks * 128 or not 0 < block <= 1024:
        raise ValueError("decode: needs N >= win_chunks * 128 and 0 < block <= 1024")
    if bank16.device.type == "cpu":
        return decode_plain(rank, bank16, block, win_chunks)
    cuda_lib.require_cuda("decode", rank, bank16)
    lib = cuda_lib.library()
    out = torch.empty_like(bank16)
    ok = torch.empty(-(-n // block), dtype=torch.int32, device=bank16.device)
    starts = torch.empty_like(ok) if -(-n // 128) > COUNT_IN_BLOCK_CHUNKS else None
    code = lib.pfmpe_resample_decode(rank.data_ptr(), bank16.data_ptr(), n, block, win_chunks,
                                     None if starts is None else starts.data_ptr(),
                                     out.data_ptr(), ok.data_ptr(), cuda_lib.stream_ptr(bank16))
    decode.launches += 1
    cuda_lib.check(code, "pfmpe_resample_decode")
    return out, ok


# wrapper calls that launched kernel F: one a call, also above
# COUNT_IN_BLOCK_CHUNKS, where a call is two launches (the starts, then the decode)
decode.launches = 0


def resample_bank(key, weights: torch.Tensor, bank16: torch.Tensor, fallback, host):
    """Counterpart of `resample_bank_pallas`: stratified resampling of a
    (16, N) bank -> (resampled16, most, decoded).  Runs the pre-pass and
    kernel F, reads the coverage on the host through `host` (one counted
    sync) and returns `fallback(key, weights, bank16) -> (resampled16,
    most)` instead where a window did not cover its block (decoded False).
    Shapes the decode cannot take go to the fallback straight away."""
    n = weights.shape[0]
    if n < WIN_CHUNKS * 128 or n > (1 << 22):  # the decode's window, the probes' bound
        return (*fallback(key, weights, bank16), False)
    rank, _counts, most = probe_rank(key, weights)
    out, ok = decode(rank, bank16.contiguous())
    if host(torch.all(ok == 1)):
        return out, most, True
    return (*fallback(key, weights, bank16), False)
