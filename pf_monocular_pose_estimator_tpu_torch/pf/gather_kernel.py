"""Windowed resampling gather kernel G (csrc/monotone_gather.cu) and its
plain PyTorch version.

Ports `pf/pallas_gather.py`: for non-decreasing ancestors, output block i
of `block` slots only reads the input lanes
[anc[i * block], anc[last slot]], so one `window`-lane span at a 128-aligned
start covers the whole block.  The window is the reference wrapper's
coverage rule: `monotone_gather` checks that every block's ancestors fit
it and returns `fallback(bank16, anc)` where one does not, as the
reference's `lax.cond` does.  The kernel reads each slot's column straight
from the bank (non-decreasing ancestors coalesce on the card); nothing is
staged.  Rows 12-15 are the constant rigid bottom row (0, 0, 0, 1).  The
reference reaches this kernel from no tracker path; neither does the port.
"""

from __future__ import annotations

import torch

from ..utils import cuda_lib

BLOCK = 512
WINDOW = 2048


def monotone_gather_plain(bank16: torch.Tensor, anc: torch.Tensor, block: int = BLOCK,
                          window: int = WINDOW):
    """Plain version of `windowed_gather` -> (out (16, N), ok (ceil(N /
    block),) int32).  An ancestor outside its block's window reads the
    window's nearest edge."""
    n = anc.shape[0]
    dev = anc.device
    nb = -(-n // block)
    t0 = torch.arange(nb, device=dev) * block
    firsts = anc[t0]
    lasts = anc[torch.clamp(t0 + block, max=n) - 1]
    max_start = max((n - window) // 128 * 128, 0)
    starts = torch.clamp(torch.div(firsts, 128, rounding_mode="floor") * 128, 0, max_start)
    ok = ((lasts - starts < window) & (firsts >= starts)).to(torch.int32)
    start_t = starts.repeat_interleave(block)[:n]
    src = start_t + torch.clamp(anc - start_t, 0, window - 1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=bank16.dtype, device=dev)[:, None]
    return torch.cat([bank16[:12].index_select(1, src), bottom.expand(4, n)]), ok


def windowed_gather(bank16: torch.Tensor, anc: torch.Tensor, block: int = BLOCK,
                    window: int = WINDOW):
    """Gather of a (16, N) bank at non-decreasing int64 ancestors through one
    window per output block -> (out, ok (ceil(N / block),) int32 per-block
    coverage).  Kernel #11 of the port (G).  Needs N >= window."""
    if bank16.dtype != torch.float32 or bank16.dim() != 2 or bank16.shape[0] != 16:
        raise ValueError("windowed_gather: bank must be a (16, N) float32 tensor")
    n = bank16.shape[1]
    if anc.dtype != torch.int64 or anc.shape != (n,):
        raise ValueError("windowed_gather: ancestors must be an (N,) int64 tensor")
    if n < window or not 0 < block <= 1024:
        raise ValueError("windowed_gather: needs N >= window and 0 < block <= 1024")
    if bank16.device.type == "cpu":
        return monotone_gather_plain(bank16, anc, block, window)
    cuda_lib.require_cuda("windowed_gather", bank16, anc)
    lib = cuda_lib.library()
    out = torch.empty_like(bank16)
    ok = torch.empty(-(-n // block), dtype=torch.int32, device=bank16.device)
    code = lib.pfmpe_monotone_gather(bank16.data_ptr(), anc.data_ptr(), n, block, window,
                                     out.data_ptr(), ok.data_ptr(), cuda_lib.stream_ptr(bank16))
    windowed_gather.launches += 1
    cuda_lib.check(code, "pfmpe_monotone_gather")
    return out, ok


windowed_gather.launches = 0


def monotone_gather(bank16: torch.Tensor, anc: torch.Tensor, fallback, block: int = BLOCK,
                    window: int = WINDOW) -> torch.Tensor:
    """Resampling gather `bank16[:, anc]` for non-decreasing anc: kernel G
    when every block's ancestors fit its window (read on the host), else
    `fallback(bank16, anc)`.  Both give the same values for a bank whose
    rows 12-15 are (0, 0, 0, 1)."""
    if bank16.shape[1] < window:
        return fallback(bank16, anc)
    out, ok = windowed_gather(bank16.contiguous(), anc.contiguous(), block, window)
    return out if bool(torch.all(ok == 1)) else fallback(bank16, anc)
