"""Ring gather kernel H (csrc/ring_gather.cu) and its plain PyTorch version.

Ports `pf/pallas_step.py::bank_layout_pin` as the reference's sharded
resampler uses it (`parallel/resample.py:305-311`): the pin is an identity
copy of the concatenated ring blocks ahead of `jnp.take`, and
`bank_restore_pin` follows the gather.  What that chain computes is
  out[r, t] = cat(blocks, 1)[r, take_pos[t]] for r < 12,
  rows 12-15 = (0, 0, 0, 1),
which kernel H does in one launch from the blocks where they lie, never
building the concatenation.  With one block and take_pos = 0..S-1 it
returns the block over the constant rows: the two pins with no gather
between them.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_lib

MAX_BLOCKS = 16


def ring_gather_plain(blocks, take_pos: torch.Tensor) -> torch.Tensor:
    """Plain version of `ring_gather`: concatenate, select, constant rows."""
    s = take_pos.shape[0]
    top = torch.cat(list(blocks), dim=1).index_select(1, take_pos)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)[:, None]
    return torch.cat([top, bottom.expand(4, s)])


def ring_gather(blocks, take_pos: torch.Tensor) -> torch.Tensor:
    """Gather S lanes at `take_pos` (int32 positions in the concatenation of
    `blocks` along the lanes) -> (16, S).  blocks: 1 to 16 float32 tensors
    of 12 rows whose lanes are contiguous; rows may be strided, so the top
    of a (16, S) bank or a lane slice of it goes in uncopied.  Positions
    must lie inside the concatenation.  Kernel #7 of the port (H)."""
    blocks = list(blocks)
    if not 1 <= len(blocks) <= MAX_BLOCKS:
        raise ValueError(f"ring_gather: takes 1 to {MAX_BLOCKS} blocks")
    for b in blocks:
        if b.dtype != torch.float32 or b.dim() != 2 or b.shape[0] != 12 or b.shape[1] < 1:
            raise ValueError("ring_gather: each block must be a (12, len >= 1) float32 tensor")
        if b.stride(1) != 1 and b.shape[1] > 1:
            raise ValueError("ring_gather: a block's lanes must be contiguous")
        if b.device != take_pos.device:
            raise ValueError("ring_gather: all tensors must be on one device")
    if take_pos.dtype != torch.int32 or take_pos.dim() != 1:
        raise ValueError("ring_gather: positions must be a 1-D int32 tensor")
    if take_pos.device.type == "cpu":
        return ring_gather_plain(blocks, take_pos)
    cuda_lib.require_cuda("ring_gather", take_pos)
    lib = cuda_lib.library()
    n_blocks = len(blocks)
    s = take_pos.shape[0]
    out = torch.empty((16, s), dtype=torch.float32, device=take_pos.device)
    ptrs = (ctypes.c_void_p * n_blocks)(*(b.data_ptr() for b in blocks))
    strides = (ctypes.c_longlong * n_blocks)(*(b.stride(0) for b in blocks))
    lens = (ctypes.c_int * n_blocks)(*(b.shape[1] for b in blocks))
    code = lib.pfmpe_ring_gather(ptrs, strides, lens, n_blocks, take_pos.data_ptr(), s,
                                 out.data_ptr(), cuda_lib.stream_ptr(take_pos))
    ring_gather.launches += 1
    cuda_lib.check(code, "pfmpe_ring_gather")
    return out


ring_gather.launches = 0
