"""Ring gather kernel H (csrc/ring_gather.cu) and its plain PyTorch version.

Ports `pf/pallas_step.py::bank_layout_pin` as the reference's sharded
resampler uses it (`parallel/resample.py:305-311`): the pin is an identity
copy of the concatenated ring blocks ahead of `jnp.take`, and
`bank_restore_pin` follows the gather.  What that chain computes, shard by
shard, is
  out[l, r, t] = cat(blocks_l, 1)[r, take_pos[l, t]] for r < 12,
  rows 12-15 = (0, 0, 0, 1),
which kernel H does in one launch for every local shard, from the blocks
where they lie, never building a concatenation.  With one block and
take_pos = 0..S-1 it returns the block over the constant rows: the two
pins with no gather between them.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_lib

MAX_BLOCKS = 16  # ring blocks a shard
# (shard, block) descriptors a launch: pointer and row stride, 3 KB of the
# kernel's 4 KB of parameters
MAX_ENTRIES = 256


def _as_shards(blocks, take_pos: torch.Tensor):
    """-> (a list of block lists, one a shard; (L, S) positions; whether
    one shard came unbatched: a list of blocks with (S,) positions)."""
    if take_pos.dim() == 1:
        return [list(blocks)], take_pos[None], True
    return [list(shard) for shard in blocks], take_pos, False


def ring_gather_plain(blocks, take_pos: torch.Tensor) -> torch.Tensor:
    """Plain version of `ring_gather`: per shard concatenate, select, constant rows."""
    shards, pos, single = _as_shards(blocks, take_pos)
    s = pos.shape[1]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32,
                          device=pos.device)[:, None].expand(4, s)
    out = torch.stack([torch.cat([torch.cat(shard, dim=1).index_select(1, p), bottom])
                       for shard, p in zip(shards, pos)])
    return out[0] if single else out


def ring_gather(blocks, take_pos: torch.Tensor) -> torch.Tensor:
    """Gather every local shard's S lanes in one launch -> (L, 16, S).

    take_pos: (L, S) int32, positions in the concatenation along the lanes
    of that shard's blocks.  blocks: L lists (one a shard) of 1 to 16
    float32 tensors of 12 rows whose lanes are contiguous; rows may be
    strided and a block may start at any lane, so the top of a (16, S) bank
    or a lane slice of another shard's goes in uncopied.  Block b has the
    same lane count on every shard.  L x blocks is at most 256.  Positions
    must lie inside the concatenation.  One shard may also come unbatched:
    a list of blocks with (S,) positions -> (16, S).  Kernel #7 of the port
    (H)."""
    if take_pos.dtype != torch.int32 or take_pos.dim() not in (1, 2):
        raise ValueError("ring_gather: positions must be an int32 tensor of (S,) or (L, S)")
    shards, pos, single = _as_shards(blocks, take_pos)
    n_shards, s = pos.shape
    count = len(shards[0]) if shards else 0
    if len(shards) != n_shards or n_shards < 1:
        raise ValueError(f"ring_gather: {len(shards)} block lists for {n_shards} shards")
    if not 1 <= count <= MAX_BLOCKS:
        raise ValueError(f"ring_gather: takes 1 to {MAX_BLOCKS} blocks a shard")
    if n_shards * count > MAX_ENTRIES:
        raise ValueError(f"ring_gather: {n_shards} shards x {count} blocks is over the "
                         f"descriptor table's {MAX_ENTRIES} entries")
    lens = [b.shape[-1] for b in shards[0]]
    dev = pos.get_device()
    ptrs, strides = [], []
    for shard in shards:
        if len(shard) != count:
            raise ValueError("ring_gather: every shard takes the same number of blocks")
        for b, n in zip(shard, lens):
            stride = b.stride()
            if b.dtype is not torch.float32 or b.shape != (12, n) or n < 1:
                raise ValueError("ring_gather: block b of every shard must be a (12, len_b >= 1) "
                                 "float32 tensor")
            if (stride[1] != 1 and n > 1) or stride[0] >= 2 ** 31:
                raise ValueError("ring_gather: a block's lanes must be contiguous and its row "
                                 "stride below 2**31")
            if b.get_device() != dev:
                raise ValueError("ring_gather: all tensors must be on one device")
            ptrs.append(b.data_ptr())
            strides.append(stride[0])
    if dev < 0:
        return ring_gather_plain(blocks, take_pos)
    cuda_lib.require_cuda("ring_gather", pos)
    lib = cuda_lib.library()
    n_entries = len(ptrs)
    out = torch.empty((n_shards, 16, s), dtype=torch.float32, device=pos.device)
    code = lib.pfmpe_ring_gather((ctypes.c_void_p * n_entries)(*ptrs),
                                 (ctypes.c_int * n_entries)(*strides), (ctypes.c_int * count)(*lens),
                                 n_shards, count, pos.data_ptr(), s, out.data_ptr(),
                                 cuda_lib.stream_ptr(pos))
    ring_gather.launches += 1
    cuda_lib.check(code, "pfmpe_ring_gather")
    return out[0] if single else out


ring_gather.launches = 0
