"""The tracker's bank reductions over a particles mesh (`tracker.bank`'s
interface for a bank (L, 16, S) and weights (L, S) in the sharded layout).

The reference leaves these to GSPMD, which partitions them from sharding
annotations; here they are written out.  Each reduces its local shards,
all_gathers the per-shard partials and combines them in shard order on
every rank, so every rank holds bit-identical values and takes the same
host branches, and a local mesh of P shards equals P ranks of one each.
Sums round differently from the unsharded `torch.sum` (per shard, then over
shards); max, argmax and lane reads are exact.
"""

from __future__ import annotations

import torch

from ..tracker.initialise import fill_bank_with_seeds
from .comm import shard_index


class ShardedBank:
    def __init__(self, mesh):
        self.mesh = mesh

    def n_lanes(self, weights: torch.Tensor) -> int:
        return self.mesh.size * weights.shape[-1]

    def max(self, weights: torch.Tensor) -> torch.Tensor:
        return torch.max(self.mesh.all_gather(torch.amax(weights, dim=1)))

    def moments(self, weights: torch.Tensor):
        partial = torch.stack([torch.sum(weights, dim=1), torch.sum(weights * weights, dim=1)], 1)
        total = torch.sum(self.mesh.all_gather(partial), dim=0)
        return total[0], total[1]

    def argmax(self, weights: torch.Tensor) -> torch.Tensor:
        best, lane = torch.max(weights, dim=1)
        # a weight and a lane (< 2**24, so exact in float32) in one gather
        packed = self.mesh.all_gather(torch.stack([best, lane.to(best.dtype)], 1))
        winner = torch.argmax(packed[:, 0]).reshape(1)
        return winner[0] * weights.shape[1] + packed.index_select(0, winner)[0, 1].to(torch.int64)

    def pick_lane(self, bank16: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        s = bank16.shape[-1]
        local = torch.clamp(idx - shard_index(self.mesh, bank16.device) * s, 0, s - 1)  # (L,)
        cols = torch.gather(bank16, 2, local[:, None, None].expand(-1, 16, 1))[:, :, 0]
        owner = torch.div(idx, s, rounding_mode="floor").reshape(1)
        return self.mesh.all_gather(cols).index_select(0, owner)[0]

    def head(self, bank16: torch.Tensor, k: int) -> torch.Tensor:
        s = bank16.shape[-1]
        if k <= s:
            return self.mesh.broadcast_from(bank16[:, :, :k], 0)
        full = self.mesh.all_gather(bank16).movedim(0, 1)  # (16, P, S)
        return full.reshape(16, -1)[:, :k]

    def fill_seeds(self, bank16, seeds, seed_mask) -> torch.Tensor:
        s = bank16.shape[-1]
        return torch.stack([
            fill_bank_with_seeds(bank16[i], seeds, seed_mask, r * s, self.mesh.size * s)
            for i, r in enumerate(self.mesh.ranks)])
