"""What the tracker asks of the whole particle bank: the few reductions,
lane reads and lane-indexed writes of a frame.  `WholeBank` answers them
for one (16, N) bank on one device; `parallel.bank.ShardedBank` for a bank
cut over a particles mesh.  Everything else the tracker does to a bank is
elementwise over lanes and takes either layout as it is."""

from __future__ import annotations

import torch

from ..pf.soa import pick_lane
from .initialise import fill_bank_with_seeds


class WholeBank:
    """Bank (16, N), weights (N,)."""

    def n_lanes(self, weights: torch.Tensor) -> int:
        return weights.shape[0]

    def max(self, weights: torch.Tensor) -> torch.Tensor:
        return torch.max(weights)

    def moments(self, weights: torch.Tensor):
        """(sum w, sum w^2)."""
        return torch.sum(weights), torch.sum(weights * weights)

    def argmax(self, weights: torch.Tensor) -> torch.Tensor:
        """First lane of the largest weight (0-d int64)."""
        return torch.argmax(weights)

    def pick_lane(self, bank16: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """(16,): the pose in lane `idx` (held on the device)."""
        return pick_lane(bank16, idx)

    def head(self, bank16: torch.Tensor, k: int) -> torch.Tensor:
        """(16, k): the first k lanes."""
        return bank16[:, :k]

    def fill_seeds(self, bank16, seeds, seed_mask) -> torch.Tensor:
        return fill_bank_with_seeds(bank16, seeds, seed_mask)
