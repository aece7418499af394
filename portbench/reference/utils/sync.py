# Frozen copy of pf_monocular_pose_estimator_tpu_torch/utils/sync.py, the port's plain
# PyTorch path, trimmed to what the benchmark's reference calls; it calls no
# kernel and no code of the program.
"""Device -> host reads, counted.

The reference runs its whole frame as one compiled program with
`lax.cond` / `lax.while_loop`; the port turns those into host control
flow, and every value the host branches on is a device -> host copy (a
stream synchronisation on CUDA).  Code that branches takes a `HostReads`
and reads through it, so the tracker can report its syncs per frame.
"""

from __future__ import annotations

import torch


class HostReads:
    """Callable that copies a tensor to a host list and counts the copy."""

    def __init__(self) -> None:
        self.count = 0

    def __call__(self, t: torch.Tensor):
        self.count += 1
        return t.detach().cpu().tolist()
