"""Several processes, one shard each (port of `parallel/distributed.py`):
`torch.distributed` initialisation, the mesh over every rank, and the frame
every rank feeds its tracker.

Every process runs the same program on the same frames.  The collectives
of the sharded step (`parallel.resample`, `parallel.bank`) go over `nccl`
between cards and `gloo` on the CPU.  Nothing here finds a cluster by
itself: the caller gives the rendezvous (`tcp://host:port` or
`file:///path`), the world size and the rank.
"""

from __future__ import annotations

import numpy as np
import torch

from .comm import DistMesh, LocalMesh


def initialize_distributed(init_method: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, backend: str | None = None) -> int:
    """Initialise `torch.distributed`; a no-op for a single process
    (num_processes in (None, 1)).  The backend defaults to `nccl` where a
    card is present and `gloo` elsewhere.  Returns the process id."""
    if num_processes is None or num_processes <= 1:
        return 0
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    return dist.get_rank()


def make_pod_mesh():
    """The particles mesh over every rank of the job: one shard per rank
    once `initialize_distributed` has run, else a single local shard."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return DistMesh()
    return LocalMesh(1)


def broadcast_frame(frame: np.ndarray, device) -> torch.Tensor:
    """Host (H, W) frame -> float32 tensor on this rank's device.  Every
    process passes its own copy of the same frame (one camera feeds all
    hosts), so nothing crosses between ranks."""
    return torch.as_tensor(np.asarray(frame), dtype=torch.float32).to(device)


def run_multihost(argv=None):
    """The reference's per-process main renders a synthetic orbit sequence
    (`io/synthetic.py`), which is not ported yet."""
    raise NotImplementedError(
        "run_multihost needs io/synthetic.py: ROADMAP.md 'Modules still to port', item 5 (io/)")
