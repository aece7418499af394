"""Sharding the particle bank over a particles mesh (port of
`parallel/mesh.py`).

The reference annotates the bank-shaped leaves of the state and lets GSPMD
partition one compiled step.  PyTorch has no such partitioner: the sharded
tracker is the ordinary host-driven `Tracker` with the two hooks of the
reference (`pf_fn`, `resample_fn`) and its bank kept in the mesh's layout
(`comm`): bank and resampled (L, 16, S), weights (L, S), every small leaf
replicated.  The bank's few cross-shard reductions are written out in
`parallel.bank`.

`make_sharded_multi_tracker` (targets x particles) waits for the port of
`tracker/multi.py`.
"""

from __future__ import annotations

import torch

from ..geometry.camera import Camera
from ..tracker.state import TargetState
from ..tracker.step import Tracker
from ..utils.config import TrackerConfig
from .comm import LocalMesh, shard_lanes, unshard_lanes
from .pf_kernels import make_sharded_pf_fn
from .resample import make_distributed_resampler

_BANK_LEAVES = ("bank", "resampled", "weights")


def make_mesh(particle_shards: int) -> LocalMesh:
    """A particles mesh of `particle_shards` shards in this process, all on
    the tracker's device.  One shard per `torch.distributed` rank:
    `parallel.distributed.make_pod_mesh`."""
    return LocalMesh(particle_shards)


def shard_target_state(state: TargetState, mesh) -> TargetState:
    """Cut the bank-shaped leaves of a whole state into the mesh's layout
    (this process's shards); the small leaves stay as they are."""
    return state.replace(**{name: shard_lanes(mesh, getattr(state, name))
                            for name in _BANK_LEAVES})


def unshard_target_state(state: TargetState, mesh) -> TargetState:
    """The inverse of `shard_target_state`, on every rank (an all_gather of
    the bank: for tests and results, not for the per-frame path)."""
    return state.replace(**{name: unshard_lanes(mesh, getattr(state, name))
                            for name in _BANK_LEAVES})


def make_sharded_tracker(camera: Camera, markers_h, marker_mask, config: TrackerConfig, mesh,
                         resample_reach: int = 1, payload_window="auto",
                         cdf_chunk: int | None = None, device="cuda") -> Tracker:
    """The per-frame step for one target with the bank sharded over `mesh`;
    the state goes through `shard_target_state` first.

    Resampling is the explicit distributed scheme (`parallel.resample`):
    scalar collectives and a reach-limited ring, never an all_gather of the
    bank.  The propagate + weight pass runs per shard
    (`parallel.pf_kernels`).  `payload_window` and `cdf_chunk` go to
    `make_distributed_resampler`; draws beyond the window or the reach are
    clamped and counted in `FrameResult.resample_clipped` (cumulative):
    widen the window, or pass None for whole blocks, if it rises.

    `use_cam_pos=True` raises: the sharded step takes no observer pose, as
    the reference's sharded step takes none."""
    if config.use_cam_pos:
        raise ValueError("make_sharded_tracker: use_cam_pos=True needs an observer pose each "
                         "frame, and the sharded step takes none (nor does the reference's "
                         "parallel/mesh.py::make_sharded_tracker); use make_tracker")
    tracker_device = torch.device(device)
    camera = camera.to(tracker_device)
    return Tracker(
        camera, markers_h, marker_mask, config, tracker_device,
        pf_fn=make_sharded_pf_fn(mesh, camera, config),
        resample_fn=make_distributed_resampler(mesh, config.n_particles, reach=resample_reach,
                                               payload_window=payload_window,
                                               cdf_chunk=cdf_chunk),
        mesh=mesh)
