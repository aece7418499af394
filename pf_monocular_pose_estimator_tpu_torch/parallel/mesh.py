"""Sharding the particle bank over a particles mesh, and targets over
groups of it (port of `parallel/mesh.py`).

The reference annotates the bank-shaped leaves of the state and lets GSPMD
partition one compiled step.  PyTorch has no such partitioner: the sharded
tracker is the ordinary host-driven `Tracker` with the two hooks of the
reference (`pf_fn`, `resample_fn`) and its bank kept in the mesh's layout
(`comm`): bank and resampled (L, 16, S), weights (L, S), every small leaf
replicated.  The bank's few cross-shard reductions are written out in
`parallel.bank`.

`make_sharded_multi_tracker` is the reference's targets x particles
tracker: each target a sharded tracker of its own, the targets taking turns
on a local mesh, or each group of ranks of a distributed job holding its
block of targets.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry.camera import Camera
from ..tracker.multi import MultiTracker, stack_states, target_state
from ..tracker.state import FrameResult, TargetState
from ..tracker.step import Tracker, check_card_limits
from ..utils.config import TrackerConfig
from .comm import DistMesh, LocalMesh, shard_lanes, unshard_lanes
from .pf_kernels import make_sharded_pf_fn
from .resample import make_distributed_resampler

_BANK_LEAVES = ("bank", "resampled", "weights")


def make_mesh(particle_shards: int, target_shards: int = 1) -> LocalMesh:
    """A ('targets', 'particles') mesh in this process, all on the tracker's
    device: `target_shards` groups of targets, each over `particle_shards`
    shards.  One shard per `torch.distributed` rank:
    `parallel.distributed.make_pod_mesh`."""
    return LocalMesh(particle_shards, target_shards)


def shard_target_state(state: TargetState, mesh, batched: bool = False) -> TargetState:
    """Cut the bank-shaped leaves of a whole state into the mesh's layout
    (this process's shards); the small leaves stay as they are.  With
    `batched`, a multi-target state (T, ...) keeps the targets this process
    holds (`mesh.owned_targets`), each bank cut the same way:
    (T_own, L, 16, S)."""
    if not batched:
        return state.replace(**{name: shard_lanes(mesh, getattr(state, name))
                                for name in _BANK_LEAVES})
    owned = mesh.owned_targets(state.key.shape[0])
    return stack_states([shard_target_state(target_state(state, t), mesh) for t in owned])


def unshard_target_state(state: TargetState, mesh, batched: bool = False) -> TargetState:
    """The inverse of `shard_target_state`, on every rank (all_gathers of
    the bank, and with `batched` of every target: for tests, results and
    checkpoints, not for the per-frame path)."""
    if not batched:
        return state.replace(**{name: unshard_lanes(mesh, getattr(state, name))
                                for name in _BANK_LEAVES})
    whole = stack_states([unshard_target_state(target_state(state, i), mesh)
                          for i in range(state.key.shape[0])])
    return TargetState(**{f.name: mesh.gather_targets(getattr(whole, f.name))
                          for f in dataclasses.fields(TargetState)})


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
    the reference's sharded step takes none.  So does, on a CUDA device, a
    configuration the card's kernels do not take (`check_card_limits`)."""
    if config.use_cam_pos:
        raise ValueError("make_sharded_tracker: use_cam_pos=True needs an observer pose each "
                         "frame, and the sharded step takes none (nor does the reference's "
                         "parallel/mesh.py::make_sharded_tracker); use make_tracker")
    tracker_device = torch.device(device)
    if tracker_device.type == "cuda":  # before anything reaches the card
        check_card_limits(config, len(markers_h))
    camera = camera.to(tracker_device)
    return Tracker(
        camera, markers_h, marker_mask, config, tracker_device,
        pf_fn=make_sharded_pf_fn(mesh, camera, config),
        resample_fn=make_distributed_resampler(mesh, config.n_particles, reach=resample_reach,
                                               payload_window=payload_window,
                                               cdf_chunk=cdf_chunk),
        mesh=mesh)


def _pack_results(results: FrameResult) -> tuple[torch.Tensor, list]:
    """A stacked `FrameResult` (T, ...) -> (T, F) int32, every field's bits
    as they are (bool as 0 / 1), and the layout to unpack it."""
    t = results.pose.shape[0]
    cols, layout = [], []
    for f in dataclasses.fields(FrameResult):
        x = getattr(results, f.name).reshape(t, -1)
        bits = x.to(torch.int32) if x.dtype == torch.bool else x.contiguous().view(torch.int32)
        cols.append(bits)
        layout.append((f.name, bits.shape[1], x.dtype, getattr(results, f.name).shape[1:]))
    return torch.cat(cols, 1), layout


def _unpack_results(packed: torch.Tensor, layout: list) -> FrameResult:
    out, col = {}, 0
    for name, width, dtype, shape in layout:
        bits = packed[:, col:col + width].contiguous()
        col += width
        x = bits != 0 if dtype == torch.bool else bits.view(dtype)
        out[name] = x.reshape(packed.shape[0], *shape)
    return FrameResult(**out)


def make_sharded_multi_tracker(camera: Camera, markers_t, masks_t, config: TrackerConfig, mesh,
                               resample_reach: int = 1, payload_window="auto",
                               cdf_chunk: int | None = None, device="cuda") -> MultiTracker:
    """The per-frame step over targets (markers_t (T, M, 4), masks_t (T, M)),
    each target's bank sharded over the particles mesh: `step(states, image,
    t) -> (states', results)`, with states from `shard_target_state(...,
    batched=True)` and results a `FrameResult` of every target (T, ...).

    On a local mesh (`make_mesh(P, target_shards)`) the targets take turns,
    each a `make_sharded_tracker` step with its bank in the (L, 16, S)
    layout: kernel B per shard, H once a resampling, D.  On a distributed
    job (`make_pod_mesh(target_devices)`) each group of ranks holds
    T / target_devices targets; every cross-shard reduction of a target goes
    over its group only, never the whole job, since different groups take
    different host branches.  After the step one all_gather over the job of
    the packed result fields gives every rank every target's results, as the
    reference's results are one global array; the tracker counts it among
    its syncs.  The ring arguments are `make_sharded_tracker`'s, per target.
    `use_cam_pos=True` raises, as it does there."""
    if config.use_cam_pos:
        raise ValueError("make_sharded_multi_tracker: use_cam_pos=True needs an observer pose "
                         "each frame, and the sharded step takes none; use make_multi_tracker")
    markers_t = torch.as_tensor(markers_t, dtype=torch.float32)
    masks_t = torch.as_tensor(masks_t).to(torch.bool)
    trackers = [make_sharded_tracker(camera, markers_t[t], masks_t[t], config, mesh,
                                     resample_reach, payload_window, cdf_chunk, device)
                for t in mesh.owned_targets(markers_t.shape[0])]
    gather = None
    if isinstance(mesh, DistMesh):
        def gather(results):
            packed, layout = _pack_results(results)
            return _unpack_results(mesh.gather_targets(packed), layout)
    return MultiTracker(trackers, gather)
