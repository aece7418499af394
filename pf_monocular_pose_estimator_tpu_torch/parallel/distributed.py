"""Several processes, one shard each (port of `parallel/distributed.py`):
`torch.distributed` initialisation, the ('targets', 'particles') mesh over
every rank, the frame every rank feeds its tracker, and the per-process
main.

Every process runs the same program on the same frames.  The collectives
of the sharded step (`parallel.resample`, `parallel.bank`) go over `nccl`
between cards and `gloo` on the CPU.  Nothing here finds a cluster by
itself: the caller gives the rendezvous (`tcp://host:port` or
`file:///path`), the world size and the rank.  One command per process:

    python -m pf_monocular_pose_estimator_tpu_torch.parallel.distributed \
        --coordinator tcp://host0:8476 --num-processes 4 --process-id $ID \
        --particles 1000000
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

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


def make_pod_mesh(target_devices: int = 1):
    """The ('targets', 'particles') mesh over every rank of the job:
    `target_devices` groups of P = world / target_devices consecutive ranks,
    each a sub-group carrying its own particles mesh; this rank gets the
    `DistMesh` of its group.  Every rank must call it, in the same order,
    once `initialize_distributed` has run.  Without a distributed job, one
    local shard holding every target group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return LocalMesh(1, target_devices)
    world, rank = dist.get_world_size(), dist.get_rank()
    if target_devices < 1 or world % target_devices:
        raise ValueError(f"{world} ranks do not divide into {target_devices} target groups")
    p = world // target_devices
    groups = [dist.new_group(list(range(g * p, (g + 1) * p))) for g in range(target_devices)]
    return DistMesh(groups[rank // p], target_shards=target_devices, target_index=rank // p)


def broadcast_frame(frame: np.ndarray, device) -> torch.Tensor:
    """Host (H, W) frame -> float32 tensor on this rank's device.  Every
    process passes its own copy of the same frame (one camera feeds all
    hosts), so nothing crosses between ranks."""
    return torch.as_tensor(np.asarray(frame), dtype=torch.float32).to(device)


def run_multihost(argv=None) -> dict:
    """The per-process main: track a rendered orbit sequence with the bank
    sharded over the pod mesh, and print (rank 0) one JSON line of
    processes, devices, particles, frames, tracked frames and frames per
    second; returns the same dict.  `--targets T` tracks T copies of the
    target through `make_sharded_multi_tracker` (a frame counts as tracked
    when every target updated).  Runs on the card unless `--device cpu`."""
    ap = argparse.ArgumentParser(description="multi-host PF tracker (PyTorch + CUDA)")
    ap.add_argument("--coordinator", type=str, default=None,
                    help="rendezvous: tcp://host:port or file:///path")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--targets", type=int, default=1)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    pid = initialize_distributed(args.coordinator, args.num_processes, args.process_id)
    import torch.distributed as dist

    from ..io.synthetic import default_camera, demo_markers, make_orbit_sequence
    from ..tracker.multi import create_states
    from ..tracker.state import TargetState
    from ..utils.config import TrackerConfig
    from ..utils.prng import prng_key
    from .mesh import make_sharded_multi_tracker, make_sharded_tracker, shard_target_state

    world = dist.get_world_size() if dist.is_initialized() else 1
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", pid % torch.cuda.device_count())
    camera = default_camera(device)
    markers = demo_markers(device)
    mask = torch.ones(markers.shape[0], dtype=torch.bool)
    config = TrackerConfig(n_particles=args.particles, min_blob_area=8.0, pf_max_retries=8)
    if args.targets == 1:
        mesh = make_pod_mesh(1)
        step = make_sharded_tracker(camera, markers, mask, config, mesh, device=device)
        state = shard_target_state(TargetState.create(config.n_particles, prng_key(0),
                                                      device=device), mesh)
    else:
        mesh = make_pod_mesh(math.gcd(args.targets, world))
        t = args.targets
        step = make_sharded_multi_tracker(camera, markers.expand(t, -1, -1), mask.expand(t, -1),
                                          config, mesh, device=device)
        state = shard_target_state(create_states(t, config.n_particles, 0, device=device), mesh,
                                   batched=True)
    seq = make_orbit_sequence(camera, markers, num_frames=args.frames, fps=50.0, device=device)
    frames, times = seq.frames.cpu().numpy(), seq.times.cpu().numpy()

    tracked = 0
    t0 = time.perf_counter()
    for i in range(args.frames):
        frame = broadcast_frame(frames[i], device)
        state, res = step(state, frame, float(times[i]))
        tracked += int(bool(torch.all(res.pose_updated)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    summary = {"processes": world, "devices": world, "particles": args.particles,
               "frames": args.frames, "targets": args.targets, "tracked": tracked,
               "fps": round(args.frames / wall, 2)}
    if pid == 0:
        print(json.dumps(summary))
    return summary


def main(argv=None) -> int:
    """The console entry (`pfmpe-multihost-torch`): `run_multihost`, exit code 0."""
    run_multihost(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
