#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port: end-to-end tracking throughput on one card.

The port's counterpart of `bench.py`, with its flags, sequence,
configuration and JSON keys: frames per second at 752x480 with a
100k-particle bank over the 480-frame synthetic orbit, the full pipeline
per frame (blob detection -> PF propagate / weight -> ESS-gated
resampling -> Gauss-Newton refine).  `vs_baseline` is against the 50
frames/s real-time bar.

    python3 bench_torch.py                  # the main path on the card
    python3 bench_torch.py --targets 2      # two targets, one after another
    python3 bench_torch.py --sharded        # the mesh program on a mesh of the cards
    python3 bench_torch.py --ess-tau 0.0    # resample on every accepted frame
    python3 bench_torch.py --device cpu --particles 2000 --frames 8 --runs 1

Eager PyTorch has no `lax.scan`: the frame loop runs on the host
(`run_sequence`), with a new tracker for every run from the same initial
state.  The frame rate follows the host's share of the CPU, so the script
times `--runs` runs and reports the best as `value` (as `bench.py` does)
beside their median and spread, the device -> host syncs per frame and the
accuracy against the sequence's poses.  `compile_s` is the first run's
seconds, the kernel library's build or load included; with `--no-cache`
the library is built into a fresh temporary directory, a cold `nvcc` build.
The one JSON line is the last line of the output.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from pf_monocular_pose_estimator_tpu_torch.io.metrics import (absolute_trajectory_error,
                                                              orientation_error_deg)
from pf_monocular_pose_estimator_tpu_torch.io.synthetic import (default_camera, demo_markers,
                                                                make_orbit_sequence)
from pf_monocular_pose_estimator_tpu_torch.parallel import (make_mesh, make_sharded_tracker,
                                                            shard_target_state)
from pf_monocular_pose_estimator_tpu_torch.tracker import (TargetState, create_states,
                                                           make_multi_tracker, make_tracker)
from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig, cuda_lib
from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

BASELINE_FPS = 50.0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--targets", type=int, default=1)
    ap.add_argument("--frames", type=int, default=480)
    # the mesh program (kernel B per shard, the ring resampler and kernel H)
    # on a mesh of one shard a card
    ap.add_argument("--sharded", action="store_true")
    # the ESS resampling gate (None = TrackerConfig's 0.15; 0.0 = resample
    # every accepted frame, the reference's semantics)
    ap.add_argument("--ess-tau", type=float, default=None)
    ap.add_argument("--no-cache", action="store_true",
                    help="build the kernel library into a fresh temporary directory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu (the plain twins, for tests)")
    ap.add_argument("--runs", type=int, default=5, help="timed runs")
    ap.add_argument("--warmup", type=int, default=1, help="untimed runs before them")
    args = ap.parse_args(argv)
    if args.sharded and args.targets > 1:
        ap.error("--sharded and --targets are mutually exclusive "
                 "(the multi-target mesh path is benchmarks/sharded_bench.py)")
    if args.runs < 1 or args.warmup < 1:
        ap.error("--runs and --warmup must be at least 1")
    return args


def label(args: argparse.Namespace) -> str:
    """`bench.py`'s metric name for these flags."""
    return f"tracking_fps_752x480_{args.particles//1000}k_particles" + (
        f"_{args.targets}targets" if args.targets > 1 else ""
    ) + ("_sharded_mesh" if args.sharded else "") + (
        f"_ess{args.ess_tau}" if args.ess_tau is not None else ""
    )


def make_config(args: argparse.Namespace) -> TrackerConfig:
    cfg_kw = dict(n_particles=args.particles, min_blob_area=8.0, pf_max_retries=8,
                  roi_particle_subsample=128)
    if args.ess_tau is not None:
        cfg_kw["resample_min_ess"] = args.ess_tau
    return TrackerConfig(**cfg_kw)


def make_path(args: argparse.Namespace, camera, markers, config: TrackerConfig, device):
    """(make_step, state0) of the path the flags choose: `make_step()` builds
    a new step and `state0` is the state every run starts from."""
    n = args.particles
    mask = torch.ones(markers.shape[0], dtype=torch.bool)
    if args.targets > 1:
        # bench.py's lax.map over the targets: the per-target loop
        markers_t = markers.expand(args.targets, *markers.shape)
        masks_t = mask.expand(args.targets, markers.shape[0])
        return (lambda: make_multi_tracker(camera, markers_t, masks_t, config, sequential=True,
                                           device=device),
                create_states(args.targets, n, seed=0, device=device))
    if args.sharded:
        mesh = make_mesh(torch.cuda.device_count() or 1)
        return (lambda: make_sharded_tracker(camera, markers, mask, config, mesh, device=device),
                shard_target_state(TargetState.create(n, prng_key(0), device=device), mesh))
    return (lambda: make_tracker(camera, markers, mask, config, device=device),
            TargetState.create(n, prng_key(0), device=device))


def run_sequence(step, state, frames: torch.Tensor, times: torch.Tensor):
    """Step `state` through `frames` (T, H, W) at `times` (T,) ->
    (state, flags (T,), updated (T,), poses (T, 4, 4)), stacked on the
    frames' device with no read back to the host.  A multi-target step
    gives target 0's flag and pose and whether every target updated, as
    `bench.py` keeps them."""
    flags, updated, poses = [], [], []
    for i in range(frames.shape[0]):
        state, res = step(state, frames[i], times[i])
        if res.pose.dim() == 3:
            flags.append(res.fail_flag[0])
            updated.append(res.pose_updated.all())
            poses.append(res.pose[0])
        else:
            flags.append(res.fail_flag)
            updated.append(res.pose_updated)
            poses.append(res.pose)
    return state, torch.stack(flags), torch.stack(updated), torch.stack(poses)


def fence(flags: torch.Tensor) -> np.ndarray:
    """Wait for the card to finish, then read the flags back to the host."""
    if flags.is_cuda:
        torch.cuda.synchronize(flags.device)
    return flags.cpu().numpy()


def power_limit() -> str | None:
    """The first card's power limit as `nvidia-smi` reports it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return None
    fields = out.splitlines()[0].split(",") if out.strip() else []
    return fields[-1].strip() if len(fields) > 1 else None


def host_cpu() -> str | None:
    """The host CPU's model name, from /proc/cpuinfo."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


def main(argv=None) -> dict:
    """Run the benchmark, print its JSON line and return it as a dict."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: --device cuda needs a GPU and torch sees none; "
                           "pass --device cpu to run the plain twins on the CPU")
    camera = default_camera(device)
    markers = demo_markers(device)
    config = make_config(args)

    t0 = time.perf_counter()
    seq = make_orbit_sequence(camera, markers, num_frames=args.frames, fps=50.0, device=device)
    fence(seq.times)
    render_s = time.perf_counter() - t0
    make_step, state0 = make_path(args, camera, markers, config, device)
    gt_poses = seq.poses.cpu().numpy()

    with tempfile.TemporaryDirectory(prefix="pfmpe_kernels_") as fresh:
        def run(first: bool = False):
            step = make_step()
            fence(seq.times)
            t0 = time.perf_counter()
            if first and args.no_cache and device.type == "cuda":
                cuda_lib.library(fresh)
            _, flags, updated, poses = run_sequence(step, state0, seq.frames, seq.times)
            fence(flags)
            return time.perf_counter() - t0, step, updated, poses

        compile_s = run(first=True)[0]
        for _ in range(args.warmup - 1):
            run()
        timed = [run() for _ in range(args.runs)]

    fps_runs = [args.frames / seconds for seconds, *_ in timed]
    fps = max(fps_runs)
    _, step, updated, poses = timed[-1]
    updated = updated.cpu().numpy()
    poses = poses.cpu().numpy()
    out = {
        "metric": label(args),
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        # particle-weighting throughput: >= 1 PF sweep per tracked frame
        "particles_weighted_per_s": round(fps * args.particles * args.targets),
        "updated_frames_fraction": round(float(updated.mean()), 3),
        "compile_s": round(compile_s, 1),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "power_limit": power_limit() if device.type == "cuda" else None,
        "host_cpu": host_cpu(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "fps_median": statistics.median(fps_runs),
        "fps_min": min(fps_runs),
        "fps_max": fps,
        "fps_runs": fps_runs,
        "syncs_per_frame": step.host.count / step.frames,
        "ate_mm": absolute_trajectory_error(poses, gt_poses, updated) * 1e3,
        "orientation_deg": orientation_error_deg(poses, gt_poses, updated),
        "render_s": render_s,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
