"""run_tracker CLI (port of `io/cli.py`), on the card unless told otherwise.

One command loads a camera calibration and a marker YAML (or takes the
default camera and demo markers), reads a sequence (npz or a recorded
`.pfsq`) or renders the synthetic orbit, runs the tracker over the frames
and reports per-frame status and timings and, where ground truth exists,
ATE and orientation error, as one JSON line last.

Usage:
  python -m pf_monocular_pose_estimator_tpu_torch.io.cli --synthetic \
      --frames 60 --particles 1000 [--device cpu] [--save-video out.npz]
  python -m pf_monocular_pose_estimator_tpu_torch.io.cli \
      --config configs/experiments/uav_target.yaml

Flags, their precedence (flag > experiment file > built-in default) and
the summary's keys are the JAX CLI's.  Where it differs: `--device` takes
`cuda` (the default) or `cpu`; `--profile DIR` writes a `torch.profiler`
trace (`DIR/trace.json`, CPU and CUDA activity, with the frame step's
`utils/trace.py` spans); there is no `--no-cache`,
as there is no compilation cache to turn off.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..pf.soa import unpack
from ..tracker import (TargetState, create_states, make_multi_tracker, make_tracker,
                       pad_marker_sets)
from ..utils import TrackerConfig, save_state, trace
from ..utils.prng import prng_key
from .experiment import load_experiment
from .markers import load_camera_calibration, load_marker_positions
from .metrics import absolute_trajectory_error, orientation_error_deg
from .seqio import SequenceReader, record_sequence
from .synthetic import default_camera, demo_markers, make_orbit_sequence
from .viz import render_overlay

# the particles whose trivectors an overlay draws (render_overlay's default)
_OVERLAY_PARTICLES = 64


def build_parser():
    p = argparse.ArgumentParser(description="LED-marker pose tracker (PyTorch + CUDA)")
    p.add_argument(
        "--config",
        type=str,
        help="experiment YAML (io/experiment.py); explicit CLI flags override file values",
    )
    p.add_argument("--synthetic", action="store_true", help="run on a synthetic orbit sequence")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--fps", type=float, default=None)
    p.add_argument("--particles", type=int, default=None)
    p.add_argument("--camera", type=str, help="camera calibration YAML")
    p.add_argument("--markers", type=str, help="marker positions YAML (reference schema)")
    p.add_argument("--markers-per-object", type=int, nargs="*", help="numberOfMarkersUAVk split")
    p.add_argument(
        "--sequence", type=str,
        help="npz with frames (T,H,W) and times (T,), or a recorded .pfsq container",
    )
    p.add_argument("--record", type=str, help="record the input sequence to this .pfsq container")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--occlusions", type=int, default=None)
    p.add_argument("--false-detections", type=int, default=None)
    p.add_argument("--pf-retries", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--save-video", type=str,
                   help="write annotated frames to .npz (single-target runs)")
    p.add_argument("--checkpoint", type=str, help="save final tracker state here")
    p.add_argument("--json", action="store_true", help="machine-readable summary only")
    p.add_argument(
        "--exposure-control",
        action="store_true",
        help="run the online exposure state machine (reports exposure_us)",
    )
    p.add_argument("--expose-time-base", type=float, default=None)
    p.add_argument(
        "--num-targets",
        type=int,
        default=None,
        help="track multiple objects (markers split via --markers-per-object, "
        "or the same marker set replicated)",
    )
    p.add_argument("--profile", type=str,
                   help="write a torch.profiler trace (CPU and CUDA activity) to this dir")
    return p


def resolve(argv=None):
    """Parse `argv` and fill what it leaves unset from the experiment file
    (`--config`), then from the built-in defaults: (args, tracker overrides)."""
    args = build_parser().parse_args(argv)

    exp = {"tracker": {}, "run": {}}
    if args.config:
        exp = load_experiment(args.config)
        run = exp["run"]
        # the file fills anything the CLI left unset
        if args.camera is None:
            args.camera = exp["camera"]
        if args.markers is None:
            args.markers = exp["markers"]
        if args.markers_per_object is None:
            args.markers_per_object = exp["markers_per_object"]
        if args.num_targets is None:
            args.num_targets = exp["num_targets"]
        if args.sequence is None:
            args.sequence = run.get("sequence")
        if not args.synthetic:
            args.synthetic = bool(run.get("synthetic", False))
        for name in ("frames", "fps", "seed"):
            if getattr(args, name) is None and name in run:
                setattr(args, name, run[name])

    # tracker-field precedence: explicit CLI flag > experiment file > built-in
    cli_tracker = {}
    if args.particles is not None:
        cli_tracker["n_particles"] = args.particles
    if args.pf_retries is not None:
        cli_tracker["pf_max_retries"] = args.pf_retries
    if args.occlusions is not None:
        cli_tracker["number_of_occlusions"] = args.occlusions
    if args.false_detections is not None:
        cli_tracker["number_of_false_detections"] = args.false_detections
    if args.exposure_control:
        cli_tracker["use_online_exposure_control"] = True
    if args.expose_time_base is not None:
        cli_tracker["expose_time_base"] = args.expose_time_base
    tracker_overrides = {**exp["tracker"], **cli_tracker}

    # built-in defaults for anything still unset
    for name, default in (("frames", 60), ("fps", 50.0), ("seed", 0), ("num_targets", 1)):
        if getattr(args, name) is None:
            setattr(args, name, default)
    return args, tracker_overrides


def main(argv=None):
    args, tracker_overrides = resolve(argv)

    device = torch.device(args.device)
    camera = load_camera_calibration(args.camera, device) if args.camera else default_camera(device)
    if args.markers:
        marker_sets = load_marker_positions(args.markers, args.markers_per_object)
        markers = torch.from_numpy(marker_sets[0]).to(device)
    else:
        markers = demo_markers(device)

    # the sequence goes to the device once, as float32 (T, H, W)
    gt_poses = None
    if args.sequence:
        if args.sequence.endswith(".pfsq"):
            with SequenceReader(args.sequence) as reader:
                f_np, t_np = reader.arrays()
        else:
            data = np.load(args.sequence)
            f_np = data["frames"]
            t_np = data["times"] if "times" in data else np.arange(f_np.shape[0]) / args.fps
            if "poses" in data:
                gt_poses = np.asarray(data["poses"])
        frames = torch.from_numpy(np.ascontiguousarray(f_np)).to(device).to(torch.float32)
        times_host = np.asarray(t_np, np.float32)
        times = torch.from_numpy(times_host).to(device)
    elif args.synthetic:
        seq = make_orbit_sequence(camera, markers, num_frames=args.frames, fps=args.fps,
                                  seed=args.seed, device=device)
        frames, times, gt_poses = seq.frames, seq.times, seq.poses.cpu().numpy()
        times_host = times.cpu().numpy()
    else:
        print("error: provide --synthetic or --sequence", file=sys.stderr)
        return 2

    if args.record:
        record_sequence(args.record, np.clip(frames.cpu().numpy(), 0, 255).astype(np.uint8),
                        times_host)
        if not args.json:
            print(f"recorded {frames.shape[0]} frames -> {args.record}")

    config = TrackerConfig(**{
        "n_particles": 1000,
        "min_blob_area": 8.0,
        "pf_max_retries": 20,
        **tracker_overrides,
    })
    multi = args.num_targets > 1
    if multi:
        if args.markers and args.markers_per_object:
            markers_t, masks_t = pad_marker_sets(
                load_marker_positions(args.markers, args.markers_per_object))
        else:
            markers_t = markers.expand(args.num_targets, markers.shape[0], 4)
            masks_t = torch.ones((args.num_targets, markers.shape[0]), dtype=torch.bool)
        step = make_multi_tracker(camera, markers_t, masks_t, config, sequential=True,
                                  device=device)
        state = create_states(args.num_targets, config.n_particles, args.seed,
                              (camera.width, camera.height), device=device)
    else:
        step = make_tracker(camera, markers, torch.ones(markers.shape[0], dtype=torch.bool),
                            config, device=device)
        state = TargetState.create(config.n_particles, prng_key(args.seed), device=device)

    profiler = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.__enter__()
        trace.enable()  # the frame step's spans in the trace, beside the device events

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    est, upd, flags, annotated = [], [], [], []
    # per-frame latency as the reference's timePoseEst / timeInitEst topics:
    # the whole step's wall time, and the same time on frames where the
    # brute-force initialiser ran
    time_pose_est_ms, time_init_est_ms = [], []
    sync()
    t_start = time.perf_counter()
    for i in range(frames.shape[0]):
        t0 = time.perf_counter()
        state, res = step(state, frames[i], times[i])
        sync()
        dt_ms = (time.perf_counter() - t0) * 1e3
        # pose, pose_updated, fail_flag, used_brute_force: one copy, (targets, 19)
        host = torch.cat([res.pose.reshape(-1, 16), res.pose_updated.reshape(-1, 1),
                          res.fail_flag.reshape(-1, 1), res.used_brute_force.reshape(-1, 1)],
                         1).to(torch.float32).cpu().numpy()
        time_pose_est_ms.append(round(dt_ms, 3))
        time_init_est_ms.append(round(dt_ms, 3) if host[:, 18].any() else 0.0)
        pose, updated, flag = host[:, :16].reshape(-1, 4, 4), host[:, 16] != 0, host[:, 17]
        if multi:
            est.append(pose)
            upd.append(updated)
            flags.append(flag.astype(int).tolist())
        else:
            est.append(pose[0])
            upd.append(bool(updated[0]))
            flags.append(int(flag[0]))
        if args.save_video and not multi:
            # only the lanes the overlay draws leave the device
            annotated.append(render_overlay(frames[i], camera, res,
                                            unpack(state.bank[:, :_OVERLAY_PARTICLES]),
                                            state.weights[:_OVERLAY_PARTICLES],
                                            max_particles=_OVERLAY_PARTICLES))
        if not args.json:
            tag = "TRACK" if np.all(upd[-1]) else "----"
            print(f"frame {i:4d}  t={float(times_host[i]):7.3f}s  [{tag}] "
                  f"flag={flags[-1]}  t_pose={dt_ms:7.2f}ms")
    wall = time.perf_counter() - t_start
    if profiler is not None:
        trace.disable()
        trace.take()
        profiler.__exit__(None, None, None)
        os.makedirs(args.profile, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.profile, "trace.json"))

    est = np.stack(est)
    upd_arr = np.asarray(upd)
    summary = {
        "frames": int(frames.shape[0]),
        "tracked_frames": int(np.all(upd_arr.reshape(len(upd), -1), axis=-1).sum()),
        "wall_s": round(wall, 3),
        "fps": round(frames.shape[0] / wall, 2),
        "flags": flags,
        "time_pose_est_ms": time_pose_est_ms,
        "time_init_est_ms": time_init_est_ms,
        # steady-state latency: median over post-warmup frames
        "time_pose_est_ms_median": round(
            float(np.median(time_pose_est_ms[1:] or time_pose_est_ms)), 3
        ),
    }
    if gt_poses is not None and not multi:
        summary["ate_m"] = absolute_trajectory_error(est, gt_poses, upd_arr)
        summary["orientation_err_deg"] = orientation_error_deg(est, gt_poses, upd_arr)
    elif gt_poses is not None:
        # (T, 4, 4): every target tracks the same object; (T, K, 4, 4): one
        # trajectory a target
        gt_k = (lambda k: gt_poses[:, k]) if gt_poses.ndim == 4 else (lambda k: gt_poses)
        summary["ate_m_per_target"] = [
            absolute_trajectory_error(est[:, k], gt_k(k), upd_arr[:, k])
            for k in range(args.num_targets)
        ]
        summary["tracked_fraction_per_target"] = [
            round(float(upd_arr[:, k].mean()), 4) for k in range(args.num_targets)
        ]

    if config.use_online_exposure_control:
        summary["exposure_us"] = float(res.exposure_us.reshape(-1)[0])
    if args.save_video and annotated:
        np.savez_compressed(args.save_video, frames=np.stack(annotated))
        summary["video"] = args.save_video
    if args.checkpoint:
        save_state(args.checkpoint, state)
        summary["checkpoint"] = args.checkpoint

    print(json.dumps(summary))
    return 0

if __name__ == "__main__":
    sys.exit(main())
