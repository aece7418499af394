#!/usr/bin/env python3
"""The benchmark of pf_monocular_pose_estimator_tpu_torch: one cell, one run.

    python3 portbench/run.py --workload uav1-100k.orbit --seed 7 --seconds 30 --trace 0

from the root of a checkout, on a machine with the cards the cell asks for
(it exits with code 3 and prints no result without them).  A cell of
`BENCHMARK.json` names a configuration (`portbench/configs/<name>.json`:
camera, marker sets, tracker settings, entry point, comparison limits) and
a traffic mix (`portbench/traffic/<name>.json`, read by `generator.py`);
each per-layer metric is read by `portbench/metrics/<name>.py`.

A run renders one period of the mix's frames (uint8, pinned host memory),
builds the tracker, steps `warmup_frames` frames, then measures a closed
loop for `--seconds`: each frame is copied to the card, cast to float32
and tracked, and its pose, update flag and fail flag are read back in one
copy; the frame's latency is that whole span.  With `--trace 1` an unprofiled
stretch and a profiled stretch of as many frames come right after the
warm-up, and the run reports the per-layer metrics instead of the
end-to-end ones.  Once the window has closed, sampled frames are
recomputed by the plain reference (`judge.py`).  The last line of standard
output is the result; the comparisons are the last lines of standard
error.  `--control bf16` judges the reference rounded to bfloat16 in the
program's place (it has to come out as not correct).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from generator import load_mix, make_traffic  # noqa: E402
from judge import Sampler, checks, flag_name, judge  # noqa: E402
from reference.geometry.camera import Camera as RefCamera  # noqa: E402
from reference.utils.flags import FailFlag  # noqa: E402
from tracing import summarise  # noqa: E402

# top-level module names the process must not hold once the window closes
JAX_NAMES = ("jax", "jaxlib", "flax", "pf_monocular_pose_estimator_tpu")
PROFILE_FRAMES = 40  # the profiled stretch, and the unprofiled one after it
PROFILE_ATTEMPTS = 3  # a trace that lists no device span is taken again


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16",), default=None,
                    help="judge the reference rounded to bfloat16 in the program's place")
    return ap.parse_args(argv)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell `name` of BENCHMARK.json with its configuration, mix, and
    the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"run.py: no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    applies = lambda m: name in m.get("workloads", [name])
    return {
        "workload": work,
        "config": json.loads((root / conf["file"]).read_text()),
        "mix": load_mix(HERE / "traffic" / f"{work['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def load_reader(name: str):
    """`metrics/<name>.py`'s `read`."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def homogeneous(points) -> np.ndarray:
    p = np.asarray(points, np.float32)
    return np.concatenate([p, np.ones((p.shape[0], 1), np.float32)], axis=1)


def build(config: dict, seed: int, device, n_particles: int | None = None):
    """(step, initial state, marker sets) of the configuration's entry point."""
    from pf_monocular_pose_estimator_tpu_torch.geometry.camera import Camera
    from pf_monocular_pose_estimator_tpu_torch.tracker import (TargetState, create_states,
                                                               make_multi_tracker, make_tracker,
                                                               pad_marker_sets)
    from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
    from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

    c = config["camera"]
    camera = Camera.create(c["fx"], c["fy"], c["cx"], c["cy"], c["dist"], c["width"],
                           c["height"], device=device)
    markers_t = [homogeneous(m) for m in config["markers"]]
    settings = dict(config["tracker"], **({"n_particles": n_particles} if n_particles else {}))
    tc = TrackerConfig(**settings)
    n = tc.n_particles
    if config["entry"] == "make_tracker":
        (markers,) = markers_t
        step = make_tracker(camera, markers, np.ones(markers.shape[0], bool), tc, device=device)
        return step, TargetState.create(n, prng_key(seed), device=device), markers_t, settings
    if config["entry"] == "make_multi_tracker":
        markers, masks = pad_marker_sets(markers_t)
        step = make_multi_tracker(camera, markers, masks, tc, sequential=True, device=device)
        return step, create_states(len(markers_t), n, seed, device=device), markers_t, settings
    raise SystemExit(f"run.py: unknown entry {config['entry']!r}")


class Loop:
    """The closed frame loop over one period of frames."""

    def __init__(self, step, state, traffic, device):
        from pf_monocular_pose_estimator_tpu_torch.pf.step_kernel import pf_step, resample_gather

        self.step, self.state, self.traffic, self.device = step, state, traffic, torch.device(device)
        self.counters = (pf_step, resample_gather)
        self.k = 0
        self.period = traffic.frames.shape[0]
        self.error = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def frame(self, keep: bool = False):
        """Step one frame -> (seconds, packed (T, 18) host pose | updated |
        flag or None if the step raised, record or None)."""
        k, idx = self.k, (self.traffic.start + self.k) % self.period
        t = k / self.traffic.fps
        prev = self.state
        pf0, rs0 = self.counters[0].launches, self.counters[1].launches
        t0 = time.perf_counter()
        try:
            img = self.traffic.frames[idx].to(self.device, non_blocking=True).float()
            state, res = self.step(prev, img, t)
            packed = torch.cat([res.pose.reshape(-1, 16), res.pose_updated.reshape(-1, 1).float(),
                                res.fail_flag.reshape(-1, 1).float()], dim=1).cpu().numpy()
        except Exception:  # the frame fails; the loop goes on from the state before it
            if self.error is None:
                self.error = traceback.format_exc()
            state, res, packed = prev, None, None
        seconds = time.perf_counter() - t0
        self.state = state
        self.k += 1
        record = None
        if keep and packed is not None:
            record = {"k": k, "idx": idx, "t": t, "prev": prev, "state": state, "result": res,
                      "packed": packed, "passes": self.counters[0].launches - pf0,
                      "resampled": self.counters[1].launches > rs0}
        return seconds, packed, idx, record

    def failed(self, packed, idx) -> bool:
        """The step raised, or a target whose every LED is in the frame did
        not get an updated pose."""
        if packed is None:
            return True
        return bool(np.any(self.traffic.drawn[idx] & (packed[:, 16] == 0)))


def profiled_stretch(loop: Loop, frames: int):
    """Profile `frames` frames (CPU and CUDA activity); a trace that lists no
    device span is taken again, up to PROFILE_ATTEMPTS times -> summary or
    None."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        loop.sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(frames):
                loop.frame()
            loop.sync()
            wall = time.perf_counter() - t0
        summary = summarise(prof, frames, wall)
        if summary is not None:
            return summary
    return None


def trajectory_errors(poses: list, traffic, ks: list) -> dict:
    """ATE (RMS, mm) and mean orientation error (deg) of the updated frames,
    a target each."""
    out = {}
    for i in range(traffic.drawn.shape[1]):
        t_err, r_err = [], []
        for packed, idx in zip(poses, ks):
            if packed is None or packed[i, 16] == 0:
                continue
            est = packed[i, :16].reshape(4, 4).astype(np.float64)
            gt = traffic.poses[idx, i].astype(np.float64)
            t_err.append(np.linalg.norm(est[:3, 3] - gt[:3, 3]))
            c = np.clip((np.trace(est[:3, :3] @ gt[:3, :3].T) - 1) / 2, -1, 1)
            r_err.append(math.degrees(math.acos(c)))
        out[f"target{i}"] = {"ate_mm": 1e3 * float(np.sqrt(np.mean(np.square(t_err))))
                             if t_err else None,
                             "orientation_deg": float(np.mean(r_err)) if r_err else None}
    return out


def end_to_end(latencies: list, window_s: float, setup_s: float) -> dict:
    """The end-to-end metrics: frames completed over the window's seconds,
    the 95th percentile of every frame's latency (numpy's linear
    interpolation) and the set-up time."""
    lat_ms = np.asarray(latencies, np.float64) * 1e3
    return {"frames_per_s": len(latencies) / window_s,
            "pose_est_ms_p95": float(np.percentile(lat_ms, 95)) if len(lat_ms) else math.nan,
            "setup_s": setup_s}


def flag_counts(poses: list) -> dict:
    """How many frames x targets of the window ended on each flag."""
    flags = [int(f) for packed in poses if packed is not None for f in packed[:, 17]]
    return {flag_name(f): n for f, n in sorted(Counter(flags).items())}


def worst_by_second(latencies: list, ends: list) -> list:
    """The longest frame latency (ms) of each second of the window."""
    worst = [0.0] * (int(ends[-1]) + 1 if ends else 0)
    for sec, end in zip(latencies, ends):
        worst[int(end)] = max(worst[int(end)], round(1e3 * sec, 3))
    return worst


def card() -> dict:
    """The card's name and power limit (`nvidia-smi`), beside the result."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return {"nvidia_smi": out[0] if out else None}
    except (OSError, subprocess.TimeoutExpired):
        return {"nvidia_smi": None}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
             control: str | None = None, n_particles: int | None = None,
             warmup_frames: int | None = None, max_frames: int | None = None) -> dict:
    """One run of a cell on `device` -> the result (and `info`).  The last
    three arguments shrink a run for the CPU tests."""
    config, mix = cell["config"], cell["mix"]
    device = torch.device(device)
    step, state, markers_t, settings = build(config, seed, device, n_particles)
    c = config["camera"]
    ref_cam = RefCamera.create(c["fx"], c["fy"], c["cx"], c["cy"], c["dist"], c["width"],
                               c["height"])
    traffic = make_traffic(mix, ref_cam, markers_t, seed, device)
    loop = Loop(step, state, traffic, device)
    init = loop.frame(keep=True)[3]
    for _ in range((traffic.warmup_frames if warmup_frames is None else warmup_frames) - 1):
        loop.frame()
    run = {"cell": {"n_particles": settings["n_particles"], "n_markers": markers_t[0].shape[0],
                    "n_targets": len(markers_t)}, "trace": None}
    if trace:
        loop.sync()
        t0 = time.perf_counter()
        for _ in range(PROFILE_FRAMES):
            loop.frame()
        loop.sync()
        run["unprofiled_wall_s"] = time.perf_counter() - t0
        run["trace"] = profiled_stretch(loop, PROFILE_FRAMES)
        if run["trace"] is None:
            raise RuntimeError("the profiler listed no device span in "
                               f"{PROFILE_ATTEMPTS} traces of {PROFILE_FRAMES} frames")
    loop.sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T_START

    # ------------------------------------------------------------ window
    sampler = Sampler(seed)
    latencies, failed, poses, idxs, ends = [], 0, [], [], []
    syncs0, pf0 = step.host.count, loop.counters[0].launches
    t_begin = time.perf_counter()
    t_end = t_begin + seconds
    while time.perf_counter() < t_end and (max_frames is None or len(latencies) < max_frames):
        sec, packed, idx, rec = loop.frame(keep=True)
        latencies.append(sec)
        ends.append(time.perf_counter() - t_begin)
        poses.append(packed)
        idxs.append(idx)
        failed += loop.failed(packed, idx)
        if rec is not None:
            sampler.offer(rec, rec["passes"], rec["resampled"],
                          bool(np.any(packed[:, 17] != int(FailFlag.PF_SUCCESS))))
    window_s = time.perf_counter() - t_begin
    loop.sync()
    run["window"] = {"frames": len(latencies), "syncs": step.host.count - syncs0,
                     "pf_launches": loop.counters[0].launches - pf0}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    held = [m for m in sys.modules if m.split(".")[0] in JAX_NAMES]

    # ------------------------------------------------------- correctness
    loop.state = state = None
    kept = ([init] if init is not None else []) + sampler.frames()
    readings = judge(kept, lambda i: traffic.frames[i], config, markers_t, device, control,
                     settings, seed)
    correct, compared = checks(readings, config.get("limits", {}))

    lat_ms = np.asarray(latencies) * 1e3
    values = end_to_end(latencies, window_s, setup_s)
    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = load_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev_info["busy_s"] = run["trace"]["busy_s"]
        dev_info["window_s"] = run["trace"]["wall_s"]
    result = {"correct": bool(correct and not held), "attempted": len(latencies),
              "failed": int(failed), "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = run["trace"]["breakdown"]
    result["checks"] = compared
    info = {
        "pose_est_ms_median": float(np.median(lat_ms)) if len(lat_ms) else None,
        "window_s": window_s, "frames_judged": readings.frames, "control": control,
        "judged_flags": readings.branches, "window_flags": flag_counts(poses),
        "mismatched_fields": sorted(readings.mismatched),
        "frames_by_second": np.bincount(np.asarray(ends, int)).tolist() if ends else [],
        "worst_ms_by_second": worst_by_second(latencies, ends),
        "trajectory": trajectory_errors(poses, traffic, idxs), "units": units,
        "end_to_end_values": values, "first_error": loop.error, "modules_held": held,
    }
    return {"result": result, "info": info}


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = load_cell(args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", args.control)
    result, info = out["result"], out["info"]
    held = [m for m in sys.modules if m.split(".")[0] in JAX_NAMES]
    if held:
        print(f"run.py: the process holds {sorted(held)}", file=sys.stderr)
        return 4
    info.update(card())
    print(json.dumps({"info": info}), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
