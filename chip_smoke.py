#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device  -- requires CUDA; prints the card's name and power limit;
  2. build   -- compiles the port's CUDA kernels from csrc/ (nvcc);
  3. kernels -- every kernel of the port against its plain PyTorch
     version on the card, at the shapes the main path gives it (N =
     100,000, M = 5, K = 16), with CUDA-event times for both, the kernel's
     time on the card alone (`device_ms`, a CUDA graph of 20 calls), the
     least time the card could take (`bound_ms`, from the bytes and
     operations of this run's inputs) and, where one PyTorch call computes
     the same function, that call's times (`library_ms`,
     `library_device_ms`; the port never calls it);
     shapes  -- (right after phase 3; tests/test_torch_kernels_cuda.py's
     grid and input generators) kernels B (both variants), E, D and
     A against their plain twins beyond the main path's shapes: K in
     {1, 4, 12, 16, 17, 32, 64, 127, 128}, M in {1, 3, 5, 8, 9, 10, 16, 31,
     32}, 0, 4, 12, 13, 20, 24, 25 and 32 sweeps, top-k 1, 16, 64, 65, 100
     and 128, max_abs_err 0; the wide shape (M = 16, K = 64 at N = 100,000,
     with shape_lanes' detections and with every slot real; D at M = 16; A
     at 20 sweeps and top-100) timed beside its bound, with the device time
     of each of A's launches;
     tests/test_torch_parallel_multi.py's two-target scene at its
     configuration (max_detections=12) on the card and on the CPU, flags
     equal on every (frame, target); configs/two_uav_marker_positions.yaml
     as one object of ten markers on a synthetic orbit (the init from a
     fresh state, then seven tracked frames from frame 0's pose) on the card
     and on the CPU, flags equal, B, D and A launched;
  4. replay  -- tests/golden/golden_sequence.npz (60 frames, 752x480)
     through `make_tracker(..., device="cuda")` at 100,000 particles,
     min_blob_area=8, pf_max_retries=8; every frame must update, ATE
     < 10 mm, orientation error < 1.5 deg; the launch counters show which
     kernels the replay went through;
  5. timing  -- a second, warm replay: frames per second and device->host
     syncs per frame; then [wide]: the same replay with cc_sweeps=20 and
     max_detections=32, so that kernel A's wide path and B's wide form run
     on every tracked frame: the same bars, the launches, the device time
     of a warm frame and the card's idle share;
  6. slice   -- the same replay with use_fused_pf_kernel=False and
     use_pallas_resample=True (XLA-style propagation + kernel E, the
     sort-free resampler with kernel F): same bars, kernels E and F
     launched and B not; the frames whose resampling took F's result and
     those that fell back to the sort path; a warm second replay;
  7. switches -- short replays (20 frames, resampling on every tracked
     frame) of the remaining single-device switches, same bars;
  8. sharded -- the bank cut over a local particles mesh of 4 shards on the
     one card (`parallel.make_sharded_tracker`): the main path's replay
     with kernel B per shard and the ring resampler's kernel H, every block
     reaching every shard; fail flags equal to the main path's frame by
     frame, nothing clipped, same bars; a warm second replay; the same with
     the reference's default ring (reach 1, a window of S / 4), whose
     clipped draws are reported; then 20 frames at 1,000,000 particles, the
     size the sharded path exists for (every frame must update);
  9. group -- a `torch.distributed` group of this one rank over `nccl`
     carries the sharded step's collectives for a few frames, which must
     equal the local mesh of one shard bit for bit;
 10. ego -- the main path with `use_cam_pos=True` and the observer pose of
     frame i - 1 given with frame i (so kernel B's left matrix moves): same
     bars, and the observer's motion at the end not the identity;
 11. faults -- the init on the reference tracker's frame-0 faulted
     detections (tests/golden/faults_init_reference.npz), held to the
     reference's outcomes (to its one outcome where its evaluations agree,
     else to one of those that rounding gives it); then the main path
     with one occlusion and two false detections, seeds 0-2, held to
     tests/test_robustness.py's bars (tracked >= 0.9, the median of the
     per-seed median translation errors <= 2 x phase 4's ATE, the pooled
     median orientation <= 3 deg);
 12. exposure -- 20 frames with `use_online_exposure_control=True`: the
     exposure counters after every frame equal a host recomputation;
 13. ipe -- `use_particle_filter=False` with 64 particles: same bars, no
     re-initialisation after frame 0, kernels B and D and the fused refine
     never launched, the one-pose refine (`refine_pose`) once a frame;
 14. realistic -- tests/golden/realistic_sequence.npz (120 uint8 frames
     with clutter) with configs/experiments/realistic_golden.yaml's
     settings: tracked >= 0.95, ATE <= 17 mm, orientation <= 5.62 deg;
 15. multi -- tests/golden/two_uav_sequence.npz (60 frames, two targets
     with distinct constellations) through `make_multi_tracker` with
     configs/experiments/two_uav_bag.yaml's settings, at its 4,000
     particles and at 100,000 a target: each target tracked >= 0.95 with
     ATE <= 20 mm (tests/test_two_uav.py's bars); warm replays of both
     forms (`sequential=True` and `False`) for frames per second;
 16. multi-sharded -- `make_sharded_multi_tracker` on a local mesh of 2
     target groups x 4 shards at 100,000 a target, every block reaching
     every shard: fail flags equal to phase 15's frame by frame, nothing
     clipped, updated >= 0.9 and median error <= 20 mm a target; then 6
     frames over a one-rank `nccl` job through `make_pod_mesh`'s sub-group
     (and the results gather), equal to the local mesh of one shard bit
     for bit;
 17. checkpoint -- the main path saved after frame 30 and a two-target
     state after frame 10, each loaded into a fresh state on the card and
     replayed 10 frames: poses and every leaf equal to the uninterrupted
     replay bit for bit;
 18. synthetic and multihost -- `make_two_target_sequence(seed=2)` renders
     the two-UAV golden again on the card (poses within 1.2e-7, frames
     within one uint8 level, the differing pixels counted), then
     `run_multihost --frames 20` in this process at its 1,000,000 particles
     must track every frame;
 19. cli -- the port's run_tracker CLI (`io/cli.py::main`) in this process:
     the golden with phase 4's configuration (flags equal to phase 4's,
     ATE within 1e-6 m, the same launches), realistic_golden.yaml through
     the port's YAML reader (flags equal to phase 14's, its bars), recorded
     to a .pfsq and replayed from it through the native reader (flags
     equal), two_uav_bag.yaml (flags equal to phase 15's at 4,000
     particles, its bars), and uav_target, two_targets, outlier_robustness,
     outdoor_expo and ipe_legacy at their own settings (uav_target with
     --save-video; ipe_legacy launching neither B nor D); then the golden
     pushed at 50 fps through `FramePipe` into the main-path tracker, and
     one `python -m ...io.cli --profile` process whose trace must hold
     device events of kernel A;
 20. bench -- `bench_torch.main` in this process for the default flags,
     --sharded, --targets 2 and --ess-tau 0.0, each at 100,000 particles
     on 752x480 frames over 120 frames of the orbit (one warm-up and two
     timed runs), its launches counted: every frame updated, ATE < 10 mm,
     orientation error < 1.5 deg, kernels A, B and D launched, H on
     --sharded and C on the other three; each JSON line is printed under
     [bench];
 21. accuracy -- `accuracy_torch.main(["--frames", "40"])` in this process
     (the BASELINE.json configs on the orbit: 1,000 and 10,000 particles;
     50,000 with one occlusion and two false detections, seeds 0-4, with
     the engine's defaults and at reference parity; four targets of
     25,000), its launches counted: config0 and config1 every frame, ATE <
     10 mm, orientation < 1.5 deg; config3 tracked >= 0.95 and every
     target's ATE <= 20 mm; config2's mean tracked fraction >= 0.9; the
     parity row printed, held to nothing; A, #2, B, C and D launched;
 22. sweep -- `sweep_torch.main` over configs/sweeps/reference_grid.yaml
     (18 cells x 2 seeds) and fault_grid.yaml (8 cells x 3 seeds), 40
     frames each, JSON and markdown to a temporary directory, the matrices
     printed under [sweep]: every cell's tracked fraction in [0, 1],
     fault_grid's cells without faults at the golden's bars on every seed,
     A, #2, B, C and D launched for each grid.
Phases 10-15 each replay a second time warm, for frames per second and
syncs per frame; every phase counts its kernel launches.
Phase 3 also holds kernel B with a moving observer (ego-motion's
cam_move_inv, a ~1e-2 twist) to its plain version, whole and per shard,
and F and G to their plain versions at 1,000,000 lanes, and
times F with the other placement of its window-start count.  After
phase 3 it reports the `-Xptxas -v` line (registers, stack frame, spills)
of every kernel (E, F and G must use no local memory, B none beyond the
math library's 32-byte sincosf frame; B's and E's registers at M = 5), and
the device time of each launch of kernels A, B, D, E, F, G and H by
torch.profiler.  After phase 5 it gives the main path's device time
against its wall time over 20 warm frames (torch.profiler), whence the
card's idle share.  To compare with
another commit on one card, copy this script into a checkout of it and
run the two in turns.
Phase 3 also holds the ring resampler at P = 1, 2, 4, 8 and kernel B per
shard against their whole-bank results, bit for bit.  Kernel H is one
launch over the 4 shards of a local mesh; after phase 3 its time on the
card alone at N = 100,000 and 1,000,000 stands beside four one-shard
launches, `index_select` and its bound, with the device time of one whole
ring resampling (`ring_timings`).  `python3 chip_smoke.py --ring-only`
runs only phases 1, 2 and that comparison, without the one-launch form,
so that a checkout from before it can be measured on the same card;
`python3 chip_smoke.py --wide-only` runs phases 1, 2, the wide shape's
timings and [wide], for the same use with a checkout whose wrappers take
the wide shapes.
The experiments' settings are read from configs/experiments/ with the
port's own YAML reader.  The last three lines are the card, the kernel
table and the device line.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "golden_sequence.npz"
N_PARTICLES = 100_000
REF = "pf_monocular_pose_estimator_tpu"
MAIN = dict(n_particles=N_PARTICLES, min_blob_area=8.0, pf_max_retries=8)
SLICE = dict(use_fused_pf_kernel=False, use_pallas_resample=True)
SWITCHES = (dict(use_folded_pf_kernel=False, use_closed_form_resample=True, use_pallas_gn=False),
            dict(use_fused_pf_kernel=False, use_pallas_weight=False))
SHORT_FRAMES = 20
MESH_SHARDS = 4
# the ring that cannot clip: whole blocks from every other shard
SHARDED = dict(resample_reach=MESH_SHARDS - 1, payload_window=None)
N_LARGE = 1_000_000
# the options ported last, each on the main path's config
EGO = dict(use_cam_pos=True)
FAULTS = dict(number_of_occlusions=1, number_of_false_detections=2)
# tests/test_robustness.py's seeds: with false detections 1-5 px from real
# ones, whether an init lands on the right constellation is decided by
# rounding, so its bars pool three runs
FAULT_SEEDS = (0, 1, 2)
# the reference's frame-0 faulted detections and its init's outcomes, jitted
# and op by op, on them and on detections one ulp away (written by
# tests/fault_episodes.py)
FAULTS_INIT_REFERENCE = ROOT / "tests" / "golden" / "faults_init_reference.npz"
EXPOSURE = dict(use_online_exposure_control=True)
IPE = dict(use_particle_filter=False)  # configs/experiments/ipe_legacy.yaml, 64 particles
IPE_PARTICLES = 64
# ego-motion's cam_move_inv in kernel B's check: a twist of ~1e-2
OBSERVER_MOVE = (0.012, -0.008, 0.01, 0.01, -0.015, 0.008)


def experiment(name: str):
    """configs/experiments/{name}.yaml through the port's reader: the loaded
    experiment and its camera as a dict of plain values."""
    sys.path.insert(0, str(ROOT))
    from pf_monocular_pose_estimator_tpu_torch.io.experiment import load_experiment
    from pf_monocular_pose_estimator_tpu_torch.io.markers import load_camera_calibration

    exp = load_experiment(str(ROOT / "configs" / "experiments" / f"{name}.yaml"))
    cam = load_camera_calibration(exp["camera"], device="cpu")
    camera = dict(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy),
                  dist=tuple(cam.dist.tolist()), width=cam.width, height=cam.height)
    return exp, camera


# configs/experiments/realistic_golden.yaml and two_uav_bag.yaml: their
# `tracker:` blocks, cameras and sequences
REALISTIC_EXPERIMENT, REALISTIC_CAMERA = experiment("realistic_golden")
REALISTIC = REALISTIC_EXPERIMENT["tracker"]
REALISTIC_GOLDEN = Path(REALISTIC_EXPERIMENT["run"]["sequence"])
TWO_UAV_EXPERIMENT, TWO_UAV_CAMERA = experiment("two_uav_bag")
TWO_UAV = TWO_UAV_EXPERIMENT["tracker"]
TWO_UAV_GOLDEN = Path(TWO_UAV_EXPERIMENT["run"]["sequence"])

# phase 19: the other committed experiments, each at its own settings
OTHER_EXPERIMENTS = ("uav_target", "two_targets", "outlier_robustness", "outdoor_expo",
                     "ipe_legacy")
# kernel A's four CUDA kernels (csrc/detect.cu)
KERNEL_A = ("threshold_blur_kernel", "label_kernel", "stats_kernel", "topk_merge_kernel")
# the wide forms of kernels A, B and E, which use no local memory
WIDE_KERNELS = ("label_round_kernel", "wide_stats_kernel", "roots_merge_kernel",
                "pf_step_kernel<(int)0, (int)0", "pf_weight_kernel<(int)0, (int)0")

# Peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): HBM bytes per
# second and float32 operations per second outside the tensor cores.  The
# bounds count integer operations at the float32 rate too, so they are
# lower bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound(n_bytes: float, n_ops: float):
    """(least time in ms, what sets it) for moving `n_bytes` once and doing `n_ops`."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def weight_ops(m: int, k: int) -> int:
    """Operations the greedy weight of one particle needs:

        26 M + 9 M K + M (2 M + 12)

    the projection (26 a marker), the M x K volume (7 a cell) with each
    marker row's first minimum (a compare and an index select a cell), then
    M greedy steps, each a first minimum over the M row pairs (2 M) and 12
    scalar operations (distance, score, reuse, penalties, the retire).  A
    row that is not retired never changes, so no step needs the volume
    again (pf_common.cuh)."""
    return 26 * m + 9 * m * k + m * (2 * m + 12)


def weight_ops_needed(rows, wprm, m: int, k: int) -> int:
    """Operations the greedy weight of the lanes `rows` (12, N) needs on
    these inputs: `weight_ops` with the volume cut to the cells the data
    needs -- every real detection's (mask term 0), and a masked slot's only
    in a row whose minimum over the real ones reached the masked slots'
    least cell (no masked cell can be a row's first minimum before;
    pf_common.cuh)."""
    import torch

    n = rows.shape[1]
    scal, mark = wprm[:8], wprm[8:8 + 4 * m]
    dets = wprm[8 + 4 * m:8 + 4 * m + 3 * k]
    big = dets[2 * k:]
    real = big == 0
    mk = mark[:3 * m].reshape(m, 3)
    xc = rows[0:1] * mk[:, 0:1] + rows[1:2] * mk[:, 1:2] + rows[2:3] * mk[:, 2:3] + rows[3:4]
    yc = rows[4:5] * mk[:, 0:1] + rows[5:6] * mk[:, 1:2] + rows[6:7] * mk[:, 2:3] + rows[7:8]
    zc = rows[8:9] * mk[:, 0:1] + rows[9:10] * mk[:, 1:2] + rows[10:11] * mk[:, 2:3] + rows[11:12]
    zc = torch.where(zc.abs() < 1e-12, torch.full_like(zc, 1e-12), zc)
    u, v = scal[0] * xc / zc + scal[2], scal[1] * yc / zc + scal[3]  # (m, n)
    dx, dy = dets[0:2 * k:2][real], dets[1:2 * k:2][real]
    t = mark[3 * m:4 * m]
    n_real, n_masked = int(real.sum()), int((~real).sum())
    cells = m * n * n_real
    if n_masked:
        rmin = torch.full((m, n), float("inf"), device=rows.device)
        for j in range(n_real):
            du, dv = dx[j] - u, dy[j] - v
            rmin = torch.minimum(rmin, du * du + dv * dv + t[:, None])
        cells += int((rmin >= big[~real].min() + t[:, None]).sum()) * n_masked
    return 26 * m * n + 9 * cells + n * m * (2 * m + 12)


def detect_ops(img, prm, sweeps: int) -> int:
    """Operations kernel A's `detect_stats` needs on these inputs: the blur
    (26 a pixel); 9 a foreground pixel for each label sweep until the labels
    stop changing; each foreground pixel's windowed sums ((s + 1)(2s + 1)
    cells at 4 each and s + 1 rows at 6 each, s = sweeps; a background
    pixel's are known); and 64 a foreground pixel (8 directions x 4 extrema
    x a test and a min) for each bbox sweep until the extrema stop changing.
    The sweeps are counted on the plain twin's maps."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.ops import detect_kernel as dk

    h, w = img.shape
    fg = dk.threshold_blur_plain(img, prm, 5, True) > 1e-3
    n_fg = int(fg.sum())
    lab, lab_sweeps = dk.label_sweeps(fg, 0), 0
    while lab_sweeps < sweeps:
        nxt = dk.label_sweeps(fg, lab_sweeps + 1)
        if torch.equal(nxt, lab):
            break
        lab, lab_sweeps = nxt, lab_sweeps + 1
    lab = dk.label_sweeps(fg, sweeps)
    flat = torch.arange(1, h * w + 1, dtype=torch.int32, device=img.device).reshape(h, w)
    lab_b = torch.where(fg, lab, -flat)
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :].expand(h, w)
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None].expand(h, w)
    ext = [torch.where(fg, c, torch.full_like(c, b)) for c, b in
           ((xs, 1e9), (xs, -1e9), (ys, 1e9), (ys, -1e9))]
    bbox_sweeps = 0
    while bbox_sweeps < sweeps:
        before = [e.clone() for e in ext]
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)):
            same = dk.shift2d(lab_b, dy, dx) == lab_b
            for i, op in enumerate((torch.minimum, torch.maximum) * 2):
                ext[i] = torch.where(same, op(ext[i], dk.shift2d(ext[i], dy, dx)), ext[i])
        if all(torch.equal(a, b) for a, b in zip(before, ext)):
            break
        bbox_sweeps += 1
    s = sweeps
    return (26 * h * w + n_fg * (9 * lab_sweeps + 4 * (s + 1) * (2 * s + 1) + 6 * (s + 1)
                                 + 64 * bbox_sweeps))


# propagation of one particle: two 4x4 composes (224), six threefry draws
# (121 each) with their affine (4 each), six sin/cos, the noise rotation
# (18), the rotated rows (48) and the two lane pins (32)
PROPAGATE_OPS = 224 + 6 * (121 + 4) + 6 + 18 + 48 + 32


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time_ms(fn, reps: int = 20) -> float:
    """One call's time on the card alone: `reps` calls captured into one CUDA
    graph and replayed, so the host's time to issue them is left out
    (`time_ms` includes it, and it is most of a short kernel's time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def load_golden(device):
    import torch
    from pf_monocular_pose_estimator_tpu_torch.geometry import Camera

    d = np.load(GOLDEN)
    cam = Camera.create(float(d["fx"]), float(d["fy"]), float(d["cx"]), float(d["cy"]),
                        np.asarray(d["dist"], np.float32), int(d["width"]), int(d["height"]),
                        device=device)
    markers = np.concatenate([d["markers"], np.ones((len(d["markers"]), 1), np.float32)], 1)
    markers = torch.from_numpy(markers).to(device)
    return d, cam, markers


def crop_offset(d):
    """(x0, y0) of the 192x256 crop around the LEDs of golden frame 17."""
    led = d["led_pixels"][17]
    return (int(np.clip(round(led[:, 0].mean() - 128), 0, 752 - 256)),
            int(np.clip(round(led[:, 1].mean() - 96), 0, 480 - 192)))


def crop_inputs(d, device):
    """Kernel A's main-path input: a 192x256 crop around the LEDs of golden
    frame 17 and its parameters (ROI, threshold 240, areas 8-160, sigma 0.6)."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.ops import detect_kernel as dk

    x0, y0 = crop_offset(d)
    crop = torch.from_numpy(d["frames"][17][y0:y0 + 192, x0:x0 + 256].astype(np.float32))
    prm = dk.make_params([6.0, 9.0, 240.0, 170.0], 240.0, 8.0, 160.0, 0.6, device)
    return crop.contiguous().to(device), prm


def gn_inputs(d, cam, markers, device, det_xy=None, seed=1):
    """Kernel D's main-path input: 11 = 2M + 1 hypotheses near the pose of
    golden frame 10, the last five each missing one marker, bound to
    `det_xy` (default: the projected markers plus 0.3 px of noise)."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.geometry import exp_se3, project

    rng = np.random.default_rng(seed)
    gt = torch.from_numpy(d["poses"][10]).to(device)
    if det_xy is None:
        det_xy = project(cam, gt, markers) + torch.from_numpy(
            rng.normal(0, 0.3, (5, 2)).astype(np.float32)).to(device)
    b = 11
    tw_d = torch.from_numpy(rng.normal(0.0, 0.01, (b, 6)).astype(np.float32)).to(device)
    poses0 = exp_se3(tw_d) @ gt
    dfm = torch.arange(5, device=device).repeat(b, 1)
    dfm[6:, :] = torch.where(torch.eye(5, dtype=torch.bool, device=device), -1, dfm[6:, :])
    cmask = dfm >= 0
    scal_d = torch.stack([cam.fx, cam.fy, cam.cx, cam.cy])
    mark = markers[:, :3].T.contiguous()
    du = det_xy[:, 0][dfm.clamp(min=0)].contiguous()
    dv = det_xy[:, 1][dfm.clamp(min=0)].contiguous()
    return (scal_d, poses0.reshape(b, 16).contiguous(), mark, du, dv, cmask.float())


def refine_inputs(d, cam, markers, device, det_xy):
    """The fused refine's main-path input: golden frame 10's pose 0.002 off as
    the picked particle, M = 5 markers, K = 16 detection slots (`det_xy`'s
    five and a sixth 3 px from the first, which the swap hypotheses bind),
    the default tolerances -> (refine_frame's arguments, refine_hypotheses')."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.geometry import exp_se3
    from pf_monocular_pose_estimator_tpu_torch.ops.blob import Detections
    from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
    from pf_monocular_pose_estimator_tpu_torch.utils.dynamic import DynamicParams

    rng = np.random.default_rng(2)
    gt = torch.from_numpy(d["poses"][10]).to(device)
    twist = torch.from_numpy(rng.normal(0.0, 0.002, 6).astype(np.float32)).to(device)
    pre_gn = exp_se3(twist) @ gt
    xy = det_xy.clone()
    xy[5] = xy[0] + torch.tensor([3.0, -1.0], device=device)
    mask = torch.zeros(16, dtype=torch.bool, device=device)
    mask[:6] = True
    det = Detections(xy=xy, xy_distorted=xy, mask=mask, area=xy[:, 0], occluded=mask,
                     injected=mask)
    config = TrackerConfig(**MAIN)
    dyn = DynamicParams.from_config(config, device)
    marker_mask = torch.ones(5, dtype=torch.bool, device=device)
    trust = torch.tensor(True, device=device)
    scal = torch.stack([cam.fx, cam.fy, cam.cx, cam.cy]).float()
    fused = (scal, pre_gn, markers.T.contiguous(), marker_mask, xy, mask,
             dyn.back_projection_pixel_tolerance_pf, dyn.jump_threshold, gt, trust,
             config.gn_max_iterations, config.gn_convergence_tol, config.gn_residual_gate,
             config.gn_step_radius, config.jump_translation_radius, config.gn_hypotheses > 1)
    chain = (cam, pre_gn, markers, marker_mask, torch.zeros(5, dtype=torch.bool, device=device),
             det, dyn, gt, trust, config)
    return fused, chain


def pf_inputs(d, cam, markers, device, cam_move_inv=None):
    """Kernel B's main-path input: N = 100,000 poses scattered 0.01 around
    golden frame 10's, a step, the five projected markers plus 0.3 px of
    noise among 16 detection slots -> (bank, parameters, keys, detections).
    `cam_move_inv` is the left matrix (ego-motion; the identity unless given)."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.geometry import exp_se3, project
    from pf_monocular_pose_estimator_tpu_torch.pf import step_kernel as sk
    from pf_monocular_pose_estimator_tpu_torch.utils import prng

    rng = np.random.default_rng(0)
    n = N_PARTICLES
    gt = torch.from_numpy(d["poses"][10]).to(device)
    tw = torch.from_numpy(rng.normal(0.0, 0.01, (n, 6)).astype(np.float32)).to(device)
    bank = (exp_se3(tw) @ gt).reshape(n, 16).T.contiguous()
    uv = project(cam, gt, markers)
    det_xy = torch.zeros((16, 2), device=device)
    det_xy[:5] = uv + torch.from_numpy(rng.normal(0, 0.3, (5, 2)).astype(np.float32)).to(device)
    det_mask = torch.zeros(16, dtype=torch.bool, device=device)
    det_mask[:5] = True
    eye = torch.eye(4, device=device)
    step = exp_se3(torch.tensor([0.002, -0.001, 0.003, 0.01, 0.0, -0.01], device=device))
    lo = torch.tensor([-0.004] * 3 + [-0.006] * 3, device=device)
    scal = torch.stack([cam.fx, cam.fy, cam.cx, cam.cy, torch.tensor(10.0, device=device),
                        torch.tensor(5.0, device=device), torch.tensor(5.0, device=device),
                        torch.tensor(0.0, device=device)])
    left = eye if cam_move_inv is None else cam_move_inv
    prm_b = sk.pack_params(left, step, gt, gt @ step, lo, -lo, scal, markers,
                           torch.ones(5, dtype=torch.bool, device=device), det_xy, det_mask,
                           torch.zeros(5, dtype=torch.bool, device=device))
    k_rot, k_trans = prng.split(prng.prng_key(7))
    return bank, prm_b, (*k_rot, *k_trans), det_xy


def check_kernels(device, d, cam, markers):
    """Phase 3: kernel vs plain at main-path shapes; returns the table rows."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.geometry import exp_se3
    from pf_monocular_pose_estimator_tpu_torch.ops import detect_kernel as dk
    from pf_monocular_pose_estimator_tpu_torch.pf import gather_kernel as gk
    from pf_monocular_pose_estimator_tpu_torch.pf import refine_kernel as rk
    from pf_monocular_pose_estimator_tpu_torch.pf import resample_kernel as fk
    from pf_monocular_pose_estimator_tpu_torch.pf import step_kernel as sk
    from pf_monocular_pose_estimator_tpu_torch.pf import weight_kernel as wk
    from pf_monocular_pose_estimator_tpu_torch.pf.soa import stratified_resample_soa
    from pf_monocular_pose_estimator_tpu_torch.utils import prng

    rows = []

    # A: threshold_blur on a full 752x480 frame (the init / full-frame path)
    frame = torch.from_numpy(d["frames"][0].astype(np.float32)).to(device)
    prm = dk.make_params([0.0, 0.0, 752.0, 480.0], 240.0, 8.0, 160.0, 0.6, device)
    got = dk.threshold_blur(frame, prm, 5)
    want = dk.threshold_blur_plain(frame, prm, 5, True)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert torch.equal(got, want), f"threshold_blur differs from plain (max {err})"
    px = frame.numel()
    # read the frame, write the blurred frame; ROI threshold (6) + 2 x 5 taps (20) a pixel
    b_ms, b_by = bound(8 * px + 4 * prm.numel(), 26 * px)
    rows.append(dict(name="threshold_blur", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/detect.cu",
                     replaces=f"{REF}/ops/pallas_kernels.py:362", max_abs_err=err,
                     ms=time_ms(lambda: dk.threshold_blur(frame, prm, 5)),
                     device_ms=device_time_ms(lambda: dk.threshold_blur(frame, prm, 5)),
                     plain_ms=time_ms(lambda: dk.threshold_blur_plain(frame, prm, 5, True), 5),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))
    print(f"[kernels] threshold_blur 480x752: exact (max abs err {err})")

    # A: detect_stats on a 192x256 crop around the LEDs of golden frame 17
    crop, prm_c = crop_inputs(d, device)
    lab, maps, top = dk.detect_stats(crop, prm_c, 5, True, 12, 16)
    lab_p, maps_p, top_p = dk.detect_stats_plain(crop, prm_c, 5, True, 12, 16)
    torch.cuda.synchronize()
    assert torch.equal(lab, lab_p), "detect_stats labels differ from plain"
    bad = [i for i in range(dk.N_MAPS) if not torch.equal(maps[i], maps_p[i])]
    assert not bad, f"detect_stats maps {bad} differ from plain"
    assert torch.equal(top, top_p), f"detect_stats top-k {top.tolist()} vs {top_p.tolist()}"
    n_roots = int((lab == torch.arange(1, 192 * 256 + 1, device=device).reshape(192, 256)).sum())
    assert n_roots >= 5, "the crop should hold the five LEDs"
    px = crop.numel()
    # read the crop, write labels and 10 maps; the operations of detect_ops
    b_ms, b_by = bound(4 * px + 4 * px * (1 + dk.N_MAPS) + 8 * 16, detect_ops(crop, prm_c, 12))
    rows.append(dict(name="detect_stats", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/detect.cu",
                     replaces=f"{REF}/ops/pallas_kernels.py:299", max_abs_err=0.0,
                     ms=time_ms(lambda: dk.detect_stats(crop, prm_c, 5, True, 12, 16)),
                     device_ms=device_time_ms(lambda: dk.detect_stats(crop, prm_c, 5, True, 12,
                                                                      16)),
                     plain_ms=time_ms(lambda: dk.detect_stats_plain(crop, prm_c, 5, True, 12, 16),
                                      3),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))
    print(f"[kernels] detect_stats 192x256: labels, 10 maps, top-16 exact ({n_roots} roots)")

    # the crop path's epilogue on A's outputs above: the detection bank, bit for
    # bit its plain twin run op by op on the same card tensors, at the tracker's
    # options (split, dip test, active markers; tolerances 0.7, a crop offset)
    from pf_monocular_pose_estimator_tpu_torch.utils import BlobParams

    params_e = BlobParams(min_blob_area=8.0)
    prm_e = torch.cat([prm_c, torch.tensor([0.7, 0.7, *crop_offset(d)], dtype=torch.float32,
                                           device=device)])
    epilogue = lambda t=top: dk.detect_epilogue(lab, maps, t, crop, prm_e, 5, params_e, cam)
    got, want = epilogue(), dk.detect_epilogue_plain(lab, maps, top, crop, prm_e, 5, params_e,
                                                     cam)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        bits = (lambda t: t.view(torch.int32)) if g.dtype == torch.float32 else (lambda t: t)
        assert torch.equal(bits(g), bits(w)), f"detect_epilogue: output {i} differs from plain"
    n_det = int(got[2].sum())
    assert n_det == 5, f"detect_epilogue: {n_det} detections, not the five LEDs"
    # per slot: A's ten maps, the label, the top-k index and up to nine crop
    # samples read, five floats and two flags written; the statistics, filters
    # and split (~170 operations), 8 undistortion rounds (~20 each) and the
    # compaction's 2K compares for each of 2K keys
    b_ms, b_by = bound(16 * (4 * (dk.N_MAPS + 1) + 8 + 4 * 9 + 4 * 5 + 2) + 4 * (16 + 9),
                       16 * (170 + 8 * 20) + (2 * 16) ** 2)
    rows.append(dict(name="detect_epilogue", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/detect.cu",
                     replaces=f"{REF}/ops/blob.py::_detect_blobs_fused after the Pallas call, "
                              "find_leds' undistortion",
                     max_abs_err=0.0, ms=time_ms(epilogue), device_ms=device_time_ms(epilogue),
                     plain_ms=time_ms(lambda: dk.detect_epilogue_plain(
                         lab, maps, top, crop, prm_e, 5, params_e, cam), 3),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))
    wide = {}
    for k in (64, 128):  # A's wide path above 64
        top_k = dk.detect_stats(crop, prm_c, 5, True, 12, k)[2]
        wide[k] = device_time_ms(lambda: epilogue(top_k))
    r = rows[-1]
    print(f"[kernels] detect_epilogue 192x256, K = 16: exact against the twin, {n_det} "
          f"detections; event {r['ms'] * 1e3:.2f} us, graph {r['device_ms'] * 1e3:.2f} us a call "
          f"(K = 64: {wide[64] * 1e3:.2f}, K = 128: {wide[128] * 1e3:.2f}), twin "
          f"{r['plain_ms'] * 1e3:.1f} us")

    # B: fused propagate + weight at N = 100,000, M = 5, K = 16
    n = N_PARTICLES
    bank, prm_b, keys, det_xy = pf_inputs(d, cam, markers, device)
    bank_k, w_k = sk.pf_step(bank, prm_b, keys, 5, 16)
    bank_p, w_p = sk.pf_step_plain(bank, prm_b, keys, 5, 16)
    torch.cuda.synchronize()
    ulps = (bank_k.view(torch.int32).long() - bank_p.view(torch.int32).long()).abs()
    ulps = torch.where((bank_k == 0) & (bank_p == 0), torch.zeros_like(ulps), ulps)
    max_ulp = int(ulps.max())
    same_w = int((w_k == w_p).sum())
    mism = torch.nonzero(w_k != w_p).flatten()[:10].tolist()
    err_b = float((w_k - w_p).abs().max())
    print(f"[kernels] pf_step N={n}: bank max {max_ulp} ulp, weights equal on {same_w} of {n} "
          f"lanes (max abs err {err_b}); mismatching lanes {mism}")
    assert max_ulp <= 4, f"pf_step bank differs by {max_ulp} ulp"
    assert same_w == n, f"pf_step weights equal on only {same_w} of {n} lanes"
    assert float(w_k.max()) > 20.0, "pf_step: no particle matched the detections"
    # read 16 rows, write 16 rows and the weight
    b_ms, b_by = bound(n * (64 + 64 + 4), n * (PROPAGATE_OPS + weight_ops(5, 16)))
    rows.append(dict(name="pf_step", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/pf_step.cu",
                     replaces=f"{REF}/pf/pallas_step.py:404", max_abs_err=err_b,
                     ms=time_ms(lambda: sk.pf_step(bank, prm_b, keys, 5, 16)),
                     device_ms=device_time_ms(lambda: sk.pf_step(bank, prm_b, keys, 5, 16)),
                     plain_ms=time_ms(lambda: sk.pf_step_plain(bank, prm_b, keys, 5, 16), 5),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # B per shard: P = 4 passes at lane_offset / n_total concatenate to the whole-bank pass
    s_len = n // MESH_SHARDS
    parts = [sk.pf_step(bank[:, i * s_len:(i + 1) * s_len].contiguous(), prm_b, keys, 5, 16,
                        lane_offset=i * s_len, n_total=n) for i in range(MESH_SHARDS)]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([b for b, _ in parts], 1), bank_k), \
        "pf_step per shard: the concatenated banks differ from the whole-bank pass"
    assert torch.equal(torch.cat([w for _, w in parts]), w_k), \
        "pf_step per shard: the concatenated weights differ from the whole-bank pass"
    shard = bank[:, s_len:2 * s_len].contiguous()
    shard_us = device_time_ms(lambda: sk.pf_step(shard, prm_b, keys, 5, 16, lane_offset=s_len,
                                                 n_total=n)) * 1e3
    print(f"[kernels] pf_step per shard P={MESH_SHARDS} (lane_offset, n_total): bank and weights "
          f"equal the whole-bank pass bit for bit; one shard's pass S={s_len} takes "
          f"{shard_us:.2f} us on the card alone")

    # B with a moving observer: ego-motion's cam_move_inv (a ~1e-2 twist) as
    # the left matrix, held to the plain version as exactly as the identity
    move = exp_se3(torch.tensor(OBSERVER_MOVE, device=device))
    _, prm_e, _, _ = pf_inputs(d, cam, markers, device, cam_move_inv=move)
    bank_e, w_e = sk.pf_step(bank, prm_e, keys, 5, 16)
    bank_ep, w_ep = sk.pf_step_plain(bank, prm_e, keys, 5, 16)
    parts = [sk.pf_step(bank[:, i * s_len:(i + 1) * s_len].contiguous(), prm_e, keys, 5, 16,
                        lane_offset=i * s_len, n_total=n) for i in range(MESH_SHARDS)]
    torch.cuda.synchronize()
    ulps = (bank_e.view(torch.int32).long() - bank_ep.view(torch.int32).long()).abs()
    ulps = torch.where((bank_e == 0) & (bank_ep == 0), torch.zeros_like(ulps), ulps)
    max_ulp_e = int(ulps.max())
    same_we = int((w_e == w_ep).sum())
    moved = float((bank_e - bank_k)[:12].abs().max())
    print(f"[kernels] pf_step N={n} with a moving observer (cam_move_inv = exp of "
          f"{list(OBSERVER_MOVE)}): bank max {max_ulp_e} ulp, weights equal on {same_we} of {n} "
          f"lanes (max abs err {float((w_e - w_ep).abs().max())}); the bank moved up to {moved} "
          f"from the identity's; per shard P={MESH_SHARDS} equal to the whole-bank pass")
    assert max_ulp_e <= 4, f"pf_step with a moving observer: bank differs by {max_ulp_e} ulp"
    assert same_we == n, f"pf_step with a moving observer: weights equal on {same_we} of {n}"
    assert moved > 1e-3, "pf_step: the moving observer did not move the bank"
    assert torch.equal(torch.cat([b for b, _ in parts], 1), bank_e) and \
        torch.equal(torch.cat([w for _, w in parts]), w_e), \
        "pf_step per shard with a moving observer differs from the whole-bank pass"

    # B, pairs variant (#4): the same pass with each particle's greedy pairs
    got = sk.pf_step(bank, prm_b, keys, 5, 16, want_pairs=True)
    want = sk.pf_step_plain(bank, prm_b, keys, 5, 16, want_pairs=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], bank_k) and torch.equal(got[1], w_k), \
        "pf_step's pairs variant changed the bank or the weights"
    assert torch.equal(got[2], want[2]), "pf_step pairs differ from plain"
    assert torch.equal(got[3], want[3]), "pf_step n_corr differs from plain"
    same_wp = int((got[1] == want[1]).sum())
    assert same_wp == n, f"pf_step pairs variant: weights equal on only {same_wp} of {n} lanes"
    print(f"[kernels] pf_step pairs N={n}: pairs and n_corr exact, weights equal on {same_wp} of "
          f"{n} lanes, bank and weights equal to the weights-only pass")
    b_ms, b_by = bound(n * (64 + 64 + 4 + 4 * 10 + 4), n * (PROPAGATE_OPS + weight_ops(5, 16)))
    rows.append(dict(name="pf_step_pairs", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/pf_step.cu",
                     replaces=f"{REF}/pf/pallas_step.py:299", max_abs_err=float(
                         (got[1] - want[1]).abs().max()),
                     ms=time_ms(lambda: sk.pf_step(bank, prm_b, keys, 5, 16, want_pairs=True)),
                     device_ms=device_time_ms(lambda: sk.pf_step(bank, prm_b, keys, 5, 16,
                                                                 want_pairs=True)),
                     plain_ms=time_ms(lambda: sk.pf_step_plain(bank, prm_b, keys, 5, 16,
                                                               want_pairs=True), 5),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # E: the standalone weight of B's propagated bank (#9)
    wprm = prm_b[76:].contiguous()
    got = wk.weight(bank_k, wprm, 5, 16)
    want = wk.weight_plain(bank_k, wprm, 5, 16)
    torch.cuda.synchronize()
    same_we = int((got[0] == want[0]).sum())
    assert torch.equal(got[1], want[1]), "pf_weight pairs differ from plain"
    assert torch.equal(got[2], want[2]), "pf_weight n_corr differs from plain"
    assert same_we == n, f"pf_weight weights equal on only {same_we} of {n} lanes"
    assert torch.equal(got[0], w_k), "pf_weight differs from kernel B's weight of the same bank"
    print(f"[kernels] pf_weight N={n}: pairs and n_corr exact, weights equal on {same_we} of {n} "
          f"lanes; {int((got[2] == 5).sum())} lanes matched 5 markers")
    b_ms, b_by = bound(n * (48 + 4 + 4 * 10 + 4), n * weight_ops(5, 16))
    rows.append(dict(name="pf_weight", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/pf_weight.cu",
                     replaces=f"{REF}/pf/pallas_weight.py:155",
                     max_abs_err=float((got[0] - want[0]).abs().max()),
                     ms=time_ms(lambda: wk.weight(bank_k, wprm, 5, 16)),
                     device_ms=device_time_ms(lambda: wk.weight(bank_k, wprm, 5, 16)),
                     plain_ms=time_ms(lambda: wk.weight_plain(bank_k, wprm, 5, 16), 5),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # C: the resampling gather with real stratified ancestors of B's weights
    wn = w_k / w_k.sum()
    anc, _, _ = stratified_resample_soa(prng.prng_key(3), wn)
    assert bool((anc[1:] >= anc[:-1]).all()), "ancestors must be non-decreasing"
    got_c = sk.resample_gather(bank_k, anc)
    want_c = sk.resample_gather_plain(bank_k, anc)
    torch.cuda.synchronize()
    assert torch.equal(got_c, want_c), "resample_gather differs from plain"
    n_unique = int(torch.unique(anc).numel())
    # read 12 rows and the int64 ancestors, write 16 rows
    b_ms, b_by = bound(n * (48 + 8 + 64), 0)
    rows.append(dict(name="resample_gather", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/resample_gather.cu",
                     replaces=f"{REF}/pf/pallas_step.py:668",
                     also_replaces=f"{REF}/pf/pallas_step.py:697", max_abs_err=0.0,
                     ms=time_ms(lambda: sk.resample_gather(bank_k, anc)),
                     device_ms=device_time_ms(lambda: sk.resample_gather(bank_k, anc)),
                     plain_ms=time_ms(lambda: sk.resample_gather_plain(bank_k, anc)),
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=time_ms(lambda: bank_k.index_select(1, anc)),
                     library_device_ms=device_time_ms(lambda: bank_k.index_select(1, anc))))
    print(f"[kernels] resample_gather N={n}: exact ({n_unique} distinct ancestors)")
    rows.append(check_ring_gather(device, bank_k, wn, got_c))

    # F (#10) and G (#11) on a covered and an uncovered weight profile
    gen = torch.Generator().manual_seed(0)
    covered = torch.softmax(0.8 * torch.randn(n, generator=gen), 0).to(device)
    lane = torch.arange(n, device=device)
    spread = torch.where(lane < n // 2, (lane % 8 == 0).float(), torch.ones_like(covered))
    spread = spread / spread.sum()
    for profile, wts in (("covered", covered), ("uncovered", spread)):
        rank, counts, _ = fk.probe_rank(prng.prng_key(9), wts)
        out, ok = fk.decode(rank, bank_k)
        out_p, ok_p = fk.decode_plain(rank, bank_k)
        anc_f = torch.repeat_interleave(torch.arange(n, device=device), counts.long())
        torch.cuda.synchronize()
        assert torch.equal(ok, ok_p), f"resample_decode flags differ from plain ({profile})"
        assert torch.equal(out, out_p), f"resample_decode differs from plain ({profile})"
        assert bool(ok.all()) == (profile == "covered"), f"resample_decode coverage ({profile})"
        if profile == "covered":
            assert torch.equal(out, bank_k[:, anc_f]), "resample_decode != bank[:, repeat(counts)]"
        print(f"[kernels] resample_decode N={n} {profile}: exact, {int(ok.sum())}/{ok.numel()} "
              f"blocks covered")
        out_g, ok_g = gk.windowed_gather(bank_k, anc_f)
        out_gp, ok_gp = gk.monotone_gather_plain(bank_k, anc_f)
        torch.cuda.synchronize()
        assert torch.equal(ok_g, ok_gp), f"monotone_gather flags differ from plain ({profile})"
        assert torch.equal(out_g, out_gp), f"monotone_gather differs from plain ({profile})"
        if bool(ok_g.all()):
            assert torch.equal(out_g, sk.resample_gather_plain(bank_k, anc_f))
        print(f"[kernels] monotone_gather N={n} {profile}: exact, {int(ok_g.sum())}/"
              f"{ok_g.numel()} blocks covered")
        if profile == "covered":
            rank_c, anc_c = rank, anc_f
    assert not bool(ok_g.all()), "the uncovered profile covered every gather window"
    check_windowed_large(device)
    # read rank and 16 rows, write 16 rows
    b_ms, b_by = bound(n * (4 + 64 + 64), n * 25)
    rows.append(dict(name="resample_decode", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/resample_decode.cu",
                     replaces=f"{REF}/pf/pallas_resample.py:181", max_abs_err=0.0,
                     ms=time_ms(lambda: fk.decode(rank_c, bank_k)),
                     device_ms=device_time_ms(lambda: fk.decode(rank_c, bank_k)),
                     plain_ms=time_ms(lambda: fk.decode_plain(rank_c, bank_k), 5),
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=time_ms(lambda: bank_k.index_select(1, anc_c)),
                     library_device_ms=device_time_ms(lambda: bank_k.index_select(1, anc_c))))
    # read 12 rows and the int64 ancestors, write 16 rows
    b_ms, b_by = bound(n * (48 + 8 + 64), n * 6)
    rows.append(dict(name="monotone_gather", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/monotone_gather.cu",
                     replaces=f"{REF}/pf/pallas_gather.py:93", max_abs_err=0.0,
                     ms=time_ms(lambda: gk.windowed_gather(bank_k, anc_c)),
                     device_ms=device_time_ms(lambda: gk.windowed_gather(bank_k, anc_c)),
                     plain_ms=time_ms(lambda: gk.monotone_gather_plain(bank_k, anc_c), 5),
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=time_ms(lambda: bank_k.index_select(1, anc_c)),
                     library_device_ms=device_time_ms(lambda: bank_k.index_select(1, anc_c))))

    print(f"[report] {card_line()}: resample_decode launches N={n} (us): "
          f"{launch_times_us(lambda: fk.decode(rank_c, bank_k))}")
    print(f"[report] {card_line()}: monotone_gather launches N={n} (us): "
          f"{launch_times_us(lambda: gk.windowed_gather(bank_k, anc_c))}")
    decode_count_placements(rank_c, bank_k)

    # D: batched Gauss-Newton over 11 = 2M + 1 hypotheses
    args = gn_inputs(d, cam, markers, device, det_xy[:5])
    b = args[1].shape[0]
    pk, sk_, ak = rk.gn_refine(*args, 25, 1e-4)
    pp, sp, ap = rk.gn_refine_plain(*args, 25, 1e-4)
    torch.cuda.synchronize()
    err_d = float((pk - pp).abs().max())
    print(f"[kernels] gn_refine B={b}: pose max abs err {err_d}, iterations "
          f"{sk_[:, 2].int().tolist()} vs {sp[:, 2].int().tolist()}")
    assert err_d <= 1e-5, f"gn_refine poses differ by {err_d}"
    assert torch.equal(sk_[:, 2], sp[:, 2]), "gn_refine iteration counts differ"
    assert float(sk_[:, 3].max()) < 1.5, "gn_refine did not converge on clean pairs"
    # each run iteration of a hypothesis: per pair projection, Jacobian and
    # normal-equation terms (~100), the 6x6 solve (~250), exp and compose
    # (~200); plus two residual passes; inputs and outputs are a few KB
    iters = float(sk_[:, 2].sum()) + 2 * b
    b_ms, b_by = bound(4 * sum(a.numel() for a in args) + 4 * b * (16 + 8 + 36),
                       iters * (100 * 5 + 450))
    rows.append(dict(name="gn_refine", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/gn_refine.cu",
                     replaces=f"{REF}/pf/pallas_refine.py:279", max_abs_err=err_d,
                     ms=time_ms(lambda: rk.gn_refine(*args, 25, 1e-4)),
                     device_ms=device_time_ms(lambda: rk.gn_refine(*args, 25, 1e-4)),
                     plain_ms=time_ms(lambda: rk.gn_refine_plain(*args, 25, 1e-4), 3),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # the fused refine: the picked particle's pairs, 11 hypotheses, D's iterations,
    # the pick and the covariance in one launch, against the plain twin; the
    # layer op by op (refine_hypotheses with D, the parent's path) is its yardstick
    from pf_monocular_pose_estimator_tpu_torch.tracker.step import refine_hypotheses

    rf_args, chain_args = refine_inputs(d, cam, markers, device, det_xy)
    got, want = rk.refine_frame(*rf_args), rk.refine_frame_plain(*rf_args)
    chain = refine_hypotheses(*chain_args, batched=True)
    torch.cuda.synchronize()
    for name in ("pose", "num_iterations", "jump", "info"):
        assert torch.equal(getattr(got, name), getattr(want, name)), f"refine_frame: {name}"
    err_f = float((got.covariance - want.covariance).abs().max())
    err_c = max(float((got.pose - chain[0]).abs().max()),
                float((got.covariance - chain[1]).abs().max()))
    print(f"[kernels] refine_frame M=5, K=16, 11 hypotheses: picked {got.info.tolist()}, "
          f"covariance max abs err {err_f} against the twin; pose and covariance "
          f"{err_c} from the op-by-op layer with D")
    assert err_f == 0.0 and err_c == 0.0, "refine_frame: pose or covariance differ"
    assert int(got.num_iterations) == int(chain[2]) and bool(got.jump) == bool(chain[3])
    # D's work on the 11 hypotheses (their iterations from the twin) and the
    # pairs' 80 distances; inputs and outputs are a few hundred bytes
    scal_f, pre_f, mark_f, mmask_f, xy_f, dmask_f, tol_f = rf_args[:7]
    dfm = rk.frame_hypotheses(scal_f, pre_f, mark_f, mmask_f, xy_f, dmask_f, tol_f)
    pick = dfm.clamp(0, 15)
    st = rk.gn_refine_plain(scal_f, pre_f.reshape(1, 16).expand(len(dfm), 16), mark_f[:3],
                            xy_f[:, 0][pick], xy_f[:, 1][pick], ((dfm >= 0) & mmask_f).float(),
                            25, 1e-4)[1]
    iters = float(st[:, 2].sum()) + 2 * len(dfm)
    b_ms, b_by = bound(4 * (16 + 20 + 48 + 16 + 36 + 20), iters * (100 * 5 + 450) + 80 * 10)
    fused = lambda: rk.refine_frame(*rf_args)
    layer = lambda: refine_hypotheses(*chain_args, batched=True)
    rows.append(dict(name="refine_frame", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/gn_refine.cu",
                     replaces="tracker/step.py::refine_hypotheses (the refine layer with D)",
                     max_abs_err=err_f, ms=time_ms(fused), device_ms=device_time_ms(fused),
                     plain_ms=time_ms(lambda: rk.refine_frame_plain(*rf_args), 3),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     profiled_us=busy_us_per_call(fused)[0], chain_ms=time_ms(layer, 5),
                     chain_profiled_us=busy_us_per_call(layer)[0]))
    r = rows[-1]
    print(f"[timing] {card_line()}: refine layer op by op with D: event {r['chain_ms'] * 1e3:.1f} "
          f"us, device busy {r['chain_profiled_us']} us a call; fused: event "
          f"{r['ms'] * 1e3:.1f} us, device busy {r['profiled_us']} us a call")

    # the one-pose refine (the IPE and init branches'): the picked particle's
    # pose above from the five true pairs, gauss_newton_refine's iterations
    # and covariance in one launch, against the plain twin (that function on
    # the scalar camera) and gauss_newton_refine on the tracker's camera (the
    # path without use_pallas_gn), both to the bit
    from pf_monocular_pose_estimator_tpu_torch.pf.refine import gauss_newton_refine

    scal_f, pre_f, mark_f, mmask_f, xy_f = rf_args[:5]
    dfm5 = torch.arange(5, dtype=torch.int32, device=device)
    rp_args = (scal_f, pre_f, mark_f, mmask_f, dfm5, xy_f)
    got, want = rk.refine_pose(*rp_args), rk.refine_pose_plain(*rp_args)
    corr = torch.stack([dfm5, dfm5], -1)
    op = lambda: gauss_newton_refine(cam, pre_f, markers, xy_f, corr, mmask_f, 25, 1e-4)
    chain = op()
    torch.cuda.synchronize()
    for name in ("pose", "covariance", "num_iterations"):
        assert torch.equal(getattr(got, name), getattr(want, name)), f"refine_pose: {name}"
    err_p = float((got.pose - chain.pose).abs().max())
    err_c = float((got.covariance - chain.covariance).abs().max())
    print(f"[kernels] refine_pose M=5, K=16: exact against the twin, {int(got.num_iterations)} "
          f"iterations; from gauss_newton_refine on the tracker's camera: pose {err_p}, "
          f"covariance {err_c}, iterations {int(chain.num_iterations)}")
    assert err_p == 0.0 and err_c == 0.0, "refine_pose: differs from gauss_newton_refine"
    assert int(got.num_iterations) == int(chain.num_iterations)
    # inputs: camera, pose, markers, mask, pairs and the five gathered
    # detections; the output buffer; D's work on one row and the covariance
    iters = int(got.num_iterations) + 2
    b_ms, b_by = bound(16 + 64 + 80 + 5 + 20 + 40 + 4 * 53, iters * (100 * 5 + 450) + 300)
    one = lambda: rk.refine_pose(*rp_args)
    rows.append(dict(name="refine_pose", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/gn_refine.cu",
                     replaces="pf/refine.py::gauss_newton_refine of one pose (IPE and init)",
                     max_abs_err=0.0, ms=time_ms(one), device_ms=device_time_ms(one),
                     plain_ms=time_ms(lambda: rk.refine_pose_plain(*rp_args), 3),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     profiled_us=busy_us_per_call(one)[0], chain_ms=time_ms(op, 5),
                     chain_profiled_us=busy_us_per_call(op)[0]))
    r = rows[-1]
    print(f"[timing] {card_line()}: one-pose refine: gauss_newton_refine op by op: event "
          f"{r['chain_ms'] * 1e3:.1f} us, device busy {r['chain_profiled_us']} us a call; "
          f"refine_pose: event {r['ms'] * 1e3:.1f} us, graph {r['device_ms'] * 1e3:.2f} us, "
          f"device busy {r['profiled_us']} us a call; twin {r['plain_ms'] * 1e3:.1f} us; bound "
          f"{b_ms * 1e3:.4f} us ({b_by})")
    return rows


def check_windowed_large(device):
    """F and G against their plain versions at 1,000,000 lanes, on a covered
    and an uncovered weight profile, with each launch's device time and F's
    other count placement timed beside it."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.pf import gather_kernel as gk
    from pf_monocular_pose_estimator_tpu_torch.pf import resample_kernel as fk
    from pf_monocular_pose_estimator_tpu_torch.utils import prng

    n = N_LARGE
    gen = torch.Generator().manual_seed(2)
    bank = torch.randn(16, n, generator=gen).to(device)
    bank[12:15], bank[15] = 0.0, 1.0
    lane = torch.arange(n, device=device)
    spread = torch.where(lane < n // 2, (lane % 8 == 0).float(), torch.ones(n, device=device))
    profiles = (("covered", torch.softmax(0.8 * torch.randn(n, generator=gen), 0).to(device)),
                ("uncovered", spread / spread.sum()))
    for profile, wts in profiles:
        rank, counts, _ = fk.probe_rank(prng.prng_key(11), wts)
        anc = torch.repeat_interleave(torch.arange(n, device=device), counts.long())
        out, ok = fk.decode(rank, bank)
        out_p, ok_p = fk.decode_plain(rank, bank)
        out_g, ok_g = gk.windowed_gather(bank, anc)
        out_gp, ok_gp = gk.monotone_gather_plain(bank, anc)
        torch.cuda.synchronize()
        assert torch.equal(ok, ok_p) and torch.equal(out, out_p), \
            f"resample_decode differs from plain at N={n} ({profile})"
        assert torch.equal(ok_g, ok_gp) and torch.equal(out_g, out_gp), \
            f"monotone_gather differs from plain at N={n} ({profile})"
        assert bool(ok.all()) == (profile == "covered"), f"resample_decode coverage ({profile})"
        print(f"[kernels] resample_decode and monotone_gather N={n} {profile}: exact, "
              f"{int(ok.sum())}/{ok.numel()} and {int(ok_g.sum())}/{ok_g.numel()} blocks covered")
        if profile == "covered":
            print(f"[report] {card_line()}: resample_decode launches N={n} (us): "
                  f"{launch_times_us(lambda: fk.decode(rank, bank))}, index_select "
                  f"{device_time_ms(lambda: bank.index_select(1, anc)) * 1e3:.2f} us")
            print(f"[report] {card_line()}: monotone_gather launches N={n} (us): "
                  f"{launch_times_us(lambda: gk.windowed_gather(bank, anc))}")
            decode_count_placements(rank, bank)


def decode_count_placements(rank, bank):
    """Kernel F's device time (CUDA graphs of 20 calls) through `decode` as
    built and with the other placement of the window-start count, which the
    wrapper chooses by N (`COUNT_IN_BLOCK_CHUNKS`): in every decode block,
    or one launch before the decode; each held to the plain version."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.pf import resample_kernel as fk

    n = bank.shape[1]
    out_p, ok_p = fk.decode_plain(rank, bank)
    built = fk.COUNT_IN_BLOCK_CHUNKS
    in_block = -(-n // 128) <= built
    placements = {"as built": built,
                  ("starts launch" if in_block else "count in every block"): (
                      0 if in_block else -(-n // 128))}
    times = {}
    try:
        for name, limit in placements.items():
            fk.COUNT_IN_BLOCK_CHUNKS = limit
            out, ok = fk.decode(rank, bank)
            torch.cuda.synchronize()
            assert torch.equal(out, out_p) and torch.equal(ok, ok_p), \
                f"resample_decode ({name}) differs from plain at N={n}"
            times[name] = round(device_time_ms(lambda: fk.decode(rank, bank)) * 1e3, 2)
    finally:
        fk.COUNT_IN_BLOCK_CHUNKS = built
    print(f"[report] {card_line()}: resample_decode N={n} on the card alone (us): {times}")


def ring_blocks(shards, deltas):
    """Each local shard's ring blocks for `deltas`, as views: shard i's block
    for delta d is shard (i - d) mod P's 12 rows of `shards` (P, 16, S), what
    `LocalMesh.receive` gives (written out, so that a checkout without it
    runs this too)."""
    p = shards.shape[0]
    return [[shards[(i - d) % p, :12] for d in deltas] for i in range(p)]


def ring_positions(p: int, s: int, total: int, gen, device):
    """(P, S) int32 positions into each shard's concatenation of `total`
    lanes: sorted, covering both ends, with clamped draws (every 97th) that
    break the order."""
    import torch

    pos = torch.sort(torch.randint(0, total, (p, s), generator=gen), dim=1).values.to(torch.int32)
    pos[:, ::97] = pos[:, s // 2:s // 2 + 1]
    pos[:, 0], pos[:, -1] = 0, total - 1
    return pos.to(device)


def ring_ancestor_positions(anc, p: int, deltas):
    """(P, S) int32: where the ancestors `anc` (N,) of the output lanes lie in
    each shard's concatenation of the blocks at `deltas`, as the ring
    resampler computes them when no draw is clipped: the main path's
    positions, mostly in the shard's own block and non-decreasing."""
    import torch

    s = anc.shape[0] // p
    src, lane = (anc // s).reshape(p, s), (anc % s).reshape(p, s)
    shard = torch.arange(p, device=anc.device)[:, None]
    slot = torch.full_like(src, -1)
    for k, d in enumerate(deltas):
        slot = torch.where(src == (shard - d) % p, k, slot)
    assert bool((slot >= 0).all()), "an ancestor lies beyond the ring's blocks"
    return (slot * s + lane).to(torch.int32)


def ring_bound(lanes: int):
    """Kernel H's bound over `lanes` output lanes: each reads a 4-byte
    position and 12 rows (48 bytes) and writes 16 rows (64 bytes), once;
    ~20 integer operations a lane."""
    return bound(lanes * (4 + 48 + 64), 20 * lanes)


def check_ring_gather(device, bank_k, wn, want_c):
    """Kernel H, one launch over the 4 shards of N = 100,000, against its
    plain version on four profiles of ring blocks (views of the other
    shards' rows, as the resampler hands them over), then the ring resampler
    on a local mesh at P = 1, 2, 4, 8 against the single-device result
    `want_c` of the same weights `wn`; returns H's table row, timed on the
    blocks of the ring that reaches every shard (the sharded replay's) at
    the positions of the stratified ancestors of `wn`."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.parallel import gather_kernel as hk
    from pf_monocular_pose_estimator_tpu_torch.parallel.comm import (LocalMesh, shard_lanes,
                                                                     unshard_lanes)
    from pf_monocular_pose_estimator_tpu_torch.parallel.resample import (make_distributed_resampler,
                                                                         ring_deltas)
    from pf_monocular_pose_estimator_tpu_torch.pf.soa import stratified_resample_soa
    from pf_monocular_pose_estimator_tpu_torch.utils import prng

    n, p = bank_k.shape[1], MESH_SHARDS
    s, w = n // p, n // p // 4
    gen = torch.Generator().manual_seed(1)
    key = prng.prng_key(3)
    anc, counts, most = stratified_resample_soa(key, wn)
    mesh = LocalMesh(p)
    shards = shard_lanes(mesh, bank_k)  # (4, 16, S)
    top12 = shards[:, :12]
    profiles = {
        "window": [list(top12), mesh.receive(top12[:, :, :w], -1),
                   mesh.receive(top12[:, :, s - w:], 1)],
        "all_reach": [mesh.receive(top12, d) for d in ring_deltas(p - 1, p)],
        "ancestors": [mesh.receive(top12, d) for d in ring_deltas(p - 1, p)],
        "identity": [list(top12)],
    }
    for name, received in profiles.items():
        blocks = [list(shard) for shard in zip(*received)]
        total = sum(b.shape[1] for b in blocks[0])
        if name == "identity":
            pos = torch.arange(s, dtype=torch.int32, device=device).repeat(p, 1)
        elif name == "ancestors":
            pos = ring_ancestor_positions(anc, p, ring_deltas(p - 1, p))
        else:
            pos = ring_positions(p, s, total, gen, device)
        before = hk.ring_gather.launches
        got = hk.ring_gather(blocks, pos)
        want = hk.ring_gather_plain(blocks, pos)
        torch.cuda.synchronize()
        assert hk.ring_gather.launches == before + 1, "ring_gather: not one launch for 4 shards"
        assert torch.equal(got, want), f"ring_gather differs from plain ({name})"
        if name == "identity":
            assert torch.equal(got[:, :12], top12), "ring_gather identity changed the block"
        if name == "ancestors":
            timed = (blocks, pos)
        print(f"[kernels] ring_gather {name} P={p} S={s} ({len(blocks[0])} blocks a shard, "
              f"{total} lanes): exact, one launch")
    blocks, pos = timed
    cat12 = torch.cat([torch.cat(shard, 1) for shard in blocks], 1)
    pos64 = (pos.long() + torch.arange(p, device=device)[:, None] * p * s).reshape(-1)
    b_ms, b_by = ring_bound(p * s)
    row = dict(name="ring_gather", route="cuda",
               source="pf_monocular_pose_estimator_tpu_torch/csrc/ring_gather.cu",
               replaces=f"{REF}/pf/pallas_step.py:716", max_abs_err=0.0,
               ms=time_ms(lambda: hk.ring_gather(blocks, pos)),
               plain_ms=time_ms(lambda: hk.ring_gather_plain(blocks, pos)),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=time_ms(lambda: cat12.index_select(1, pos64)),
               device_ms=device_time_ms(lambda: hk.ring_gather(blocks, pos)),
               library_device_ms=device_time_ms(lambda: cat12.index_select(1, pos64)))
    print(f"[timing] ring_gather P={p} S={s} at the ancestors' positions, one launch, on the "
          f"card alone (CUDA graph of 20 launches): {row['device_ms'] * 1e3:.2f} us, index_select "
          f"over the concatenation {row['library_device_ms'] * 1e3:.2f} us")

    # the ring resampler across widths against the single-device sort path + kernel C
    for p in (1, 2, 4, 8):
        mesh = LocalMesh(p)
        resample = make_distributed_resampler(mesh, n)
        before = hk.ring_gather.launches
        out = resample(key, shard_lanes(mesh, wn), shard_lanes(mesh, bank_k))
        torch.cuda.synchronize()
        assert hk.ring_gather.launches == before + 1, "the resampler did not launch kernel H once"
        assert torch.equal(unshard_lanes(mesh, out.resampled), want_c), \
            f"sharded resampler P={p}: resampled differs from the single-device path"
        assert torch.equal(unshard_lanes(mesh, out.counts).long(), counts.long()), \
            f"sharded resampler P={p}: counts differ"
        assert int(out.most) == int(most), f"sharded resampler P={p}: most differs"
        assert int(out.clipped) == 0, f"sharded resampler P={p}: {int(out.clipped)} draws clipped"
    print(f"[kernels] sharded resampler N={n}: P = 1, 2, 4, 8 equal stratified_resample_soa + "
          f"resample_gather bit for bit (resampled, counts, most), clipped 0, one launch of H")
    return row


def device_busy_us(prof):
    """(the union of a trace's device spans (kernels, copies, sets) in µs,
    the number of spans)."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy, len(spans)


def busy_us_per_call(fn, reps: int = 5, attempts: int = 3, largest: int = 6):
    """Device µs of one call of `fn`: the union of its device spans over
    `reps` calls under torch.profiler (CUDA activity), over `reps`, and the
    `largest` device entries of the trace by their total, in µs a call; a
    trace that lists no device span is taken again, up to `attempts`
    traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy, _ = device_busy_us(prof)
        if busy > 0:
            totals = sorted(((getattr(ev, "device_time_total", None)
                              or getattr(ev, "cuda_time_total", 0), kernel_name(ev.key))
                             for ev in prof.key_averages()), reverse=True)[:largest]
            return round(busy / reps, 2), {name: round(t / reps, 2) for t, name in totals}
    return "not measured (the profiler saw no device time)", {}


def ring_timings(device, batched: bool) -> dict:
    """Kernel H and the ring resampler at N = 100,000 and 1,000,000 over a
    local mesh of 4 shards, every block reaching every shard (SHARDED): H as
    four one-shard launches and, with `batched`, as one launch over the four
    shards, at the positions of stratified ancestors (and, for the check
    alone, at random positions over every block), each against its plain
    version and timed on the card alone (CUDA graphs of 20 calls), beside
    `index_select` over the concatenation and H's bound; then the device
    time of one whole ring resampling (torch.profiler, the union of its
    device spans, and its largest device entries), also on the reference's
    default ring.  Uses only what a checkout from before the batched launch
    has too: `python3 chip_smoke.py --ring-only` runs it (without `batched`)
    in such a checkout, for comparison on one card."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.parallel import gather_kernel as hk
    from pf_monocular_pose_estimator_tpu_torch.parallel.comm import LocalMesh, shard_lanes
    from pf_monocular_pose_estimator_tpu_torch.parallel.resample import (make_distributed_resampler,
                                                                         ring_deltas)
    from pf_monocular_pose_estimator_tpu_torch.pf.soa import stratified_resample_soa
    from pf_monocular_pose_estimator_tpu_torch.utils import prng

    p, out = MESH_SHARDS, {}
    mesh = LocalMesh(p)
    key = prng.prng_key(3)
    for n in (N_PARTICLES, N_LARGE):
        s = n // p
        gen = torch.Generator().manual_seed(4)
        bank = torch.randn(16, n, generator=gen)
        bank[12:15], bank[15] = 0.0, 1.0
        wts = torch.softmax(0.8 * torch.randn(n, generator=gen), 0).to(device)
        bank = bank.to(device)
        shards = shard_lanes(mesh, bank)
        blocks = ring_blocks(shards, ring_deltas(p - 1, p))
        spread = ring_positions(p, s, p * s, gen, device)
        pos = ring_ancestor_positions(stratified_resample_soa(key, wts)[0], p,
                                      ring_deltas(p - 1, p))
        per_shard = lambda: [hk.ring_gather(blocks[i], pos[i]) for i in range(p)]
        for check in (spread, pos):
            want = torch.stack([hk.ring_gather_plain(blocks[i], check[i]) for i in range(p)])
            got = torch.stack([hk.ring_gather(blocks[i], check[i]) for i in range(p)])
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"ring_gather, one launch a shard, differs at N={n}"
            if batched:
                before = hk.ring_gather.launches
                got = hk.ring_gather(blocks, check)
                torch.cuda.synchronize()
                assert hk.ring_gather.launches == before + 1 and torch.equal(got, want), \
                    f"ring_gather over {p} shards differs from plain at N={n}"
        cat12 = torch.cat([torch.cat(shard, 1) for shard in blocks], 1)
        pos64 = (pos.long() + torch.arange(p, device=device)[:, None] * p * s).reshape(-1)
        row = {"one_launch_a_shard_device_us": round(device_time_ms(per_shard) * 1e3, 2),
               "index_select_device_us": round(device_time_ms(
                   lambda: cat12.index_select(1, pos64)) * 1e3, 2),
               "bound_us": round(ring_bound(n)[0] * 1e3, 2)}
        if batched:
            row["one_launch_device_us"] = round(device_time_ms(
                lambda: hk.ring_gather(blocks, pos)) * 1e3, 2)
        w_sh, b_sh = shard_lanes(mesh, wts), shard_lanes(mesh, bank)
        for ring, kwargs in (("all_reach", dict(reach=p - 1, payload_window=None)),
                             ("default_ring", {})):
            resample = make_distributed_resampler(mesh, n, **kwargs)
            row[f"resampling_{ring}_device_us"], row[f"resampling_{ring}_largest_us"] = \
                busy_us_per_call(lambda: resample(key, w_sh, b_sh))
        out[n] = row
        print(f"[ring] {card_line()}: N={n} P={p} (us): {row}")
    return out


def replay(device, d, cam, markers, overrides=None, n_frames=None, n_particles=N_PARTICLES,
           mesh=None, base=MAIN, observer=None, seed=0, **sharded):
    """One replay of the first `n_frames` frames of `d` with the config `base`
    (the main path's unless given) plus `overrides`; with `mesh`, the bank
    cut over that particles mesh and `sharded` passed to
    `make_sharded_tracker`; with `observer(i) -> (obs_pose, obs_time)`, the
    observer pose given with frame i; the state's key is `prng_key(seed)`.
    Returns the poses, the per-frame updated / fail flag / cumulative
    clipped draws / injected and occluded detections / detection count /
    blob area / ROI / exposure and its two counters, the seconds, the
    tracker and the last state."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.parallel import (make_sharded_tracker,
                                                                shard_target_state)
    from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
    from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
    from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

    config = TrackerConfig(**dict(base, n_particles=n_particles), **(overrides or {}))
    mask = torch.ones(markers.shape[0], dtype=torch.bool)
    state = TargetState.create(n_particles, prng_key(seed), device=device)
    if mesh is None:
        step = make_tracker(cam, markers, mask, config, device=device)
    else:
        step = make_sharded_tracker(cam, markers, mask, config, mesh, device=device, **sharded)
        state = shard_target_state(state, mesh)
    frames = torch.from_numpy(d["frames"][:n_frames]).to(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, counters = [], []
    for i in range(frames.shape[0]):
        obs = () if observer is None else observer(i)
        state, res = step(state, frames[i], float(d["times"][i]), *obs)
        results.append(res)
        counters.append((state.exposure_counter_increase, state.exposure_counter_decrease))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stack = lambda name: torch.stack([getattr(r, name) for r in results]).cpu().numpy()
    return SimpleNamespace(poses=stack("pose"), updated=stack("pose_updated"),
                           flags=stack("fail_flag"), clipped=stack("resample_clipped"),
                           injected=stack("detections_injected").sum(1),
                           occluded=stack("detections_occluded").sum(1),
                           num_detections=stack("num_detections"),
                           blob_area_sum=stack("blob_area_sum"), roi=stack("roi"),
                           exposure_us=stack("exposure_us"),
                           exposure_counters=torch.stack([torch.stack(c) for c in counters])
                           .cpu().numpy(),
                           seconds=seconds, step=step, state=state, n_particles=n_particles,
                           syncs_per_frame=step.host.count / step.frames,
                           frames_per_second=frames.shape[0] / seconds)


def idle_share(device, d, cam, markers, n_frames: int = 20, overrides=None,
               n_particles: int = N_PARTICLES) -> dict:
    """The card's busy time against the wall time of `n_frames` warm frames
    of the main path (plus `overrides`): golden frames 0-19 warm a new
    tracker, 20-39 are timed as they run, 40-59 are timed under
    torch.profiler (CUDA activity only), whose kernels, copies and sets give the busy time (their union).  The
    idle share is against the wall without the profiler, which adds host
    time to each frame; the share against the profiled wall is given under
    its own name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
    from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
    from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

    config = TrackerConfig(**dict(MAIN, n_particles=n_particles), **(overrides or {}))
    step = make_tracker(cam, markers, torch.ones(markers.shape[0], dtype=torch.bool), config,
                        device=device)
    state = TargetState.create(n_particles, prng_key(0), device=device)
    frames = torch.from_numpy(d["frames"][:3 * n_frames]).to(device)

    def run(lo):
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(lo, lo + n_frames):
            state, _ = step(state, frames[i], float(d["times"][i]))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_frames

    run(0)
    wall_ms = run(n_frames)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = run(2 * n_frames)
    busy_us, n_spans = device_busy_us(prof)
    if busy_us <= 0:
        return {"wall_ms_per_frame": wall_ms,
                "device_ms_per_frame": "not measured (the trace listed no device spans)",
                "idle_share": "not measured"}
    device_ms = busy_us / 1e3 / n_frames
    return {"device_ms_per_frame": device_ms, "wall_ms_per_frame": wall_ms,
            "idle_share": 1.0 - device_ms / wall_ms,
            "profiled_wall_ms_per_frame": profiled_wall_ms,
            "profiled_idle_share": 1.0 - device_ms / profiled_wall_ms,
            "device_spans_per_frame": n_spans / n_frames}


def one_rank_group(device, d, cam, markers):
    """Phase 9: a `torch.distributed` group of this one rank over `nccl`
    (file rendezvous, no network) carries the sharded step's collectives; a
    few frames that resample on every tracked frame must equal the local
    mesh of one shard bit for bit."""
    import tempfile

    import torch
    import torch.distributed as dist
    from pf_monocular_pose_estimator_tpu_torch.parallel import DistMesh, LocalMesh, distributed

    args = dict(overrides=dict(resample_min_ess=0.0), n_frames=6)
    local = replay(device, d, cam, markers, mesh=LocalMesh(1), **args)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1,
                                rank=0)
        try:
            mesh = distributed.make_pod_mesh()
            assert isinstance(mesh, DistMesh) and mesh.size == 1
            group = replay(device, d, cam, markers, mesh=mesh, **args)
        finally:
            dist.destroy_process_group()
    assert group.updated.all() and np.array_equal(group.flags, local.flags)
    assert np.array_equal(group.poses, local.poses), "one-rank nccl group: poses differ"
    assert torch.equal(group.state.bank, local.state.bank), "one-rank nccl group: banks differ"
    assert int(group.clipped[-1]) == 0
    print(f"[group] one rank over nccl {'.'.join(map(str, torch.cuda.nccl.version()))}: 6 frames "
          f"at {N_PARTICLES} particles equal the local mesh of one shard bit for bit (poses, "
          f"flags, bank), {group.frames_per_second:.2f} frames/s")


PTXAS_FIELDS = re.compile(r"Function properties for (\S+)|(\d+) bytes stack frame, (\d+) bytes "
                          r"spill stores, (\d+) bytes spill loads|Used (\d+) registers")


def ptxas_report(cuda_lib) -> list:
    """`nvcc -Xptxas -v` of every source in csrc/ with the port's flags, one
    nvcc each, all at once: (source, kernel, registers, stack frame, spill
    stores, spill loads) per kernel.  gn_refine.cu is built a second time
    with sinf/cosf as __sinf/__cosf, whose frame tells the math library's
    local memory from the kernel's own."""
    import tempfile

    csrc = ROOT / "pf_monocular_pose_estimator_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        fast_trig = Path(tmp) / "gn_refine_fast_trig.cu"
        fast_trig.write_text((csrc / "gn_refine.cu").read_text()
                             .replace("sinf(", "__sinf(").replace("cosf(", "__cosf("))
        sources = [csrc / name for name in cuda_lib.SOURCES] + [fast_trig]
        procs = [subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v",
                                   "-I", str(csrc), "-c", "-o", f"{tmp}/{i}.o", str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for i, src in enumerate(sources)]
        rows = []
        for src, proc in zip(sources, procs):
            _, err = proc.communicate()
            assert proc.returncode == 0, f"ptxas report: {src.name} failed:\n{err}"
            name = None
            for m in PTXAS_FIELDS.finditer(err):
                if m[1]:
                    name = m[1]
                elif m[2]:
                    rows.append([src.name, name, None, *map(int, m.group(2, 3, 4))])
                elif rows and rows[-1][1] == name:
                    rows[-1][2] = int(m[5])
    demangler = Path(cuda_lib._nvcc()).parent / "cu++filt"
    if demangler.is_file():
        names = subprocess.run([str(demangler)], input="\n".join(r[1] for r in rows),
                               capture_output=True, text=True, check=True).stdout.splitlines()
        for r, full in zip(rows, names):
            r[1] = kernel_name(full)
    return rows


def kernel_name(full: str) -> str:
    """'void <unnamed>::k<(int)5>(float const*, int)' -> 'k<(int)5>'."""
    full = full.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
    full = full.removeprefix("void ")
    return (full.rsplit("(", 1)[0] if full.endswith(")") else full)[:60]


def launch_times_us(fn, reps: int = 20, attempts: int = 3):
    """Device time of each kernel that one call of `fn` launches (µs), by
    torch.profiler; a trace that lists no device time is taken again, up to
    `attempts` traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = {}
        for ev in prof.key_averages():
            total = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            if total > 0 and ev.count >= reps:
                times[kernel_name(ev.key)] = round(total / reps, 3)
        if times:
            return times
    return "not measured (the profiler saw no device time)"


def report(device, d, cam, markers, cuda_lib, dk, rk, sk, wk, hk):
    """The build report of every kernel (E, F, G, H and the wide forms of A,
    B and E must use no local memory, B's default forms none beyond the math
    library's 32-byte sincosf frame; the registers of B and E at the main
    path's M = 5 and of the wide forms) and the device time of
    each launch of kernels A, B, D, E and H on their main-path inputs (H:
    one launch over the 4 shards of B's bank, every block reaching every
    shard, at the positions of the stratified ancestors of B's weights)."""
    from pf_monocular_pose_estimator_tpu_torch.parallel.comm import LocalMesh, shard_lanes
    from pf_monocular_pose_estimator_tpu_torch.parallel.resample import ring_deltas
    from pf_monocular_pose_estimator_tpu_torch.pf.soa import stratified_resample_soa
    from pf_monocular_pose_estimator_tpu_torch.utils import prng

    greedy_regs, wide_regs = {}, {}
    for src, name, regs, frame, stores, loads in ptxas_report(cuda_lib):
        print(f"[report] ptxas {src} {name}: {regs} registers, {frame} bytes stack frame, "
              f"{stores} bytes spill stores, {loads} bytes spill loads")
        if name.startswith(WIDE_KERNELS):
            wide_regs[name] = regs
            assert frame == stores == loads == 0, f"{src} {name} uses local memory"
            continue
        if src in ("resample_decode.cu", "monotone_gather.cu", "pf_weight.cu", "ring_gather.cu"):
            assert frame == stores == loads == 0, f"{src} {name} uses local memory"
        if src == "pf_step.cu":
            assert frame <= 32 and stores == loads == 0, f"{src} {name} uses local memory"
        if name.startswith(("pf_step_kernel<(int)5,", "pf_weight_kernel<(int)5,")):
            greedy_regs[name] = regs
    print(f"[report] {card_line()}: registers of kernels B and E at M = 5: {greedy_regs}; of "
          f"the wide forms of A, B and E: {wide_regs}")
    crop, prm = crop_inputs(d, device)
    gn_args = gn_inputs(d, cam, markers, device)
    bank, prm_b, keys, _ = pf_inputs(d, cam, markers, device)
    bank_e = sk.pf_step(bank, prm_b, keys, 5, 16)[0]
    wprm = prm_b[76:].contiguous()
    p, w_e = MESH_SHARDS, sk.pf_step(bank, prm_b, keys, 5, 16)[1]
    anc = stratified_resample_soa(prng.prng_key(3), w_e / w_e.sum())[0]
    blocks = ring_blocks(shard_lanes(LocalMesh(p), bank_e), ring_deltas(p - 1, p))
    pos = ring_ancestor_positions(anc, p, ring_deltas(p - 1, p))
    # one trace for all five: a run's later traces have come back without device time
    rf_args = refine_inputs(d, cam, markers, device, pf_inputs(d, cam, markers, device)[3])[0]
    times = launch_times_us(lambda: (dk.detect_stats(crop, prm, 5, True, 12, 16),
                                     rk.gn_refine(*gn_args, 25, 1e-4),
                                     rk.refine_frame(*rf_args),
                                     sk.pf_step(bank, prm_b, keys, 5, 16),
                                     sk.pf_step(bank, prm_b, keys, 5, 16, want_pairs=True),
                                     wk.weight(bank_e, wprm, 5, 16),
                                     hk.ring_gather(blocks, pos)))
    print(f"[report] {card_line()}: launches of kernels A (detect_stats), D (gn_refine), the "
          f"fused refine (refine_frame), B "
          f"(pf_step, weights only and with pairs), E (pf_weight) and H (ring_gather, {p} "
          f"shards) at N={N_PARTICLES} (us): {times}")


# [shapes]: the shape grid of tests/test_torch_kernels_cuda.py (SHAPE_*,
# every bucket of kernels B, E, D and A beyond the main path's K = 16, M = 5,
# 12 sweeps and top-k 16) with that file's input generators
SHAPE_LANES = 20_000
WIDE = dict(m=16, k=64, sweeps=20, topk=100)  # the wide shape timed at N_PARTICLES
WIDE_REPLAY = dict(cc_sweeps=20, max_detections=32)  # [wide]: A's and B's wide forms every frame
TEN_MARKERS = ROOT / "configs" / "two_uav_marker_positions.yaml"
TEN_FRAMES = 8
TWIN_FRAMES = 6


def exact_err(got, want) -> float:
    """Largest |got - want| over pairs of tensors; NaN against NaN counts as
    equal, NaN against a number as inf."""
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        d = (g - w).abs().masked_fill((g == w) | (g.isnan() & w.isnan()), 0.0)
        err = max(err, float(d.nan_to_num(nan=float("inf")).max()) if d.numel() else 0.0)
    return err


def shape_phase(device, d, card, counted) -> dict:
    """[shapes]: kernels B (both variants), E, D and A against their plain
    twins on the card across the shape grid (every K with M in {3, 9, 32},
    every M with K in {12, 64}, the full K x M grid for E; D at every M; A
    at every sweep count and top-k on two frames), each with max_abs_err 0;
    the wide shape's device time beside its bound; tests/
    test_torch_parallel_multi.py's two-target scene at its configuration
    (max_detections=12) on the card and on the CPU, flags equal on every
    (frame, target); and configs/two_uav_marker_positions.yaml as one object
    of ten markers on a synthetic orbit: frame 0 from a fresh state (the
    init) and frames 1-7 from a state seeded at frame 0's pose (the track
    branch: B, D and A at M = 10), on the card and on the CPU, flags equal."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.io import load_marker_positions, make_orbit_sequence
    from pf_monocular_pose_estimator_tpu_torch.io.markers import load_camera_calibration
    from pf_monocular_pose_estimator_tpu_torch.ops import detect_kernel as dk
    from pf_monocular_pose_estimator_tpu_torch.pf import refine_kernel as rk
    from pf_monocular_pose_estimator_tpu_torch.pf import step_kernel as sk
    from pf_monocular_pose_estimator_tpu_torch.pf import weight_kernel as wk
    from pf_monocular_pose_estimator_tpu_torch.tracker import (TargetState, create_states,
                                                               make_multi_tracker, make_tracker)
    from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
    from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

    t_phase = time.perf_counter()
    sys.path.insert(0, str(ROOT / "tests"))
    threads = torch.get_num_threads()  # a test module sets its own
    import test_torch_kernels_cuda as grid
    from test_torch_parallel_multi import CONFIG as TWIN_CONFIG
    from test_torch_parallel_multi import N as TWIN_N
    from test_torch_parallel_multi import _scene
    torch.set_num_threads(threads)
    shape_m, shape_k = grid.SHAPE_M, grid.SHAPE_K

    out = {"card": card}
    # B and E over the grid
    pairs = sorted({(m, k) for k in shape_k for m in (3, 9, 32)}
                   | {(m, k) for m in shape_m for k in (12, 64)})
    keys = (5, 6, 7, 8)
    err_pf = 0.0
    for m in shape_m:
        for k in shape_k:
            bank, prm = grid._card_params(device, *grid.shape_lanes(m, k, SHAPE_LANES))
            wprm = prm[76:].contiguous()
            err_pf = max(err_pf, exact_err(wk.weight(bank, wprm, m, k),
                                           wk.weight_plain(bank, wprm, m, k)))
            if (m, k) in pairs:
                want = sk.pf_step_plain(bank, prm, keys, m, k, want_pairs=True)
                err_pf = max(err_pf, exact_err(sk.pf_step(bank, prm, keys, m, k, want_pairs=True),
                                               want))
                err_pf = max(err_pf, exact_err(sk.pf_step(bank, prm, keys, m, k), want[:2]))
    torch.cuda.synchronize()
    print(f"[shapes] B (both variants) at {len(pairs)} (M, K) pairs and E at all "
          f"{len(shape_m) * len(shape_k)}, M in {shape_m}, K in {shape_k}, {SHAPE_LANES} lanes: "
          f"max abs err {err_pf}")
    assert err_pf == 0.0, f"[shapes] B / E differ from their plain twins by {err_pf}"
    # D at every M
    err_d = 0.0
    for m in shape_m:
        args = grid._gn_batch(m, 2 * m + 1, device)[0]
        err_d = max(err_d, exact_err(rk.gn_refine(*args, 25, 1e-4),
                                     rk.gn_refine_plain(*args, 25, 1e-4)))
    print(f"[shapes] D at M in {shape_m} (2M + 1 hypotheses, one frozen, one diverging): "
          f"max abs err {err_d}")
    assert err_d == 0.0, f"[shapes] D differs from its plain twin by {err_d}"
    # A at every sweep count and top-k, on the golden crop and a frame of many blobs
    crop, prm_c = crop_inputs(d, device)
    rng = np.random.default_rng(11)
    frames_a = {"golden crop 192x256": (crop, prm_c), "blobs 192x256": (
        grid._large_blob_image(rng, 192, 256).to(device),
        dk.make_params([0.0, 0.0, 256.0, 192.0], 240.0, 8.0, 160.0, 0.6, device))}
    sweep_grid, topk_grid = grid.SHAPE_SWEEPS + (32,), grid.SHAPE_TOPK + (1, 128)
    err_a = 0.0
    for name, (img, prm) in frames_a.items():
        for sweeps in sweep_grid:
            for topk in topk_grid:
                got = dk.detect_stats(img, prm, 5, True, sweeps, topk)
                want = dk.detect_stats_plain(img, prm, 5, True, sweeps, topk)
                err_a = max(err_a, exact_err((got[0], got[1], got[2]),
                                             (want[0], want[1], want[2])))
    print(f"[shapes] A at sweeps {sweep_grid} x top-k {topk_grid} on {list(frames_a)}: "
          f"max abs err {err_a}")
    assert err_a == 0.0, f"[shapes] A differs from its plain twin by {err_a}"
    out["max_abs_err"] = dict(pf=err_pf, gn=err_d, detect=err_a)

    out["wide"] = wide_timings(device, card)

    # the CPU twin's two-target scene at its configuration, card against CPU
    cam_s, markers_s, masks_s, frames_s = _scene(TWIN_FRAMES)

    def twin(dev):
        step = make_multi_tracker(cam_s, markers_s, masks_s, TrackerConfig(**TWIN_CONFIG),
                                  device=dev)
        states = create_states(2, TWIN_N, 0, (160, 96), device=dev)
        flags = []
        for i, frame in enumerate(frames_s):
            states, res = step(states, frame.to(dev), 0.02 * (i + 1))
            flags.append(res.fail_flag.cpu().numpy())
        return SimpleNamespace(flags=np.stack(flags))

    card_twin = counted("shapes-twin", twin, device)
    cpu_twin = twin("cpu")
    differ = np.argwhere(card_twin.flags != cpu_twin.flags).tolist()
    print(f"[shapes] two-target scene, max_detections={TWIN_CONFIG['max_detections']}, "
          f"{TWIN_FRAMES} frames: card flags {card_twin.flags.tolist()}, CPU equal: {not differ}")
    assert not differ, f"[shapes] two-target flags differ at (frame, target) {differ}"
    assert card_twin.launches["pf_step"] > 0, "[shapes] two-target scene never launched B"

    # ten markers as one object
    markers10 = torch.as_tensor(load_marker_positions(str(TEN_MARKERS))[0])
    assert markers10.shape == (10, 4)
    cam10 = load_camera_calibration(TWO_UAV_EXPERIMENT["camera"], device="cpu")
    seq = make_orbit_sequence(cam10, markers10, num_frames=TEN_FRAMES, device="cpu")
    n10 = 4000
    config10 = TrackerConfig(**dict(MAIN, n_particles=n10))

    def ten(dev):
        step = make_tracker(cam10, markers10, torch.ones(10, dtype=torch.bool), config10,
                            device=dev)
        fresh = TargetState.create(n10, prng_key(0), device=dev)
        _, res0 = step(fresh, seq.frames[0].to(dev), float(seq.times[0]))
        p0 = seq.poses[0].to(dev)
        state = fresh.replace(
            current_pose=p0.clone(), previous_pose=p0.clone(), predicted_pose=p0.clone(),
            bank=p0.reshape(16, 1).repeat(1, n10), resampled=p0.reshape(16, 1).repeat(1, n10),
            it_since_initialized=torch.tensor(2, dtype=torch.int32, device=dev),
            time_current=seq.times[0].to(dev), time_previous=seq.times[0].to(dev) - 0.02)
        flags, errs = [int(res0.fail_flag)], []
        for i in range(1, TEN_FRAMES):
            state, res = step(state, seq.frames[i].to(dev), float(seq.times[i]))
            flags.append(int(res.fail_flag))
            errs.append(float(torch.linalg.norm(res.pose[:3, 3].cpu() - seq.poses[i][:3, 3])))
        return SimpleNamespace(flags=flags, errs=errs)

    card_ten = counted("shapes-ten", ten, device)
    cpu_ten = ten("cpu")
    print(f"[shapes] ten markers as one object, {TEN_FRAMES} frames at {n10} particles: card "
          f"flags {card_ten.flags}, CPU {cpu_ten.flags}; card translation errors (mm) "
          f"{[round(e * 1e3, 3) for e in card_ten.errs]}")
    assert card_ten.flags == cpu_ten.flags, "[shapes] ten-marker flags differ from the CPU's"
    for name in ("pf_step", "refine_frame", "detect_stats"):
        assert card_ten.launches[name] > 0, f"[shapes] ten markers never launched {name}"
    out.update(twin=dict(flags=card_twin.flags.tolist(), launches=card_twin.launches),
               ten_markers=dict(flags=card_ten.flags, errors_m=card_ten.errs,
                                launches=card_ten.launches))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[shapes] the phase took {out['seconds']:.1f} s")
    return out


def launch_spans_us(fn, reps: int = 10, attempts: int = 3):
    """Device µs of each launch one call of `fn` makes, in launch order,
    averaged over `reps` calls under torch.profiler -> [(kernel, µs), ...];
    a trace that lists no device span is taken again, up to `attempts`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, kernel_name(e.name)[:40],
                        e.time_range.end - e.time_range.start) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans and len(spans) % reps == 0:
            per = len(spans) // reps
            return [(spans[i][1], round(sum(spans[r * per + i][2] for r in range(reps)) / reps, 3))
                    for i in range(per)]
    return "not measured (the profiler saw no device time)"


def wide_timings(device, card) -> dict:
    """The wide shape (WIDE: B and E at M = 16, K = 64 on N_PARTICLES lanes
    of tests/test_torch_kernels_cuda.py's `shape_lanes`, and with every slot
    a real detection; D at M = 16; A at 20 sweeps and top-100 on its
    192x256 frame of many blobs) on the card alone and by events, beside
    its bound, with the device time of each of A's launches."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.ops import detect_kernel as dk
    from pf_monocular_pose_estimator_tpu_torch.pf import refine_kernel as rk
    from pf_monocular_pose_estimator_tpu_torch.pf import step_kernel as sk
    from pf_monocular_pose_estimator_tpu_torch.pf import weight_kernel as wk

    sys.path.insert(0, str(ROOT / "tests"))
    threads = torch.get_num_threads()  # a test module sets its own
    import test_torch_kernels_cuda as grid
    torch.set_num_threads(threads)
    m, k, n = WIDE["m"], WIDE["k"], N_PARTICLES
    keys = (5, 6, 7, 8)
    lanes = {}
    for dets in ("shape_lanes", "every slot real"):
        bank, a, gt = grid.shape_lanes(m, k, n)
        if dets != "shape_lanes":
            a["det_mask"][:] = True
        lanes[dets] = grid._card_params(device, bank, a, gt)
    args_d = grid._gn_batch(m, 2 * m + 1, device)[0]
    blobs = grid._large_blob_image(np.random.default_rng(11), 192, 256).to(device)
    prm_a = dk.make_params([0.0, 0.0, 256.0, 192.0], 240.0, 8.0, 160.0, 0.6, device)
    sw, tk = WIDE["sweeps"], WIDE["topk"]
    px = blobs.numel()
    rows = {}
    for dets, (bank, prm) in lanes.items():
        wprm = prm[76:].contiguous()
        out_bank = sk.pf_step(bank, prm, keys, m, k)[0]
        tag = "" if dets == "shape_lanes" else ", every slot real"
        rows[f"pf_step{tag}"] = (
            f"M={m}, K={k}, N={n}{tag}", lambda b=bank, p=prm: sk.pf_step(b, p, keys, m, k),
            n * (64 + 64 + 4), n * PROPAGATE_OPS + weight_ops_needed(out_bank[:12], wprm, m, k),
            n * (PROPAGATE_OPS + weight_ops(m, k)))
        rows[f"pf_weight{tag}"] = (
            f"M={m}, K={k}, N={n}{tag}", lambda b=bank, w=wprm: wk.weight(b, w, m, k),
            n * (48 + 4 + 8 * m + 4), weight_ops_needed(bank[:12], wprm, m, k),
            n * weight_ops(m, k))
    rows["gn_refine"] = (f"M={m}, {2 * m + 1} hypotheses", lambda: rk.gn_refine(*args_d, 25, 1e-4),
                         4 * sum(a.numel() for a in args_d) + 4 * (2 * m + 1) * 60, 0, None)
    rows["detect_stats"] = (f"192x256 of many blobs, {sw} sweeps, top-{tk}",
                            lambda: dk.detect_stats(blobs, prm_a, 5, True, sw, tk),
                            4 * px + 4 * px * (1 + dk.N_MAPS) + 8 * tk,
                            detect_ops(blobs, prm_a, sw), None)
    out = {"card": card}
    for name, (shape, fn, n_bytes, n_ops, all_cells_ops) in rows.items():
        b_ms, b_by = bound(n_bytes, n_ops)
        row = dict(shape=shape, device_ms=device_time_ms(fn), ms=time_ms(fn), bound_ms=b_ms,
                   bound_by=b_by)
        every = ""
        if all_cells_ops is not None:  # B and E: the bound of every cell of the volume too
            row["every_cell_bound_ms"] = bound(n_bytes, all_cells_ops)[0]
            every = f"; every cell of the volume {row['every_cell_bound_ms'] * 1e3:.2f} us"
        out[name] = row
        print(f"[shapes] {card}: {name} ({shape}): {row['device_ms'] * 1e3:.2f} us on the card "
              f"alone, {row['ms'] * 1e3:.1f} us by events, bound {b_ms * 1e3:.2f} us "
              f"({b_by}{every})")
    spans = launch_spans_us(rows["detect_stats"][1])
    out["detect_stats"]["launch_us"] = spans
    print(f"[shapes] {card}: detect_stats ({rows['detect_stats'][0]}) launches (us): {spans}")
    return out


def wide_phase(device, d, cam, markers, card, counted_replay) -> dict:
    """[wide]: the main path with WIDE_REPLAY (cc_sweeps=20,
    max_detections=32), so that kernel A runs its wide path (20 sweeps) and
    B its wide form (K = 32) on every tracked frame: the golden's bars
    (every frame updated, ATE < 10 mm, orientation < 1.5 deg), the launches
    of A, #2, B, C and D, the device time of a warm frame and the card's
    idle share (`idle_share`)."""
    run = counted_replay("wide", WIDE_REPLAY)
    for name in ("threshold_blur", "detect_stats", "pf_step", "refine_frame"):
        assert run.launches[name] > 0, f"[wide] never launched {name}"
    idle = idle_share(device, d, cam, markers, overrides=WIDE_REPLAY)
    out = dict(config=WIDE_REPLAY, updated=int(run.updated.sum()), frames=len(run.updated),
               ate_mm=run.ate * 1e3, orientation_deg=run.ori,
               launches={name: run.launches[name] for name in
                         ("detect_stats", "threshold_blur", "pf_step", "resample_gather",
                          "refine_frame")},
               idle=idle, card=card)
    print(f"[wide] {card}: {out}")
    return out


def faulted_init_on_card(device, cam, markers) -> list:
    """The port's init (`initialise`, then Gauss-Newton as the init branch
    runs it) on the card, on the reference tracker's frame-0 faulted
    detections of FAULTS_INIT_REFERENCE's seeds.  Where the reference's
    jitted and op-by-op evaluations agree, the card must give their flag
    and correspondences.  Where they split, the decision turns on rounding,
    and the card must give one of the reference's outcomes: jitted or op by
    op, on these detections or on the port's CPU detections one ulp away
    ("shifted").  The refined pose must lie within 0.05 mm and 0.1 deg
    (tests/test_torch_tracker.py's bars) of the outcome it matches."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.ops.blob import Detections
    from pf_monocular_pose_estimator_tpu_torch.pf.refine import gauss_newton_refine
    from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState
    from pf_monocular_pose_estimator_tpu_torch.tracker.initialise import initialise
    from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
    from pf_monocular_pose_estimator_tpu_torch.utils.dynamic import DynamicParams
    from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

    ref = np.load(FAULTS_INIT_REFERENCE)
    config = TrackerConfig(**MAIN, **FAULTS)
    dyn = DynamicParams.from_config(config, device)
    cam = cam.to(device)
    markers_h = torch.as_tensor(markers, dtype=torch.float32).to(device)
    m = markers_h.shape[0]
    marker_mask = torch.ones(m, dtype=torch.bool, device=device)
    prefer = torch.cat([torch.zeros(4), torch.eye(3).reshape(9)]).to(device)
    rows = []
    for i, seed in enumerate(ref["seed"].tolist()):
        xy = torch.from_numpy(ref["xy"][i]).to(device)
        mask = torch.from_numpy(ref["mask"][i]).to(device)
        zeros = torch.zeros_like(mask)
        det = Detections(xy, xy, mask, torch.zeros(mask.shape, device=device), zeros, zeros)
        bank = TargetState.create(N_PARTICLES, prng_key(seed), device=device).bank
        got = initialise(cam, det, markers_h, marker_mask, bank, config, dyn, prefer_near=prefer)
        corr = torch.stack([torch.arange(m, dtype=torch.int32, device=device),
                            got.det_for_marker], -1)
        pose = gauss_newton_refine(cam, got.pose, markers_h, xy, corr,
                                   (got.det_for_marker >= 0) & marker_mask,
                                   config.gn_max_iterations, config.gn_convergence_tol).pose
        flag, dfm, pose = int(got.flag), got.det_for_marker.cpu().numpy(), pose.cpu().numpy()
        evals = {ev: (int(ref[f"{ev}_flag"][i]), ref[f"{ev}_dfm"][i], ref[f"{ev}_pose"][i])
                 for ev in ("jit", "eager", "jit_shifted", "eager_shifted")}
        agreed = evals["jit"][0] == evals["eager"][0] and np.array_equal(evals["jit"][1],
                                                                        evals["eager"][1])
        matches = [ev for ev, (f, want, _) in evals.items()
                   if f == flag and np.array_equal(dfm, want)
                   and (ev in ("jit", "eager") or not agreed)]
        row = dict(seed=seed, flag=flag, dfm=dfm.tolist(), reference_agrees=agreed,
                   matches=matches, reference={ev: e[1].tolist() for ev, e in evals.items()})
        if matches and flag == 0:
            want = evals[matches[0]][2]
            cos = np.clip((np.trace(pose[:3, :3] @ want[:3, :3].T) - 1) / 2, -1, 1)
            row.update(gap_mm=float(np.linalg.norm(pose[:3, 3] - want[:3, 3])) * 1e3,
                       gap_deg=float(np.degrees(np.arccos(cos))))
        print(f"[faults] init on the reference's detections: {row}")
        assert matches, f"faults init, seed {seed}: {row}"
        assert flag != 0 or (row["gap_mm"] < 0.05 and row["gap_deg"] < 0.1), row
        rows.append(row)
    return rows


def observer_poses(d, device):
    """`observer(i) -> (obs_pose, obs_time)` for the golden sequence: with
    frame i the observer pose of frame i - 1 arrives (one frame late, so the
    tracker extrapolates the observer's motion), built so that the object
    stands still in the world: cam_world = gt_0 @ inv(gt_{i-1}), given
    through the mounting rotation as obs_pose = cam_world @ inv(_ROT_CAM)."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.tracker.step import _ROT_CAM

    gt = d["poses"].astype(np.float64)
    rot_inv = np.linalg.inv(np.asarray(_ROT_CAM))
    poses = [torch.from_numpy((gt[0] @ np.linalg.inv(gt[max(i - 1, 0)]) @ rot_inv)
                              .astype(np.float32)).to(device) for i in range(len(gt))]
    return lambda i: (poses[i], float(d["times"][max(i - 1, 0)]))


def exposure_on_host(run, base: float):
    """The exposure state machine recomputed on the host from each frame's
    blob area sum, ROI and detection count (float32, as the tracker does) ->
    (counter_increase, counter_decrease, exposure_us) after every frame."""
    f32 = np.float32
    inc = dec = 0
    exposure = f32(base)
    out = []
    for area, roi, count in zip(run.blob_area_sum, run.roi, run.num_detections):
        frac = f32(area) / max(f32(roi[2]) * f32(roi[3]), f32(1.0))
        inc += int(count > 0 and frac < f32(0.013))
        dec += int(count > 0 and frac > f32(0.037))
        if inc > 500 or dec > 500:
            exposure = f32(exposure + (0.2 * base if inc > 500 else -0.2 * base))
            inc = dec = 0
        out.append((inc, dec, float(exposure)))
    return out


def ported_options(device, d, cam, markers, card, main_run, counted_replay, warm_replay,
                   summary) -> dict:
    """Phases 10-14: the options ported last, each driven through
    `make_tracker` with its launch counts set to 0 just before and read just
    after, then replayed warm; returns their summaries.

    [ego] observer poses one frame late; [faults] one occlusion and two false
    detections, three seeds held to tests/test_robustness.py's bars against
    phase 4's ATE; [exposure] the exposure counters against a host recomputation;
    [ipe] the track branch without a particle filter; [realistic] the
    realistic golden with configs/experiments/realistic_golden.yaml's
    settings and bars."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.io.markers import load_camera_calibration
    from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig

    out = {}
    pf_kernels = ("detect_stats", "pf_step", "refine_frame")

    def launched(tag, run, names):
        missing = [n for n in names if run.launches[n] == 0]
        assert not missing, f"{tag}: never launched {missing}"

    # 10. ego-motion: the first path whose kernel B gets a left matrix that moves
    observer = observer_poses(d, device)
    ego = counted_replay("ego", EGO, observer=observer)
    launched("ego", ego, pf_kernels)
    change = float((ego.state.change_cam_pose - torch.eye(4, device=device)).abs().max())
    print(f"[ego] change_cam_pose at the end differs from the identity by {change}")
    assert change > 1e-3, "ego: the observer never moved"
    out["ego"] = dict(summary(ego, warm_replay("ego", EGO, observer=observer)),
                      change_cam_pose_from_identity=change)

    # 11. faults: first the init on the reference's own faulted detections
    # (faulted_init_on_card), then tests/test_robustness.py's bars over its
    # three seeds (tracked fraction averaged, the median of the per-seed
    # median translation errors against phase 4's clean ATE, the median
    # orientation over every tracked frame).  Its per-seed orientation bars
    # (mean <= 11, worst <= 17 deg) are reported, not asserted: whether a
    # seed's frame-0 init locks onto the injected clones turns on float32
    # rounding of the detections (one ulp flips the reference's own init;
    # tests/fault_episodes.py), so which seed draws a long episode is not
    # the port's to choose.
    init_rows = faulted_init_on_card(device, cam, markers)
    per_seed, errs, angs = [], [], []
    for seed in FAULT_SEEDS:
        run = counted_replay(f"faults seed {seed}", FAULTS, bars=False, all_updated=False,
                             seed=seed)
        launched("faults", run, pf_kernels)
        upd = run.updated
        err = np.linalg.norm(run.poses[upd][:, :3, 3] - d["poses"][upd][:, :3, 3], axis=-1)
        rel = np.einsum("tij,tkj->tik", run.poses[upd][:, :3, :3], d["poses"][upd][:, :3, :3])
        ang = np.degrees(np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)))
        errs.append(err)
        angs.append(ang)
        per_seed.append(dict(seed=seed, tracked=float(upd.mean()),
                             median_translation_mm=float(np.median(err)) * 1e3,
                             ate_mm=run.ate * 1e3, orientation_deg=run.ori,
                             injected=int(run.injected.sum()), occluded=int(run.occluded.sum()),
                             flags=sorted(set(run.flags.tolist()))))
        print(f"[faults] {per_seed[-1]}")
        if seed == FAULT_SEEDS[0]:
            faults = run
    stats = dict(tracked=float(np.mean([p["tracked"] for p in per_seed])),
                 median_of_medians_mm=float(np.median([np.median(e) for e in errs])) * 1e3,
                 clean_ate_mm=main_run.ate * 1e3,
                 pooled_median_orientation_deg=float(np.median(np.concatenate(angs))),
                 mean_seed_orientation_deg=float(np.mean([p["orientation_deg"] for p in per_seed])),
                 worst_seed_orientation_deg=float(max(p["orientation_deg"] for p in per_seed)),
                 injected=sum(p["injected"] for p in per_seed),
                 occluded=sum(p["occluded"] for p in per_seed))
    print(f"[faults] over seeds {list(FAULT_SEEDS)}: {stats} (bars: tracked >= 0.9, median of "
          f"medians <= {2 * main_run.ate * 1e3:.3f} mm, pooled median orientation <= 3 deg)")
    assert stats["tracked"] >= 0.9, f"faults: tracked {stats['tracked']}"
    assert stats["median_of_medians_mm"] <= 2 * main_run.ate * 1e3, f"faults: {stats}"
    assert stats["pooled_median_orientation_deg"] <= 3.0, f"faults: orientation {stats}"
    assert stats["injected"] > 0 and stats["occluded"] > 0, "faults: nothing injected"
    out["faults"] = dict(summary(faults, warm_replay("faults", FAULTS, all_updated=False)),
                         **stats, per_seed=per_seed, init_on_reference_detections=init_rows)

    # 12. exposure control: the counters after every frame against the host
    exposure = counted_replay("exposure", EXPOSURE, SHORT_FRAMES)
    launched("exposure", exposure, pf_kernels)
    want = exposure_on_host(exposure, TrackerConfig().expose_time_base)
    got = [(int(a), int(b), float(e)) for (a, b), e in zip(exposure.exposure_counters,
                                                          exposure.exposure_us)]
    print(f"[exposure] counters (increase, decrease, exposure us) after each frame: {got}")
    assert got == want, f"exposure: the tracker's {got} against the host's {want}"
    out["exposure"] = dict(summary(exposure, warm_replay("exposure", EXPOSURE, SHORT_FRAMES)),
                           counters=got[-1])

    # 13. IPE: no particle filter, so no kernel B and no batched GN; every
    # frame's one-pose refine (the init's too) is one launch of refine_pose
    ipe = counted_replay("ipe", IPE, n_particles=IPE_PARTICLES)
    launched("ipe", ipe, ("threshold_blur", "detect_stats", "refine_pose"))
    assert ipe.launches["pf_step"] == ipe.launches["refine_frame"] == 0
    assert ipe.launches["gn_refine"] == 0
    assert ipe.launches["refine_pose"] == int(ipe.updated.sum()), ipe.launches
    reinit = np.flatnonzero(ipe.flags[1:] == 0).tolist()
    assert not reinit, f"ipe: re-initialised on frames {[f + 1 for f in reinit]}"
    idle = idle_share(device, d, cam, markers, overrides=IPE, n_particles=IPE_PARTICLES)
    print(f"[idle] {card}: ipe, 20 warm frames: {idle}")
    out["ipe"] = dict(summary(ipe, warm_replay("ipe", IPE, n_particles=IPE_PARTICLES)),
                      n_particles=IPE_PARTICLES, idle=idle)

    # 14. the realistic golden: clutter, distractors, blur, flicker (uint8)
    r = np.load(REALISTIC_GOLDEN)
    r_cam = load_camera_calibration(REALISTIC_EXPERIMENT["camera"], device)
    r_markers = torch.from_numpy(np.concatenate([r["markers"], np.ones((5, 1), np.float32)],
                                                1)).to(device)
    golden = (r, r_cam, r_markers)
    n_real = REALISTIC["n_particles"]
    real = counted_replay("realistic", base=REALISTIC, n_particles=n_real, golden=golden,
                          bars=False, all_updated=False)
    launched("realistic", real, ("threshold_blur",) + pf_kernels)
    tracked = float(real.updated.mean())
    print(f"[realistic] tracked {tracked}, ATE {real.ate * 1e3:.3f} mm, orientation "
          f"{real.ori:.3f} deg (bars: >= 0.95, <= 17 mm, <= 5.62 deg)")
    assert tracked >= 0.95, f"realistic: tracked {tracked}"
    assert real.ate <= 0.017, f"realistic: ATE {real.ate * 1e3:.2f} mm"
    assert real.ori <= 5.62, f"realistic: orientation error {real.ori:.2f} deg"
    out["realistic"] = dict(summary(real, warm_replay("realistic", base=REALISTIC,
                                                      n_particles=n_real, golden=golden,
                                                      all_updated=False)),
                            tracked=tracked, frames=int(real.poses.shape[0]))
    for name, v in out.items():
        print(f"[{name}] {card}: {v}")
    return out, real


def multi_replay(device, d, cam, markers_t, masks_t, n_particles: int, sequential: bool = True,
                 mesh=None, frames=None, state=None, overrides=None, **sharded):
    """One two-target replay of frames `frames` (a range; all of `d`'s unless
    given) with configs/experiments/two_uav_bag.yaml's settings at
    `n_particles` a target, plus `overrides`: `make_multi_tracker`, or with `mesh`
    `make_sharded_multi_tracker` (`sharded` passed on).  Starts from `state`
    (the states of `create_states(2, n, 0)` unless given).  Returns per frame
    and target the poses, updated and fail flags, cumulative clipped draws,
    the seconds, the step and the last state."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.parallel import (make_sharded_multi_tracker,
                                                                shard_target_state)
    from pf_monocular_pose_estimator_tpu_torch.tracker import create_states, make_multi_tracker
    from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig

    config = TrackerConfig(**dict(TWO_UAV, n_particles=n_particles), **(overrides or {}))
    frames = range(len(d["frames"])) if frames is None else frames
    if state is None:
        state = create_states(2, n_particles, 0, (cam.width, cam.height), device=device)
        if mesh is not None:
            state = shard_target_state(state, mesh, batched=True)
    if mesh is None:
        step = make_multi_tracker(cam, markers_t, masks_t, config, sequential=sequential,
                                  device=device)
    else:
        step = make_sharded_multi_tracker(cam, markers_t, masks_t, config, mesh, device=device,
                                          **sharded)
    images = torch.from_numpy(d["frames"][frames.start:frames.stop]).to(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = []
    for j, i in enumerate(frames):
        state, res = step(state, images[j], float(d["times"][i]))
        results.append(res)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stack = lambda name: torch.stack([getattr(r, name) for r in results]).cpu().numpy()
    n = len(frames)
    return SimpleNamespace(poses=stack("pose"), updated=stack("pose_updated"),
                           flags=stack("fail_flag"), clipped=stack("resample_clipped"),
                           seconds=seconds, step=step, state=state, n_particles=n_particles,
                           syncs_per_frame=step.host.count / step.frames,
                           frames_per_second=n / seconds, frames=frames)


def multi_bars(tag, run, gt, min_tracked: float, max_ate: float | None = None,
               max_median: float | None = None) -> list:
    """Per target: tracked fraction, ATE / median translation error and
    orientation error over the updated frames, against the given bars."""
    rows = []
    for k in range(run.poses.shape[1]):
        upd = run.updated[:, k]
        est, want = run.poses[upd, k], gt[run.frames.start:run.frames.stop][upd, k]
        ate, ori = accuracy(est, want)
        err = np.linalg.norm(est[:, :3, 3] - want[:, :3, 3], axis=-1)
        rows.append(dict(target=k, tracked=float(upd.mean()), ate_mm=ate * 1e3,
                         median_mm=float(np.median(err)) * 1e3, orientation_deg=ori))
    print(f"[{tag}] {run.n_particles} particles a target: {rows}; flags "
          f"{sorted(set(run.flags.ravel().tolist()))}; {run.syncs_per_frame:.2f} syncs a frame")
    for r in rows:
        assert r["tracked"] >= min_tracked, f"{tag}: target {r['target']} tracked {r['tracked']}"
        assert max_ate is None or r["ate_mm"] <= max_ate * 1e3, f"{tag}: {r}"
        assert max_median is None or r["median_mm"] <= max_median * 1e3, f"{tag}: {r}"
    return rows


def checkpoint_resume(device, tag, run_to, resume, like):
    """Save the state of `run_to()` (after the checkpoint frame), run on from
    it uninterrupted (`resume(state)`), then load the file into `like` (a
    fresh state on the card) and run the same frames again: every pose and
    every leaf of the final state must be equal bit for bit."""
    import dataclasses
    import tempfile

    import torch
    from pf_monocular_pose_estimator_tpu_torch.utils import load_state, save_state

    state = run_to()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/state.npz"
        save_state(path, state)
        loaded = load_state(path, like)
    for f in dataclasses.fields(state):
        assert torch.equal(getattr(loaded, f.name), getattr(state, f.name)), f"{tag}: {f.name}"
    straight, poses_a = resume(state)
    again, poses_b = resume(loaded)
    assert np.array_equal(poses_a, poses_b), f"{tag}: resumed poses differ"
    differ = [f.name for f in dataclasses.fields(state)
              if not torch.equal(getattr(straight, f.name), getattr(again, f.name))]
    assert not differ, f"{tag}: resumed state differs in {differ}"
    print(f"[checkpoint] {tag}: {poses_a.shape[0]} resumed frames equal the uninterrupted "
          f"replay bit for bit (poses and all {len(dataclasses.fields(state))} leaves)")
    return poses_a.shape[0]


def epilogue_per_crop(tag, run):
    """Every crop-path detection of a counted replay launched the epilogue
    once after kernel A (the full frame launches neither)."""
    n_a, n_e = run.launches["detect_stats"], run.launches["detect_epilogue"]
    assert n_e == n_a > 0, f"{tag}: {n_e} epilogue launches for {n_a} of kernel A"
    print(f"[{tag}] detect_epilogue: {n_e} launches, one a crop-path detection")


def multi_target_phases(device, card, counted, main_args) -> dict:
    """Phases 15-18: the two-UAV golden through the multi-tracker (4,000 and
    100,000 particles a target, both forms), the targets x particles tracker
    on a local mesh and over a one-rank `nccl` sub-group, checkpoints, the
    renderer on the card and `run_multihost`.  `counted(tag, fn, *args,
    **kwargs)` runs fn with every launch count set to 0 just before and
    attaches the counts read just after."""
    import tempfile

    import torch
    import torch.distributed as dist
    from pf_monocular_pose_estimator_tpu_torch.io import (demo_markers, load_camera_calibration,
                                                          make_two_target_sequence,
                                                          second_markers)
    from pf_monocular_pose_estimator_tpu_torch.parallel import distributed, make_mesh
    from pf_monocular_pose_estimator_tpu_torch.tracker import (TargetState, create_states,
                                                               make_tracker, pad_marker_sets)
    from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
    from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

    out = {}
    d = np.load(TWO_UAV_GOLDEN)
    cam = load_camera_calibration(TWO_UAV_EXPERIMENT["camera"], device)
    markers_t, masks_t = pad_marker_sets([demo_markers(device), second_markers(device)])
    gt = d["poses"]
    pf_kernels = ("threshold_blur", "detect_stats", "pf_step", "refine_frame")

    def launched(tag, run, names):
        missing = [n for n in names if run.launches[n] == 0]
        assert not missing, f"{tag}: never launched {missing}"

    def summary(cold, warm, rows):
        return {"frames_per_second": warm.frames_per_second,
                "syncs_per_frame": warm.syncs_per_frame, "targets": rows,
                "launches": cold.launches}

    # 15. multi: the experiment's 4,000 particles, then the main path's 100,000
    small = counted("multi-4k", multi_replay, device, d, cam, markers_t, masks_t,
                    TWO_UAV["n_particles"])
    launched("multi-4k", small, pf_kernels)
    rows_small = multi_bars("multi-4k", small, gt, 0.95, max_ate=0.02)
    multi = counted("multi", multi_replay, device, d, cam, markers_t, masks_t, N_PARTICLES)
    launched("multi", multi, pf_kernels)
    for tag, run in (("multi-4k", small), ("multi", multi)):
        epilogue_per_crop(tag, run)
    rows = multi_bars("multi", multi, gt, 0.95, max_ate=0.02)
    warm = multi_replay(device, d, cam, markers_t, masks_t, N_PARTICLES)
    batched = counted("multi-batched", multi_replay, device, d, cam, markers_t, masks_t,
                      N_PARTICLES, sequential=False)
    assert np.array_equal(batched.flags, multi.flags), "multi: the two forms' flags differ"
    epilogue_per_crop("multi-batched", batched)
    same = bool(np.array_equal(batched.poses, multi.poses))
    for tag, run in (("sequential", warm), ("batched", batched)):
        print(f"[multi] {card}: {tag} warm replay {run.frames_per_second:.2f} frames/s at "
              f"{N_PARTICLES} particles a target ({1e3 / run.frames_per_second:.2f} ms/frame), "
              f"{run.syncs_per_frame:.2f} device->host syncs per frame")
    print(f"[multi] batched poses equal the sequential ones bit for bit: {same}")
    out["multi_4k"] = dict(summary(small, multi_replay(device, d, cam, markers_t, masks_t,
                                                       TWO_UAV["n_particles"]), rows_small),
                           n_particles=TWO_UAV["n_particles"])
    out["multi"] = dict(summary(multi, warm, rows), n_particles=N_PARTICLES,
                        batched_frames_per_second=batched.frames_per_second,
                        batched_syncs_per_frame=batched.syncs_per_frame,
                        batched_poses_equal=same)

    # 16. multi-sharded: 2 targets over a (2 targets x 4 particles) local mesh,
    # every block reaching every shard
    mesh = make_mesh(MESH_SHARDS, target_shards=2)
    ring = dict(resample_reach=MESH_SHARDS - 1, payload_window=None)
    sharded = counted("multi-sharded", multi_replay, device, d, cam, markers_t, masks_t,
                      N_PARTICLES, mesh=mesh, **ring)
    launched("multi-sharded", sharded, ("threshold_blur", "detect_stats", "pf_step",
                                        "ring_gather", "refine_frame"))
    rows_sh = multi_bars("multi-sharded", sharded, gt, 0.9, max_median=0.02)
    differ = np.argwhere(sharded.flags != multi.flags).tolist()
    assert not differ, f"multi-sharded: flags differ from phase 15's at (frame, target) {differ}"
    assert int(sharded.clipped[-1].max()) == 0, f"multi-sharded: clipped {sharded.clipped[-1]}"
    got = sharded.launches
    assert got["pf_step"] % MESH_SHARDS == 0 and got["resample_gather"] == 0
    assert got["ring_gather"] == multi.launches["resample_gather"], \
        f"multi-sharded: {got['ring_gather']} launches of H, not one a resampling " \
        f"({multi.launches['resample_gather']})"
    sharded_warm = multi_replay(device, d, cam, markers_t, masks_t, N_PARTICLES, mesh=mesh,
                                **ring)
    print(f"[multi-sharded] {card}: warm replay {sharded_warm.frames_per_second:.2f} frames/s, "
          f"{sharded_warm.syncs_per_frame:.2f} syncs per frame")
    out["multi_sharded"] = dict(summary(sharded, sharded_warm, rows_sh), shards=MESH_SHARDS,
                                target_shards=2, clipped=sharded.clipped[-1].tolist())

    # ... then 6 frames over a one-rank nccl job through make_pod_mesh's sub-group
    # (resampling on every tracked frame, as phase 9)
    every = dict(frames=range(6), overrides=dict(resample_min_ess=0.0))
    local = multi_replay(device, d, cam, markers_t, masks_t, N_PARTICLES,
                         mesh=make_mesh(1, target_shards=1), **every)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1,
                                rank=0)
        try:
            pod = distributed.make_pod_mesh(target_devices=1)
            assert pod.group is not None and pod.size == 1 and pod.target_shards == 1
            group = multi_replay(device, d, cam, markers_t, masks_t, N_PARTICLES, mesh=pod,
                                 **every)
        finally:
            dist.destroy_process_group()
    assert np.array_equal(group.flags, local.flags) and np.array_equal(group.poses, local.poses)
    assert torch.equal(group.state.bank, local.state.bank), "one-rank nccl group: banks differ"
    print(f"[multi-group] one rank over nccl: 6 frames, 2 targets at {N_PARTICLES} particles "
          f"equal the local mesh of one shard bit for bit (poses, flags, banks); the results "
          f"gather counted: {group.syncs_per_frame:.2f} syncs per frame against "
          f"{local.syncs_per_frame:.2f}")

    # 17. checkpoints: the main path saved after frame 30 and resumed over
    # frames 31-40; a two-target state saved after frame 10, resumed over 11-20
    g, g_cam, g_markers = main_args
    config = TrackerConfig(**MAIN)
    ones = torch.ones(g_markers.shape[0], dtype=torch.bool)

    def main_to(n):
        step = make_tracker(g_cam, g_markers, ones, config, device=device)
        state = TargetState.create(N_PARTICLES, prng_key(0), device=device)
        for i in range(n):
            state, _ = step(state, torch.from_numpy(g["frames"][i]).to(device),
                            float(g["times"][i]))
        return state

    def main_from(state):
        step = make_tracker(g_cam, g_markers, ones, config, device=device)
        poses = []
        for i in range(31, 41):
            state, res = step(state, torch.from_numpy(g["frames"][i]).to(device),
                              float(g["times"][i]))
            poses.append(res.pose)
        return state, torch.stack(poses).cpu().numpy()

    n_main = checkpoint_resume(device, "main path, frame 30", lambda: main_to(31), main_from,
                               TargetState.create(N_PARTICLES, device=device))

    def multi_from(state):
        run = multi_replay(device, d, cam, markers_t, masks_t, N_PARTICLES, frames=range(11, 21),
                           state=state)
        return run.state, run.poses

    n_multi = checkpoint_resume(
        device, "two targets, frame 10",
        lambda: multi_replay(device, d, cam, markers_t, masks_t, N_PARTICLES,
                             frames=range(11)).state,
        multi_from, create_states(2, N_PARTICLES, 5, device=device))
    out["checkpoint"] = dict(main_frames_resumed=n_main, multi_frames_resumed=n_multi)

    # 18. the renderer on the card: the two-UAV golden again, then run_multihost
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = make_two_target_sequence(cam, demo_markers(device), second_markers(device),
                                   num_frames=60, fps=50.0, seed=2, device=device)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    pose_diff = np.abs(seq.poses.cpu().numpy() - gt)
    levels = np.abs(seq.frames.to(torch.uint8).cpu().numpy().astype(np.int16)
                    - d["frames"].astype(np.int16))
    render = dict(pose_max_abs_diff=float(pose_diff.max()),
                  pose_elements_differing=int((pose_diff > 0).sum()),
                  max_level_diff=int(levels.max()), pixels_differing=int((levels > 0).sum()),
                  pixels=int(levels.size), ms_per_frame=render_s * 1e3 / 60)
    print(f"[synthetic] {card}: two_uav_sequence.npz regenerated on the card: {render}")
    assert render["pose_max_abs_diff"] <= 1.2e-7, f"synthetic: poses {render}"
    assert render["max_level_diff"] <= 1, f"synthetic: frames {render}"
    mh = counted("multihost", lambda: SimpleNamespace(
        line=distributed.run_multihost(["--frames", str(SHORT_FRAMES)])))
    launched("multihost", mh, ("threshold_blur", "detect_stats", "pf_step", "refine_frame"))
    print(f"[multihost] {card}: {mh.line}")
    assert mh.line["tracked"] == mh.line["frames"] == SHORT_FRAMES, f"multihost: {mh.line}"
    out["synthetic"] = render
    out["multihost"] = dict(mh.line, launches=mh.launches)
    for name in ("multi_4k", "multi", "multi_sharded", "checkpoint"):
        print(f"[{name}] {card}: {out[name]}")
    return out, small


def run_cli(argv) -> SimpleNamespace:
    """The port's `io/cli.py::main(argv + ["--json"])` in this process, its
    stdout captured: the summary (its last line) and the seconds."""
    import contextlib
    import io

    from pf_monocular_pose_estimator_tpu_torch.io import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main([*map(str, argv), "--json"])
    seconds = time.perf_counter() - t0
    assert rc == 0, f"cli {argv}: exit code {rc}"
    return SimpleNamespace(summary=json.loads(out.getvalue().strip().splitlines()[-1]),
                           seconds=seconds)


def pipe_replay(device, d, cam, markers) -> SimpleNamespace:
    """The golden frames pushed at 50 fps by `FramePipe.start_replay`'s native
    thread into a new main-path tracker, which takes each frame through
    `pop_latest` (stale ones are discarded); every popped frame must equal
    the golden frame of its sequence number."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.io.framepipe import FramePipe
    from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
    from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
    from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

    golden = d["frames"]
    step = make_tracker(cam, markers, torch.ones(markers.shape[0], dtype=torch.bool),
                        TrackerConfig(**MAIN), device=device)
    state = TargetState.create(N_PARTICLES, prng_key(0), device=device)
    pipe = FramePipe(golden.shape[2], golden.shape[1], capacity=8)
    stepped, tracked, skipped = 0, 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.start_replay(golden, fps=50.0)
    while (got := pipe.pop_latest(timeout_ms=2000)) is not None:
        frame, ts, seq, skip = got
        assert np.array_equal(frame, golden[seq]), f"pipe: frame {seq} differs from the golden"
        state, res = step(state, torch.from_numpy(frame).to(device), ts)
        stepped, skipped = stepped + 1, skipped + skip
        tracked += bool(res.pose_updated)
        if seq == len(golden) - 1:
            break
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    pipe.stop_replay()
    stats = pipe.stats
    pipe.close()
    return SimpleNamespace(**stats, stepped=stepped, tracked=tracked, skipped=skipped,
                           seconds=seconds, frames_per_second=stepped / seconds)


def cli_phase(device, card, counted, main_args, main_run, real_run, multi_4k_run) -> dict:
    """Phase 19: the port's run_tracker CLI (`io/cli.py`), in this process
    with its launches counted, over the main path (phase 4's configuration:
    the golden's camera and markers are the CLI's defaults), the realistic
    golden (flags equal to phase 14's; recorded to a .pfsq and replayed
    from it through the native reader with the same flags), the two-UAV
    golden (flags equal to phase 15's at 4,000 particles) and every other
    committed experiment at its own settings; then the frame pipe at 50 fps
    into the main-path tracker, and one `python -m` run of the CLI with
    `--profile`, whose trace must hold device events of kernel A."""
    import tempfile

    import torch
    from pf_monocular_pose_estimator_tpu_torch.io import default_camera, demo_markers
    from pf_monocular_pose_estimator_tpu_torch.io.seqio import SequenceReader

    t_phase = time.perf_counter()
    d, cam, markers = main_args
    out = {}

    # the CLI's default device is the card; another is passed on
    dev = [] if device == "cuda" else ["--device", device]

    def cli(tag, argv):
        run = counted(f"cli {tag}", run_cli, [*argv, *dev])
        s = run.summary
        row = dict(frames=s["frames"], tracked_frames=s["tracked_frames"], fps=s["fps"],
                   time_pose_est_ms_median=s["time_pose_est_ms_median"], seconds=run.seconds,
                   launches=run.launches)
        row.update({k: s[k] for k in ("ate_m", "orientation_err_deg", "ate_m_per_target",
                                      "tracked_fraction_per_target", "exposure_us") if k in s})
        print(f"[cli] {card}: {tag}: {row}")
        out[tag] = row
        return s, run.launches

    # the main path: the CLI's default camera and markers are the golden's
    want = default_camera(device)
    for name in ("fx", "fy", "cx", "cy", "dist"):
        assert torch.equal(getattr(cam, name), getattr(want, name)), f"cli: camera {name}"
    assert torch.equal(markers, demo_markers(device)), "cli: the golden's markers"
    s, launches = cli("main", ["--sequence", GOLDEN, "--particles", N_PARTICLES,
                               "--pf-retries", MAIN["pf_max_retries"]])
    assert s["flags"] == main_run.flags.tolist(), "cli main: flags differ from phase 4's"
    assert s["tracked_frames"] == s["frames"] == 60, f"cli main: {s['tracked_frames']} tracked"
    assert abs(s["ate_m"] - main_run.ate) <= 1e-6, f"cli main: ATE {s['ate_m']} vs {main_run.ate}"
    assert launches == main_run.launches, f"cli main: launches {launches} vs {main_run.launches}"

    with tempfile.TemporaryDirectory() as tmp:
        # the realistic golden through the YAML reader, recorded, then replayed
        config = ROOT / "configs" / "experiments" / "realistic_golden.yaml"
        pfsq = Path(tmp) / "realistic.pfsq"
        s, _ = cli("realistic", ["--config", config, "--record", pfsq])
        tracked = s["tracked_frames"] / s["frames"]
        assert s["flags"] == real_run.flags.tolist(), "cli realistic: flags differ from phase 14's"
        assert tracked >= 0.95 and s["ate_m"] <= 0.017 and s["orientation_err_deg"] <= 5.62, \
            f"cli realistic: {s}"
        with SequenceReader(str(pfsq)) as reader:
            assert reader.native, "cli realistic: the .pfsq reader took the numpy path"
            frames, times = reader.arrays()
        r = np.load(REALISTIC_GOLDEN)
        assert np.array_equal(frames, r["frames"]) and np.array_equal(times, r["times"])
        replay_s, _ = cli("realistic-pfsq", ["--config", config, "--sequence", pfsq])
        assert replay_s["flags"] == s["flags"], "cli realistic: the .pfsq replay's flags differ"

        # two UAVs: split markers, per-target ATE
        s, _ = cli("two_uav", ["--config", ROOT / "configs" / "experiments" / "two_uav_bag.yaml"])
        assert s["flags"] == multi_4k_run.flags.tolist(), "cli two_uav: flags differ from phase 15's"
        for frac, ate in zip(s["tracked_fraction_per_target"], s["ate_m_per_target"]):
            assert frac >= 0.95 and ate <= 0.02, f"cli two_uav: {s}"

        # every other committed experiment at its own settings
        video = Path(tmp) / "uav_target.npz"
        for name in OTHER_EXPERIMENTS:
            extra = ["--save-video", video] if name == "uav_target" else []
            s, launches = cli(name, ["--config", ROOT / "configs" / "experiments" / f"{name}.yaml",
                                     *extra])
            assert launches["detect_stats"] > 0, f"cli {name}: kernel A never launched"
            if name == "uav_target":
                # tests/test_experiment.py's bars: all frames but one tracked, ATE < 50 mm
                assert s["tracked_frames"] >= s["frames"] - 1 and s["ate_m"] < 0.05, f"cli: {s}"
                v = np.load(video)["frames"]
                assert v.shape == (60, 480, 752, 3) and v.dtype == np.uint8, v.shape
            elif name == "ipe_legacy":
                assert launches["pf_step"] == launches["refine_frame"] == 0, f"cli ipe: {launches}"
            else:
                assert launches["pf_step"] > 0 and launches["refine_frame"] > 0, f"cli {name}"

    # the frame pipe: golden frames at 50 fps into the main-path tracker
    pipe = counted("cli pipe", pipe_replay, device, d, cam, markers)
    out["pipe"] = {k: getattr(pipe, k) for k in ("pushed", "dropped", "pending", "skipped",
                                                  "stepped", "tracked", "frames_per_second",
                                                  "launches")}
    print(f"[cli] {card}: frame pipe at 50 fps: {out['pipe']}")
    assert pipe.stepped > 0 and pipe.pushed == len(d["frames"])

    # one fresh process: `python -m ... --profile`, whose trace holds kernel A
    with tempfile.TemporaryDirectory() as trace_dir:
        cmd = [sys.executable, "-m", "pf_monocular_pose_estimator_tpu_torch.io.cli", "--synthetic",
               "--frames", "20", "--particles", str(N_PARTICLES), "--pf-retries",
               str(MAIN["pf_max_retries"]), "--json", "--profile", trace_dir, *dev]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        assert proc.returncode == 0, f"cli -m: exit code {proc.returncode}\n{proc.stderr[-4000:]}"
        s = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(Path(trace_dir) / "trace.json") as f:
            events = json.load(f)["traceEvents"]
    kernel_a = [e for e in events if e.get("cat") == "kernel"
                and any(k in e.get("name", "") for k in KERNEL_A)]
    row = dict(frames=s["frames"], tracked_frames=s["tracked_frames"], fps=s["fps"],
               ate_m=s["ate_m"], seconds=seconds, kernel_a_events=len(kernel_a),
               kernel_a_device_us=sum(e.get("dur", 0) for e in kernel_a),
               device_events=sum(e.get("cat") == "kernel" for e in events))
    print(f"[cli] {card}: python -m ... --profile: {row}")
    assert s["frames"] == 20 and kernel_a, f"cli -m: no device events of kernel A: {row}"
    out["subprocess"] = row
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[cli] phase 19 took {out['seconds']:.1f} s")
    return out


BENCH_FLAG_SETS = ([], ["--sharded"], ["--targets", "2"], ["--ess-tau", "0.0"])
BENCH_RUN = ["--frames", "120", "--warmup", "1", "--runs", "2"]


def bench_phase(counted) -> list:
    """Phase 20: `bench_torch.main` for each of BENCH_FLAG_SETS at its full
    width (100,000 particles, 752x480) over BENCH_RUN's frames and runs,
    launches counted over all its runs; each line must show every frame
    updated and the golden's accuracy bars, and the kernels of its path
    launched (A, B, D; H sharded, C otherwise)."""
    import contextlib
    import io

    import bench_torch

    def bench(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            line = bench_torch.main(argv)
        assert out.getvalue().splitlines() == [json.dumps(line)]
        return SimpleNamespace(line=line)

    lines = []
    for flags in BENCH_FLAG_SETS:
        tag = "bench " + (" ".join(flags) or "default")
        got = counted(tag, bench, flags + BENCH_RUN)
        line, launches = got.line, got.launches
        print(f"[bench] {json.dumps(line)}")
        assert line["updated_frames_fraction"] == 1.0, f"{tag}: frames not updated"
        assert line["ate_mm"] < 10, f"{tag}: ATE {line['ate_mm']:.2f} mm"
        assert line["orientation_deg"] < 1.5, f"{tag}: orientation {line['orientation_deg']:.2f}"
        gather, other = (("ring_gather", "resample_gather") if "--sharded" in flags
                         else ("resample_gather", "ring_gather"))
        for name in ("threshold_blur", "detect_stats", "pf_step", "refine_frame", gather):
            assert launches[name] > 0, f"{tag}: never launched {name}"
        assert launches[other] == 0, f"{tag}: launched {other}"
        lines.append(dict(line, launches=launches))
    return lines


# the kernels of the main path: A (#1), #2, B, C and the fused refine (D inside)
MAIN_KERNELS = ("detect_stats", "threshold_blur", "pf_step", "resample_gather", "refine_frame")
ACCURACY_RUN = ["--frames", "40"]
SWEEP_GRIDS = ("reference_grid.yaml", "fault_grid.yaml")


def accuracy_phase(card, counted) -> dict:
    """Phase 21: `accuracy_torch.main` (the BASELINE.json configs on the
    40-frame orbit), its launches counted.  config0 and config1 hold the
    golden's bars (every frame, ATE < 10 mm, orientation < 1.5 deg),
    config3 tests/test_two_uav.py's (tracked >= 0.95, every target's ATE <=
    20 mm), config2 tests/test_robustness.py's tracked fraction (the mean
    of five seeds >= 0.9); the parity row is reported and held to nothing
    (rounding decides which faulted seeds lock onto the clones)."""
    import accuracy_torch

    got = counted("accuracy", lambda: SimpleNamespace(report=accuracy_torch.main(ACCURACY_RUN)))
    report, launches = got.report, got.launches
    print(f"[accuracy] {card}: {json.dumps(report)}")
    for row in ("config0_1k_clean", "config1_10k"):
        r = report[row]
        assert r["tracked_fraction"] == 1.0, f"accuracy {row}: tracked {r['tracked_fraction']}"
        assert r["ate_mm"] < 10, f"accuracy {row}: ATE {r['ate_mm']} mm"
        assert r["orientation_err_deg"] < 1.5, f"accuracy {row}: {r['orientation_err_deg']} deg"
    multi = report["config3_4targets_25k"]
    assert multi["tracked_fraction"] >= 0.95, f"accuracy config3: tracked {multi}"
    assert max(multi["ate_mm_per_target"]) <= 20, f"accuracy config3: ATE {multi}"
    faulted = report["config2_50k_outliers"]["tracked_fraction_mean"]
    assert faulted >= 0.9, f"accuracy config2: tracked {faulted} (mean of five seeds)"
    parity = report["config2_50k_outliers_reference_parity"]
    print(f"[accuracy] reference parity (no bar): tracked {parity['tracked_fraction_mean']}, "
          f"per seed {[(r['tracked_fraction'], r['ate_mm']) for r in parity['per_seed']]}")
    for name in MAIN_KERNELS:
        assert launches[name] > 0, f"accuracy: never launched {name}"
    return dict(report, launches=launches)


def sweep_phase(card, counted) -> dict:
    """Phase 22: `sweep_torch.main` over configs/sweeps/reference_grid.yaml
    (18 cells x 2 seeds) and fault_grid.yaml (8 cells x 3 seeds) at their
    own 40 frames, JSON and markdown written to a temporary directory, the
    launches of each grid counted.  Every cell's `tracked` lies in [0, 1];
    fault_grid's cells without occlusions or false detections hold the
    golden's bars on every seed; kernels A, #2, B, C and D are launched."""
    import tempfile

    import sweep_torch

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in SWEEP_GRIDS:
            md = Path(tmp) / name.replace(".yaml", ".md")
            argv = [str(ROOT / "configs" / "sweeps" / name), "--out",
                    str(Path(tmp) / name.replace(".yaml", ".json")), "--md", str(md)]
            got = counted(f"sweep {name}", lambda: SimpleNamespace(result=sweep_torch.main(argv)))
            result, launches = got.result, got.launches
            print(f"[sweep] {card}: {name}, {len(result['cells'])} cells, "
                  f"{result['wall_s_total']} s\n{md.read_text()}")
            for cell in result["cells"]:
                assert 0.0 <= cell["tracked"] <= 1.0, f"sweep {name}: {cell}"
                p = cell["params"]
                if p.get("number_of_occlusions", 1) == 0 and p.get("number_of_false_detections",
                                                                    1) == 0:
                    assert cell["tracked"] == 1.0, f"sweep {name}: {cell}"
                    assert max(cell["ate_mm"]) < 10, f"sweep {name}: {cell}"
                    assert max(cell["ori_deg"]) < 1.5, f"sweep {name}: {cell}"
            for kernel in MAIN_KERNELS:
                assert launches[kernel] > 0, f"sweep {name}: never launched {kernel}"
            out[name] = dict(result, launches=launches)
    return out


def accuracy(est, gt):
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
    rel = np.einsum("tij,tkj->tik", est[:, :3, :3], gt[:, :3, :3])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.sqrt(np.mean(err ** 2))), float(np.sqrt(np.mean(np.degrees(np.arccos(cos)) ** 2)))


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; this needs a GPU")
    sys.path.insert(0, str(ROOT))
    import pf_monocular_pose_estimator_tpu_torch  # noqa: F401  (sets TF32 off)
    from pf_monocular_pose_estimator_tpu_torch.ops import detect_kernel as dk
    from pf_monocular_pose_estimator_tpu_torch.parallel import gather_kernel as hk
    from pf_monocular_pose_estimator_tpu_torch.parallel import make_mesh
    from pf_monocular_pose_estimator_tpu_torch.pf import gather_kernel as gk
    from pf_monocular_pose_estimator_tpu_torch.pf import refine_kernel as rk
    from pf_monocular_pose_estimator_tpu_torch.pf import resample_kernel as fk
    from pf_monocular_pose_estimator_tpu_torch.pf import step_kernel as sk
    from pf_monocular_pose_estimator_tpu_torch.pf import weight_kernel as wk
    from pf_monocular_pose_estimator_tpu_torch.utils import cuda_lib

    device = "cuda"
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | nvidia-smi: {card}")

    # 2. build
    cuda_lib.library()
    print(f"[build] kernels ready in {cuda_lib.build_seconds:.2f} s ({cuda_lib.build_dir()})")

    if sys.argv[1:] == ["--ring-only"]:
        ring = ring_timings(device, batched=False)
        print(card)
        print(json.dumps({"ring": ring}))
        return 0

    def summary(cold, warm):
        return {"frames_per_second": warm.frames_per_second,
                "syncs_per_frame": warm.syncs_per_frame, "ate_mm": cold.ate * 1e3,
                "orientation_deg": cold.ori}

    # launch counters: (wrapper, attribute) per kernel row
    counters = {"threshold_blur": (dk.threshold_blur, "launches"),
                "detect_stats": (dk.detect_stats, "launches"),
                "detect_epilogue": (dk.detect_epilogue, "launches"),
                "pf_step": (sk.pf_step, "launches"), "pf_step_pairs": (sk.pf_step, "pairs_launches"),
                "pf_weight": (wk.weight, "launches"),
                "resample_gather": (sk.resample_gather, "launches"),
                "resample_decode": (fk.decode, "launches"),
                "monotone_gather": (gk.windowed_gather, "launches"),
                "ring_gather": (hk.ring_gather, "launches"),
                "gn_refine": (rk.gn_refine, "launches"),
                "refine_frame": (rk.refine_frame, "launches"),
                "refine_pose": (rk.refine_pose, "launches")}

    def counted(tag, fn, *args, **kwargs):
        """fn(*args, **kwargs) with every launch count set to 0 just before
        it; the counts read just after are attached to its result."""
        for f, attr in counters.values():
            setattr(f, attr, 0)
        run = fn(*args, **kwargs)
        run.launches = {name: getattr(f, attr) for name, (f, attr) in counters.items()}
        print(f"[{tag}] launches in the replay: {run.launches}")
        return run

    def counted_replay(tag, *args, bars=True, all_updated=True, golden=None, **kwargs):
        """A replay (of `golden` = (data, camera, markers), the golden sequence
        unless given), its launches counted; with `all_updated` every frame
        must update and, with `bars`, the golden sequence's accuracy bars
        hold.  ATE and orientation error are over the updated frames."""
        data, camera, marks = golden or (d, cam, markers)
        run = counted(tag, replay, device, data, camera, marks, *args, **kwargs)
        n_frames = run.poses.shape[0]
        run.ate, run.ori = accuracy(run.poses[run.updated], data["poses"][:n_frames][run.updated])
        print(f"[{tag}] {run.n_particles} particles, {n_frames} frames: updated "
              f"{int(run.updated.sum())}/{n_frames}, ATE {run.ate * 1e3:.3f} mm, orientation "
              f"{run.ori:.3f} deg, flags {sorted(set(run.flags.tolist()))}, first pass "
              f"{run.seconds:.2f} s")
        missed = np.flatnonzero(~run.updated).tolist()
        assert not (all_updated and missed), f"{tag}: untracked frames: {missed}"
        if bars:
            assert run.ate < 0.01, f"{tag}: ATE {run.ate * 1e3:.2f} mm"
            assert run.ori < 1.5, f"{tag}: orientation error {run.ori:.2f} deg"
        return run

    def warm_replay(tag, *args, all_updated=True, golden=None, **kwargs):
        """A second replay of a path just driven: frames per second, syncs per frame."""
        data, camera, marks = golden or (d, cam, markers)
        run = replay(device, data, camera, marks, *args, **kwargs)
        assert run.updated.all() or not all_updated
        print(f"[{tag}] {card}: warm replay {run.frames_per_second:.2f} frames/s at "
              f"{run.n_particles} particles ({1e3 / run.frames_per_second:.2f} ms/frame), "
              f"{run.syncs_per_frame:.2f} device->host syncs per frame")
        return run

    if sys.argv[1:] == ["--wide-only"]:
        # the wide shapes' times and [wide], for a checkout whose wrappers match
        d, cam, markers = load_golden(device)
        out = {"wide_shapes": wide_timings(device, card),
               "wide": wide_phase(device, d, cam, markers, card, counted_replay)}
        print(card)
        print(json.dumps(out))
        return 0

    # 3. kernels against plain
    d, cam, markers = load_golden(device)
    rows = check_kernels(device, d, cam, markers)
    torch.cuda.synchronize()
    report(device, d, cam, markers, cuda_lib, dk, rk, sk, wk, hk)
    ring = ring_timings(device, batched=True)

    # [shapes]: the kernels beyond the main path's shapes, the twin scene, ten markers
    shapes = shape_phase(device, d, card, counted)

    # 4. replay through the main path, counters from zero; 5. a warm second replay
    main_run = counted_replay("replay")
    for name in ("threshold_blur", "detect_stats", "pf_step", "refine_frame"):
        assert main_run.launches[name] > 0, f"the replay never launched {name}"
    epilogue_per_crop("replay", main_run)
    if main_run.launches["resample_gather"] == 0:
        print("[replay] no frame resampled (the ESS gate never fired)")
    main_warm = warm_replay("timing")
    idle = idle_share(device, d, cam, markers)
    print(f"[idle] {card}: main path, 20 warm frames: {idle}")
    # [wide]: the main path with kernel A's and B's wide forms on every frame
    wide = wide_phase(device, d, cam, markers, card, counted_replay)

    # 6. the slice: XLA-style propagation + kernel E, sort-free resampling (kernel F)
    slice_run = counted_replay("slice", SLICE)
    print(f"[slice] resampling took kernel F's result on frames {slice_run.step.decoded_frames}; "
          f"fell back to the sort path (kernel C) on frames {slice_run.step.fallback_frames}")
    for name in ("pf_weight", "resample_decode", "threshold_blur", "detect_stats",
                 "refine_frame"):
        assert slice_run.launches[name] > 0, f"the slice never launched {name}"
    assert slice_run.launches["pf_step"] == 0, "the slice launched pf_step"
    slice_warm = warm_replay("slice", SLICE)

    # 7. the remaining switches: short replays, resampling on every tracked frame
    for overrides in SWITCHES:
        print(f"[switches] {overrides}:")
        counted_replay("switches", dict(overrides, resample_min_ess=0.0), SHORT_FRAMES)

    # 8. the sharded path: a local mesh of 4 shards on the one card.  Every
    # block reaches every shard (SHARDED), so no draw can be clipped and the
    # resampling is the main path's slot for slot.
    mesh = make_mesh(MESH_SHARDS)
    sharded_run = counted_replay("sharded", mesh=mesh, **SHARDED)
    print(f"[sharded] P={MESH_SHARDS}: ATE {sharded_run.ate * 1e3:.3f} mm, orientation "
          f"{sharded_run.ori:.3f} deg; main path: ATE {main_run.ate * 1e3:.3f} mm, orientation "
          f"{main_run.ori:.3f} deg")
    differ = np.flatnonzero(sharded_run.flags != main_run.flags).tolist()
    assert not differ, f"sharded: fail flags differ from the main path's on frames {differ}"
    assert int(sharded_run.clipped[-1]) == 0, f"sharded: {sharded_run.clipped[-1]} draws clipped"
    assert sharded_run.state.bank.shape == (MESH_SHARDS, 16, N_PARTICLES // MESH_SHARDS)
    # one launch of B per shard and PF pass (at least one pass a tracked frame), one
    # of H for all shards a resampling: as many as the main path's gathers
    got = sharded_run.launches
    assert got["pf_step"] % MESH_SHARDS == 0 and got["pf_step"] >= MESH_SHARDS * 59, \
        "sharded: kernel B launches"
    assert got["ring_gather"] == main_run.launches["resample_gather"] > 0, \
        f"sharded: {got['ring_gather']} launches of kernel H, not one a resampling " \
        f"({main_run.launches['resample_gather']})"
    assert got["resample_gather"] == 0, "sharded: launched the unsharded gather"
    for name in ("threshold_blur", "detect_stats", "refine_frame"):
        assert got[name] > 0, f"the sharded replay never launched {name}"
    epilogue_per_crop("sharded", sharded_run)
    print(f"[sharded] pf_step {got['pf_step']} launches (main path "
          f"{main_run.launches['pf_step']} x {MESH_SHARDS} shards), ring_gather "
          f"{got['ring_gather']} (main path's resample_gather "
          f"{main_run.launches['resample_gather']})")
    sharded_warm = warm_replay("sharded", mesh=mesh, **SHARDED)

    # the reference's default ring (reach 1, a window of S / 4): what it clips here
    default_run = counted_replay("sharded-default-ring", mesh=mesh)
    first = np.flatnonzero(default_run.clipped > 0)
    print(f"[sharded-default-ring] reach 1, window S/4: {int(default_run.clipped[-1])} draws "
          f"clipped over the replay, the first on frame "
          f"{int(first[0]) if first.size else None}; ring_gather "
          f"{default_run.launches['ring_gather']} launches")

    # the size the sharded path exists for; the only bar: every frame updated
    large_run = counted_replay("sharded-large", n_frames=SHORT_FRAMES, n_particles=N_LARGE,
                               mesh=mesh, bars=False, **SHARDED)
    print(f"[sharded-large] {int(large_run.clipped[-1])} draws clipped")
    large_warm = warm_replay("sharded-large", n_frames=SHORT_FRAMES, n_particles=N_LARGE,
                             mesh=mesh, **SHARDED)

    # 9. the same step over a torch.distributed group of this one rank
    one_rank_group(device, d, cam, markers)

    # 10-14. the options ported last, each counted, then a warm second replay
    new_paths, real_run = ported_options(device, d, cam, markers, card, main_run,
                                         counted_replay, warm_replay, summary)

    # 15-18. two targets, targets x particles, checkpoints, the renderer, multihost
    multi_paths, multi_4k_run = multi_target_phases(device, card, counted, (d, cam, markers))
    new_paths.update(multi_paths)

    # 19. the run_tracker CLI over the main path and every committed experiment
    new_paths["cli"] = cli_phase(device, card, counted, (d, cam, markers), main_run, real_run,
                                 multi_4k_run)

    # 20. bench_torch.py's four flag sets at full width
    new_paths["bench"] = bench_phase(counted)

    # 21. accuracy_torch.py: the BASELINE.json configs; 22. sweep_torch.py: both grids
    new_paths["accuracy"] = accuracy_phase(card, counted)
    new_paths["sweep"] = sweep_phase(card, counted)

    for r in rows:
        # each kernel's launches on the path it lies on: A-D on the main path, E
        # and F on the slice, H on the sharded replay; B's pairs variant and G
        # lie on no tracker path
        on = {"pf_weight": slice_run, "resample_decode": slice_run,
              "ring_gather": sharded_run}.get(r["name"], main_run)
        r["launches"] = on.launches[r["name"]]
        lib = "" if r["library_ms"] is None else (
            f", library call {r['library_ms'] * 1e3:.1f} us "
            f"({r['library_device_ms'] * 1e3:.2f} on the card alone)")
        print(f"[timing] {card}: {r['name']} kernel {r['ms'] * 1e3:.1f} us "
              f"({r['device_ms'] * 1e3:.2f} on the card alone), bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), plain {r['plain_ms'] * 1e3:.1f} us"
              f"{lib}")

    print(json.dumps({
        "replay": dict(summary(main_run, main_warm), card=card, idle=idle),
        "slice": dict(summary(slice_run, slice_warm), decoded_frames=slice_run.step.decoded_frames,
                      fallback_frames=slice_run.step.fallback_frames),
        "sharded": dict(summary(sharded_run, sharded_warm), shards=MESH_SHARDS,
                        pf_step_launches=got["pf_step"], ring_gather_launches=got["ring_gather"],
                        clipped=int(sharded_run.clipped[-1]),
                        default_ring_clipped=int(default_run.clipped[-1])),
        "sharded_large": dict(summary(large_run, large_warm), n_particles=N_LARGE,
                              frames=SHORT_FRAMES, clipped=int(large_run.clipped[-1])),
        "ring": ring, "shapes": shapes, "wide": wide, **new_paths}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
