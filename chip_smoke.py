#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device  -- requires CUDA; prints the card's name and power limit;
  2. build   -- compiles the port's CUDA kernels from csrc/ (nvcc);
  3. kernels -- every kernel of the main path against its plain PyTorch
     version on the card, at the shapes the main path gives it, with
     CUDA-event times for both;
  4. replay  -- tests/golden/golden_sequence.npz (60 frames, 752x480)
     through `make_tracker(..., device="cuda")` at 100,000 particles,
     min_blob_area=8, pf_max_retries=8; every frame must update, ATE
     < 10 mm, orientation error < 1.5 deg; the launch counters show which
     kernels the replay went through;
  5. timing  -- a second, warm replay: frames per second and device->host
     syncs per frame.
The last two lines are the kernel table and the device line as JSON.
It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "golden_sequence.npz"
N_PARTICLES = 100_000
REF = "pf_monocular_pose_estimator_tpu"


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


def check_kernels(device, d, cam, markers):
    """Phase 3: kernel vs plain at main-path shapes; returns the table rows."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.geometry import exp_se3, project
    from pf_monocular_pose_estimator_tpu_torch.ops import detect_kernel as dk
    from pf_monocular_pose_estimator_tpu_torch.pf import refine_kernel as rk
    from pf_monocular_pose_estimator_tpu_torch.pf import step_kernel as sk
    from pf_monocular_pose_estimator_tpu_torch.pf.soa import stratified_resample_soa
    from pf_monocular_pose_estimator_tpu_torch.utils import prng

    rng = np.random.default_rng(0)
    rows = []

    # A: threshold_blur on a full 752x480 frame (the init / full-frame path)
    frame = torch.from_numpy(d["frames"][0].astype(np.float32)).to(device)
    prm = dk.make_params([0.0, 0.0, 752.0, 480.0], 240.0, 8.0, 160.0, 0.6, device)
    got = dk.threshold_blur(frame, prm, 5)
    want = dk.threshold_blur_plain(frame, prm, 5, True)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert torch.equal(got, want), f"threshold_blur differs from plain (max {err})"
    rows.append(dict(name="threshold_blur", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/detect.cu",
                     replaces=f"{REF}/ops/pallas_kernels.py:362", max_abs_err=err,
                     ms=time_ms(lambda: dk.threshold_blur(frame, prm, 5)),
                     plain_ms=time_ms(lambda: dk.threshold_blur_plain(frame, prm, 5, True), 5)))
    print(f"[kernels] threshold_blur 480x752: exact (max abs err {err})")

    # A: detect_stats on a 192x256 crop around the LEDs of golden frame 17
    led = d["led_pixels"][17]
    x0 = int(np.clip(round(led[:, 0].mean() - 128), 0, 752 - 256))
    y0 = int(np.clip(round(led[:, 1].mean() - 96), 0, 480 - 192))
    crop = torch.from_numpy(d["frames"][17][y0:y0 + 192, x0:x0 + 256].astype(np.float32))
    crop = crop.contiguous().to(device)
    prm_c = dk.make_params([6.0, 9.0, 240.0, 170.0], 240.0, 8.0, 160.0, 0.6, device)
    lab, maps, top = dk.detect_stats(crop, prm_c, 5, True, 12, 16)
    lab_p, maps_p, top_p = dk.detect_stats_plain(crop, prm_c, 5, True, 12, 16)
    torch.cuda.synchronize()
    assert torch.equal(lab, lab_p), "detect_stats labels differ from plain"
    bad = [i for i in range(dk.N_MAPS) if not torch.equal(maps[i], maps_p[i])]
    assert not bad, f"detect_stats maps {bad} differ from plain"
    assert torch.equal(top, top_p), f"detect_stats top-k {top.tolist()} vs {top_p.tolist()}"
    n_roots = int((lab == torch.arange(1, 192 * 256 + 1, device=device).reshape(192, 256)).sum())
    assert n_roots >= 5, "the crop should hold the five LEDs"
    rows.append(dict(name="detect_stats", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/detect.cu",
                     replaces=f"{REF}/ops/pallas_kernels.py:299", max_abs_err=0.0,
                     ms=time_ms(lambda: dk.detect_stats(crop, prm_c, 5, True, 12, 16)),
                     plain_ms=time_ms(lambda: dk.detect_stats_plain(crop, prm_c, 5, True, 12, 16),
                                      3)))
    print(f"[kernels] detect_stats 192x256: labels, 10 maps, top-16 exact ({n_roots} roots)")

    # B: fused propagate + weight at N = 100,000, M = 5, K = 16
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
    prm_b = sk.pack_params(eye, step, gt, gt @ step, lo, -lo, scal, markers,
                           torch.ones(5, dtype=torch.bool, device=device), det_xy, det_mask,
                           torch.zeros(5, dtype=torch.bool, device=device))
    k_rot, k_trans = prng.split(prng.prng_key(7))
    keys = (*k_rot, *k_trans)
    bank_k, w_k = sk.pf_step(bank, prm_b, keys, 5, 16)
    bank_p, w_p = sk.pf_step_plain(bank, prm_b, keys, 5, 16)
    torch.cuda.synchronize()
    ulps = (bank_k.view(torch.int32).long() - bank_p.view(torch.int32).long()).abs()
    ulps = torch.where((bank_k == 0) & (bank_p == 0), torch.zeros_like(ulps), ulps)
    max_ulp = int(ulps.max())
    same_w = float((w_k == w_p).float().mean())
    mism = torch.nonzero(w_k != w_p).flatten()[:10].tolist()
    err_b = float((w_k - w_p).abs().max())
    print(f"[kernels] pf_step N={n}: bank max {max_ulp} ulp, weights equal on "
          f"{same_w * 100:.4f}% of lanes (max abs err {err_b}); mismatching lanes {mism}")
    assert max_ulp <= 4, f"pf_step bank differs by {max_ulp} ulp"
    assert same_w >= 0.9999, f"pf_step weights equal on only {same_w:.6f} of lanes"
    assert float(w_k.max()) > 20.0, "pf_step: no particle matched the detections"
    rows.append(dict(name="pf_step", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/pf_step.cu",
                     replaces=f"{REF}/pf/pallas_step.py:404", max_abs_err=err_b,
                     ms=time_ms(lambda: sk.pf_step(bank, prm_b, keys, 5, 16)),
                     plain_ms=time_ms(lambda: sk.pf_step_plain(bank, prm_b, keys, 5, 16), 5)))

    # C: the resampling gather with real stratified ancestors of B's weights
    wn = w_k / w_k.sum()
    anc, _, _ = stratified_resample_soa(prng.prng_key(3), wn)
    assert bool((anc[1:] >= anc[:-1]).all()), "ancestors must be non-decreasing"
    got_c = sk.resample_gather(bank_k, anc)
    want_c = sk.resample_gather_plain(bank_k, anc)
    torch.cuda.synchronize()
    assert torch.equal(got_c, want_c), "resample_gather differs from plain"
    n_unique = int(torch.unique(anc).numel())
    rows.append(dict(name="resample_gather", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/resample_gather.cu",
                     replaces=f"{REF}/pf/pallas_step.py:668",
                     also_replaces=f"{REF}/pf/pallas_step.py:697", max_abs_err=0.0,
                     ms=time_ms(lambda: sk.resample_gather(bank_k, anc)),
                     plain_ms=time_ms(lambda: sk.resample_gather_plain(bank_k, anc))))
    print(f"[kernels] resample_gather N={n}: exact ({n_unique} distinct ancestors)")

    # D: batched Gauss-Newton over 11 = 2M + 1 hypotheses
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
    args = (scal_d, poses0.reshape(b, 16).contiguous(), mark, du, dv, cmask.float())
    pk, sk_, ak = rk.gn_refine(*args, 25, 1e-4)
    pp, sp, ap = rk.gn_refine_plain(*args, 25, 1e-4)
    torch.cuda.synchronize()
    err_d = float((pk - pp).abs().max())
    print(f"[kernels] gn_refine B={b}: pose max abs err {err_d}, iterations "
          f"{sk_[:, 2].int().tolist()} vs {sp[:, 2].int().tolist()}")
    assert err_d <= 1e-5, f"gn_refine poses differ by {err_d}"
    assert torch.equal(sk_[:, 2], sp[:, 2]), "gn_refine iteration counts differ"
    assert float(sk_[:, 3].max()) < 1.5, "gn_refine did not converge on clean pairs"
    rows.append(dict(name="gn_refine", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/gn_refine.cu",
                     replaces=f"{REF}/pf/pallas_refine.py:279", max_abs_err=err_d,
                     ms=time_ms(lambda: rk.gn_refine(*args, 25, 1e-4)),
                     plain_ms=time_ms(lambda: rk.gn_refine_plain(*args, 25, 1e-4), 3)))
    return rows


def replay(device, d, cam, markers):
    """Phases 4/5 body: one replay; returns (poses, updated, flags, seconds, tracker)."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
    from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
    from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

    config = TrackerConfig(n_particles=N_PARTICLES, min_blob_area=8.0, pf_max_retries=8)
    step = make_tracker(cam, markers, torch.ones(markers.shape[0], dtype=torch.bool), config,
                        device=device)
    frames = torch.from_numpy(d["frames"]).to(device)
    state = TargetState.create(N_PARTICLES, prng_key(0), device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses, upd, flags = [], [], []
    for i in range(frames.shape[0]):
        state, res = step(state, frames[i], float(d["times"][i]))
        poses.append(res.pose)
        upd.append(res.pose_updated)
        flags.append(res.fail_flag)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    poses = torch.stack(poses).cpu().numpy()
    return poses, torch.stack(upd).cpu().numpy(), torch.stack(flags).cpu().numpy(), seconds, step


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
    from pf_monocular_pose_estimator_tpu_torch.pf import refine_kernel as rk
    from pf_monocular_pose_estimator_tpu_torch.pf import step_kernel as sk
    from pf_monocular_pose_estimator_tpu_torch.utils import cuda_lib

    device = "cuda"
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | nvidia-smi: {card}")

    # 2. build
    cuda_lib.library()
    print(f"[build] kernels ready in {cuda_lib.build_seconds:.2f} s ({cuda_lib.build_dir()})")

    # 3. kernels against plain
    d, cam, markers = load_golden(device)
    rows = check_kernels(device, d, cam, markers)
    torch.cuda.synchronize()

    # 4. replay through the main path, counters from zero
    wrappers = {"threshold_blur": dk.threshold_blur, "detect_stats": dk.detect_stats,
                "pf_step": sk.pf_step, "resample_gather": sk.resample_gather,
                "gn_refine": rk.gn_refine}
    for fn in wrappers.values():
        fn.launches = 0
    est, upd, flags, cold_s, step = replay(device, d, cam, markers)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    ate, ori = accuracy(est, d["poses"])
    print(f"[replay] {N_PARTICLES} particles, 60 frames: updated {int(upd.sum())}/60, "
          f"ATE {ate * 1e3:.3f} mm, orientation {ori:.3f} deg, flags {sorted(set(flags.tolist()))}, "
          f"first pass {cold_s:.2f} s")
    print(f"[replay] launches in the replay: {launches}")
    assert upd.all(), f"untracked frames: {np.flatnonzero(~upd).tolist()}"
    assert ate < 0.01, f"ATE {ate * 1e3:.2f} mm"
    assert ori < 1.5, f"orientation error {ori:.2f} deg"
    for name in ("threshold_blur", "detect_stats", "pf_step", "gn_refine"):
        assert launches[name] > 0, f"the replay never launched {name}"
    if launches["resample_gather"] == 0:
        print("[replay] no frame resampled (the ESS gate never fired)")

    # 5. timing: a warm second replay
    _, upd2, _, warm_s, step2 = replay(device, d, cam, markers)
    assert upd2.all()
    fps = 60.0 / warm_s
    syncs = step2.host.count / step2.frames
    print(f"[timing] {card}: warm replay {fps:.2f} frames/s at {N_PARTICLES} particles "
          f"({warm_s * 1e3 / 60:.2f} ms/frame), {syncs:.2f} device->host syncs per frame")
    for r in rows:
        r["launches"] = launches[r["name"]]
        print(f"[timing] {card}: {r['name']} kernel {r['ms'] * 1e3:.1f} us vs plain "
              f"{r['plain_ms'] * 1e3:.1f} us")
    print(json.dumps({"replay": {"card": card, "frames_per_second": fps,
                                 "syncs_per_frame": syncs, "ate_mm": ate * 1e3,
                                 "orientation_deg": ori}}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
