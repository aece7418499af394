#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device  -- requires CUDA; prints the card's name and power limit;
  2. build   -- compiles the port's CUDA kernels from csrc/ (nvcc);
  3. kernels -- every kernel of the port against its plain PyTorch
     version on the card, at the shapes the main path gives it (N =
     100,000, M = 5, K = 16), with CUDA-event times for both, the least
     time the card could take (`bound_ms`, from the bytes and operations
     of this run's inputs) and, where one PyTorch call computes the same
     function, that call's time (`library_ms`; the port never calls it);
  4. replay  -- tests/golden/golden_sequence.npz (60 frames, 752x480)
     through `make_tracker(..., device="cuda")` at 100,000 particles,
     min_blob_area=8, pf_max_retries=8; every frame must update, ATE
     < 10 mm, orientation error < 1.5 deg; the launch counters show which
     kernels the replay went through;
  5. timing  -- a second, warm replay: frames per second and device->host
     syncs per frame;
  6. slice   -- the same replay with use_fused_pf_kernel=False and
     use_pallas_resample=True (XLA-style propagation + kernel E, the
     sort-free resampler with kernel F): same bars, kernels E and F
     launched and B not; the frames whose resampling took F's result and
     those that fell back to the sort path; a warm second replay;
  7. switches -- short replays (20 frames, resampling on every tracked
     frame) of the remaining single-device switches, same bars.
The last three lines are the card, the kernel table and the device line.
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
MAIN = dict(n_particles=N_PARTICLES, min_blob_area=8.0, pf_max_retries=8)
SLICE = dict(use_fused_pf_kernel=False, use_pallas_resample=True)
SWITCHES = (dict(use_folded_pf_kernel=False, use_closed_form_resample=True, use_pallas_gn=False),
            dict(use_fused_pf_kernel=False, use_pallas_weight=False))
SHORT_FRAMES = 20

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
    """Operations of the greedy weight of one particle: projection (26 a
    marker), the M x K volume (7 a cell), then M steps of a min, a
    first-index and a retire sweep over the volume (3 M K), the reuse and
    used updates (2 K), the downgrade sum (2 M) and 9 scalar operations."""
    return 26 * m + 7 * m * k + m * (3 * m * k + 2 * k + 2 * m + 9)


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
    from pf_monocular_pose_estimator_tpu_torch.pf import gather_kernel as gk
    from pf_monocular_pose_estimator_tpu_torch.pf import refine_kernel as rk
    from pf_monocular_pose_estimator_tpu_torch.pf import resample_kernel as fk
    from pf_monocular_pose_estimator_tpu_torch.pf import step_kernel as sk
    from pf_monocular_pose_estimator_tpu_torch.pf import weight_kernel as wk
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
    px = frame.numel()
    # read the frame, write the blurred frame; ROI threshold (6) + 2 x 5 taps (20) a pixel
    b_ms, b_by = bound(8 * px + 4 * prm.numel(), 26 * px)
    rows.append(dict(name="threshold_blur", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/detect.cu",
                     replaces=f"{REF}/ops/pallas_kernels.py:362", max_abs_err=err,
                     ms=time_ms(lambda: dk.threshold_blur(frame, prm, 5)),
                     plain_ms=time_ms(lambda: dk.threshold_blur_plain(frame, prm, 5, True), 5),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))
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
    px = crop.numel()
    # read the crop, write labels and 10 maps; blur (26), 12 label sweeps
    # over 3x3 (9 each) and 10 moment accumulations (2 each) a pixel
    b_ms, b_by = bound(4 * px + 4 * px * (1 + dk.N_MAPS) + 8 * 16, (26 + 12 * 9 + 20) * px)
    rows.append(dict(name="detect_stats", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/detect.cu",
                     replaces=f"{REF}/ops/pallas_kernels.py:299", max_abs_err=0.0,
                     ms=time_ms(lambda: dk.detect_stats(crop, prm_c, 5, True, 12, 16)),
                     plain_ms=time_ms(lambda: dk.detect_stats_plain(crop, prm_c, 5, True, 12, 16),
                                      3),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))
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
    # read 16 rows, write 16 rows and the weight
    b_ms, b_by = bound(n * (64 + 64 + 4), n * (PROPAGATE_OPS + weight_ops(5, 16)))
    rows.append(dict(name="pf_step", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/pf_step.cu",
                     replaces=f"{REF}/pf/pallas_step.py:404", max_abs_err=err_b,
                     ms=time_ms(lambda: sk.pf_step(bank, prm_b, keys, 5, 16)),
                     plain_ms=time_ms(lambda: sk.pf_step_plain(bank, prm_b, keys, 5, 16), 5),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # B, pairs variant (#4): the same pass with each particle's greedy pairs
    got = sk.pf_step(bank, prm_b, keys, 5, 16, want_pairs=True)
    want = sk.pf_step_plain(bank, prm_b, keys, 5, 16, want_pairs=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], bank_k) and torch.equal(got[1], w_k), \
        "pf_step's pairs variant changed the bank or the weights"
    assert torch.equal(got[2], want[2]), "pf_step pairs differ from plain"
    assert torch.equal(got[3], want[3]), "pf_step n_corr differs from plain"
    same_wp = float((got[1] == want[1]).float().mean())
    assert same_wp >= 0.9999, f"pf_step pairs variant: weights equal on only {same_wp:.6f}"
    print(f"[kernels] pf_step pairs N={n}: pairs and n_corr exact, weights equal on "
          f"{same_wp * 100:.4f}% of lanes, bank and weights equal to the weights-only pass")
    b_ms, b_by = bound(n * (64 + 64 + 4 + 4 * 10 + 4), n * (PROPAGATE_OPS + weight_ops(5, 16)))
    rows.append(dict(name="pf_step_pairs", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/pf_step.cu",
                     replaces=f"{REF}/pf/pallas_step.py:299", max_abs_err=float(
                         (got[1] - want[1]).abs().max()),
                     ms=time_ms(lambda: sk.pf_step(bank, prm_b, keys, 5, 16, want_pairs=True)),
                     plain_ms=time_ms(lambda: sk.pf_step_plain(bank, prm_b, keys, 5, 16,
                                                               want_pairs=True), 5),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # E: the standalone weight of B's propagated bank (#9)
    wprm = prm_b[76:].contiguous()
    got = wk.weight(bank_k, wprm, 5, 16)
    want = wk.weight_plain(bank_k, wprm, 5, 16)
    torch.cuda.synchronize()
    same_we = float((got[0] == want[0]).float().mean())
    assert torch.equal(got[1], want[1]), "pf_weight pairs differ from plain"
    assert torch.equal(got[2], want[2]), "pf_weight n_corr differs from plain"
    assert same_we >= 0.9999, f"pf_weight weights equal on only {same_we:.6f} of lanes"
    assert torch.equal(got[0], w_k), "pf_weight differs from kernel B's weight of the same bank"
    print(f"[kernels] pf_weight N={n}: pairs and n_corr exact, weights equal on "
          f"{same_we * 100:.4f}% of lanes; {int((got[2] == 5).sum())} lanes matched 5 markers")
    b_ms, b_by = bound(n * (48 + 4 + 4 * 10 + 4), n * weight_ops(5, 16))
    rows.append(dict(name="pf_weight", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/pf_weight.cu",
                     replaces=f"{REF}/pf/pallas_weight.py:155",
                     max_abs_err=float((got[0] - want[0]).abs().max()),
                     ms=time_ms(lambda: wk.weight(bank_k, wprm, 5, 16)),
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
                     plain_ms=time_ms(lambda: sk.resample_gather_plain(bank_k, anc)),
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=time_ms(lambda: bank_k.index_select(1, anc))))
    print(f"[kernels] resample_gather N={n}: exact ({n_unique} distinct ancestors)")

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
    # read rank and 16 rows, write 16 rows
    b_ms, b_by = bound(n * (4 + 64 + 64), n * 25)
    rows.append(dict(name="resample_decode", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/resample_decode.cu",
                     replaces=f"{REF}/pf/pallas_resample.py:181", max_abs_err=0.0,
                     ms=time_ms(lambda: fk.decode(rank_c, bank_k)),
                     plain_ms=time_ms(lambda: fk.decode_plain(rank_c, bank_k), 5),
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=time_ms(lambda: bank_k.index_select(1, anc_c))))
    # read 12 rows and the int64 ancestors, write 16 rows
    b_ms, b_by = bound(n * (48 + 8 + 64), n * 6)
    rows.append(dict(name="monotone_gather", route="cuda",
                     source="pf_monocular_pose_estimator_tpu_torch/csrc/monotone_gather.cu",
                     replaces=f"{REF}/pf/pallas_gather.py:93", max_abs_err=0.0,
                     ms=time_ms(lambda: gk.windowed_gather(bank_k, anc_c)),
                     plain_ms=time_ms(lambda: gk.monotone_gather_plain(bank_k, anc_c), 5),
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=time_ms(lambda: bank_k.index_select(1, anc_c))))

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
                     plain_ms=time_ms(lambda: rk.gn_refine_plain(*args, 25, 1e-4), 3),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))
    return rows


def replay(device, d, cam, markers, overrides=None, n_frames=None):
    """One replay of the first `n_frames` golden frames with the main path's
    config plus `overrides`; returns (poses, updated, flags, seconds, tracker)."""
    import torch
    from pf_monocular_pose_estimator_tpu_torch.tracker import TargetState, make_tracker
    from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig
    from pf_monocular_pose_estimator_tpu_torch.utils.prng import prng_key

    config = TrackerConfig(**MAIN, **(overrides or {}))
    step = make_tracker(cam, markers, torch.ones(markers.shape[0], dtype=torch.bool), config,
                        device=device)
    frames = torch.from_numpy(d["frames"][:n_frames]).to(device)
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

    # 3. kernels against plain
    d, cam, markers = load_golden(device)
    rows = check_kernels(device, d, cam, markers)
    torch.cuda.synchronize()

    # launch counters: (wrapper, attribute) per kernel row
    counters = {"threshold_blur": (dk.threshold_blur, "launches"),
                "detect_stats": (dk.detect_stats, "launches"),
                "pf_step": (sk.pf_step, "launches"), "pf_step_pairs": (sk.pf_step, "pairs_launches"),
                "pf_weight": (wk.weight, "launches"),
                "resample_gather": (sk.resample_gather, "launches"),
                "resample_decode": (fk.decode, "launches"),
                "monotone_gather": (gk.windowed_gather, "launches"),
                "gn_refine": (rk.gn_refine, "launches")}

    def zero_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read_counts():
        return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}

    def check_replay(tag, est, upd, flags, seconds, n_frames):
        ate, ori = accuracy(est, d["poses"][:n_frames])
        print(f"[{tag}] {N_PARTICLES} particles, {n_frames} frames: updated {int(upd.sum())}/"
              f"{n_frames}, ATE {ate * 1e3:.3f} mm, orientation {ori:.3f} deg, flags "
              f"{sorted(set(flags.tolist()))}, first pass {seconds:.2f} s")
        assert upd.all(), f"{tag}: untracked frames: {np.flatnonzero(~upd).tolist()}"
        assert ate < 0.01, f"{tag}: ATE {ate * 1e3:.2f} mm"
        assert ori < 1.5, f"{tag}: orientation error {ori:.2f} deg"
        return ate, ori

    # 4. replay through the main path, counters from zero
    zero_counts()
    est, upd, flags, cold_s, step = replay(device, d, cam, markers)
    launches = read_counts()
    print(f"[replay] launches in the replay: {launches}")
    ate, ori = check_replay("replay", est, upd, flags, cold_s, 60)
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

    # 6. the slice: XLA-style propagation + kernel E, sort-free resampling (kernel F)
    zero_counts()
    est_s, upd_s, flags_s, cold_s, step_s = replay(device, d, cam, markers, SLICE)
    slice_launches = read_counts()
    print(f"[slice] launches in the replay: {slice_launches}")
    ate_s, ori_s = check_replay("slice", est_s, upd_s, flags_s, cold_s, 60)
    print(f"[slice] resampling took kernel F's result on frames {step_s.decoded_frames}; "
          f"fell back to the sort path (kernel C) on frames {step_s.fallback_frames}")
    assert slice_launches["pf_weight"] > 0, "the slice never launched pf_weight"
    assert slice_launches["resample_decode"] > 0, "the slice never launched resample_decode"
    for name in ("threshold_blur", "detect_stats", "gn_refine"):
        assert slice_launches[name] > 0, f"the slice never launched {name}"
    assert slice_launches["pf_step"] == 0, "the slice launched pf_step"
    _, upd_s2, _, warm_s, step_s2 = replay(device, d, cam, markers, SLICE)
    assert upd_s2.all()
    fps_s = 60.0 / warm_s
    syncs_s = step_s2.host.count / step_s2.frames
    print(f"[slice] {card}: warm replay {fps_s:.2f} frames/s at {N_PARTICLES} particles "
          f"({warm_s * 1e3 / 60:.2f} ms/frame), {syncs_s:.2f} device->host syncs per frame")

    # 7. the remaining switches: short replays, resampling on every tracked frame
    for overrides in SWITCHES:
        zero_counts()
        est_w, upd_w, flags_w, cold_w, _ = replay(device, d, cam, markers,
                                                  dict(overrides, resample_min_ess=0.0),
                                                  SHORT_FRAMES)
        print(f"[switches] {overrides}: launches {read_counts()}")
        check_replay("switches", est_w, upd_w, flags_w, cold_w, SHORT_FRAMES)

    for r in rows:
        # each kernel's launches on the path it lies on: A-D on the main path, E
        # and F on the slice; B's pairs variant and G lie on no tracker path
        r["launches"] = (slice_launches if r["name"] in ("pf_weight", "resample_decode")
                         else launches)[r["name"]]
        lib = "" if r["library_ms"] is None else f", library call {r['library_ms'] * 1e3:.1f} us"
        print(f"[timing] {card}: {r['name']} kernel {r['ms'] * 1e3:.1f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), plain {r['plain_ms'] * 1e3:.1f} us"
              f"{lib}")
    print(json.dumps({"replay": {"card": card, "frames_per_second": fps,
                                 "syncs_per_frame": syncs, "ate_mm": ate * 1e3,
                                 "orientation_deg": ori},
                      "slice": {"frames_per_second": fps_s, "syncs_per_frame": syncs_s,
                                "ate_mm": ate_s * 1e3, "orientation_deg": ori_s,
                                "decoded_frames": step_s.decoded_frames,
                                "fallback_frames": step_s.fallback_frames}}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
