"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`; each test skips when torch sees no GPU, so on a CPU-only
machine they count as skipped.  On the GPU machine:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda -q

(chip_smoke.py runs the same checks at the main path's full shapes, and
the SHAPE_* grid below with this file's generators in its [shapes] phase.)"""

import numpy as np
import pytest
import torch

from pf_monocular_pose_estimator_tpu_torch.geometry import exp_se3
from pf_monocular_pose_estimator_tpu_torch.ops import detect_kernel as dk
from pf_monocular_pose_estimator_tpu_torch.parallel import gather_kernel as hk
from pf_monocular_pose_estimator_tpu_torch.parallel import LocalMesh, shard_lanes, unshard_lanes
from pf_monocular_pose_estimator_tpu_torch.parallel.resample import make_distributed_resampler
from pf_monocular_pose_estimator_tpu_torch.pf import gather_kernel as gk
from pf_monocular_pose_estimator_tpu_torch.pf import refine_kernel as rk
from pf_monocular_pose_estimator_tpu_torch.pf import resample_kernel as fk
from pf_monocular_pose_estimator_tpu_torch.pf import step_kernel as sk
from pf_monocular_pose_estimator_tpu_torch.pf import weight_kernel as wk
from pf_monocular_pose_estimator_tpu_torch.pf.soa import stratified_resample_soa
from pf_monocular_pose_estimator_tpu_torch.utils import prng

pytestmark = pytest.mark.cuda


# Shapes beyond the tracker's defaults (K = 16, M = 5, 12 sweeps, top-k 16)
# that the card takes: every form of kernels B, E, D and A and the edges of
# the wide ones -- K and M off a group of four rows, sweep counts off a
# round of 8 bbox and 12 label sweeps, top-k on both sides of 64
# (chip_smoke.py's [shapes] phase runs the same grid).
SHAPE_K = (1, 4, 12, 16, 17, 32, 64, 127, 128)
SHAPE_M = (1, 3, 5, 8, 9, 10, 16, 31, 32)
SHAPE_SWEEPS = (0, 4, 12, 13, 20, 24, 25)
SHAPE_TOPK = (16, 64, 65, 100)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _image(rng, h, w):
    img = rng.uniform(0, 200, (h, w)).astype(np.float32)
    for _ in range(12):  # saturated blobs of a few pixels
        y, x = rng.integers(4, h - 4), rng.integers(4, w - 4)
        r = rng.integers(1, 4)
        img[y - r:y + r + 1, x - r:x + r + 1] = 255.0
    return torch.from_numpy(img)


@pytest.mark.parametrize("active", [True, False])
def test_threshold_blur_exact(dev, active):
    rng = np.random.default_rng(0)
    img = _image(rng, 480, 752).to(dev)
    prm = dk.make_params([10.0, 5.0, 700.0, 460.0], 240.0 if active else 60.0, 8.0, 160.0, 0.6,
                         dev)
    got = dk.threshold_blur(img, prm, 5, active)
    torch.cuda.synchronize()
    assert torch.equal(got, dk.threshold_blur_plain(img, prm, 5, active))


@pytest.mark.parametrize("shape", [(192, 256), (100, 90)])
def test_detect_stats_exact(dev, shape):
    rng = np.random.default_rng(1)
    img = _image(rng, *shape).to(dev)
    prm = dk.make_params([3.0, 2.0, shape[1] - 6.0, shape[0] - 4.0], 240.0, 8.0, 160.0, 0.6, dev)
    lab, maps, top = dk.detect_stats(img, prm, 5, True, 12, 16)
    lab_p, maps_p, top_p = dk.detect_stats_plain(img, prm, 5, True, 12, 16)
    torch.cuda.synchronize()
    assert torch.equal(lab, lab_p)
    assert torch.equal(maps, maps_p)
    assert torch.equal(top, top_p)


def _tied_image(h, w):
    """Identical 3x3 saturated squares every 10 px: components of one area,
    so the ranking falls back on the flat index."""
    img = np.zeros((h, w), np.float32)
    for y in range(4, h - 4, 10):
        for x in range(4, w - 4, 10):
            img[y - 1:y + 2, x - 1:x + 2] = 255.0
    return torch.from_numpy(img)


def _seam_edge_image(rng, h, w):
    """Random blobs, plus components across the stats tiles' seams (x and y
    at multiples of 16, 24 and 32) that touch the frame's edges."""
    img = _image(rng, h, w).numpy()
    img[0:3, 20:50] = 255.0  # top edge, across x = 24, 32, 48
    img[30:36, 20:36] = 255.0  # across x = 24, 32 and y = 32
    img[h - 2:, w - 40:] = 255.0  # bottom-right corner
    img[40:60, 0:2] = 255.0  # left edge, across y = 48
    return torch.from_numpy(img)


@pytest.mark.parametrize("case,shape,k", [
    ("tied", (64, 96), 16), ("tied", (64, 96), 64), ("empty", (64, 96), 16),
    ("seam_edge", (96, 128), 16), ("random", (61, 200), 16), ("random", (480, 752), 16),
    ("random", (192, 256), 1), ("random", (192, 256), 64)])
def test_detect_stats_edge_cases_exact(dev, case, shape, k):
    """Kernel A's two-stage top-k and packed bbox sweeps against the plain
    version: more than k roots of tied areas, no foreground (k pixels of
    score 0), components across tile seams and frame edges, shapes that are
    no multiple of any tile, k = 1 and k = 64."""
    rng = np.random.default_rng(9)
    h, w = shape
    img = {"tied": lambda: _tied_image(h, w),
           "empty": lambda: torch.from_numpy(rng.uniform(0, 200, shape).astype(np.float32)),
           "seam_edge": lambda: _seam_edge_image(rng, h, w),
           "random": lambda: _image(rng, h, w)}[case]().to(dev)
    prm = dk.make_params([0.0, 0.0, float(w), float(h)], 240.0, 8.0, 160.0, 0.6, dev)
    got = dk.detect_stats(img, prm, 5, True, 12, k)
    want = dk.detect_stats_plain(img, prm, 5, True, 12, k)
    torch.cuda.synchronize()
    roots = int((want[0] == torch.arange(1, h * w + 1, device=dev).reshape(h, w)).sum())
    assert (roots > 16) if case == "tied" else (roots == 0) if case == "empty" else roots > 0
    assert torch.equal(got[0], want[0])
    for i in range(dk.N_MAPS):
        assert torch.equal(got[1][i], want[1][i]), f"map {i}"
    assert torch.equal(got[2], want[2]), (got[2].tolist(), want[2].tolist())


def _large_blob_image(rng, h, w):
    """`_image`'s noise and small blobs, a grid of 3x3 squares (more roots
    than the largest top-k) and components wider than 24 px: a ring, a long
    diagonal and a cross over the tiles' seams, which labels of more than 12
    sweeps and their halos must follow."""
    img = _image(rng, h, w).numpy()
    img[4:h - 4:10, 4:w - 4:10] = 255.0
    img[5:h - 4:10, 4:w - 4:10] = 255.0
    yy, xx = np.mgrid[:h, :w]
    r = np.hypot(yy - h * 0.4, xx - w * 0.45)
    img[(r > 18) & (r < 21)] = 255.0
    diag = np.abs((yy - 6) - 0.6 * (xx - 10)) < 1.2
    img[diag & (xx < min(w, 90))] = 255.0
    img[h // 2 - 1:h // 2 + 1, 20:min(w, 70)] = 255.0
    img[max(0, h // 2 - 30):h // 2 + 30, 45:47] = 255.0
    return torch.from_numpy(img)


@pytest.mark.parametrize("topk", SHAPE_TOPK)
@pytest.mark.parametrize("sweeps", SHAPE_SWEEPS)
@pytest.mark.parametrize("shape", [(192, 256), (100, 90)])
def test_detect_stats_every_shape_exact(dev, shape, sweeps, topk):
    """Kernel A at every sweep count and top-k of the grid (up to 12 sweeps
    and top-64 on the default shapes, the rest on the wide path's rounds)
    against the plain version on `_large_blob_image`: labels, maps and
    top-k equal."""
    rng = np.random.default_rng(sweeps + topk)
    h, w = shape
    img = _large_blob_image(rng, h, w).to(dev)
    prm = dk.make_params([0.0, 0.0, float(w), float(h)], 240.0, 8.0, 160.0, 0.6, dev)
    got = dk.detect_stats(img, prm, 5, True, sweeps, topk)
    want = dk.detect_stats_plain(img, prm, 5, True, sweeps, topk)
    torch.cuda.synchronize()
    roots = int((want[0] == torch.arange(1, h * w + 1, device=dev).reshape(h, w)).sum())
    assert roots > (topk if h * w > 40_000 else 0)  # the small frame fills with non-roots
    assert torch.equal(got[0], want[0])
    for i in range(dk.N_MAPS):
        assert torch.equal(got[1][i], want[1][i]), f"map {i}"
    assert torch.equal(got[2], want[2]), (got[2].tolist(), want[2].tolist())


@pytest.mark.parametrize("sweeps,topk", [(13, 1), (32, 128), (32, 16)])
def test_detect_stats_wide_ends_exact(dev, sweeps, topk):
    """Kernel A at the ends of the wide shapes' range, the main crop's shape."""
    test_detect_stats_every_shape_exact(dev, (192, 256), sweeps, topk)


def _band_image(h, w):
    """Dots every 6 px (one area each) with a band across the whole width
    and a column down the whole height, both over the seams of every tile
    (x and y at multiples of 16 and 32), whose labels still change at the
    32nd sweep."""
    img = np.zeros((h, w), np.float32)
    img[2:h - 3:6, 2:w - 3:6] = 255.0
    img[h // 2 - 1:h // 2 + 2, :] = 255.0
    img[:, 63:66] = 255.0
    return torch.from_numpy(img)


@pytest.mark.parametrize("topk", [16, 65, 128])
@pytest.mark.parametrize("sweeps", [13, 24, 25, 32])
def test_detect_stats_wide_band_exact(dev, sweeps, topk):
    """The wide path's rounds on components that cross every tile seam and
    need the last sweep (`_band_image`, 192x256), with more components
    than the top-k."""
    h, w = 192, 256
    img = _band_image(h, w).to(dev)
    prm = dk.make_params([0.0, 0.0, float(w), float(h)], 240.0, 8.0, 160.0, 0.6, dev)
    got = dk.detect_stats(img, prm, 5, True, sweeps, topk)
    want = dk.detect_stats_plain(img, prm, 5, True, sweeps, topk)
    torch.cuda.synchronize()
    fg = dk.threshold_blur_plain(img, prm, 5, True) > 1e-3
    assert not torch.equal(dk.label_sweeps(fg, sweeps - 1), want[0])  # the last sweep counts
    roots = int((want[0] == torch.arange(1, h * w + 1, device=dev).reshape(h, w)).sum())
    assert roots > topk
    assert torch.equal(got[0], want[0])
    for i in range(dk.N_MAPS):
        assert torch.equal(got[1][i], want[1][i]), f"map {i}"
    assert torch.equal(got[2], want[2]), (got[2].tolist(), want[2].tolist())


@pytest.mark.parametrize("sweeps,topk", [(13, 65), (20, 128), (32, 100)])
def test_detect_stats_wide_full_frame_exact(dev, sweeps, topk):
    """The wide path on a whole 480x752 frame of `_band_image`: more bbox
    tiles than SMs (rounds of several waves), sums tiles in every round,
    and ~10,000 roots, so the merge sorts its compact keys in several
    passes of at most 4,096."""
    h, w = 480, 752
    img = _band_image(h, w).to(dev)
    prm = dk.make_params([0.0, 0.0, float(w), float(h)], 240.0, 8.0, 160.0, 0.6, dev)
    got = dk.detect_stats(img, prm, 5, True, sweeps, topk)
    want = dk.detect_stats_plain(img, prm, 5, True, sweeps, topk)
    torch.cuda.synchronize()
    roots = int((want[0] == torch.arange(1, h * w + 1, device=dev).reshape(h, w)).sum())
    assert roots > 2 * 4096
    assert torch.equal(got[0], want[0])
    for i in range(dk.N_MAPS):
        assert torch.equal(got[1][i], want[1][i]), f"map {i}"
    assert torch.equal(got[2], want[2]), (got[2].tolist(), want[2].tolist())


@pytest.mark.parametrize("topk", [65, 128])
@pytest.mark.parametrize("shape", [(192, 256), (61, 200)])
def test_detect_stats_wide_topk_few_roots_exact(dev, shape, topk):
    """The wide merge on frames with fewer components than the top-k: the
    roots by rank, then the lowest flat indices that are not roots."""
    rng = np.random.default_rng(topk)
    h, w = shape
    img = _image(rng, h, w).to(dev)
    prm = dk.make_params([0.0, 0.0, float(w), float(h)], 240.0, 8.0, 160.0, 0.6, dev)
    got = dk.detect_stats(img, prm, 5, True, 12, topk)
    want = dk.detect_stats_plain(img, prm, 5, True, 12, topk)
    torch.cuda.synchronize()
    roots = int((want[0] == torch.arange(1, h * w + 1, device=dev).reshape(h, w)).sum())
    assert 0 < roots < topk
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2]), (got[2].tolist(), want[2].tolist())


def _pf_inputs(dev, n, rng, cam_move_inv=None):
    """A bank scattered around a pose, kernel B's parameters for one pass
    (its left matrix `cam_move_inv`, the identity unless given)."""
    gt = exp_se3(torch.tensor([0.02, -0.01, 0.0, 0.1, -0.2, 0.3])).to(dev)
    gt[2, 3] += 1.3
    tw = torch.from_numpy(rng.normal(0, 0.02, (n, 6)).astype(np.float32)).to(dev)
    bank = (exp_se3(tw) @ gt).reshape(n, 16).T.contiguous()
    markers = torch.cat([torch.from_numpy(rng.normal(0, 0.08, (5, 3)).astype(np.float32)),
                         torch.ones(5, 1)], 1).to(dev)
    pts = (gt @ markers.T)[:3]
    det_xy = torch.zeros(16, 2, device=dev)
    det_xy[:5, 0] = 420.0 * pts[0] / pts[2] + 376.0
    det_xy[:5, 1] = 418.0 * pts[1] / pts[2] + 240.0
    det_xy[5] = det_xy[2] + 1.5
    det_mask = torch.arange(16, device=dev) < 6
    scal = torch.tensor([420.0, 418.0, 376.0, 240.0, 10.0, 5.0, 5.0, 0.0], device=dev)
    lo = torch.tensor([-0.02] * 3 + [-0.01] * 3, device=dev)
    step = exp_se3(torch.tensor([0.001, 0.0, 0.002, 0.0, 0.01, 0.0], device=dev))
    left = torch.eye(4, device=dev) if cam_move_inv is None else cam_move_inv.to(dev)
    prm = sk.pack_params(left, step, gt, gt @ step, lo, -lo, scal, markers,
                         torch.ones(5, dtype=torch.bool, device=dev), det_xy, det_mask,
                         torch.tensor([False, True, False, False, False], device=dev))
    return bank, prm


# an observer that moved: ~1e-2 in translation and rotation (ego-motion's
# cam_move_inv, the left matrix of kernel B's compose)
OBSERVER_MOVE = (0.012, -0.008, 0.01, 0.01, -0.015, 0.008)


GREEDY_CASES = ("ties", "masked", "all_masked", "tol_inf", "tol_huge")
GREEDY_CAM = dict(fx=420.0, fy=418.0, cx=376.0, cy=240.0)


def greedy_edge_lanes(case, m, k=16, n=4099, seed=0):
    """Lanes and weight parameters on which a greedy over row minima could
    part from the reference's sweeps over the whole volume -> (bank16 (16, n)
    float32 numpy, dict of the weight's arguments after the camera, as
    `weight_particles_bank` and `weight_particles_pallas` take them, the
    true pose (4, 4)).

    Markers: 0 at x = 0 (an infinite row 0 then makes only its xc NaN: a
    volume NaN in one row), 1 and 2 at one point (rows tied across markers;
    the second match reuses the first's detection).  Detections: the
    projections with noise, an exact duplicate of the last marker's (ties
    within a row), masked ones on the exact projections of markers 0 and 1,
    the rest masked at 0.  Cases: `ties` (everything valid, a downgraded
    marker), `masked` (markers 0 and m - 1 and marker 0's detection
    masked), `all_masked` (every detection and marker 1 masked: every cell
    at 3e37 or above, tol_pf = inf, so retired rows are selected again and
    tie with masked ones), `tol_inf` / `tol_huge` (marker m - 1 masked, tol_pf
    inf / 1e19 > sqrt(3e37): after the real matches a retired row ties the
    masked row at 3e37).  Lanes: poses near the true one; from lane 2 on
    (past kernel B's pins) NaN, +inf and -inf in each of rows 0-11, a
    translation whose du * du overflows, z = 0, the true pose, all zeros."""
    rng = np.random.default_rng(seed + 100 * m + 7 * GREEDY_CASES.index(case))
    mk = rng.normal(0, 0.08, (m, 3)).astype(np.float32)
    mk[0, 0] = 0.0
    mk[2] = mk[1]
    markers = np.concatenate([mk, np.ones((m, 1), np.float32)], 1)
    gt = exp_se3(torch.tensor([0.02, -0.01, 0.0, 0.05, -0.03, 0.1])).numpy()
    gt[2, 3] += 1.2
    pts = (gt @ markers.T)[:3]
    uv = np.stack([GREEDY_CAM["fx"] * pts[0] / pts[2] + GREEDY_CAM["cx"],
                   GREEDY_CAM["fy"] * pts[1] / pts[2] + GREEDY_CAM["cy"]], 1).astype(np.float32)
    det_xy = np.zeros((k, 2), np.float32)
    det_xy[:m] = uv + rng.normal(0, 0.3, (m, 2)).astype(np.float32)
    det_xy[m] = det_xy[m - 1]
    det_xy[m + 1:m + 3] = uv[:2]
    det_mask = np.arange(k) <= m
    marker_mask = np.ones(m, bool)
    downgrade = np.zeros(m, bool)
    tol_pf = 10.0
    if case == "ties":
        downgrade[m - 1] = True
    elif case == "masked":
        marker_mask[[0, m - 1]] = False
        det_mask[0] = False
    elif case == "all_masked":
        det_mask[:] = False
        marker_mask[1] = False
        tol_pf = float("inf")
    else:
        marker_mask[m - 1] = False
        tol_pf = float("inf") if case == "tol_inf" else 1e19

    tw = torch.from_numpy(rng.normal(0, 0.01, (n, 6)).astype(np.float32))
    bank = (exp_se3(tw) @ torch.from_numpy(gt)).reshape(n, 16).T.contiguous().numpy()
    special = []
    for r in range(12):
        for val in (np.nan, np.inf, -np.inf):
            col = gt.reshape(16).copy()
            col[r] = val
            special.append(col)
    far, flat = gt.copy(), gt.copy()
    far[:3, 3] = (1e30, -3e29, 1.0)
    flat[2] = (0.0, 0.0, 0.0, 0.0)
    special += [far.reshape(16), flat.reshape(16), gt.reshape(16), np.zeros(16, np.float32)]
    special = np.stack(special, 1)[:, :max(n - 2, 0)]
    bank[:, 2:2 + special.shape[1]] = special
    args = dict(markers_h=markers, marker_mask=marker_mask, det_xy=det_xy, det_mask=det_mask,
                tol_pf=tol_pf, tol_init=5.0, downgrade=downgrade)
    return bank, args, gt


def shape_lanes(m, k, n=4099, seed=0):
    """Lanes and weight arguments at M = m markers and K = k detection slots,
    as `greedy_edge_lanes` returns them.  Markers 1 and 2 at one point (rows
    tied across markers) where m >= 3; detections: the projections of
    min(m, k - 1) markers in a shuffled order with noise, then an exact
    duplicate of the first (ties within a row), every other slot masked on
    the exact projection of a marker (padding that must never win); marker
    m - 1 masked where m >= 2; random downgrades.  Lanes: poses near the true
    one, from lane 2 on a NaN, an inf and a zero pose."""
    rng = np.random.default_rng(seed + 1000 * m + k)
    mk = rng.normal(0, 0.08, (m, 3)).astype(np.float32)
    if m >= 3:
        mk[2] = mk[1]
    markers = np.concatenate([mk, np.ones((m, 1), np.float32)], 1)
    gt = exp_se3(torch.tensor([0.02, -0.01, 0.0, 0.05, -0.03, 0.1])).numpy()
    gt[2, 3] += 1.2
    pts = (gt @ markers.T)[:3]
    uv = np.stack([GREEDY_CAM["fx"] * pts[0] / pts[2] + GREEDY_CAM["cx"],
                   GREEDY_CAM["fy"] * pts[1] / pts[2] + GREEDY_CAM["cy"]], 1).astype(np.float32)
    real = max(1, min(m, k - 1))
    order = rng.permutation(m)
    det_xy = uv[np.arange(k) % m].copy()  # padding: exact projections, masked
    det_xy[:real] = uv[order[:real]] + rng.normal(0, 0.3, (real, 2)).astype(np.float32)
    det_mask = np.arange(k) < real
    if k > real:
        det_xy[real] = det_xy[0]
        det_mask[real] = True
    marker_mask = np.ones(m, bool)
    if m >= 2:
        marker_mask[m - 1] = False
    downgrade = rng.random(m) < 0.3
    tw = torch.from_numpy(rng.normal(0, 0.01, (n, 6)).astype(np.float32))
    bank = (exp_se3(tw) @ torch.from_numpy(gt)).reshape(n, 16).T.contiguous().numpy()
    bank[0, 2], bank[3, 3], bank[:, 4] = np.nan, np.inf, 0.0
    args = dict(markers_h=markers, marker_mask=marker_mask, det_xy=det_xy, det_mask=det_mask,
                tol_pf=10.0, tol_init=5.0, downgrade=downgrade)
    return bank, args, gt


def _card_params(dev, bank, a, gt):
    """Lanes and weight arguments on the card: the bank and kernel B's
    parameters (a small noise step from the true pose; kernel E's are their
    tail)."""
    t = lambda x: torch.as_tensor(x).to(dev)
    gt = t(gt)
    nms = torch.tensor(float(a["marker_mask"].sum()))
    scal = torch.tensor([GREEDY_CAM["fx"], GREEDY_CAM["fy"], GREEDY_CAM["cx"], GREEDY_CAM["cy"],
                         a["tol_pf"], a["tol_init"], nms, 0.0], device=dev)
    lo = torch.tensor([-0.02] * 3 + [-0.01] * 3, device=dev)
    step = exp_se3(torch.tensor([0.001, 0.0, 0.002, 0.0, 0.01, 0.0])).to(dev)
    prm = sk.pack_params(torch.eye(4, device=dev), step, gt, gt @ step, lo, -lo, scal,
                         t(a["markers_h"]), t(a["marker_mask"]), t(a["det_xy"]),
                         t(a["det_mask"]), t(a["downgrade"]))
    return t(bank), prm


def _greedy_inputs(dev, case, m, n):
    """`greedy_edge_lanes` on the card (`_card_params`)."""
    return _card_params(dev, *greedy_edge_lanes(case, m, 16, n))


def _check_pf_kernels(bank, prm, m, k):
    """Kernels E and B (weights only and with pairs) against their plain
    versions: weights, pairs, pair counts and banks equal (NaN where the
    twin's bank is NaN) -> the plain weight's pair counts."""
    wprm = prm[76:].contiguous()
    got, want = wk.weight(bank, wprm, m, k), wk.weight_plain(bank, wprm, m, k)
    keys = (5, 6, 7, 8)
    got_b = sk.pf_step(bank, prm, keys, m, k)
    got_p = sk.pf_step(bank, prm, keys, m, k, want_pairs=True)
    want_p = sk.pf_step_plain(bank, prm, keys, m, k, want_pairs=True)
    torch.cuda.synchronize()
    n = bank.shape[1]
    differ = (got[0] != want[0]) | (got[1] != want[1]).any(0).any(0) | (got[2] != want[2])
    assert not bool(differ.any()), f"E differs from plain on {int(differ.sum())} of {n} lanes"
    assert _equal_nan(got_p[0], want_p[0]) and _equal_nan(got_b[0], want_p[0])
    assert torch.equal(got_p[2], want_p[2]) and torch.equal(got_p[3], want_p[3])
    assert torch.equal(got_p[1], want_p[1]) and torch.equal(got_b[1], want_p[1])
    return want[2]


@pytest.mark.parametrize("k", SHAPE_K)
@pytest.mark.parametrize("m", SHAPE_M)
def test_pf_kernels_every_shape_exact(dev, m, k):
    """Kernels E and B (both variants) at every bucket of K and M
    (`shape_lanes`: ties across and within rows, masked padding on exact
    projections, a masked marker, NaN and inf lanes) against their plain
    versions, bit for bit."""
    n_corr = _check_pf_kernels(*_card_params(dev, *shape_lanes(m, k)), m, k)
    assert int(n_corr.max()) >= max(1, min(m, k - 1) - 1)  # the pinned lanes match


@pytest.mark.parametrize("m,k", [(9, 32), (9, 128), (32, 64), (32, 128)])
@pytest.mark.parametrize("case", GREEDY_CASES)
def test_greedy_edge_cases_wide_exact(dev, case, m, k):
    """`greedy_edge_lanes` at the wide form's shapes, bit for bit."""
    _check_pf_kernels(*_card_params(dev, *greedy_edge_lanes(case, m, k, 1029)), m, k)


def split_lanes(m, k, n=1029, seed=0, odd=None):
    """`shape_lanes` where the wide form's two lists of detections tie: the
    slots are laid out as masked exact copies of the first real detections,
    then the real ones, then the other masked slots, so a masked copy has
    the lower k; tol_pf = inf, so masked cells are selected once the real
    ones are retired; and lanes 5-8 sit where every cell overflows to inf
    (a row's minimum reaches the masked slots' bound and ties across both
    lists).  `odd` = (slot, x, mask term) sets one slot to values outside
    the real / masked split (an infinite x, a mask term of 1 or -1)."""
    bank, a, gt = shape_lanes(m, k, n, seed)
    real = np.flatnonzero(a["det_mask"])
    masked = np.flatnonzero(~a["det_mask"])
    n_copy = min(len(real), len(masked))
    xy = a["det_xy"]
    det_xy = np.concatenate([xy[real[:n_copy]], xy[real], xy[masked[n_copy:]]])
    det_mask = np.arange(k) >= n_copy
    det_mask[n_copy + len(real):] = False
    a = dict(a, det_xy=det_xy, det_mask=det_mask, tol_pf=float("inf"))
    far = gt.copy()
    far[:3, 3] = (3e19, -3e19, 1.0)
    bank[:, 5:9] = far.reshape(16, 1)
    if odd is not None:
        slot, x, big = odd
        a["det_xy"][slot, 0] = x
        a["det_big"] = (slot, big)
    return bank, a, gt


def _split_params(dev, bank, a, gt):
    """`_card_params`, with a["det_big"] = (slot, mask term) written into
    the packed parameters where given."""
    big = a.pop("det_big", None)
    bank_t, prm = _card_params(dev, bank, a, gt)
    if big is not None:
        m, k = len(a["marker_mask"]), len(a["det_mask"])
        prm[76 + 8 + 4 * m + 2 * k + big[0]] = big[1]
    return bank_t, prm


@pytest.mark.parametrize("odd", [None, (0, float("inf"), 0.0), (1, 30.0, 1.0), (2, 30.0, -1.0)])
@pytest.mark.parametrize("m,k", [(5, 32), (9, 17), (10, 127), (31, 64)])
def test_greedy_wide_split_ties_exact(dev, m, k, odd):
    """Kernels E and B (both variants) where the wide form's real and
    masked detections tie (`split_lanes`), and on detections outside the
    real / masked split (an infinite x, mask terms 1 and -1), bit for bit."""
    if odd is not None and odd[0] >= k:
        pytest.skip("no such slot")
    n_corr = _check_pf_kernels(*_split_params(dev, *split_lanes(m, k, odd=odd)), m, k)
    assert int(n_corr.max()) >= min(m - 1, k)


@pytest.mark.parametrize("n", [4099, 45])
@pytest.mark.parametrize("m", range(3, 9))
@pytest.mark.parametrize("case", GREEDY_CASES)
def test_greedy_edge_cases_exact(dev, case, m, n):
    """Kernels E and B (weights only and with pairs) against their plain
    versions on `greedy_edge_lanes`: weights, pairs, pair counts and banks
    equal (NaN where the twin's bank is NaN)."""
    n_corr = _check_pf_kernels(*_greedy_inputs(dev, case, m, n), m, 16)
    assert int((n_corr == 0).sum()) >= 12  # the NaN lanes form no pair
    if case == "ties":
        assert int(n_corr.max()) == m  # some lane matched every marker


def _equal_nan(a, b):
    """torch.equal, with NaN equal to NaN (the NaN and infinite pose rows
    stay NaN through the propagation)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def test_pf_step_wide_angles_exact(dev):
    """Kernel B's sincosf against torch.sin and torch.cos (sinf, cosf) on
    noise angles up to 3e5 rad, where the math library reduces the angle
    on its slow path: the bank equal bit for bit."""
    rng = np.random.default_rng(8)
    bank, prm = _pf_inputs(dev, 4099, rng)
    prm[64:70] = torch.tensor([-3e5, 3e5] * 3, device=dev)
    keys = (21, 22, 23, 24)
    got_b, got_w = sk.pf_step(bank, prm, keys, 5, 16)
    want_b, want_w = sk.pf_step_plain(bank, prm, keys, 5, 16)
    torch.cuda.synchronize()
    assert float(want_b[0].abs().max()) > 0.5  # the rotations are far from the identity
    assert torch.equal(got_b, want_b) and torch.equal(got_w, want_w)


@pytest.mark.parametrize("n,offset", [(4099, 0), (2048, 1000)])
def test_pf_step_matches_plain(dev, n, offset):
    rng = np.random.default_rng(2)
    bank, prm = _pf_inputs(dev, n, rng)
    keys = (*prng.split(prng.prng_key(3))[0], *prng.split(prng.prng_key(3))[1])
    got_b, got_w = sk.pf_step(bank, prm, keys, 5, 16, lane_offset=offset, n_total=8192)
    want_b, want_w = sk.pf_step_plain(bank, prm, keys, 5, 16, lane_offset=offset, n_total=8192)
    torch.cuda.synchronize()
    assert torch.equal(got_b, want_b)
    assert torch.equal(got_w, want_w)
    assert float(got_w.max()) > 20.0


@pytest.mark.parametrize("n,offset", [(4099, 0), (2048, 1000), (100_000, 0)])
def test_pf_step_moving_observer_exact(dev, n, offset):
    """Kernel B with a cam_move_inv that is not the identity (the observer's
    ego-motion): bank and weights equal to the plain version bit for bit, as
    with the identity, and the bank moved by it."""
    rng = np.random.default_rng(2)
    move = exp_se3(torch.tensor(OBSERVER_MOVE))
    bank, prm = _pf_inputs(dev, n, rng, cam_move_inv=move)
    _, prm_still = _pf_inputs(dev, n, np.random.default_rng(2))
    keys = (*prng.split(prng.prng_key(3))[0], *prng.split(prng.prng_key(3))[1])
    got_b, got_w = sk.pf_step(bank, prm, keys, 5, 16, lane_offset=offset, n_total=n + offset)
    want_b, want_w = sk.pf_step_plain(bank, prm, keys, 5, 16, lane_offset=offset,
                                      n_total=n + offset)
    still_b, _ = sk.pf_step(bank, prm_still, keys, 5, 16, lane_offset=offset, n_total=n + offset)
    torch.cuda.synchronize()
    assert torch.equal(got_b, want_b)
    assert torch.equal(got_w, want_w)
    assert float((got_b - still_b)[:12].abs().max()) > 1e-3


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_pf_pass_moving_observer_exact(dev, shards):
    """The sharded pass (`parallel/pf_kernels.py`: kernel B on each shard at
    its lane offset) with a moving observer equals the whole-bank pass bit
    for bit, and both equal the plain version."""
    from pf_monocular_pose_estimator_tpu_torch.geometry import Camera
    from pf_monocular_pose_estimator_tpu_torch.parallel.pf_kernels import make_sharded_pf_fn
    from pf_monocular_pose_estimator_tpu_torch.pf.propagate import NoiseBounds
    from pf_monocular_pose_estimator_tpu_torch.utils import TrackerConfig

    n = 20_000
    rng = np.random.default_rng(5)
    bank, prm = _pf_inputs(dev, n, rng)
    cam = Camera.create(420.0, 418.0, 376.0, 240.0).to(dev)
    gt = prm[32:48].reshape(4, 4)  # the current pose of _pf_inputs
    step = exp_se3(torch.tensor([0.001, 0.0, 0.002, 0.0, 0.01, 0.0])).to(dev)
    move = exp_se3(torch.tensor(OBSERVER_MOVE)).to(dev)
    markers = torch.cat([torch.from_numpy(rng.normal(0, 0.08, (5, 3)).astype(np.float32)),
                         torch.ones(5, 1)], 1).to(dev)
    det_xy = torch.zeros(16, 2, device=dev)
    det_xy[:5] = project_markers(cam, move @ gt @ step, markers)
    det_mask = torch.arange(16, device=dev) < 5
    noise = NoiseBounds(*(torch.tensor(v, device=dev) for v in (-0.02, 0.02, -0.01, 0.01)))
    args = (prng.prng_key(9), bank, gt, move @ gt @ step, step, move, noise,
            torch.tensor(1.0, device=dev), torch.tensor(1.0, device=dev), True, True, 1.0)
    weigh = (markers, torch.ones(5, dtype=torch.bool, device=dev), det_xy, det_mask,
             torch.tensor(10.0, device=dev), torch.tensor(5.0, device=dev),
             torch.zeros(5, dtype=torch.bool, device=dev), 5.0)
    want_b, want_w = sk.fused_propagate_weight(*args, cam, *weigh, want_pairs=False)
    mesh = LocalMesh(shards)
    pf_fn = make_sharded_pf_fn(mesh, cam, TrackerConfig(n_particles=n))
    before = sk.pf_step.launches
    got_b, got_w = pf_fn(args[0], shard_lanes(mesh, bank), *args[2:], *weigh)
    prm_m, keys4 = sk.step_params(args[0], *args[2:], cam, *weigh)
    plain_b, plain_w = sk.pf_step_plain(bank, prm_m, keys4, 5, 16)
    torch.cuda.synchronize()
    assert sk.pf_step.launches == before + shards
    assert torch.equal(unshard_lanes(mesh, got_b), want_b)
    assert torch.equal(unshard_lanes(mesh, got_w), want_w)
    assert torch.equal(want_b, plain_b) and torch.equal(want_w, plain_w)
    assert float(want_w.max()) > 20.0  # the moved detections are matched


def project_markers(cam, pose, markers):
    from pf_monocular_pose_estimator_tpu_torch.geometry import project

    return project(cam, pose, markers)


def test_pf_step_pairs_matches_plain(dev):
    rng = np.random.default_rng(3)
    bank, prm = _pf_inputs(dev, 5000, rng)
    keys = (11, 12, 13, 14)
    got = sk.pf_step(bank, prm, keys, 5, 16, want_pairs=True)
    want = sk.pf_step_plain(bank, prm, keys, 5, 16, want_pairs=True)
    weights_only = sk.pf_step(bank, prm, keys, 5, 16)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert torch.equal(got[0], weights_only[0]) and torch.equal(got[1], weights_only[1])


def test_weight_kernel_matches_plain(dev):
    rng = np.random.default_rng(5)
    bank, prm = _pf_inputs(dev, 7001, rng)
    got = wk.weight(bank, prm[76:].contiguous(), 5, 16)
    want = wk.weight_plain(bank, prm[76:], 5, 16)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert int(got[2].max()) >= 4


@pytest.mark.parametrize("profile", ["covered", "spread"])
def test_resample_decode_matches_plain(dev, profile):
    n = 20_000
    gen = torch.Generator().manual_seed(1)
    if profile == "covered":
        w = torch.softmax(0.8 * torch.randn(n, generator=gen), 0)
    else:
        lane = torch.arange(n)
        w = torch.where(lane < n // 2, (lane % 8 == 0).float(), torch.ones(n))
        w = w / w.sum()
    bank = torch.randn(16, n, generator=gen).to(dev)
    rank, counts, _ = fk.probe_rank(prng.prng_key(2), w.to(dev))
    out, ok = fk.decode(rank, bank)
    out_p, ok_p = fk.decode_plain(rank, bank)
    torch.cuda.synchronize()
    assert torch.equal(ok, ok_p) and torch.equal(out, out_p)
    assert bool(ok.all()) == (profile == "covered")
    if profile == "covered":
        anc = torch.repeat_interleave(torch.arange(n, device=dev), counts.long())
        assert torch.equal(out, bank[:, anc])


@pytest.mark.parametrize("spread", [False, True])
def test_monotone_gather_matches_plain(dev, spread):
    # n a multiple of 128: the coverage rule's last window start,
    # (n - 2048) // 128 * 128, then reaches the bank's last lane
    n = 20_480
    rng = np.random.default_rng(8)
    bank, prm = _pf_inputs(dev, n, rng)
    if spread:
        anc = torch.cat([torch.zeros(256), torch.full((n - 256,), n - 1)]).long().to(dev)
    else:
        _, w = sk.pf_step(bank, prm, (1, 2, 3, 4), 5, 16)
        anc, _, _ = stratified_resample_soa(prng.prng_key(5), w / w.sum())
    out, ok = gk.windowed_gather(bank, anc)
    out_p, ok_p = gk.monotone_gather_plain(bank, anc)
    torch.cuda.synchronize()
    assert torch.equal(ok, ok_p) and torch.equal(out, out_p)
    if bool(ok.all()):
        assert torch.equal(out, sk.resample_gather_plain(bank, anc))
    assert bool(ok.all()) != spread


def _hand_rank(case, n):
    """Hand-made ranks with rank[n - 1] = n, as in tests/test_torch_resample.py:
    every slot on one ancestor; a block's ancestors over more chunks than its
    window; one chunk-last rank stepping down below a block start that the
    chunks before it exceed (a count and a search of the chunk-last ranks
    then disagree, and the count is the reference's)."""
    j = torch.arange(n)
    if case == "one_chunk":
        return torch.where(j < 3000, 0, n).int()
    if case == "coarse_past_window":
        rank = j // 16
        rank[-1] = n
        return rank.int()
    rank = j + 1
    rank[20 * 128 + 127] = 2000
    return rank.int()


@pytest.mark.parametrize("case,n,block,win_chunks", [
    ("covered", 1536, 1024, 12), ("covered", 6001, 1024, 12), ("spread", 4097, 1024, 12),
    ("covered", 1_000_000, 1024, 12), ("spread", 1_000_000, 1024, 12),
    ("one_chunk", 6001, 1024, 12), ("coarse_past_window", 6001, 1024, 12),
    ("step_down", 6001, 1024, 12), ("covered", 6001, 1000, 12), ("spread", 20_000, 128, 12),
    ("covered", 20_000, 1024, 100), ("spread", 1_000_000, 128, 12),
    ("covered", 1_000_000, 100, 12)])
def test_resample_decode_edge_cases_exact(dev, case, n, block, win_chunks):
    """Kernel F against its plain version on every block, covered or not: N
    equal to the window, N not a multiple of 128 or of 4, a last block of one
    slot, 1,000,000 lanes, hand-made ranks, logical blocks that are not a
    multiple of the CUDA block, and a window above 48 KB of rank.  Up to
    131,072 lanes each decode block counts its window start; above, one
    launch counts them all (in two passes of its histogram at block 100)."""
    gen = torch.Generator().manual_seed(n)
    bank = torch.randn(16, n, generator=gen).to(dev)
    if case in ("covered", "spread"):
        if case == "covered":
            w = torch.softmax(0.8 * torch.randn(n, generator=gen), 0)
        else:
            lane = torch.arange(n)
            w = torch.where(lane < n // 2, (lane % 8 == 0).float(), torch.ones(n))
            w = w / w.sum()
        rank = fk.probe_rank(prng.prng_key(4), w.to(dev))[0]
    else:
        rank = _hand_rank(case, n).to(dev)
    out, ok = fk.decode(rank, bank, block, win_chunks)
    out_p, ok_p = fk.decode_plain(rank, bank, block, win_chunks)
    torch.cuda.synchronize()
    assert torch.equal(ok, ok_p) and torch.equal(out, out_p)
    if case in ("spread", "coarse_past_window") and block == 1024:
        assert not bool(ok.all())
    if case == "step_down":
        last = rank[127::128].long()
        t0 = torch.arange(ok.numel(), device=dev) * block
        count = (last[None, :] <= t0[:, None]).sum(1)
        assert bool((count != torch.searchsorted(last, t0, right=True)).any())


@pytest.mark.parametrize("n,block,window,kind", [
    (2048, 512, 2048, "uniform"), (6001, 512, 2048, "uniform"), (4097, 512, 2048, "skew"),
    (1_000_000, 512, 2048, "uniform"), (6001, 128, 2048, "uniform"), (6001, 1024, 2048, "skew"),
    (6001, 512, 1024, "uniform")])
def test_monotone_gather_edge_cases_exact(dev, n, block, window, kind):
    """Kernel G against its plain version on every block, covered or not
    (uncovered blocks read their window's nearest edge): N equal to the
    window, N not a multiple of 128 or of 4, a last block of one slot,
    1,000,000 lanes, other blocks and a narrower window."""
    rng = np.random.default_rng(n + block + window)
    anc = np.sort(rng.integers(0, n, n))
    if kind == "skew":  # the middle third crowds onto a few ancestors
        anc[n // 3: 2 * n // 3] = np.sort(rng.integers(0, 4, 2 * n // 3 - n // 3)) * (n // 4)
        anc = np.sort(anc)
    bank = torch.randn(16, n, generator=torch.Generator().manual_seed(n)).to(dev)
    anc = torch.from_numpy(anc).to(dev)
    out, ok = gk.windowed_gather(bank, anc, block, window)
    out_p, ok_p = gk.monotone_gather_plain(bank, anc, block, window)
    torch.cuda.synchronize()
    assert torch.equal(ok, ok_p) and torch.equal(out, out_p)
    assert bool(ok.all()) == (kind == "uniform" and n % 128 == 0)


def test_resample_gather_exact(dev):
    rng = np.random.default_rng(4)
    bank, prm = _pf_inputs(dev, 10_000, rng)
    _, w = sk.pf_step(bank, prm, (1, 2, 3, 4), 5, 16)
    anc, _, _ = stratified_resample_soa(prng.prng_key(5), w / w.sum())
    got = sk.resample_gather(bank, anc)
    torch.cuda.synchronize()
    assert torch.equal(got, sk.resample_gather_plain(bank, anc))


@pytest.mark.parametrize("s", [25_000, 4099, 4098, 45])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("profile", ["window", "full_blocks", "identity"])
def test_ring_gather_exact(dev, profile, shards, s):
    """Kernel H, one launch over L shards, at S = 25,000 (N = 100,000 over
    P = 4), at odd shard sizes that rule out its 8-byte vector stores, and
    at an even one that is no multiple of 4.  Each shard's own block is the
    top of its (16, S) bank and the others are views of the other shards'
    rows, the window profile's tail at an unaligned lane offset; positions
    land in every block, and clamped draws break their order."""
    rng = np.random.default_rng(7)
    mesh = LocalMesh(shards)
    bank = torch.from_numpy(rng.normal(size=(shards, 16, s)).astype(np.float32)).to(dev)
    top12 = bank[:, :12]
    w = s // 4
    received = {"window": [list(top12), mesh.receive(top12[:, :, :w], -1),
                           mesh.receive(top12[:, :, s - w:], 1)],
                "full_blocks": [mesh.receive(top12, d) for d in (0, -1, 1, -2, 2)],
                "identity": [list(top12)]}[profile]
    blocks = [list(shard) for shard in zip(*received)]
    total = sum(b.shape[1] for b in blocks[0])
    if profile == "identity":
        pos = torch.arange(s, dtype=torch.int32).repeat(shards, 1)
    else:
        pos = np.sort(rng.integers(0, total, (shards, s)), axis=1).astype(np.int32)
        pos[:, ::97] = pos[:, s // 2:s // 2 + 1]
        pos[:, 0], pos[:, -1] = 0, total - 1
        pos = torch.from_numpy(pos)
    pos = pos.to(dev)
    before = hk.ring_gather.launches
    got = hk.ring_gather(blocks, pos)
    torch.cuda.synchronize()
    assert hk.ring_gather.launches == before + 1
    assert got.shape == (shards, 16, s)
    assert torch.equal(got, hk.ring_gather_plain(blocks, pos))
    if profile == "identity":
        assert torch.equal(got[:, :12], bank[:, :12])
        assert got[:, 12:].transpose(1, 2).reshape(-1, 4).unique(dim=0).tolist() == \
            [[0.0, 0.0, 0.0, 1.0]]


@pytest.mark.parametrize("window", ["auto", None])
def test_sharded_resampler_exact_across_widths(dev, window):
    """The ring resampler on the card (kernel H, one launch over the local
    shards) equals the single-device sort resampler + kernel C at every
    width."""
    rng = np.random.default_rng(8)
    n = 20_000
    bank, prm = _pf_inputs(dev, n, rng)
    _, w = sk.pf_step(bank, prm, (1, 2, 3, 4), 5, 16)
    w = w / w.sum()
    anc, counts, most = stratified_resample_soa(prng.prng_key(5), w)
    want = sk.resample_gather(bank, anc)
    for p in (1, 2, 4, 8):
        mesh = LocalMesh(p)
        before = hk.ring_gather.launches
        out = make_distributed_resampler(mesh, n, payload_window=window)(
            prng.prng_key(5), shard_lanes(mesh, w), shard_lanes(mesh, bank))
        torch.cuda.synchronize()
        assert hk.ring_gather.launches == before + 1
        assert torch.equal(unshard_lanes(mesh, out.resampled), want)
        assert torch.equal(unshard_lanes(mesh, out.counts).long(), counts.long())
        assert int(out.most) == int(most) and int(out.clipped) == 0


def _gn_batch(m, b, dev):
    """B hypotheses of M markers near a pose 1.4 m in front of the camera.
    Hypothesis 0 starts at the optimum of noise-free pairs, so it freezes at
    iteration 1; the last one (for B = 1: the only one, at even M) starts far
    along the optical axis, at the first distance and tilt from which GN ends
    with a larger error than it began with (the divergence revert)."""
    rng = np.random.default_rng(10 * m + b)
    gt = exp_se3(torch.tensor([0.02, -0.01, 0.0, 0.1, 0.2, 0.0]))
    gt[2, 3] += 1.4
    mark = torch.from_numpy(rng.normal(0, 0.08, (3, m)).astype(np.float32))
    pts = gt[:3, :3] @ mark + gt[:3, 3:]
    u, v = 420.0 * pts[0] / pts[2] + 376.0, 418.0 * pts[1] / pts[2] + 240.0
    du = u.repeat(b, 1) + torch.from_numpy(rng.normal(0, 0.3, (b, m)).astype(np.float32))
    dv = v.repeat(b, 1) + torch.from_numpy(rng.normal(0, 0.3, (b, m)).astype(np.float32))
    poses = (exp_se3(torch.from_numpy(rng.normal(0, 0.02, (b, 6)).astype(np.float32))) @ gt)
    poses = poses.reshape(b, 16)
    mask = torch.from_numpy((rng.random((b, m)) > 0.1).astype(np.float32))
    scal = torch.tensor([420.0, 418.0, 376.0, 240.0], device=dev)
    frozen, diverging = (0, b - 1) if b > 1 else ((None, 0) if m % 2 == 0 else (0, None))
    if frozen is not None:
        poses[frozen], du[frozen], dv[frozen], mask[frozen] = gt.reshape(16), u, v, 1.0
    if diverging is not None:
        mask[diverging] = 1.0
        far = torch.stack([(exp_se3(torch.tensor([0.0, 0.0, z, rx, 0.0, 0.0])) @ gt).reshape(16)
                           for z in (3.0, 5.0, 10.0, 20.0, 40.0, 80.0)
                           for rx in (0.0, 0.3, -0.5, 1.0)])
        n = far.shape[0]
        rep = lambda x: x[diverging].repeat(n, 1).to(dev)
        stats = rk.gn_refine_plain(scal, far.to(dev), mark.to(dev), rep(du), rep(dv), rep(mask),
                                   25, 1e-4)[1]
        hits = torch.nonzero(stats[:, 5] > 0).flatten()
        assert hits.numel() > 0, "no far start diverged"
        poses[diverging] = far[int(hits[0])]
    args = (scal, poses.to(dev), mark.to(dev), du.to(dev), dv.to(dev), mask.to(dev))
    return args, frozen, diverging


@pytest.mark.parametrize("b", [1, 11, 40])
@pytest.mark.parametrize("m", range(1, 9))
def test_gn_refine_every_m_exact(dev, m, b):
    """Kernel D (one warp a hypothesis, M a template parameter) against its
    plain version at every M and several batch sizes, with a hypothesis that
    freezes at iteration 1 and one that diverges: all three outputs equal
    bit for bit."""
    args, frozen, diverging = _gn_batch(m, b, dev)
    got = rk.gn_refine(*args, 25, 1e-4)
    want = rk.gn_refine_plain(*args, 25, 1e-4)
    torch.cuda.synchronize()
    if frozen is not None:
        assert float(want[1][frozen, 2]) == 1.0 and float(want[1][frozen, 4]) == 1.0
    if diverging is not None:
        assert float(want[1][diverging, 5]) == 1.0
        assert torch.equal(want[0][diverging], args[1][diverging])
    for g, w in zip(got, want):  # a diverged run may leave NaN in its normal matrix
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("b", [11, 65])
@pytest.mark.parametrize("m", SHAPE_M)
def test_gn_refine_every_shape_exact(dev, m, b):
    """Kernel D at the shape grid's marker counts (9, 16 and 32 on the
    runtime-count instantiation) against its plain version, bit for bit."""
    test_gn_refine_every_m_exact(dev, m, b)


def test_gn_refine_matches_plain(dev):
    rng = np.random.default_rng(6)
    b, m = 11, 5
    poses = (exp_se3(torch.from_numpy(rng.normal(0, 0.01, (b, 6)).astype(np.float32)))
             @ exp_se3(torch.tensor([0.0, 0.0, 1.4, 0.1, 0.2, 0.0]))).reshape(b, 16).to(dev)
    mark = torch.from_numpy(rng.normal(0, 0.08, (3, m)).astype(np.float32)).to(dev)
    du = torch.from_numpy(rng.uniform(300, 450, (b, m)).astype(np.float32)).to(dev)
    dv = torch.from_numpy(rng.uniform(200, 280, (b, m)).astype(np.float32)).to(dev)
    mask = torch.from_numpy((rng.random((b, m)) > 0.15).astype(np.float32)).to(dev)
    scal = torch.tensor([420.0, 418.0, 376.0, 240.0], device=dev)
    got = rk.gn_refine(scal, poses.contiguous(), mark, du, dv, mask, 25, 1e-4)
    want = rk.gn_refine_plain(scal, poses, mark, du, dv, mask, 25, 1e-4)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(ValueError):
        dk.threshold_blur(torch.zeros(8, 8, device=dev), torch.zeros(11, device=dev), 5)
    with pytest.raises(ValueError):  # fewer pixels than the top-k asks for
        dk.detect_stats(torch.zeros(4, 4, device=dev), torch.zeros(12, device=dev), 5, topk=17)
    with pytest.raises(ValueError):
        dk.threshold_blur(torch.zeros(8, 8, device=dev), torch.zeros(12), 5)
    with pytest.raises(ValueError):
        sk.resample_gather(torch.zeros(16, 4, device=dev), torch.zeros(4, dtype=torch.int32,
                                                                        device=dev))
    with pytest.raises(ValueError):
        fk.decode(torch.zeros(100, dtype=torch.int32, device=dev), torch.zeros(16, 100, device=dev))
    with pytest.raises(ValueError):
        gk.windowed_gather(torch.zeros(16, 4096, device=dev),
                           torch.zeros(4096, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        hk.ring_gather([torch.zeros(12, 8, device=dev)], torch.zeros(8, dtype=torch.int64,
                                                                     device=dev))
    with pytest.raises(ValueError):
        hk.ring_gather([torch.zeros(12, 8)], torch.zeros(8, dtype=torch.int32, device=dev))


def test_bench_no_cache_builds_into_a_temporary_directory(dev, monkeypatch, capsys):
    """`bench_torch.py --no-cache` builds the kernel library with nvcc into a
    fresh temporary directory, runs on it, and leaves build/torch_kernels/
    as it was."""
    import sys
    import tempfile
    from pathlib import Path

    from pf_monocular_pose_estimator_tpu_torch.utils import cuda_lib

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import bench_torch

    def listing():
        d = cuda_lib.build_dir()
        return {p.name: (p.stat().st_mtime_ns, p.stat().st_size) for p in d.iterdir()} \
            if d.exists() else {}

    before = listing()
    built = []
    real = cuda_lib.cached_build

    def spy(*args, **kwargs):
        so = real(*args, **kwargs)
        built.append(so)
        return so

    monkeypatch.setattr(cuda_lib, "cached_build", spy)
    monkeypatch.setattr(cuda_lib, "_lib", cuda_lib._lib)  # the library loaded before, back after
    line = bench_torch.main(["--no-cache", "--particles", "2000", "--frames", "4", "--runs", "1"])
    assert line["updated_frames_fraction"] == 1.0
    assert len(built) == 1
    so = built[0]
    assert Path(tempfile.gettempdir()) in so.parents and cuda_lib.build_dir() not in so.parents
    assert not so.parent.exists()  # removed when the run ended
    assert cuda_lib._lib._name == str(so)
    assert listing() == before
