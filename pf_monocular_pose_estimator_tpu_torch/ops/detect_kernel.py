"""Detection front-end kernel A (csrc/detect.cu) and its plain versions.

Ports the reference's Pallas kernels `ops/pallas_kernels.py::
threshold_blur_pallas` and `::detect_stats_pallas` with their semantics:
zero blur borders, exactly `sweeps` sweeps of 3x3 max-label propagation,
windowed same-label moment sums at reach = sweeps, bbox extrema by
`sweeps` same-label min/max sweeps, and the top-k roots ranked by the
exact in-range-lifted component count, lowest flat index on ties.

Both wrappers take one float32 parameter vector on the image's device:
  [x0, y0, roi_w, roi_h, threshold, min_area, max_area, taps...]
The crop path's epilogue, `detect_epilogue`, takes A's outputs to the
finished detection bank in one launch (csrc/detect.cu); its vector goes on
with [wh_tol, circ_tol, offset_x, offset_y].  For a CPU tensor each wrapper
runs the plain version; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry.camera import Camera, undistort_pixels
from ..utils import cuda_lib
from ..utils.config import BlobParams
from ..utils.sync import upload

N_MAPS = 10  # cnt, sx, sy, xmin, xmax, ymin, ymax, sxx, syy, sxy
# What kernel A's `detect_stats` takes on the card (csrc/detect.cu): every
# 0 <= sweeps <= MAX_SWEEPS and 1 <= topk <= min(MAX_TOPK, pixels).  Up to 12
# sweeps with a top-k of up to 64 run the default shapes, the rest the wide
# path (label and bbox rounds, more launches than the default's four).
MAX_SWEEPS = 32
MAX_TOPK = 128
N_EPILOGUE = 4  # the epilogue's values after the taps: wh_tol, circ_tol, offset x and y
_IMAX = 2**31 - 1  # the compaction's key of an empty entry


def check_card_shape(sweeps: int, topk: int, pixels: int) -> None:
    """Raise unless kernel A takes `sweeps` and `topk` on `pixels` pixels."""
    if not 0 <= sweeps <= MAX_SWEEPS or not 1 <= topk <= min(MAX_TOPK, pixels):
        raise ValueError(f"detect_stats: the kernel takes 0 <= sweeps <= {MAX_SWEEPS} and "
                         f"1 <= topk <= min({MAX_TOPK}, pixels) (got sweeps = {sweeps}, "
                         f"topk = {topk}, {pixels} pixels)")


def gaussian_taps(sigma: float) -> np.ndarray:
    """OpenCV-compatible odd Gaussian kernel (reference `_gaussian_kernel_1d`)."""
    if sigma <= 0:
        return np.array([1.0], dtype=np.float32)
    ksize = int(round(sigma * 3.0)) * 2 + 1
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def make_params(roi, threshold, min_area, max_area, sigma: float, device) -> torch.Tensor:
    """Pack the kernel's parameter vector (all float32, on `device`)."""
    f = lambda v: upload(v, device).reshape(-1)
    taps = upload(gaussian_taps(sigma), device)
    return torch.cat([f(roi), f(threshold), f(min_area), f(max_area), taps])


def shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = x[y - dy, x - dx], zero outside the frame."""
    h, w = x.shape
    out = torch.zeros_like(x)
    ys, yd = (slice(0, h - dy), slice(dy, h)) if dy >= 0 else (slice(-dy, h), slice(0, h + dy))
    xs, xd = (slice(0, w - dx), slice(dx, w)) if dx >= 0 else (slice(-dx, w), slice(0, w + dx))
    out[yd, xd] = x[ys, xs]
    return out


def _thresholded(img: torch.Tensor, prm: torch.Tensor, active: bool) -> torch.Tensor:
    h, w = img.shape
    xs = torch.arange(w, device=img.device, dtype=torch.float32)[None, :]
    ys = torch.arange(h, device=img.device, dtype=torch.float32)[:, None]
    x0, y0, rw, rh, thr = prm[0], prm[1], prm[2], prm[3], prm[4]
    in_roi = (xs >= x0) & (xs < x0 + rw) & (ys >= y0) & (ys < y0 + rh)
    zero = torch.zeros((), dtype=torch.float32, device=img.device)
    if active:
        tz = torch.where(img > thr, img, zero)  # THRESH_TOZERO
    else:
        tz = torch.where(img > thr, zero, torch.full_like(zero, 255.0))  # THRESH_BINARY_INV
    return torch.where(in_roi, tz, zero)


def threshold_blur_plain(img: torch.Tensor, prm: torch.Tensor, ntaps: int, active: bool):
    """ROI mask + threshold + separable blur with zero borders, the
    reference's tap order (rows, then columns)."""
    tz = _thresholded(img, prm, active)
    taps = prm[7 : 7 + ntaps]
    half = ntaps // 2
    acc = torch.zeros_like(tz)
    for i in range(ntaps):
        acc = acc + taps[i] * shift2d(tz, i - half, 0)
    out = torch.zeros_like(acc)
    for i in range(ntaps):
        out = out + taps[i] * shift2d(acc, 0, i - half)
    return out


def _check_image(name: str, img: torch.Tensor, prm: torch.Tensor, ntaps: int):
    if img.dtype != torch.float32 or img.dim() != 2:
        raise ValueError(f"{name}: image must be a 2-D float32 tensor")
    if prm.dtype != torch.float32 or prm.numel() != 7 + ntaps:
        raise ValueError(f"{name}: params must hold 7 + ntaps float32 values")
    if prm.device != img.device:
        raise ValueError(f"{name}: image and params must share a device")


def threshold_blur(img: torch.Tensor, prm: torch.Tensor, ntaps: int, active: bool = True):
    """(H, W) float32 -> blurred (H, W).  Kernel #2 of the port."""
    _check_image("threshold_blur", img, prm, ntaps)
    if img.device.type == "cpu":
        return threshold_blur_plain(img, prm, ntaps, active)
    cuda_lib.require_cuda("threshold_blur", img, prm)
    lib = cuda_lib.library()
    h, w = img.shape
    out = torch.empty_like(img)
    code = lib.pfmpe_threshold_blur(img.data_ptr(), prm.data_ptr(), ntaps, h, w, int(active),
                                    out.data_ptr(), cuda_lib.stream_ptr(img))
    threshold_blur.launches += 1
    cuda_lib.check(code, "pfmpe_threshold_blur")
    return out


threshold_blur.launches = 0


def label_sweeps(fg: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Bounded connected components: 1-based flat index, max-propagated
    through a 3x3 window exactly `sweeps` times (0 on background)."""
    h, w = fg.shape
    flat = torch.arange(1, h * w + 1, dtype=torch.int32, device=fg.device).reshape(h, w)
    zero = torch.zeros((), dtype=torch.int32, device=fg.device)
    lab = torch.where(fg, flat, zero)
    for _ in range(sweeps):
        mx = torch.maximum(lab, torch.maximum(shift2d(lab, 0, 1), shift2d(lab, 0, -1)))
        m = torch.maximum(mx, torch.maximum(shift2d(mx, 1, 0), shift2d(mx, -1, 0)))
        lab = torch.where(fg, m, zero)
    return lab


def detect_stats_plain(img, prm, ntaps: int, active: bool, sweeps: int, topk: int):
    """Plain twin of `detect_stats`: (labels i32, maps (10, H, W), top (topk,) i64)."""
    h, w = img.shape
    dev = img.device
    blurred = threshold_blur_plain(img, prm, ntaps, active)
    fg = blurred > 1e-3
    lab = label_sweeps(fg, sweeps)
    flat = torch.arange(1, h * w + 1, dtype=torch.int32, device=dev).reshape(h, w)
    lab_b = torch.where(fg, lab, -flat)  # background: unique negatives; border fill 0

    reach = sweeps
    f0 = torch.zeros((h, w), dtype=torch.float32, device=dev)
    cnt, sx, sy, sxx, syy, sxy = f0, f0, f0, f0, f0, f0
    for dy in range(-reach, 1):
        r_cnt, r_sx, r_sxx = f0, f0, f0
        for dx in range(-reach, reach + 1):
            samef = (shift2d(lab_b, -dy, -dx) == lab_b).float()  # lab_b[y + dy, x + dx]
            fdx = float(dx)
            r_cnt = r_cnt + samef
            r_sx = r_sx + fdx * samef
            r_sxx = r_sxx + (fdx * fdx) * samef
        fdy = float(dy)
        cnt = cnt + r_cnt
        sx = sx + r_sx
        sy = sy + fdy * r_cnt
        sxx = sxx + r_sxx
        syy = syy + (fdy * fdy) * r_cnt
        sxy = sxy + fdy * r_sx

    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    big = torch.full((), 1e9, dtype=torch.float32, device=dev)
    xmin, xmax = torch.where(fg, xs, big), torch.where(fg, xs, -big)
    ymin, ymax = torch.where(fg, ys, big), torch.where(fg, ys, -big)
    for _ in range(sweeps):
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)):
            same = shift2d(lab_b, dy, dx) == lab_b
            xmin = torch.where(same, torch.minimum(xmin, shift2d(xmin, dy, dx)), xmin)
            xmax = torch.where(same, torch.maximum(xmax, shift2d(xmax, dy, dx)), xmax)
            ymin = torch.where(same, torch.minimum(ymin, shift2d(ymin, dy, dx)), ymin)
            ymax = torch.where(same, torch.maximum(ymax, shift2d(ymax, dy, dx)), ymax)

    maps = torch.stack([cnt, sx, sy, xmin, xmax, ymin, ymax, sxx, syy, sxy])
    area = torch.where(lab == flat, cnt, f0)
    in_range = (area >= prm[5]) & (area <= prm[6]) & (area > 0)
    score = torch.where(in_range, area + 1e6, area).reshape(-1)
    # highest score first, lowest flat index on ties (lax.top_k's order)
    top = torch.sort(score, descending=True, stable=True).indices[:topk]
    return lab, maps, top


def detect_stats(img: torch.Tensor, prm: torch.Tensor, ntaps: int, active: bool = True,
                 sweeps: int = 12, topk: int = 16):
    """Fused threshold + blur + bounded CC + per-root statistics + top-k.
    Kernel #1 of the port.  Returns (labels (H, W) int32, maps (10, H, W)
    float32 valid at root pixels, top (topk,) int64 flat root indices)."""
    _check_image("detect_stats", img, prm, ntaps)
    if img.device.type == "cpu":
        return detect_stats_plain(img, prm, ntaps, active, sweeps, topk)
    cuda_lib.require_cuda("detect_stats", img, prm)
    h, w = img.shape
    check_card_shape(sweeps, topk, h * w)
    lib = cuda_lib.library()
    blurred = torch.empty_like(img)
    lab = torch.empty((h, w), dtype=torch.int32, device=img.device)
    maps = torch.empty((N_MAPS, h, w), dtype=torch.float32, device=img.device)
    scratch = torch.empty((lib.pfmpe_detect_stats_scratch(h, w, sweeps, topk),), dtype=torch.uint8,
                          device=img.device)
    top = torch.empty((topk,), dtype=torch.int32, device=img.device)
    code = lib.pfmpe_detect_stats(
        img.data_ptr(), prm.data_ptr(), ntaps, h, w, int(active), sweeps, topk,
        blurred.data_ptr(), lab.data_ptr(), maps.data_ptr(), scratch.data_ptr(),
        top.data_ptr(), cuda_lib.stream_ptr(img),
    )
    detect_stats.launches += 1
    detect_stats.pixels += h * w
    cuda_lib.check(code, "pfmpe_detect_stats")
    return lab, maps, top.long()


detect_stats.launches = 0
detect_stats.pixels = 0  # h * w of every launch: kernel A's bytes scale with it


def shape_filter(area, bb_w, bb_h, comp_ids, min_area, max_area, wh_tol, circ_tol):
    """Components kept by area, width-to-height ratio and circularity."""
    ratio = torch.minimum(bb_w / bb_h, bb_h / bb_w)
    circ_w = torch.abs(1.0 - area / (math.pi * (bb_w / 2.0) ** 2))
    circ_h = torch.abs(1.0 - area / (math.pi * (bb_h / 2.0) ** 2))
    return (
        (comp_ids > 0)
        & (area >= min_area)
        & (area <= max_area)
        & (torch.abs(1.0 - ratio) <= wh_tol)
        & (circ_w <= circ_tol)
        & (circ_h <= circ_tol)
    )


def _argsort_stable(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).indices


def split_and_compact(params: BlobParams, comp_ids, cx, cy, area, valid, var_xx, var_yy,
                      var_xy, min_area, max_area, img=None):
    """Split oversized elongated components into two detections, then
    compact valid detections to the front in component-id order:
    (xy (K, 2) distorted, mask (K,), area (K,) zero where masked)."""
    dev = cx.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if not params.split_merged:
        perm = _argsort_stable(torch.where(valid, comp_ids, _IMAX))
        xy_d = torch.stack([cx, cy], dim=-1)[perm]
        mask = valid[perm]
        return xy_d, mask, torch.where(mask, area[perm], zero)

    tr = var_xx + var_yy
    diff = var_xx - var_yy
    disc = torch.sqrt(torch.clamp(diff * diff + 4.0 * var_xy * var_xy, min=0.0))
    lam_max = 0.5 * (tr + disc)
    lam_min = torch.clamp(0.5 * (tr - disc), min=1e-6)
    half = area * 0.5
    split_ok = (
        (comp_ids > 0)
        & (area > max_area)
        & (area <= params.split_max_factor * max_area)
        & (lam_max / lam_min >= params.split_min_elongation)
        & (half >= min_area)
        & (half <= max_area)
    )
    degen = torch.abs(var_xy) <= 1e-9
    one = torch.ones((), dtype=torch.float32, device=dev)
    ux = torch.where(degen, torch.where(diff >= 0, one, zero), var_xy)
    uy = torch.where(degen, torch.where(diff >= 0, zero, one), lam_max - var_xx)
    norm = torch.sqrt(torch.clamp(ux * ux + uy * uy, min=1e-12))
    off = torch.sqrt(torch.clamp(lam_max - lam_min, min=0.0))
    ox = ux / norm * off
    oy = uy / norm * off

    if img is not None and params.split_dip_ratio < 1e6:
        h_i, w_i = img.shape
        sample_img = img if params.active_markers else 255.0 - img

        def _sample(x, y):
            xi = torch.clamp(torch.round(x).long(), 0, w_i - 1)
            yi = torch.clamp(torch.round(y).long(), 0, h_i - 1)
            return sample_img[yi, xi]

        i_c = _sample(cx, cy)
        i_1 = _sample(cx + ox, cy + oy)
        i_2 = _sample(cx - ox, cy - oy)
        ratio = params.split_dip_ratio
        dip_axis = i_c <= ratio * torch.minimum(i_1, i_2)
        perp_k = torch.sqrt(torch.clamp(lam_min, min=1.0)) * 0.8 + 0.5
        px_ = -(uy / norm) * perp_k
        py_ = (ux / norm) * perp_k

        def _perp_min(xc, yc):
            return torch.minimum(_sample(xc + px_, yc + py_), _sample(xc - px_, yc - py_))

        w_c = _perp_min(cx, cy)
        w_lobe = torch.minimum(_perp_min(cx + ox, cy + oy), _perp_min(cx - ox, cy - oy))
        lobes_wide = w_lobe >= 0.5 * torch.minimum(i_1, i_2)
        thin_waist = w_c <= ratio * w_lobe
        split_ok = split_ok & (dip_axis | (lobes_wide & thin_waist))

    p_valid = valid | split_ok
    p_x = torch.where(split_ok, cx + ox, cx)
    p_y = torch.where(split_ok, cy + oy, cy)
    p_area = torch.where(split_ok, half, area)
    keys = torch.cat(
        [torch.where(p_valid, comp_ids * 2, _IMAX), torch.where(split_ok, comp_ids * 2 + 1, _IMAX)]
    )
    xs_all = torch.cat([p_x, cx - ox])
    ys_all = torch.cat([p_y, cy - oy])
    areas_all = torch.cat([p_area, half])
    valid_all = torch.cat([p_valid, split_ok])
    perm = _argsort_stable(keys)[: comp_ids.shape[0]]
    xy_d = torch.stack([xs_all[perm], ys_all[perm]], dim=-1)
    mask = valid_all[perm]
    return xy_d, mask, torch.where(mask, areas_all[perm], zero)


def finish_bank(camera: Camera, xy_d, mask, area):
    """Undistort the compacted detections and zero every masked slot:
    (xy, xy_distorted, mask, area, falses), falses a (K,) bool of False."""
    xy_u = undistort_pixels(camera, xy_d)
    zero = torch.zeros((), dtype=torch.float32, device=xy_d.device)
    return (torch.where(mask[:, None], xy_u, zero), torch.where(mask[:, None], xy_d, zero), mask,
            torch.where(mask, area, zero), torch.zeros_like(mask))


def detect_epilogue_plain(lab, maps, top, img, prm, ntaps: int, params: BlobParams,
                          camera: Camera):
    """Plain twin of `detect_epilogue`, op by op: the root test and the
    statistics at the top-k roots, the shape filters, the splitter and the
    compaction, the crop offset, undistortion and the masking."""
    h, w = img.shape
    dev = img.device
    min_area, max_area = prm[5], prm[6]
    wh_tol, circ_tol = prm[7 + ntaps], prm[8 + ntaps]
    offset = prm[9 + ntaps:11 + ntaps]
    cnt, sx, sy, xmin, xmax, ymin, ymax, sxx, syy, sxy = (m.reshape(-1) for m in maps)
    flat = torch.arange(1, h * w + 1, dtype=torch.int32, device=dev)
    area_map = torch.where(lab.reshape(-1) == flat, cnt, torch.zeros((), device=dev))
    valid0 = area_map[top] > 0
    comp_ids = torch.where(valid0, top + 1, torch.zeros_like(top))

    cntv = torch.clamp(cnt[top], min=1e-9)
    root_x = (top % w).float()
    root_y = (top // w).float()
    mean_dx = sx[top] / cntv
    mean_dy = sy[top] / cntv
    cx = root_x + mean_dx
    cy = root_y + mean_dy
    area = area_map[top]
    var_xx = sxx[top] / cntv - mean_dx * mean_dx
    var_yy = syy[top] / cntv - mean_dy * mean_dy
    var_xy = sxy[top] / cntv - mean_dx * mean_dy
    bb_w = xmax[top] - xmin[top] + 1.0
    bb_h = ymax[top] - ymin[top] + 1.0
    valid = shape_filter(area, bb_w, bb_h, comp_ids, min_area, max_area, wh_tol, circ_tol)
    xy_d, mask, area_s = split_and_compact(params, comp_ids, cx, cy, area, valid, var_xx, var_yy,
                                           var_xy, min_area, max_area, img=img)
    return finish_bank(camera, xy_d + offset[None, :], mask, area_s)


def detect_epilogue(lab, maps, top, img, prm, ntaps: int, params: BlobParams, camera: Camera):
    """Kernel A's outputs on a crop -> the finished detection bank, in one
    launch of `detect_epilogue_kernel` (csrc/detect.cu) on the stream A ran
    on.  lab (H, W) int32, maps (10, H, W), top (K,) int64 as `detect_stats`
    returned them for `img`, and not checked again; img the float32 crop;
    prm A's vector and the epilogue's four values (7 + ntaps + N_EPILOGUE);
    the camera's intrinsics and distortion on the same device.  Returns (xy
    (K, 2) undistorted, xy_distorted (K, 2), mask (K,) bool, area (K,),
    falses (K,) bool), zero where the mask is false.  CPU tensors take the
    plain twin, CUDA tensors the kernel (tensors on both raise).  `.calls`
    counts every call, `.launches` the kernel's."""
    detect_epilogue.calls += 1
    cam = (camera.fx, camera.fy, camera.cx, camera.cy, camera.dist)
    given = (img, prm) + cam
    h, w = img.shape
    if any(t.dtype != torch.float32 for t in given):
        raise ValueError("detect_epilogue: the crop, the params and the camera must be float32")
    if prm.numel() != 7 + ntaps + N_EPILOGUE or camera.dist.numel() != 5:
        raise ValueError(f"detect_epilogue: params must hold 7 + ntaps + {N_EPILOGUE} values, "
                         "the distortion 5")
    if img.device.type == "cpu":
        if any(t.device != img.device for t in given):
            raise ValueError("detect_epilogue: all tensors must share a device")
        return detect_epilogue_plain(lab, maps, top, img, prm, ntaps, params, camera)
    k = top.numel()
    if not 1 <= k <= min(MAX_TOPK, h * w):
        raise ValueError(f"detect_epilogue: the kernel takes 1 <= K <= min({MAX_TOPK}, pixels) "
                         f"(got K = {k}, {h * w} pixels)")
    cuda_lib.require_cuda("detect_epilogue", *given)
    lib = cuda_lib.library()
    out = torch.empty(5 * k, dtype=torch.float32, device=img.device)
    flags = torch.empty(2 * k, dtype=torch.bool, device=img.device)
    mode = ((1 if params.split_merged else 0) | (2 if params.split_dip_ratio < 1e6 else 0)
            | (4 if params.active_markers else 0))
    code = lib.pfmpe_detect_epilogue(
        lab.data_ptr(), maps.data_ptr(), top.data_ptr(), img.data_ptr(), h, w, k, prm.data_ptr(),
        ntaps, mode, float(params.split_max_factor), float(params.split_min_elongation),
        float(params.split_dip_ratio), *(t.data_ptr() for t in cam), out.data_ptr(),
        flags.data_ptr(), cuda_lib.stream_ptr(img))
    detect_epilogue.launches += 1
    cuda_lib.check(code, "pfmpe_detect_epilogue")
    return (out[:2 * k].view(k, 2), out[2 * k:4 * k].view(k, 2), flags[:k], out[4 * k:],
            flags[k:])


detect_epilogue.launches = 0
detect_epilogue.calls = 0
