"""Detection front-end kernel A (csrc/detect.cu) and its plain versions.

Ports the reference's Pallas kernels `ops/pallas_kernels.py::
threshold_blur_pallas` and `::detect_stats_pallas` with their semantics:
zero blur borders, exactly `sweeps` sweeps of 3x3 max-label propagation,
windowed same-label moment sums at reach = sweeps, bbox extrema by
`sweeps` same-label min/max sweeps, and the top-k roots ranked by the
exact in-range-lifted component count, lowest flat index on ties.

Both wrappers take one float32 parameter vector on the image's device:
  [x0, y0, roi_w, roi_h, threshold, min_area, max_area, taps...]
For a CPU tensor they run the plain version; for a CUDA tensor they launch
the kernel or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_lib
from ..utils.sync import upload

N_MAPS = 10  # cnt, sx, sy, xmin, xmax, ymin, ymax, sxx, syy, sxy
# What kernel A's `detect_stats` takes on the card (csrc/detect.cu): every
# 0 <= sweeps <= MAX_SWEEPS and 1 <= topk <= min(MAX_TOPK, pixels).  Up to 12
# sweeps with a top-k of up to 64 run the default shapes, the rest the wide
# path (label and bbox rounds, more launches than the default's four).
MAX_SWEEPS = 32
MAX_TOPK = 128


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
