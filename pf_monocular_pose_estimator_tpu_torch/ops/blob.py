"""LED blob detection (port of the reference's `ops/blob.py`).

Two paths, as in the reference on its accelerator:
  * a fixed-size crop around the ROI when the ROI fits it: kernel A's
    fused `detect_stats` (threshold + blur + bounded CC + per-root
    statistics + top-k), then the shape filters in torch;
  * otherwise the full frame: kernel A's `threshold_blur`, then bounded CC,
    box-sum ranking, top-k and the (K, H*W) membership product in torch.
Both end in the merged-blob splitter and a stable compaction.  The choice
between them is host control flow on the ROI (one device -> host read).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..geometry.camera import Camera, distort_pixels, undistort_pixels
from ..utils.config import BlobParams
from ..utils.sync import HostReads, upload
from . import detect_kernel as dk

_IMAX = 2**31 - 1


@dataclasses.dataclass
class Detections:
    """Fixed-capacity detection bank (reference `ops/blob.py::Detections`)."""

    xy: torch.Tensor  # (K, 2) undistorted
    xy_distorted: torch.Tensor  # (K, 2)
    mask: torch.Tensor  # (K,) bool
    area: torch.Tensor  # (K,)
    occluded: torch.Tensor  # (K,) bool
    injected: torch.Tensor  # (K,) bool

    @property
    def count(self) -> torch.Tensor:
        return torch.sum(self.mask.to(torch.int32))


def _argsort_stable(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).indices


def connected_components(fg: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Label foreground pixels by max-propagating flat indices: an int32
    (H, W) label image, 0 on background, each component carrying the
    1-based flat index of its largest pixel reached in `sweeps` sweeps of a
    3x3 window (reference `ops/blob.py::connected_components`)."""
    return dk.label_sweeps(fg, sweeps)


def _split_and_compact(params: BlobParams, comp_ids, cx, cy, area, valid, var_xx, var_yy,
                       var_xy, min_area, max_area, img=None):
    """Split oversized elongated components into two detections, then
    compact valid detections to the front in component-id order."""
    dev = cx.device
    imax = upload(_IMAX, dev, comp_ids.dtype)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if not params.split_merged:
        perm = _argsort_stable(torch.where(valid, comp_ids, imax))
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
        [torch.where(p_valid, comp_ids * 2, imax), torch.where(split_ok, comp_ids * 2 + 1, imax)]
    )
    xs_all = torch.cat([p_x, cx - ox])
    ys_all = torch.cat([p_y, cy - oy])
    areas_all = torch.cat([p_area, half])
    valid_all = torch.cat([p_valid, split_ok])
    perm = _argsort_stable(keys)[: comp_ids.shape[0]]
    xy_d = torch.stack([xs_all[perm], ys_all[perm]], dim=-1)
    mask = valid_all[perm]
    return xy_d, mask, torch.where(mask, areas_all[perm], zero)


def _shape_filter(area, bb_w, bb_h, comp_ids, min_area, max_area, wh_tol, circ_tol):
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


def _detect_blobs_fused(img, roi, params: BlobParams, min_area, max_area, threshold,
                        wh_tol, circ_tol):
    """Crop path: kernel A's detect_stats, then the shape filters."""
    h, w = img.shape
    dev = img.device
    taps = dk.gaussian_taps(params.gaussian_sigma)
    prm = dk.make_params(roi, threshold, min_area, max_area, params.gaussian_sigma, dev)
    lab, maps, top_idx = dk.detect_stats(
        img.contiguous(), prm, taps.size, params.active_markers, params.cc_sweeps,
        params.max_detections,
    )
    cnt, sx, sy, xmin, xmax, ymin, ymax, sxx, syy, sxy = (m.reshape(-1) for m in maps)
    flat = torch.arange(1, h * w + 1, dtype=torch.int32, device=dev)
    area_map = torch.where(lab.reshape(-1) == flat, cnt, torch.zeros((), device=dev))
    valid0 = area_map[top_idx] > 0
    comp_ids = torch.where(valid0, top_idx + 1, torch.zeros_like(top_idx))

    cntv = torch.clamp(cnt[top_idx], min=1e-9)
    root_x = (top_idx % w).float()
    root_y = (top_idx // w).float()
    mean_dx = sx[top_idx] / cntv
    mean_dy = sy[top_idx] / cntv
    cx = root_x + mean_dx
    cy = root_y + mean_dy
    area = area_map[top_idx]
    var_xx = sxx[top_idx] / cntv - mean_dx * mean_dx
    var_yy = syy[top_idx] / cntv - mean_dy * mean_dy
    var_xy = sxy[top_idx] / cntv - mean_dx * mean_dy
    bb_w = xmax[top_idx] - xmin[top_idx] + 1.0
    bb_h = ymax[top_idx] - ymin[top_idx] + 1.0
    valid = _shape_filter(area, bb_w, bb_h, comp_ids, min_area, max_area, wh_tol, circ_tol)
    return _split_and_compact(params, comp_ids, cx, cy, area, valid, var_xx, var_yy, var_xy,
                              min_area, max_area, img=img)


def _box_sum(x: torch.Tensor, dim: int, r: int) -> torch.Tensor:
    """box[i] = c[min(i + r, L - 1)] - (c[i - r - 1] if i > r else 0)."""
    c = torch.cumsum(x, dim=dim)
    length = x.shape[dim]
    idx = torch.arange(length, device=x.device)
    upper = c.index_select(dim, torch.clamp(idx + r, max=length - 1))
    lower = c.index_select(dim, torch.clamp(idx - r - 1, min=0))
    keep = (idx - r - 1 >= 0).to(x.dtype)
    keep = keep.reshape([-1 if d == dim else 1 for d in range(x.dim())])
    return upper - lower * keep


def _detect_blobs(img, roi, params: BlobParams, min_area, max_area, threshold, wh_tol,
                  circ_tol):
    """Full-frame path: kernel A's threshold_blur, the rest in torch."""
    h, w = img.shape
    dev = img.device
    taps = dk.gaussian_taps(params.gaussian_sigma)
    prm = dk.make_params(roi, threshold, min_area, max_area, params.gaussian_sigma, dev)
    blurred = dk.threshold_blur(img.contiguous(), prm, taps.size, params.active_markers)
    fg = blurred > 1e-3
    labels = dk.label_sweeps(fg, params.cc_sweeps)

    k_cap = params.max_detections
    flat = torch.arange(1, h * w + 1, dtype=torch.int32, device=dev).reshape(h, w)
    is_root = fg & (labels == flat)
    box_r = 2 * params.cc_sweeps
    mass = _box_sum(_box_sum(fg.float(), 0, box_r), 1, box_r)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    root_area = torch.where(is_root, mass, zero).reshape(-1)
    in_range = (root_area >= min_area) & (root_area <= max_area) & (root_area > 0)
    score = torch.where(in_range, root_area + 1e6, root_area)
    top_idx = torch.sort(score, descending=True, stable=True).indices[:k_cap]
    comp_ids = torch.where(root_area[top_idx] > 0, top_idx + 1, torch.zeros_like(top_idx))

    lab_flat = labels.reshape(-1).long()
    member = (lab_flat[None, :] == comp_ids[:, None]) & (comp_ids[:, None] > 0)
    member_f = member.float()
    xs_f = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w).reshape(-1)
    ys_f = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w).reshape(-1)
    weight = blurred.reshape(-1) if params.intensity_weighted_centroids else torch.ones_like(xs_f)
    feats = torch.stack([weight, weight * xs_f, weight * ys_f, torch.ones_like(weight)], dim=-1)
    moments = member_f @ feats  # (K, 4)
    wsum = torch.clamp(moments[:, 0], min=1e-9)
    cx = moments[:, 1] / wsum
    cy = moments[:, 2] / wsum
    area = moments[:, 3]
    wm = member_f * weight[None, :]
    dxs = xs_f[None, :] - cx[:, None]
    dys = ys_f[None, :] - cy[:, None]
    var_xx = torch.sum(wm * dxs * dxs, dim=-1) / wsum
    var_yy = torch.sum(wm * dys * dys, dim=-1) / wsum
    var_xy = torch.sum(wm * dxs * dys, dim=-1) / wsum

    big = torch.full((), 1e9, dtype=torch.float32, device=dev)
    x_min = torch.min(torch.where(member, xs_f[None, :], big), dim=-1).values
    x_max = torch.max(torch.where(member, xs_f[None, :], -big), dim=-1).values
    y_min = torch.min(torch.where(member, ys_f[None, :], big), dim=-1).values
    y_max = torch.max(torch.where(member, ys_f[None, :], -big), dim=-1).values
    bb_w = x_max - x_min + 1.0
    bb_h = y_max - y_min + 1.0
    valid = _shape_filter(area, bb_w, bb_h, comp_ids, min_area, max_area, wh_tol, circ_tol)
    return _split_and_compact(params, comp_ids, cx, cy, area, valid, var_xx, var_yy, var_xy,
                              min_area, max_area, img=img)


def find_leds(image: torch.Tensor, roi: torch.Tensor, params: BlobParams, camera: Camera,
              min_area=None, max_area=None, threshold=None, wh_distortion=None,
              circ_distortion=None, host: HostReads | None = None) -> Detections:
    """Detect LED blobs in a frame (reference `ops/blob.py::find_leds`).

    The crop-or-full-frame choice reads the ROI on the host (`host`)."""
    host = host or HostReads()
    h, w = image.shape
    dev = image.device
    img = image.float()
    min_area = upload(params.min_blob_area if min_area is None else min_area, dev)
    max_area = upload(params.max_blob_area if max_area is None else max_area, dev)
    threshold = upload(params.threshold if threshold is None else threshold, dev)
    wh_tol = upload(params.max_width_height_distortion if wh_distortion is None
                    else wh_distortion, dev)
    circ_tol = upload(params.max_circular_distortion if circ_distortion is None
                      else circ_distortion, dev)
    roi = roi.float()
    args = (params, min_area, max_area, threshold, wh_tol, circ_tol)

    crop = params.roi_crop
    use_crop = crop is not None and crop[0] + 8 <= h and crop[1] + 8 <= w
    fits = False
    if use_crop:
        ch, cw = int(crop[0]), int(crop[1])
        r = np.asarray(host(roi), dtype=np.float32)
        fits = bool((r[2] <= np.float32(cw - 8)) and (r[3] <= np.float32(ch - 8)))
    if fits:
        half_two = np.float32(2.0)
        cx0 = int(np.clip(np.round(r[0] + r[2] / half_two - np.float32(cw / 2)), 0, w - cw))
        cy0 = int(np.clip(np.round(r[1] + r[3] / half_two - np.float32(ch / 2)), 0, h - ch))
        img_c = img[cy0 : cy0 + ch, cx0 : cx0 + cw].contiguous()
        offset = np.asarray([cx0, cy0], np.float32)
        roi_local = host.put(np.concatenate([r[:2] - offset, r[2:]]), dev)
        xy_d, mask, area_s = _detect_blobs_fused(img_c, roi_local, *args)
        xy_d = xy_d + host.put(offset, dev)[None, :]
    else:
        xy_d, mask, area_s = _detect_blobs(img, roi, *args)

    xy_u = undistort_pixels(camera, xy_d)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    falses = torch.zeros_like(mask)
    return Detections(
        xy=torch.where(mask[:, None], xy_u, zero),
        xy_distorted=torch.where(mask[:, None], xy_d, zero),
        mask=mask,
        area=torch.where(mask, area_s, zero),
        occluded=falses,
        injected=falses,
    )


def determine_roi(predicted_pixels: torch.Tensor, pixel_mask: torch.Tensor, camera: Camera,
                  border: float) -> torch.Tensor:
    """Bounding ROI [x0, y0, w, h] of predicted (undistorted) pixels."""
    dev = predicted_pixels.device
    big = torch.full((), 1e9, dtype=torch.float32, device=dev)
    m = pixel_mask[:, None]
    lo = torch.where(m, predicted_pixels, big)
    hi = torch.where(m, predicted_pixels, -big)
    x_min, y_min = torch.min(lo[:, 0]), torch.min(lo[:, 1])
    x_max, y_max = torch.max(hi[:, 0]), torch.max(hi[:, 1])
    corners = torch.stack([torch.stack([x_min, y_min]), torch.stack([x_max, y_max])])
    dist = distort_pixels(camera, corners)
    wf, hf = float(camera.width), float(camera.height)
    x0 = torch.clamp(dist[0, 0] - border, 0.0, wf)
    x1 = torch.clamp(dist[1, 0] + border, 0.0, wf)
    y0 = torch.clamp(dist[0, 1] - border, 0.0, hf)
    y1 = torch.clamp(dist[1, 1] + border, 0.0, hf)
    degenerate = ((x1 - x0) < 1.0) | ((y1 - y0) < 1.0) | ~torch.any(pixel_mask)
    full = upload([0.0, 0.0, wf, hf], dev)
    box = torch.stack([x0, y0, x1 - x0, y1 - y0])
    return torch.where(degenerate, full, box)


def grow_roi(roi: torch.Tensor, dx, dy, camera: Camera) -> torch.Tensor:
    """Grow an ROI symmetrically by (dx, dy), clamped to the frame."""
    wf, hf = float(camera.width), float(camera.height)
    x0 = torch.clamp(roi[0] - dx, min=0.0)
    y0 = torch.clamp(roi[1] - dy, min=0.0)
    w = torch.minimum(roi[2] + 2.0 * dx, wf - x0)
    h = torch.minimum(roi[3] + 2.0 * dy, hf - y0)
    return torch.stack([x0, y0, w, h])
