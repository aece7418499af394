"""LED blob detection (port of the reference's `ops/blob.py`).

Two paths, as in the reference on its accelerator:
  * a fixed-size crop around the ROI when the ROI fits it: kernel A's
    fused `detect_stats` (threshold + blur + bounded CC + per-root
    statistics + top-k), then one launch of `detect_epilogue` for the
    shape filters, the splitter, the compaction and the undistortion;
  * otherwise the full frame: kernel A's `threshold_blur`, then bounded CC,
    box-sum ranking, top-k and the (K, H*W) membership product in torch,
    and the same filters, splitter and compaction op by op.
The choice between them is host control flow on the ROI (one device -> host
read).  The host's parameters reach the device as one copy a call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry.camera import Camera, distort_pixels
from ..utils.config import BlobParams
from ..utils.sync import HostReads, upload
from . import detect_kernel as dk


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


def connected_components(fg: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Label foreground pixels by max-propagating flat indices: an int32
    (H, W) label image, 0 on background, each component carrying the
    1-based flat index of its largest pixel reached in `sweeps` sweeps of a
    3x3 window (reference `ops/blob.py::connected_components`)."""
    return dk.label_sweeps(fg, sweeps)


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


def _detect_blobs(img, prm, ntaps: int, params: BlobParams):
    """Full-frame path: kernel A's threshold_blur, the rest in torch:
    (xy (K, 2) distorted, mask (K,), area (K,))."""
    h, w = img.shape
    dev = img.device
    min_area, max_area = prm[5], prm[6]
    blurred = dk.threshold_blur(img.contiguous(), prm[:7 + ntaps], ntaps, params.active_markers)
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
    valid = dk.shape_filter(area, bb_w, bb_h, comp_ids, min_area, max_area, prm[7 + ntaps],
                            prm[8 + ntaps])
    return dk.split_and_compact(params, comp_ids, cx, cy, area, valid, var_xx, var_yy, var_xy,
                                min_area, max_area, img=img)


def _pack(host: HostReads, device, values) -> torch.Tensor:
    """`values` (numbers, arrays, tensors) as one float32 vector on `device`:
    every host value in one `host.put`, the tensors already on the device
    joined to it there, with no read back."""
    on_dev = [torch.is_tensor(v) and v.device == device for v in values]
    host_vals = [np.asarray(v.detach().cpu() if torch.is_tensor(v) else v, np.float32).reshape(-1)
                 for v, d in zip(values, on_dev) if not d]
    put = host.put(np.concatenate(host_vals), device)
    if not any(on_dev):
        return put
    sizes = iter(a.size for a in host_vals)
    pieces, at = [], 0
    for v, d in zip(values, on_dev):
        if d:
            pieces.append(v.reshape(-1).to(torch.float32))
        else:
            n = next(sizes)
            pieces.append(put[at:at + n])
            at += n
    return torch.cat(pieces)


def find_leds(image: torch.Tensor, roi: torch.Tensor, params: BlobParams, camera: Camera,
              min_area=None, max_area=None, threshold=None, wh_distortion=None,
              circ_distortion=None, host: HostReads | None = None) -> Detections:
    """Detect LED blobs in a frame (reference `ops/blob.py::find_leds`).

    The crop-or-full-frame choice reads the ROI on the host (`host`)."""
    host = host or HostReads()
    h, w = image.shape
    dev = image.device
    roi = roi.float()
    taps = dk.gaussian_taps(params.gaussian_sigma)

    crop = params.roi_crop
    use_crop = crop is not None and crop[0] + 8 <= h and crop[1] + 8 <= w
    fits = False
    if use_crop:
        ch, cw = int(crop[0]), int(crop[1])
        r = np.asarray(host(roi), dtype=np.float32)
        fits = bool((r[2] <= np.float32(cw - 8)) and (r[3] <= np.float32(ch - 8)))
    box, offset = roi, np.zeros(2, np.float32)
    if fits:
        half_two = np.float32(2.0)
        cx0 = int(np.clip(np.round(r[0] + r[2] / half_two - np.float32(cw / 2)), 0, w - cw))
        cy0 = int(np.clip(np.round(r[1] + r[3] / half_two - np.float32(ch / 2)), 0, h - ch))
        offset = np.asarray([cx0, cy0], np.float32)
        box = np.concatenate([r[:2] - offset, r[2:]])
    pick = lambda v, default: default if v is None else v
    prm = _pack(host, dev, [
        box, pick(threshold, params.threshold), pick(min_area, params.min_blob_area),
        pick(max_area, params.max_blob_area), taps,
        pick(wh_distortion, params.max_width_height_distortion),
        pick(circ_distortion, params.max_circular_distortion), offset])
    if fits:  # only the crop is converted to float
        img_c = image[cy0 : cy0 + ch, cx0 : cx0 + cw].float().contiguous()
        lab, maps, top = dk.detect_stats(img_c, prm[:7 + taps.size], taps.size,
                                         params.active_markers, params.cc_sweeps,
                                         params.max_detections)
        bank = dk.detect_epilogue(lab, maps, top, img_c, prm, taps.size, params, camera)
    else:
        bank = dk.finish_bank(camera, *_detect_blobs(image.float(), prm, taps.size, params))
    xy, xy_d, mask, area, falses = bank
    return Detections(xy=xy, xy_distorted=xy_d, mask=mask, area=area, occluded=falses,
                      injected=falses)


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
