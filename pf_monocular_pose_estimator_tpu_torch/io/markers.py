"""Marker-YAML and camera-calibration loading (port of `io/markers.py`).

Both files are read with the port's own YAML reader (`io/flat_yaml.py`).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..geometry.camera import Camera
from . import flat_yaml


def load_marker_positions(path: str, markers_per_object: List[int] | None = None):
    """Load a reference-format marker YAML (`marker_positions:`, a list of
    {x, y, z}).

    Returns a list of (M_i, 4) float32 homogeneous numpy arrays, one per
    tracked object: the whole list with `markers_per_object=None`, else the
    list cut into those counts, which must sum to its length."""
    data = flat_yaml.load(path)
    pts = np.array(
        [[p["x"], p["y"], p["z"], 1.0] for p in data["marker_positions"]], dtype=np.float32
    )
    if markers_per_object is None:
        return [pts]
    out = []
    offset = 0
    for count in markers_per_object:
        out.append(pts[offset : offset + count])
        offset += count
    if offset != len(pts):
        raise ValueError(
            f"marker YAML has {len(pts)} points but markers_per_object sums to {offset}"
        )
    return out


def load_camera_calibration(path: str, device="cuda") -> Camera:
    """Load a camera YAML: {fx, fy, cx, cy, distortion: [k1, k2, p1, p2, k3],
    width, height}, on `device` (the card unless asked otherwise); a missing
    distortion is zero, a missing size 752x480, as in the reference."""
    data = flat_yaml.load(path)
    return Camera.create(
        fx=data["fx"],
        fy=data["fy"],
        cx=data["cx"],
        cy=data["cy"],
        dist=data.get("distortion", [0.0] * 5),
        width=data.get("width", 752),
        height=data.get("height", 480),
        device=device,
    )
