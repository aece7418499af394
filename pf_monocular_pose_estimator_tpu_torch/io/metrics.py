"""Trajectory accuracy metrics (port of `io/metrics.py`, numpy only): the
offline ATE analysis the golden-sequence replays are held to."""

from __future__ import annotations

import numpy as np


def absolute_trajectory_error(est_poses: np.ndarray, gt_poses: np.ndarray, mask=None) -> float:
    """RMS translation error between (T,4,4) pose arrays (object->camera)."""
    est = np.asarray(est_poses)
    gt = np.asarray(gt_poses)
    d = est[:, :3, 3] - gt[:, :3, 3]
    err = np.linalg.norm(d, axis=-1)
    if mask is not None:
        mask = np.asarray(mask, bool)
        if not mask.any():
            return float("inf")
        err = err[mask]
    return float(np.sqrt(np.mean(err**2)))


def orientation_error_deg(est_poses: np.ndarray, gt_poses: np.ndarray, mask=None) -> float:
    """RMS geodesic rotation error in degrees between (T,4,4) pose arrays."""
    est = np.asarray(est_poses)[:, :3, :3]
    gt = np.asarray(gt_poses)[:, :3, :3]
    rel = np.einsum("tij,tkj->tik", est, gt)  # est @ gt^T
    tr = np.clip((np.trace(rel, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    ang = np.degrees(np.arccos(tr))
    if mask is not None:
        mask = np.asarray(mask, bool)
        if not mask.any():
            return float("inf")
        ang = ang[mask]
    return float(np.sqrt(np.mean(ang**2)))
