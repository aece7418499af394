"""Propagation-noise bounds and factors, and the reference's AoS
propagation over an (N, 4, 4) bank (port of `pf/propagate.py`).

The tracker's propagation runs on the (16, N) layout: inside kernel B
(`pf.step_kernel`), or `pf.soa.propagate_soa`."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import rotation_rpy
from ..utils import prng


class NoiseBounds(NamedTuple):
    min_translation: torch.Tensor | float = -0.02
    max_translation: torch.Tensor | float = 0.02
    min_angular: torch.Tensor | float = -0.015
    max_angular: torch.Tensor | float = 0.015


def propagation_noise_factors(freshly_initialised: bool, prediction_matrix: torch.Tensor,
                              dt_frames: torch.Tensor):
    """Per-axis noise scale factors -> (fac_trans (3,), fac_rot (3,))."""
    dt = torch.clamp(dt_frames, min=1e-6)
    vel = torch.abs(prediction_matrix[0, 3]) / dt
    fac_t = torch.clamp(vel, 0.2, 1.0) / 4.0
    ones = torch.ones(3, dtype=torch.float32, device=prediction_matrix.device)
    if freshly_initialised:
        return ones, ones
    return fac_t * ones, 0.2 * ones


def propagate(key, resampled_bank: torch.Tensor, current_pose, predicted_pose,
              prediction_matrix, cam_move_inv, noise: NoiseBounds, fac_trans, fac_rot,
              tracking, apply_prediction, inflation) -> torch.Tensor:
    """One propagation sweep over an (N, 4, 4) bank -> (N, 4, 4).

    base = cam_move_inv @ T @ prediction_matrix while tracking with the
    prediction, cam_move_inv @ T while tracking without it, T otherwise;
    angles and translations are `jax.random.uniform(k, (N, 3), lo, hi)`
    under the two halves of `key` (the port's threefry, bit for bit); the
    rotation noise is base @ Rz @ Ry @ Rx, the translation noise is added to
    the unrotated base translation; particles 0 and 1 are set to the current
    and predicted poses."""
    dev = resampled_bank.device
    n = resampled_bank.shape[0]
    f = lambda v: torch.as_tensor(v, dtype=torch.float32).to(dev)
    k_rot, k_trans = prng.split(key)
    base = resampled_bank
    if bool(tracking):
        base = f(cam_move_inv) @ resampled_bank
        if bool(apply_prediction):
            base = base @ f(prediction_matrix)
    three = torch.ones(3, dtype=torch.float32, device=dev)
    infl = f(inflation)
    lo_a = f(noise.min_angular) * three * f(fac_rot) * infl
    hi_a = f(noise.max_angular) * three * f(fac_rot) * infl
    angles = prng.uniform(k_rot, (n, 3), dev, lo_a, hi_a)
    lo_t = f(noise.min_translation) * three * f(fac_trans) * infl
    hi_t = f(noise.max_translation) * three * f(fac_trans) * infl
    dts = prng.uniform(k_trans, (n, 3), dev, lo_t, hi_t)
    noisy = base @ rotation_rpy(angles)  # a new tensor: set in place
    noisy[:, :3, 3] = base[:, :3, 3] + dts
    noisy[0] = f(current_pose)
    noisy[1] = f(predicted_pose)
    return noisy
