# Frozen copy of pf_monocular_pose_estimator_tpu_torch/pf/propagate.py, the port's plain
# PyTorch path, trimmed to what the benchmark's reference calls; it calls no
# kernel and no code of the program.
"""Propagation-noise bounds and factors (port of `pf/propagate.py`); the
propagation itself is `pf.step_kernel.propagate_plain`."""

from __future__ import annotations

from typing import NamedTuple

import torch


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

