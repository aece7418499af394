# Frozen copy of pf_monocular_pose_estimator_tpu_torch/utils/dynamic.py, the port's plain
# PyTorch path, trimmed to what the benchmark's reference calls; it calls no
# kernel and no code of the program.
"""Runtime-tunable parameters (port of the reference's `utils/dynamic.py`).

In the reference these ride into the compiled step as traced operands so
retuning costs no recompile.  PyTorch runs eagerly, so here they are
plain float32 0-d tensors on the tracker's device; the step reads the
few it branches on as host floats.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import TrackerConfig


@dataclasses.dataclass
class DynamicParams:
    back_projection_pixel_tolerance: torch.Tensor
    back_projection_pixel_tolerance_pf: torch.Tensor
    nearest_neighbour_pixel_tolerance: torch.Tensor
    certainty_threshold: torch.Tensor
    valid_correspondence_threshold: torch.Tensor
    min_translation_noise: torch.Tensor
    max_translation_noise: torch.Tensor
    min_angular_noise: torch.Tensor
    max_angular_noise: torch.Tensor
    pf_exit_gate_factor: torch.Tensor
    pf_accept_gate_factor: torch.Tensor
    marginal_margin_factor: torch.Tensor
    noise_inflation_per_10_iters: torch.Tensor
    jump_threshold: torch.Tensor
    init_pair_distance_gate: torch.Tensor
    init_cluster_radius: torch.Tensor
    threshold_value: torch.Tensor
    min_blob_area: torch.Tensor
    max_blob_area: torch.Tensor
    max_width_height_distortion: torch.Tensor
    max_circular_distortion: torch.Tensor

    @classmethod
    def from_config(cls, config: TrackerConfig, device="cpu") -> "DynamicParams":
        return cls(
            **{
                f.name: torch.tensor(float(getattr(config, f.name)), dtype=torch.float32,
                                     device=device)
                for f in dataclasses.fields(cls)
            }
        )
