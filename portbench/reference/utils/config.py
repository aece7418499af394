# Frozen copy of pf_monocular_pose_estimator_tpu_torch/utils/config.py, the port's plain
# PyTorch path, trimmed to what the benchmark's reference calls; it calls no
# kernel and no code of the program.
"""Tracker configuration (a copy of the reference's `utils/config.py`).

Field for field the same frozen dataclass as the JAX package's
`TrackerConfig` (tests/test_torch_config.py holds them equal); only the
comments are shortened.  `BlobParams` lives here as well, because the
reference's lives in `ops/blob.py`, which pulls in jax.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple


class BlobParams(NamedTuple):
    """Static detection parameters (reference `ops/blob.py::BlobParams`)."""

    threshold: float = 240.0
    gaussian_sigma: float = 0.6
    min_blob_area: float = 20.0
    max_blob_area: float = 160.0
    max_width_height_distortion: float = 0.7
    max_circular_distortion: float = 0.7
    active_markers: bool = True
    max_detections: int = 16
    cc_sweeps: int = 12
    intensity_weighted_centroids: bool = False
    use_pallas: bool = True
    roi_crop: tuple | None = (192, 256)
    split_merged: bool = True
    split_max_factor: float = 2.5
    split_min_elongation: float = 1.5
    split_dip_ratio: float = 0.75


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    # --- detection ---
    threshold_value: float = 240.0
    gaussian_sigma: float = 0.6
    min_blob_area: float = 20.0
    max_blob_area: float = 160.0
    max_width_height_distortion: float = 0.7
    max_circular_distortion: float = 0.7
    roi_border_thickness: float = 10.0
    active_markers: bool = True
    max_detections: int = 16
    cc_sweeps: int = 12
    roi_crop: Tuple[int, int] | None = (192, 256)
    split_merged_blobs: bool = True
    split_max_factor: float = 2.5
    split_min_elongation: float = 1.5
    split_dip_ratio: float = 0.75

    # --- tolerances / thresholds ---
    back_projection_pixel_tolerance: float = 5.0
    back_projection_pixel_tolerance_pf: float = 10.0
    nearest_neighbour_pixel_tolerance: float = 7.0
    certainty_threshold: float = 1.0
    valid_correspondence_threshold: float = 0.5

    # --- fault injection ---
    number_of_occlusions: int = 0
    number_of_false_detections: int = 0

    # --- particle filter ---
    use_particle_filter: bool = True
    n_particles: int = 1000
    min_translation_noise: float = -0.025
    max_translation_noise: float = 0.025
    min_angular_noise: float = -0.02
    max_angular_noise: float = 0.02
    marker_downgrade: Tuple[bool, ...] = (False, False, False, False, False)
    use_cam_pos: bool = False
    use_pallas_weight: bool = True
    use_fused_pf_kernel: bool = True
    use_folded_pf_kernel: bool = True
    use_pallas_gn: bool = True
    use_closed_form_resample: bool = False
    use_pallas_resample: bool = False
    resample_min_ess: float = 0.15
    use_online_exposure_control: bool = False
    expose_time_base: float = 2000.0

    # --- promoted constants ---
    pf_max_retries: int = 80
    pf_exit_gate_factor: int = 5
    pf_accept_gate_factor: int = 3
    marginal_margin_factor: float = 0.0
    pf_init_min_markers: int = 4
    noise_inflation_per_10_iters: float = 0.025
    uncertainty_cap: int = 200
    jump_threshold: float = 0.3
    min_num_leds_detected: int = 4
    gn_max_iterations: int = 25
    gn_convergence_tol: float = 1e-4
    gn_hypotheses: int = 4
    gn_residual_gate: float = 1.5
    gn_step_radius: float = 0.08
    init_consistency_radius: float = 0.08
    init_consistency_rotation_deg: float = 35.0
    init_consistency_uncertainty_cap: int = 60
    init_consistency_reject_bump: int = 20
    init_drop_one_variants: int = 6
    degraded_reinit_frames: int = 12
    degraded_reset_decay: int = 0
    pf_coast_frames: int = 2
    degraded_weight_offset: float = 0.5
    jump_translation_radius: float = 0.0
    motion_prior_radius: float = 0.05
    motion_prior_falloff: float = 0.012
    abs_min_blob_area: float = 5.0
    abs_max_blob_area: float = 20.0
    blob_area_distance_slope: float = 10.0
    roi_uncertainty_growth: float = 7.0
    roi_distance_gain: float = 20.0
    roi_retry_growth: float = 20.0

    # --- capacities ---
    max_candidates_per_led: int = 4
    max_correspondence_candidates: int = 32
    max_p3p_seeds: int = 32
    roi_particle_subsample: int = 128

    init_pair_distance_gate: float = 1000.0
    init_cluster_radius: float = 1000.0
    init_cluster_min: int = 5

    debug_skip: Tuple[str, ...] = ()

    @classmethod
    def reference_parity(cls, **overrides) -> "TrackerConfig":
        base = dict(
            pf_init_min_markers=0,
            init_drop_one_variants=0,
            init_consistency_radius=0.0,
            degraded_reinit_frames=0,
            gn_hypotheses=1,
            jump_translation_radius=0.0,
            motion_prior_radius=0.0,
            marginal_margin_factor=0.0,
            split_merged_blobs=False,
            resample_min_ess=0.0,
            pf_coast_frames=0,
        )
        base.update(overrides)
        return cls(**base)

    def blob_params(self, adaptive: bool = False) -> BlobParams:
        return BlobParams(
            threshold=self.threshold_value,
            gaussian_sigma=self.gaussian_sigma,
            min_blob_area=self.min_blob_area,
            max_blob_area=self.max_blob_area,
            max_width_height_distortion=self.max_width_height_distortion,
            max_circular_distortion=self.max_circular_distortion,
            active_markers=self.active_markers,
            max_detections=self.max_detections,
            cc_sweeps=self.cc_sweeps,
            roi_crop=self.roi_crop,
            split_merged=self.split_merged_blobs,
            split_max_factor=self.split_max_factor,
            split_min_elongation=self.split_min_elongation,
            split_dip_ratio=self.split_dip_ratio,
        )
