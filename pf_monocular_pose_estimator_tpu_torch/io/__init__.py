from .metrics import absolute_trajectory_error, orientation_error_deg
from .synthetic import (
    SyntheticSequence,
    default_camera,
    demo_markers,
    make_orbit_sequence,
    make_realistic_sequence,
    make_two_target_sequence,
    render_frame,
    second_markers,
)

__all__ = ["SyntheticSequence", "absolute_trajectory_error", "default_camera", "demo_markers",
           "make_orbit_sequence", "make_realistic_sequence", "make_two_target_sequence",
           "orientation_error_deg", "render_frame", "second_markers"]
