from .markers import load_camera_calibration, load_marker_positions
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
from .viz import render_overlay

__all__ = ["SyntheticSequence", "absolute_trajectory_error", "default_camera", "demo_markers",
           "load_camera_calibration", "load_marker_positions", "make_orbit_sequence",
           "make_realistic_sequence", "make_two_target_sequence", "orientation_error_deg",
           "render_frame", "render_overlay", "second_markers"]
