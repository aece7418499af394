# Frozen copy of pf_monocular_pose_estimator_tpu_torch/geometry/__init__.py, the port's plain
# PyTorch path, trimmed to what the benchmark's reference calls; it calls no
# kernel and no code of the program.
from .align import umeyama_rigid
from .camera import (
    Camera,
    bearing_vectors,
    distort_pixels,
    project,
    project_points,
    undistort_pixels,
)
from .se3 import compose, exp_se3, inverse, log_se3, predict_constant_velocity, rotation_rpy, skew

__all__ = [
    "Camera",
    "bearing_vectors",
    "compose",
    "distort_pixels",
    "exp_se3",
    "inverse",
    "log_se3",
    "predict_constant_velocity",
    "project",
    "project_points",
    "rotation_rpy",
    "skew",
    "umeyama_rigid",
    "undistort_pixels",
]
