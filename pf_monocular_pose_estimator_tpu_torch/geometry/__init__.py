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
