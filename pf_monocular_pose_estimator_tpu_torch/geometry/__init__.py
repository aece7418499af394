from .align import umeyama_rigid
from .camera import Camera, bearing_vectors, distort_pixels, project, undistort_pixels
from .se3 import exp_se3, inverse, log_se3, predict_constant_velocity, skew

__all__ = [
    "Camera",
    "bearing_vectors",
    "distort_pixels",
    "exp_se3",
    "inverse",
    "log_se3",
    "predict_constant_velocity",
    "project",
    "skew",
    "umeyama_rigid",
    "undistort_pixels",
]
