from .blob import Detections, determine_roi, find_leds, grow_roi
from .detect_kernel import detect_stats, threshold_blur
from .exposure import ExposureState, exposure_control
from .faults import inject_faults

__all__ = ["Detections", "ExposureState", "detect_stats", "determine_roi", "exposure_control",
           "find_leds", "grow_roi", "inject_faults", "threshold_blur"]
