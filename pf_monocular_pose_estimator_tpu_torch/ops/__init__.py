from .blob import Detections, determine_roi, find_leds, grow_roi
from .detect_kernel import detect_stats, threshold_blur

__all__ = ["Detections", "detect_stats", "determine_roi", "find_leds", "grow_roi",
           "threshold_blur"]
