"""Kernel A's (`detect_stats`, `csrc/detect.cu`) share of its roofline: its
least time on the chip's HBM bandwidth (`detect_stats_bound`) over its mean
device time a launch in the profiled stretch, in %.

A's bytes: each crop pixel read once (4 B), its label and ten statistics
maps written once (4 x 11 B), and the top-k written (8 B each); bytes set
its bound up to 12 sweeps (0.70 µs on the 192x256 crop, its operations
0.03 µs).  Its pixels a launch are the program's counters
`detect_stats.pixels` over `detect_stats.launches`, over the process (the
crop has one size at every launch).  A launch is its kernels in the
stretch, one top-k merge each.  None on a program without the pixel
counter, and where the full-frame blur #2 ran in the stretch (its one
kernel is also A's first)."""

import sys

from roofline import HBM_BYTES_PER_S

TOPK = 16  # TrackerConfig.max_detections, which no cell sets
KERNELS = ("threshold_blur_kernel", "label_kernel", "label_round_kernel", "stats_kernel",
           "topk_merge_kernel", "wide_stats_kernel", "roots_merge_kernel")
LAST = ("topk_merge_kernel", "roots_merge_kernel")  # one of them ends every launch of A
BLUR = "threshold_blur_kernel"


def detect_stats_bound(pixels: float, topk: int = TOPK) -> float:
    """Kernel A's least time (s) a launch on `pixels` crop pixels."""
    return (48 * pixels + 8 * topk) / HBM_BYTES_PER_S


def read(run: dict):
    tr = run["trace"]
    dk = sys.modules.get("pf_monocular_pose_estimator_tpu_torch.ops.detect_kernel")
    counter = getattr(dk, "detect_stats", None)
    pixels = getattr(counter, "pixels", 0)
    if not tr or not pixels or not counter.launches:
        return None
    base = lambda n: n.split("<")[0]
    launches = sum(c for n, c in tr["launches_by_name"].items() if base(n) in LAST)
    blurs = sum(c for n, c in tr["launches_by_name"].items() if base(n) == BLUR)
    if not launches or blurs > launches:
        return None
    per_launch = sum(s for n, s in tr["device_s_by_name"].items() if base(n) in KERNELS) / launches
    return 100.0 * detect_stats_bound(pixels / counter.launches) / per_launch
