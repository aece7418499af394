"""Device µs a frame in the kernels of `csrc/detect.cu` (kernel A and the
full-frame blur #2, `ops/detect_kernel.py`), by their names in the profiled
stretch."""

KERNELS = ("threshold_blur_kernel", "label_kernel", "label_round_kernel", "stats_kernel",
           "topk_merge_kernel", "wide_stats_kernel", "roots_merge_kernel")


def read(run: dict):
    tr = run["trace"]
    if not tr:
        return None
    s = sum(t for name, t in tr["device_s_by_name"].items() if name.split("<")[0] in KERNELS)
    return s * 1e6 / tr["frames"] if s > 0 else None
