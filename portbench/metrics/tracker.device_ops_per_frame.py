"""Device operations (kernels, copies and sets) a frame in the profiled
stretch: what the tracker's host loop launches."""


def read(run: dict):
    tr = run["trace"]
    return tr["device_ops"] / tr["frames"] if tr else None
