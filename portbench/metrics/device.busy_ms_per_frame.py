"""Device ms a frame in the profiled stretch: the union of every device
span (kernels, copies, sets) over the frames."""


def read(run: dict):
    tr = run["trace"]
    return tr["busy_s"] * 1e3 / tr["frames"] if tr else None
