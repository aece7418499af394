"""Kernel B's (`pf_step_kernel`, `csrc/pf_step.cu`) share of its roofline:
its least time on the chip's peaks (`roofline.pf_step_bound`, the larger of
N x 132 bytes over HBM bandwidth and its operations over the float32 rate)
over its mean device time a launch in the profiled stretch, in %."""

from roofline import pf_step_bound


def read(run: dict):
    tr = run["trace"]
    if not tr:
        return None
    names = [n for n in tr["device_s_by_name"] if n.split("<")[0] == "pf_step_kernel"]
    launches = sum(tr["launches_by_name"][n] for n in names)
    if not launches:
        return None
    per_launch = sum(tr["device_s_by_name"][n] for n in names) / launches
    cell = run["cell"]
    least, _ = pf_step_bound(cell["n_particles"], cell["n_markers"], cell["n_markers"])
    return 100.0 * least / per_launch
