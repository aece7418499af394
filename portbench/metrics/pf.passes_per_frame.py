"""PF passes a frame over the window: the change of kernel B's launch
counter (`pf/step_kernel.py::pf_step.launches`) over the frames, every
target's passes counted."""


def read(run: dict):
    w = run["window"]
    return w["pf_launches"] / w["frames"] if w["frames"] and w["pf_launches"] else None
