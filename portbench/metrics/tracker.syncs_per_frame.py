"""Device -> host reads of the tracker a frame over the window: the change
of the step's `host.count` (`utils/sync.py::HostReads`; one instance shared
by the targets of a multi-target step), over the frames.  The benchmark's
own read of each frame's pose is not counted."""


def read(run: dict):
    w = run["window"]
    return w["syncs"] / w["frames"] if w["frames"] else None
