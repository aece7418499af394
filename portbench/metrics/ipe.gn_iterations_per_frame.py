"""Gauss-Newton iterations a frame that the IPE track branch ran op by op
from the host: the program's counters `tracker/step.py::ipe_counts`
`.gn_iterations` over `.frames`, over the process (`gn_max_iterations` a
frame refined once; less where frames end before the refine).  0.0 where
IPE frames ran none; None on a program without the counters
or where no IPE frame ran."""

import sys


def read(run: dict):
    step = sys.modules.get("pf_monocular_pose_estimator_tpu_torch.tracker.step")
    counts = getattr(step, "ipe_counts", None)
    frames = getattr(counts, "frames", 0)
    return counts.gn_iterations / frames if frames else None
