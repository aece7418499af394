"""Share of the IPE frames that reached the consensus check and failed it,
so that the brute-force initialisation ran, in %: 100 x the program's
counters `tracker/step.py::ipe_counts` `.fallback` over `.checked`, over
the process.  None on a program without the counters or where no IPE
frame reached the check."""

import sys


def read(run: dict):
    step = sys.modules.get("pf_monocular_pose_estimator_tpu_torch.tracker.step")
    counts = getattr(step, "ipe_counts", None)
    checked = getattr(counts, "checked", 0)
    return 100.0 * counts.fallback / checked if checked else None
