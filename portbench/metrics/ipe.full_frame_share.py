"""Share of the IPE track frames that found too few LEDs in the ROI and
detected again on the whole frame, in %: 100 x the program's counters
`tracker/step.py::ipe_counts` `.full_frame` over `.frames`, over the
process.  None on a program without the counters or where no IPE frame
ran."""

import sys


def read(run: dict):
    step = sys.modules.get("pf_monocular_pose_estimator_tpu_torch.tracker.step")
    counts = getattr(step, "ipe_counts", None)
    frames = getattr(counts, "frames", 0)
    return 100.0 * counts.full_frame / frames if frames else None
