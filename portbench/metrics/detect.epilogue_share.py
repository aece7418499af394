"""Share of the crop path's epilogue calls that ran as one launch of its
kernel (`ops/detect_kernel.py::detect_epilogue`, `csrc/detect.cu`), in %:
100 x the wrapper's `launches` over its `calls`, over the process (a call
on CPU tensors takes the plain twin: a call and no launch).  None on a
program without the counters."""

import sys


def read(run: dict):
    dk = sys.modules.get("pf_monocular_pose_estimator_tpu_torch.ops.detect_kernel")
    counter = getattr(dk, "detect_epilogue", None)
    calls = getattr(counter, "calls", 0)
    return 100.0 * counter.launches / calls if calls else None
