"""Share of the refine layer's calls that ran as one launch of the fused
kernel (`pf/refine_kernel.py::refine_frame`, `csrc/gn_refine.cu`), in %:
100 x the wrapper's `launches` over its `calls`, over the process (a call
on CPU tensors takes the plain twin: a call and no launch).  None on a
program without the counters."""

import sys


def read(run: dict):
    rk = sys.modules.get("pf_monocular_pose_estimator_tpu_torch.pf.refine_kernel")
    counter = getattr(rk, "refine_frame", None)
    calls = getattr(counter, "calls", 0)
    return 100.0 * counter.launches / calls if calls else None
