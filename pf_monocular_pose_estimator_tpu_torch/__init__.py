"""pf_monocular_pose_estimator_tpu_torch — the PyTorch + CUDA port.

The same LED-marker 6-DoF tracker as `pf_monocular_pose_estimator_tpu`
(the JAX/Pallas reference, which this package never imports), written as
plain functions on torch tensors with hand-written CUDA kernels for
Hopper (`sm_90a`) where the reference has Pallas kernels.

Layer map (the reference's names, so each module's counterpart is easy
to find):
  geometry/  SE(3) exp/log, pinhole camera + plumb-bob distortion, Umeyama
  solvers/   batched Ferrari quartic + Kneip P3P, combinatoric tables
  ops/       LED detection (`detect_kernel` wraps csrc/detect.cu), fault
             injection, online exposure control
  pf/        propagate, weight, resample, refine; `step_kernel` wraps
             csrc/pf_step.cu + csrc/resample_gather.cu, `weight_kernel`
             csrc/pf_weight.cu, `resample_kernel` csrc/resample_decode.cu,
             `gather_kernel` csrc/monotone_gather.cu, `refine_kernel`
             csrc/gn_refine.cu
  tracker/   per-frame state machine (init branch, PF and IPE track
             branches, observer ego-motion)
  parallel/  the bank sharded over a particles mesh: `comm` (a local mesh
             of P shards on one device, or one shard per
             `torch.distributed` rank), the ring resampler, kernel B per
             shard, the sharded tracker; `gather_kernel` wraps
             csrc/ring_gather.cu
  utils/     config, fail flags, dynamic params, threefry PRNG, state
             converters, the kernel library build
  csrc/      CUDA C++ sources, built at first use into build/torch_kernels/

Every kernel wrapper takes its plain PyTorch version for CPU tensors and
launches its CUDA kernel (or raises) for CUDA tensors.  The entry points
(`tracker.make_tracker`, `tracker.TargetState.create`) run on the card
unless given `device="cpu"`.
"""

import torch as _torch

__version__ = "0.1.0"

# TF32 keeps ~3 decimal digits.  The reference measured what reduced-
# precision matmuls cost this geometry (its package __init__: the 4x4
# composes, marker projections and Gauss-Newton normal equations are
# small matmuls whose rounding lands in the pixel residuals — orientation
# error went from 0.93 deg to 2.4-7.8 deg), so both switches stay off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
