from .gather_kernel import windowed_gather
from .propagate import NoiseBounds, propagate, propagation_noise_factors
from .refine import gauss_newton_refine
from .refine_kernel import gn_refine
from .resample import stratified_resample
from .resample_kernel import decode
from .step_kernel import pf_step, resample_gather
from .weight import weight_particles
from .weight_kernel import weight

__all__ = ["NoiseBounds", "decode", "gauss_newton_refine", "gn_refine", "pf_step", "propagate",
           "propagation_noise_factors", "resample_gather", "stratified_resample", "weight",
           "weight_particles", "windowed_gather"]
