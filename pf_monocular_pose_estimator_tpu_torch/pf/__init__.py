from .gather_kernel import windowed_gather
from .refine_kernel import gn_refine
from .resample_kernel import decode
from .step_kernel import pf_step, resample_gather
from .weight_kernel import weight

__all__ = ["decode", "gn_refine", "pf_step", "resample_gather", "weight", "windowed_gather"]
