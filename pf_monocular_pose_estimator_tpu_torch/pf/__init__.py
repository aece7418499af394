from .refine_kernel import gn_refine
from .step_kernel import pf_step, resample_gather

__all__ = ["gn_refine", "pf_step", "resample_gather"]
