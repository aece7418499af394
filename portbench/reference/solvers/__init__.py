# Frozen copy of pf_monocular_pose_estimator_tpu_torch/solvers/__init__.py, the port's plain
# PyTorch path, trimmed to what the benchmark's reference calls; it calls no
# kernel and no code of the program.
from .combinatorics import combination_table, permutation_table
from .p3p import p3p_kneip, p3p_object_to_camera
from .quartic import solve_quartic

__all__ = [
    "combination_table",
    "p3p_kneip",
    "p3p_object_to_camera",
    "permutation_table",
    "solve_quartic",
]
