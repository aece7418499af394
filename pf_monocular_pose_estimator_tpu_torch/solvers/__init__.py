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
