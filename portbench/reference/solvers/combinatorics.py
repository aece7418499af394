# Frozen copy of pf_monocular_pose_estimator_tpu_torch/solvers/combinatorics.py, the port's plain
# PyTorch path, trimmed to what the benchmark's reference calls; it calls no
# kernel and no code of the program.
"""Host-side combinatoric index tables (numpy, static shapes).

Replaces the MATLAB-ported runtime enumerators of
pf_mpe_lib/src/combinations.cpp:34-302 (`combinationsNoReplacement`,
`permutationsNoReplacement`).  In the TPU design the marker count and the
detection capacity are static, so the index tables are precomputed once on
the host (0-based, unlike the reference's 1-based matrices) and baked into
the compiled program as constants; the compute path just gathers.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def combination_table(n: int, k: int) -> np.ndarray:
    """C(n, k) combinations as an (num, k) int32 array, 0-based."""
    if n < k:
        return np.zeros((0, k), dtype=np.int32)
    return np.array(list(itertools.combinations(range(n), k)), dtype=np.int32)


@lru_cache(maxsize=None)
def permutation_table(n: int, k: int) -> np.ndarray:
    """P(n, k) permutations as an (num, k) int32 array, 0-based."""
    if n < k:
        return np.zeros((0, k), dtype=np.int32)
    return np.array(list(itertools.permutations(range(n), k)), dtype=np.int32)
