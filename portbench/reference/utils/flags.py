# Frozen copy of pf_monocular_pose_estimator_tpu_torch/utils/flags.py, the port's plain
# PyTorch path, trimmed to what the benchmark's reference calls; it calls no
# kernel and no code of the program.
"""The per-frame failure taxonomy.

Functional parity target: the 17 FailFlag codes of
pf_mpe/include/pf_mpe/monocular_pose_estimator.h:121-137, set throughout
pf_mpe_lib/src/pose_estimator.cpp (SURVEY.md §5).  Values kept numerically
identical (including the reference's fractional 1.5 "jump" code, stored
x10 here so the enum stays integral: flag 15 == reference 1.5).
"""

from __future__ import annotations

import enum


class FailFlag(enum.IntEnum):
    """Per-frame status, x10 vs. the reference's float codes."""

    NOT_PROCESSED = -10  # reference -1: initial value
    INIT_SUCCESS = 0  # 0: brute-force initialisation succeeded
    PF_SUCCESS = 10  # 1: particle filter produced a pose
    PF_JUMP = 15  # 1.5: optimisation jumped (rotation delta >= 0.3)
    SHORT_P3P_SUCCESS = 20  # 2: re-initialised via short P3P
    TOO_FEW_LEDS_INIT = 30  # 3: not enough detections to initialise
    PF_NO_REASONABLE_PARTICLE = 40  # 4: no particle above the accept gate
    UNCERTAINTY_REINIT = 50  # 5: uncertainty cap forced re-init
    TOO_FEW_CORRESPONDENCES = 60  # 6: checkCorrespondences input too small
    NOT_ENOUGH_VALID_CORR = 70  # 7: valid fraction below threshold
    CERTAINTY_FAILED_ALL = 80  # 8: certainty gate failed for all combos
    P3P_FAILED = 90  # 9: P3P solver failed (collinear)
    TOO_FEW_MARKERS_DETECTED = 100  # 10: fewer detections than markers
    NO_CORR_FROM_HISTOGRAM = 110  # 11: histogram produced no candidates
    HISTOGRAM_ALL_ZERO = 120  # 12: vote histogram empty
    SHORT_TOO_FEW_DETECTIONS = 130  # 13: short P3P input too small
    SHORT_NO_CORR_FROM_HISTOGRAM = 140  # 14
    SHORT_HISTOGRAM_FAILED = 150  # 15
    SHORT_P3P_FAILED = 160  # 16
    # engine extension (no reference counterpart): a validated init pose
    # was rejected by the temporal-consistency gate
    INIT_INCONSISTENT = 170
