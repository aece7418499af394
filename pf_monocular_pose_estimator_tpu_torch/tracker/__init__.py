from .check import check_correspondences
from .init_search import brute_force_histogram, correspondences_from_histogram
from .initialise import initialise
from .multi import (
    MultiTracker,
    create_states,
    make_multi_tracker,
    pad_marker_sets,
    stack_states,
    target_state,
)
from .short_p3p import short_p3p
from .state import FrameResult, TargetState
from .step import Tracker, make_tracker, tracker_step

__all__ = ["FrameResult", "MultiTracker", "TargetState", "Tracker", "brute_force_histogram",
           "check_correspondences", "correspondences_from_histogram", "create_states",
           "initialise", "make_multi_tracker", "make_tracker", "pad_marker_sets", "short_p3p",
           "stack_states", "target_state", "tracker_step"]
