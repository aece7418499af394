from .multi import (
    MultiTracker,
    create_states,
    make_multi_tracker,
    pad_marker_sets,
    stack_states,
    target_state,
)
from .state import FrameResult, TargetState
from .step import Tracker, make_tracker

__all__ = ["FrameResult", "MultiTracker", "TargetState", "Tracker", "create_states",
           "make_multi_tracker", "make_tracker", "pad_marker_sets", "stack_states",
           "target_state"]
