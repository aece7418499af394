from .state import FrameResult, TargetState
from .step import Tracker, make_tracker

__all__ = ["FrameResult", "TargetState", "Tracker", "make_tracker"]
