from .checkpoint import load_state, save_state
from .config import BlobParams, TrackerConfig
from .dynamic import DynamicParams
from .flags import FailFlag

__all__ = ["BlobParams", "DynamicParams", "FailFlag", "TrackerConfig", "load_state", "save_state"]
