from .config import BlobParams, TrackerConfig
from .dynamic import DynamicParams
from .flags import FailFlag

__all__ = ["BlobParams", "DynamicParams", "FailFlag", "TrackerConfig"]
