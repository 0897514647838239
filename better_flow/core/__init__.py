from better_flow.core.events import EventSlice
from better_flow.core.model import MotionModel

__all__ = ["EventSlice", "MotionModel"]
