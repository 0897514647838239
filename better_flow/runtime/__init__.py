from better_flow.runtime.slice_buffer import EventRingBuffer
from better_flow.runtime.dvs_flow import DVSFlow

__all__ = ["EventRingBuffer", "DVSFlow"]
