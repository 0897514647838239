from better_flow.parallel.distributed import (
    initialize as initialize_distributed,
    make_host_mesh,
    process_local_slice_range,
)
from better_flow.parallel.event_parallel import process_slice_event_parallel
from better_flow.parallel.mesh import make_event_mesh
from better_flow.parallel.multihost import compensate_recording_multihost

__all__ = [
    "make_event_mesh",
    "process_slice_event_parallel",
    "initialize_distributed",
    "make_host_mesh",
    "process_local_slice_range",
    "compensate_recording_multihost",
]
