from better_flow.models.global_flow import (
    GlobalFlowState,
    SliceResult,
    process_slice,
    slice_geometry,
)

__all__ = [
    "GlobalFlowState",
    "SliceResult",
    "process_slice",
    "slice_geometry",
]
