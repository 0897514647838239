from better_flow.eval.metrics import (
    FlowErrors,
    evaluate_flow,
    psnr,
    read_dense_gt,
    sharpness,
)

__all__ = ["FlowErrors", "evaluate_flow", "psnr", "read_dense_gt", "sharpness"]
