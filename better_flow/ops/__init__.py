from better_flow.ops.warp import (
    apply_project,
    compute_uv,
    n_from_u,
    project_4param,
    project_4param_reinit,
    project_divcrl,
)
from better_flow.ops.time_image import (
    time_image,
    count_image,
    scatter_images,
)
from better_flow.ops.gradient import masked_scharr, lr_sobel, gradient_img_fuse
from better_flow.ops.reductions import (
    center_of_mass,
    model_compute,
    nonzero_average,
)

__all__ = [
    "apply_project",
    "compute_uv",
    "n_from_u",
    "project_4param",
    "project_4param_reinit",
    "project_divcrl",
    "time_image",
    "count_image",
    "scatter_images",
    "masked_scharr",
    "lr_sobel",
    "gradient_img_fuse",
    "center_of_mass",
    "model_compute",
    "nonzero_average",
]
