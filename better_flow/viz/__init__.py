from better_flow.viz.images import (
    arrow_flow_img,
    color_flow_img,
    color_gradient_img,
    color_time_img,
    generate_color_circle,
    projection_img,
    projection_img_unopt,
    time_img_u8,
)

__all__ = [
    "arrow_flow_img",
    "color_flow_img",
    "color_gradient_img",
    "color_time_img",
    "generate_color_circle",
    "projection_img",
    "projection_img_unopt",
    "time_img_u8",
]
