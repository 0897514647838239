"""Interactive manual minimization — OptimizerRolling::manual
(optimizer_rolling.h:128-233) with OpenCV trackbars.

Sliders x tilt / y tilt / rot / div (centred at 127) plus fine/coarse feed
the model deltas each tick; the accumulators advance with the manual-mode
dividers (10000, 10000, 1000, 1000 — :197), events are re-warped with the
accumulated totals, and the time image + colored gradient + color-time
views refresh.  'c' runs the automatic optimizer from the current state;
's' dumps the normalized time image; ESC exits.

Requires a display (cv2.namedWindow); the CLI falls back with a message
when none is available.
"""

from __future__ import annotations

import numpy as np


def run_manual(x, y, t_ns, sensor, scale: int = 3) -> dict:
    import cv2
    import jax.numpy as jnp

    from better_flow.config import OptimizerConfig
    from better_flow.core.events import make_slice
    from better_flow.core.model import MotionModel
    from better_flow.models import global_flow as gf
    from better_flow.ops.time_image import time_image
    from better_flow.ops.warp import project_4param_reinit
    from better_flow.viz.debug_images import gradient_img_color
    from better_flow.viz.images import color_time_img, time_img_u8

    ev = make_slice(np.asarray(x, np.float64), np.asarray(y, np.float64),
                    np.asarray(t_ns, np.float64))
    H, W = gf.static_image_shape(scale, sensor)
    geom = gf.slice_geometry(ev, scale, sensor)

    win = "Minimization output"
    win_color = "Minimization output color"
    cv2.namedWindow(win, cv2.WINDOW_NORMAL)
    cv2.namedWindow(win_color, cv2.WINDOW_NORMAL)
    for name, init, maxv in [("x tilt", 127, 255), ("y tilt", 127, 255),
                             ("rot", 127, 255), ("div", 127, 255),
                             ("fine/coarse", 500, 1000)]:
        cv2.createTrackbar(name, win, init, maxv, lambda *_: None)

    model = MotionModel.zero()
    pr_x, pr_y = ev.x, ev.y
    code = 0
    while code != 27:  # esc
        code = cv2.waitKey(33)
        if code == ord("c"):
            res = gf.process_slice(ev, model, OptimizerConfig(scale=scale), sensor)
            model = res.model
            pr_x, pr_y = res.pr_x, res.pr_y
            for name in ("x tilt", "y tilt", "rot", "div"):
                cv2.setTrackbarPos(name, win, 127)

        fine = cv2.getTrackbarPos("fine/coarse", win)
        dx = (cv2.getTrackbarPos("x tilt", win) - 127) / (fine + 1)
        dy = (cv2.getTrackbarPos("y tilt", win) - 127) / (fine + 1)
        rot = (cv2.getTrackbarPos("rot", win) - 127) / (fine + 1)
        div = (cv2.getTrackbarPos("div", win) - 127) / (fine + 1)

        cx = (float(model.cx) - float(geom.x_shift)) / scale
        cy = (float(model.cy) - float(geom.y_shift)) / scale
        model = model._replace(
            dx=jnp.float32(dx), dy=jnp.float32(dy),
            rot=jnp.float32(rot), div=jnp.float32(div),
        ).update_accumulators(10000.0, 10000.0, 1000.0, 1000.0)
        pr_x, pr_y, _, _ = project_4param_reinit(
            ev.x, ev.y, ev.t, pr_x, pr_y,
            -model.total_dx, -model.total_dy, cx, cy,
            model.total_div, -model.total_rot,
        )

        timg = time_image(pr_x, pr_y, ev.t, ev.active, scale,
                          geom.x_shift, geom.y_shift, geom.w_dyn, geom.h_dyn,
                          H, W)
        if code == ord("s"):
            cv2.imwrite(f"./time_manual.jpg", time_img_u8(np.asarray(timg)))

        cv2.imshow(win, gradient_img_color(timg))
        cv2.imshow(win_color, color_time_img(
            np.asarray(pr_x), np.asarray(pr_y), np.asarray(ev.t),
            scale=scale, res_x=sensor.res_x, res_y=sensor.res_y,
        ))

    cv2.destroyAllWindows()
    return {"model": model, "pr_x": np.asarray(pr_x), "pr_y": np.asarray(pr_y)}
