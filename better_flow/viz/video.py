"""Video/picture generation with the reference's HUD.

Transcribes the output block of DVS_flow::recompute (dvs_flow.h:255-335):
a 2x2 grid [compensated count | compensated color-time; raw count | raw
color-time] with timestamp / %realtime / slice width / event counts overlaid
on the top-left quadrant and the model state on the bottom-left.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from better_flow.viz.images import color_time_img, projection_img


def f2str(v: float) -> str:
    """dvs_flow.h:14-19: two-decimal truncation formatter (C++ integer
    division semantics, including its no-zero-padding quirk)."""
    base = int(v * 100)
    whole = int(base / 100)  # truncation toward zero, like C++
    return f"{whole}.{abs(base) % 100}"


def _put(img, text, org):
    cv2.putText(img, text, org, cv2.FONT_HERSHEY_DUPLEX, 0.6,
                (255, 255, 255), 1, cv2.LINE_AA, False)


def hud_frame(rec, model, res_x: int, res_y: int, time_diff_ns: int,
              on_time_change_ns: int, buf_size: int, event_diff: int) -> np.ndarray:
    """Build one HUD frame from a SliceRecord (dvs_flow.h:255-335)."""
    if cv2 is None:  # pragma: no cover
        raise ImportError("OpenCV (cv2) required for video generation")
    kw = dict(res_x=res_x, res_y=res_y)
    img_pr_f = projection_img(rec.pr_x, rec.pr_y, rec.noise, scale=3, **kw)
    img_color_f = color_time_img(rec.pr_x, rec.pr_y, rec.t_local, rec.noise, scale=3, **kw)
    img_pr_t = projection_img(rec.x, rec.y, rec.noise, scale=3, **kw)
    img_color_t = color_time_img(rec.x, rec.y, rec.t_local, rec.noise, scale=3, **kw)

    img_pr_t = cv2.cvtColor(img_pr_t, cv2.COLOR_GRAY2BGR)
    img_pr_f = cv2.cvtColor(img_pr_f, cv2.COLOR_GRAY2BGR)

    size = (res_y * 3, res_x * 3)
    img_pr_t = cv2.resize(img_pr_t, size)
    img_pr_f = cv2.resize(img_pr_f, size)
    img_color_t = cv2.resize(img_color_t, size)
    img_color_f = cv2.resize(img_color_f, size)

    slice_w = time_diff_ns / 1e9
    speedup = on_time_change_ns / time_diff_ns if time_diff_ns else 0.0
    ts = rec.timestamp[-1] / 1e9 if rec.n_events else 0.0
    _put(img_pr_t, "timestamp: " + f2str(ts), (20, 40))
    _put(img_pr_t, "%realtime: " + f2str(speedup), (20, 70))
    _put(img_pr_t, "Time diff (new): " + f2str(slice_w), (20, 100))
    _put(img_pr_t, f"Events: {buf_size}", (20, 130))
    _put(img_pr_t, f"New events: {event_diff}", (20, 160))

    h = res_x * 3
    _put(img_pr_f, "Model:", (20, h - 160))
    _put(img_pr_f, f"C: ({f2str(float(model.cx))}, {f2str(float(model.cy))})", (20, h - 130))
    _put(
        img_pr_f,
        f"Shift: ({f2str(float(model.dx))}, {f2str(float(model.dy))}); "
        f"total: ({f2str(float(model.total_dx))}, {f2str(float(model.total_dy))})",
        (20, h - 100),
    )
    _put(img_pr_f, f"Rot: {f2str(float(model.rot))} total: {f2str(float(model.total_rot))}", (20, h - 70))
    _put(img_pr_f, f"Div: {f2str(float(model.div))} total: {f2str(float(model.total_div))}", (20, h - 40))

    top = np.hstack([img_pr_t, img_color_t])
    bottom = np.hstack([img_pr_f, img_color_f])
    return np.vstack([top, bottom])


class VideoSink:
    """cv::VideoWriter equivalent (dvs_flow.h:114-129) with mp4 default."""

    def __init__(self, path: str, fps: int = 30, res_x: int = 180, res_y: int = 240):
        if cv2 is None:  # pragma: no cover
            raise ImportError("OpenCV (cv2) required for video generation")
        w, h = 2 * res_y * 3, 2 * res_x * 3
        fourcc = cv2.VideoWriter_fourcc(*("mp4v" if path.endswith(".mp4") else "MJPG"))
        self.writer = cv2.VideoWriter(path, fourcc, fps, (w, h), True)

    def write(self, frame: np.ndarray):
        self.writer.write(frame)

    def close(self):
        self.writer.release()
