"""Live streaming frontend — the bf_visualizer (ROS node) equivalent.

The reference's live pipeline (ros_nodes_src/bf_visualizer.cpp) subscribes
to a DVS event topic, keeps a large display buffer, optionally runs an
embedded low-latency DVS_flow, publishes a 3-D point cloud of the slice and
projection/color-flow images, and instruments processing lag.  ROS is
replaced here by plain callbacks plus an optional socket transport
(better_flow.io.stream); everything else is transcribed:

* display buffer: 1e6 events / 0.5 s (bf_visualizer.cpp:30-31)
* embedded estimator: 30k / 0.07 s slices, scale 1, max 10 iterations
  (bf_visualizer.cpp:33-34, 102-104 — config.low_latency_config)
* point cloud: (x, y, t) triples downsampled to <= 200k points
  (bf_visualizer.cpp:215-243)
* lag monitor: wall-clock vs event-time delta with colour-coded print and
  auto-reset on timestamp jumps (bf_visualizer.cpp:181-200)
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from better_flow.config import PipelineConfig, low_latency_config
from better_flow.runtime.dvs_flow import DVSFlow
from better_flow.runtime.slice_buffer import EventRingBuffer

_GREEN = "\033[92m"
_YELLOW = "\033[93m"
_RED = "\033[91m"
_RESET = "\033[0m"


class LagMonitor:
    """Wall-clock vs event-time lag (bf_visualizer.cpp:181-200).

    The reference prints the delta between elapsed wall time and elapsed
    event time since the epoch of the first event, colour-coded green /
    yellow / red, and resets its epoch when the event timestamps jump
    backwards (a new recording or a camera reset).
    """

    def __init__(self, yellow_s: float = 0.05, red_s: float = 0.2):
        self.yellow_s = yellow_s
        self.red_s = red_s
        self.reset()

    def reset(self):
        self._wall0 = None
        self._event0 = None
        self._last_event = None

    def update(self, event_time_ns: int) -> float:
        now = time.monotonic()
        if self._last_event is not None and event_time_ns < self._last_event:
            # timestamp jump -> new stream epoch (bf_visualizer.cpp:187-189)
            self.reset()
        self._last_event = event_time_ns
        if self._wall0 is None:
            self._wall0 = now
            self._event0 = event_time_ns
            return 0.0
        lag = (now - self._wall0) - (event_time_ns - self._event0) / 1e9
        return lag

    def format(self, lag: float) -> str:
        colour = _GREEN if lag < self.yellow_s else (
            _YELLOW if lag < self.red_s else _RED
        )
        return f"{colour}lag: {lag * 1000:+.1f} ms{_RESET}"


def point_cloud(x, y, t_ns, max_points: int = 200_000) -> np.ndarray:
    """(x, y, t-seconds) triples, uniformly downsampled to <= max_points
    (bf_visualizer.cpp:219-222 computes the same 'density' stride)."""
    n = len(x)
    stride = max(1, int(np.ceil(n / max_points)))
    idx = np.arange(0, n, stride)
    return np.stack(
        [np.asarray(x)[idx], np.asarray(y)[idx], np.asarray(t_ns)[idx] / 1e9],
        axis=1,
    )


class EventVisualizer:
    """Live frontend: display buffer + optional embedded estimator.

    Callbacks replace ROS publishers:
      on_cloud(points)                      -- the rviz point cloud topic
      on_images(dict of named images)       -- the three image topics
      on_lag(lag_seconds)                   -- the lag print
    """

    def __init__(
        self,
        process_data: bool = True,
        refresh_ns: int = int(0.066e9),
        display_capacity: int = 1_000_000,
        display_span_ns: int = int(0.5e9),
        cfg: Optional[PipelineConfig] = None,
        on_cloud: Optional[Callable] = None,
        on_images: Optional[Callable] = None,
        on_lag: Optional[Callable] = None,
        quiet: bool = False,
    ):
        self.buffer = EventRingBuffer(display_capacity, display_span_ns)
        self.estimator: Optional[DVSFlow] = None
        self._last_rec = None
        if process_data:
            self.estimator = DVSFlow(cfg or low_latency_config())
            self.estimator.on_slice = self._stash_slice
        self.refresh_ns = refresh_ns
        self.last_refresh = 0
        self.lag = LagMonitor()
        self.on_cloud = on_cloud
        self.on_images = on_images
        self.on_lag = on_lag
        self.quiet = quiet

    def add_events(self, x, y, t_ns) -> int:
        """Feed a batch; fires visualization refreshes like the event
        callback + trigger of bf_visualizer.cpp:116-128, 163-200."""
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        t_ns = np.asarray(t_ns, np.int64)
        self.buffer.push_batch(x, y, t_ns)
        if self.estimator is not None:
            self.estimator.add_events(x, y, t_ns)
        fired = 0
        if len(t_ns):
            newest = int(t_ns[-1])
            lag = self.lag.update(newest)
            if newest - self.last_refresh >= self.refresh_ns:
                self.last_refresh = newest
                self._refresh(lag)
                fired += 1
        return fired

    def _stash_slice(self, rec):
        self._last_rec = rec

    def _refresh(self, lag: float):
        if self.on_lag is not None:
            self.on_lag(lag)
        elif not self.quiet:
            print(self.lag.format(lag))
        snap = self.buffer.snapshot()
        if self.on_cloud is not None:
            self.on_cloud(point_cloud(snap["x"], snap["y"], snap["timestamp"]))
        if self.on_images is not None and self._last_rec is not None:
            rec = self._last_rec
            from better_flow.viz.images import (
                color_flow_img,
                projection_img,
                projection_img_unopt,
            )

            sensor = self.estimator.cfg.sensor
            self.on_images({
                # visualize_minimizer's three topics (bf_visualizer.cpp:246-267)
                "projection": projection_img(
                    rec.pr_x, rec.pr_y, rec.noise, scale=1,
                    res_x=sensor.res_x, res_y=sensor.res_y,
                ),
                "color_flow": color_flow_img(
                    rec.pr_x, rec.pr_y, rec.u, rec.v, rec.noise,
                    res_x=sensor.res_x, res_y=sensor.res_y,
                ),
                "unoptimized": projection_img_unopt(
                    rec.x, rec.y, rec.noise, scale=1,
                    res_x=sensor.res_x, res_y=sensor.res_y,
                ),
            })


def replay_file(path: str, visualizer: EventVisualizer, chunk: int = 4096,
                realtime: bool = False) -> int:
    """File-replay mode (bf_visualizer.cpp:302-337): feed a recording
    through the live frontend, optionally paced to wall-clock."""
    from better_flow.io.event_file import read_events

    rec = read_events(path)
    n = len(rec["x"])
    t0_wall = time.monotonic()
    t0_ev = int(rec["t_ns"][0]) if n else 0
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        if realtime:
            target = (int(rec["t_ns"][end - 1]) - t0_ev) / 1e9
            sleep = target - (time.monotonic() - t0_wall)
            if sleep > 0:
                time.sleep(sleep)
        visualizer.add_events(
            rec["x"][start:end], rec["y"][start:end], rec["t_ns"][start:end]
        )
    return n
