"""Live frontend: lag monitor, point cloud, socket transport, visualizer."""

import threading

import numpy as np

from better_flow.config import (
    OptimizerConfig,
    PipelineConfig,
    SensorConfig,
    SliceConfig,
)
from better_flow.io.stream import EventPublisher, EventSubscriber, pack_events
from better_flow.io.synthetic import synthetic_events
from better_flow.runtime.live import EventVisualizer, LagMonitor, point_cloud


def test_lag_monitor_resets_on_time_jump():
    m = LagMonitor()
    m.update(int(1e9))
    m.update(int(2e9))
    assert m._event0 == int(1e9)
    m.update(int(0.5e9))  # backwards jump -> reset epoch
    assert m._event0 == int(0.5e9)


def test_lag_format_colors():
    m = LagMonitor()
    assert "92m" in m.format(0.0)    # green
    assert "93m" in m.format(0.1)    # yellow
    assert "91m" in m.format(0.5)    # red


def test_point_cloud_downsample():
    n = 500_000
    pc = point_cloud(np.zeros(n), np.zeros(n), np.arange(n, dtype=np.int64))
    assert len(pc) <= 200_000
    assert pc.shape[1] == 3


def test_visualizer_end_to_end():
    d = synthetic_events(20000, duration_s=0.4, res_x=24, res_y=32,
                         vx=20.0, vy=-10.0, seed=1)
    clouds, images, lags = [], [], []
    cfg = PipelineConfig(
        sensor=SensorConfig(24, 32),
        slice=SliceConfig(max_events=4000, span_ns=int(0.07e9),
                          refresh_events=3000, refresh_time_ns=int(0.05e9)),
        optimizer=OptimizerConfig(scale=1, max_iter=10, min_events=500),
    )
    vis = EventVisualizer(
        process_data=True, refresh_ns=int(0.066e9), cfg=cfg,
        on_cloud=clouds.append, on_images=images.append, on_lag=lags.append,
    )
    for start in range(0, len(d["x"]), 2048):
        end = start + 2048
        vis.add_events(d["x"][start:end], d["y"][start:end], d["t_ns"][start:end])
    assert len(clouds) >= 3
    assert len(lags) == len(clouds)
    assert images, "estimator produced no image refreshes"
    assert set(images[-1]) == {"projection", "color_flow", "unoptimized"}
    assert images[-1]["projection"].shape == (24, 32)


def test_socket_roundtrip():
    pub = EventPublisher()
    received = []
    sub = EventSubscriber(pub.address, on_batch=lambda x, y, t: received.append((x, y, t)))
    th = threading.Thread(target=sub.run, kwargs={"max_batches": 2}, daemon=True)
    th.start()
    import time

    time.sleep(0.1)  # let the subscriber connect
    x = np.array([1.0, 2.0], np.float32)
    y = np.array([3.0, 4.0], np.float32)
    t = np.array([10, 20], np.int64)
    pub.publish(x, y, t)
    pub.publish(x + 1, y + 1, t + 1)
    th.join(timeout=5)
    pub.close()
    sub.close()
    assert len(received) == 2
    np.testing.assert_array_equal(received[0][0], x)
    np.testing.assert_array_equal(received[1][2], t + 1)
