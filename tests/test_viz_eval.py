"""Visualization images and evaluation metrics."""

import numpy as np
import pytest

from better_flow.eval.metrics import FlowErrors, aee, evaluate_flow, psnr, sharpness
from better_flow.io.synthetic import synthetic_events
from better_flow.viz.images import (
    arrow_flow_img,
    color_flow_img,
    color_gradient_img,
    color_time_img,
    generate_color_circle,
    projection_img,
)
from better_flow.viz.video import f2str

cv2 = pytest.importorskip("cv2")


@pytest.fixture
def scene():
    return synthetic_events(5000, duration_s=0.1, res_x=24, res_y=32,
                            vx=20.0, vy=-10.0, seed=0)


def test_projection_img_shape_and_normalization(scene):
    img = projection_img(scene["x"], scene["y"], scale=3, res_x=24, res_y=32)
    assert img.shape == (72, 96)
    assert img.dtype == np.uint8
    nz = img[img > 0]
    # normalized so nonzero mean ~127 (saturation may skew slightly)
    assert 100 < nz.mean() < 160


def test_projection_sharper_when_compensated(scene):
    """Compensating exact motion concentrates mass -> higher nonzero mean."""
    t_s = scene["t_ns"] / 1e9
    raw = projection_img(scene["x"], scene["y"], scale=3, res_x=24, res_y=32)
    comp = projection_img(scene["x"] - 20.0 * t_s, scene["y"] + 10.0 * t_s,
                          scale=3, res_x=24, res_y=32)
    assert (comp > 0).sum() < (raw > 0).sum()


def test_color_time_img(scene):
    img = color_time_img(scene["x"], scene["y"], scene["t_ns"],
                         scale=3, res_x=24, res_y=32)
    assert img.shape == (75, 99, 3)
    assert img.any()


def test_color_flow_and_arrow(scene):
    u = np.full(len(scene["x"]), 20.0)
    v = np.full(len(scene["x"]), -10.0)
    cf = color_flow_img(scene["x"], scene["y"], u, v, res_x=24, res_y=32)
    assert cf.shape == (24, 32, 3)
    ar = arrow_flow_img(scene["x"][:50], scene["y"][:50], u[:50], v[:50],
                        res_x=24, res_y=32)
    assert ar.shape == (240, 320, 3)


def test_color_gradient_img():
    gx = np.random.default_rng(0).normal(size=(20, 20)).astype(np.float32)
    gy = np.random.default_rng(1).normal(size=(20, 20)).astype(np.float32)
    img = color_gradient_img(gx, gy)
    assert img.shape == (20, 20, 3)


def test_color_circle():
    img = generate_color_circle()
    assert img.shape == (4000, 4000, 3)


def test_f2str_matches_reference_semantics():
    assert f2str(1.23) == "1.23"
    assert f2str(-1.23) == "-1.23"
    assert f2str(0.5) == "0.50"[:4 - 1] or f2str(0.5) == "0.50"  # "0.50" vs "0.5"
    # the reference's no-zero-padding quirk: 1.05 -> "1.5"
    assert f2str(1.05) == "1.5"


def test_psnr_and_sharpness():
    a = np.random.default_rng(0).random((32, 32))
    assert psnr(a, a) == float("inf")
    noisy = a + 0.01
    assert psnr(a, noisy) > 30
    img = np.zeros((10, 10)); img[2, 2] = 100; img[3, 3] = 50
    assert sharpness(img) == 75.0


def test_evaluate_flow_perfect_estimate():
    """When the estimate equals GT, all errors vanish."""
    n = 200
    rng = np.random.default_rng(0)
    px = rng.integers(1, 23, n).astype(float)
    py = rng.integers(1, 31, n).astype(float)
    u = np.full(n, 5.0)
    v = np.full(n, -3.0)
    gt = np.zeros((25, 32, 2))
    gt[..., 0] = 5.0
    gt[..., 1] = -3.0
    e = evaluate_flow(px, py, u, v, gt, res_x=24, res_y=32)
    assert e.n == n
    assert e.speed < 1e-9
    assert e.angular < 1e-6
    assert e.vector < 1e-9


def test_evaluate_flow_projection_semantics():
    """GT is projected onto the estimated direction before comparison
    (event_file.cpp:174-183): an orthogonal estimate sees zero gt speed."""
    gt = np.zeros((25, 32, 2))
    gt[..., 0] = 10.0  # gt points along +x
    e = evaluate_flow([5.0], [5.0], [0.0], [4.0], gt, res_x=24, res_y=32)
    # projection of (10,0) onto (0,1) is zero -> speed error == est speed
    assert abs(e.speed - 4.0) < 1e-9


def test_aee():
    assert aee([1, 2], [0, 0], [1, 2], [0, 0]) == 0.0
    assert abs(aee([0.0], [0.0], [3.0], [4.0]) - 5.0) < 1e-12


def test_video_sink_writes_frames(tmp_path):
    """VideoSink + hud_frame produce a playable file (dvs_flow.h:114-129)."""
    import numpy as np

    from better_flow.viz.video import VideoSink

    path = str(tmp_path / "out.mp4")
    sink = VideoSink(path, fps=10, res_x=24, res_y=32)
    frame = np.random.default_rng(0).integers(
        0, 255, (2 * 24 * 3, 2 * 32 * 3, 3), np.uint8
    )
    for _ in range(5):
        sink.write(frame)
    sink.close()
    import os

    assert os.path.getsize(path) > 1000
    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    assert n == 5
