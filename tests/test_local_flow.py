"""Local 2-param window optimizer and score-search model."""

import numpy as np
import jax.numpy as jnp
import pytest

from better_flow.io.synthetic import synthetic_events
from better_flow.models.local_flow import (
    LocalWindow,
    flow_field_grid,
    gather_windows,
    local_flow_field,
    gaussian_kernel_1d,
)
from better_flow.models.score_search import compute_flow_bruteforce
from better_flow.config import NZ, UV_FACTOR


def test_gaussian_kernel_matches_opencv():
    cv2 = pytest.importorskip("cv2")
    for k in (3, 5, 7):
        ours = gaussian_kernel_1d(k)
        theirs = cv2.getGaussianKernel(k, 0).ravel()
        np.testing.assert_allclose(ours, theirs, rtol=1e-5)


def test_gather_windows():
    x = np.array([5.0, 6.0, 20.0, 5.5])
    y = np.array([5.0, 6.0, 20.0, 5.5])
    t = np.zeros(4)
    wins = gather_windows(x, y, t, np.ones(4, bool), [5.0], [5.0], wsz=5, k=3)
    assert int(wins.valid[0].sum()) == 3  # events 0, 1, 3 are inside


def test_local_flow_recovers_translation():
    """A window over a translating scene recovers the flow direction.

    The window's fixed event subset must cover the full slice time span
    (k >= events in window) or the sub-pixel warp plateau stalls the
    descent — mirrors the C++ window constructor taking *all* window events
    (optimizer_sampler.h:31-48)."""
    d = synthetic_events(6000, duration_s=0.1, res_x=48, res_y=48,
                         vx=90.0, vy=-60.0, n_points=60, seed=3,
                         margin=0.25)
    wins = gather_windows(
        d["x"], d["y"], d["t_ns"].astype(np.float64),
        np.ones(len(d["x"]), bool), [24.0], [24.0], wsz=31, k=6144,
    )
    u, v, n_ev, iters, _nx, _ny = local_flow_field(wins, scale=3, wsz=31)
    assert int(n_ev[0]) > 100
    assert int(iters[0]) > 3
    # direction should roughly match (loose: single window, quantized data)
    assert float(u[0]) > 20.0
    assert float(v[0]) < -10.0


def test_flow_field_grid_shapes():
    d = synthetic_events(6000, duration_s=0.1, res_x=48, res_y=64,
                         vx=20.0, vy=0.0, seed=5)
    out = flow_field_grid(d["x"], d["y"], d["t_ns"], 48, 64,
                          step=16, wsz=15, scales=(3,), k=512)
    assert out["u"].shape == out["grid_x"].shape
    assert out["n_events"].sum() > 0


def test_bruteforce_finds_translation():
    """The candidate sweep prefers the true flow over zero flow."""
    vx = 40.0
    d = synthetic_events(3000, duration_s=0.1, res_x=32, res_y=32,
                         vx=vx, vy=0.0, n_points=50, seed=7, margin=0.25)
    true_nx = vx * NZ / UV_FACTOR  # = n_from_u
    out = compute_flow_bruteforce(
        d["x"], d["y"], d["t_ns"], res_x=32, res_y=32,
        x_range=(-0.1, 0.11), y_range=(-0.01, 0.011), step=0.01,
        scale=3, wsize=9,
    )
    ok = out["score"] > 0
    assert ok.sum() > len(d["x"]) * 0.5
    med_u = np.median(out["u"][ok])
    assert abs(med_u - vx) < 15.0
