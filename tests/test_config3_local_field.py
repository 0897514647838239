"""BASELINE config 3: per-pixel local flow field with iterative
coarse-to-fine refinement on DAVIS 346x260.

Two properties the global 4-parameter model cannot deliver:

* Two independently-moving objects — a single (dx, dy, rot, div) model has
  ONE translation; the local field must recover both motions
  (optimizer_sampler.cpp:90-153 is the per-window building block).
* Large displacements — the reference's halve-and-flip descent started at
  zero flow stalls on the quantized-score plateau; the coarse-to-fine
  chain (flow_field_grid: coarse scale, wide initial step, seeded finer
  scales) must beat the single-scale search (SURVEY §7 step 6).
"""

import numpy as np
import pytest

from better_flow.io.synthetic import synthetic_events
from better_flow.models.local_flow import flow_field_grid

DAVIS_X, DAVIS_Y = 346, 260


def _two_object_scene(seed=0, n_per_obj=15000, duration_s=0.1):
    """Two textured patches on DAVIS 346x260 moving independently:
    object A (left half) at (+80, +30) px/s, object B (right half) at
    (-80, -30) px/s."""
    va = (80.0, 30.0)
    vb = (-80.0, -30.0)
    a = synthetic_events(n_per_obj, duration_s=duration_s, res_x=150,
                         res_y=220, vx=va[0], vy=va[1], n_points=150,
                         seed=seed, margin=0.2)
    b = synthetic_events(n_per_obj, duration_s=duration_s, res_x=150,
                         res_y=220, vx=vb[0], vy=vb[1], n_points=150,
                         seed=seed + 1, margin=0.2)
    # Offset the two streams into disjoint halves of the DAVIS frame.
    ax, ay = a["x"] + 10, a["y"] + 20
    bx, by = b["x"] + 186, b["y"] + 20
    x = np.concatenate([ax, bx])
    y = np.concatenate([ay, by])
    t = np.concatenate([a["t_ns"], b["t_ns"]])
    order = np.argsort(t, kind="stable")
    return x[order], y[order], t[order], va, vb


def test_config3_two_objects_davis():
    """The local field recovers BOTH object motions on 346x260 — the
    scene a global 4-param model cannot represent — with a per-window
    AEE gate vs the synthetic ground truth, and emits the per-pixel
    dense field."""
    x, y, t_ns, va, vb = _two_object_scene()
    out = flow_field_grid(x, y, t_ns, DAVIS_X, DAVIS_Y,
                          step=32, wsz=31, k=3072, dense=True)
    gx, gy = out["grid_x"], out["grid_y"]
    u, v, n_ev = out["u"], out["v"], out["n_events"]

    # Windows whose full extent lies inside one object's textured region.
    in_a = (gx > 40) & (gx < 130) & (gy > 70) & (gy < 210) & (n_ev >= 200)
    in_b = (gx > 216) & (gx < 306) & (gy > 70) & (gy < 210) & (n_ev >= 200)
    assert in_a.sum() >= 3, f"too few A windows ({in_a.sum()})"
    assert in_b.sum() >= 3, f"too few B windows ({in_b.sum()})"

    speed = float(np.hypot(*va))  # 85.4 px/s, same for both objects
    aee_a = np.median(np.hypot(u[in_a] - va[0], v[in_a] - va[1]))
    aee_b = np.median(np.hypot(u[in_b] - vb[0], v[in_b] - vb[1]))
    assert aee_a < 0.25 * speed, f"object A AEE {aee_a:.1f} px/s"
    assert aee_b < 0.25 * speed, f"object B AEE {aee_b:.1f} px/s"
    # The two recovered motions really are opposite — no global model fits.
    assert np.median(u[in_a]) > 40 and np.median(u[in_b]) < -40

    # Per-pixel dense output: full-resolution field, sign-correct at the
    # object centres.
    assert out["u_dense"].shape == (DAVIS_X, DAVIS_Y)
    assert out["v_dense"].shape == (DAVIS_X, DAVIS_Y)
    assert out["u_dense"][85, 130] > 40
    assert out["u_dense"][261, 130] < -40


def test_config3_coarse_to_fine_beats_single_scale():
    """The chained coarse-to-fine schedule recovers a large displacement
    the single-scale search stalls on: the real ablation behind
    flow_field_grid's default scales=(1, 3, 3)."""
    vx, vy = 350.0, 100.0
    d = synthetic_events(20000, duration_s=0.1, res_x=96, res_y=96,
                         vx=vx, vy=vy, n_points=200, seed=3, margin=0.3)
    kw = dict(step=33, wsz=31, k=8192)  # grid includes the centre (48, 48)
    single = flow_field_grid(d["x"], d["y"], d["t_ns"], 96, 96,
                             scales=(3,), **kw)
    chained = flow_field_grid(d["x"], d["y"], d["t_ns"], 96, 96,
                              scales=(1, 3, 3), **kw)
    # the central window (grid position (1, 1) of the 2x2 grid)
    w = np.argmin(np.hypot(single["grid_x"].ravel() - 48,
                           single["grid_y"].ravel() - 48))
    assert single["n_events"].ravel()[w] >= 1000

    def aee(o):
        return float(np.hypot(o["u"].ravel()[w] - vx,
                              o["v"].ravel()[w] - vy))

    e_single, e_chain = aee(single), aee(chained)
    # Measured: single-scale stalls near (221, 0) (AEE ~164 px/s); the
    # chain lands within a few px/s.  Gate at a 3x margin each way.
    assert e_chain < 35.0, f"chained AEE {e_chain:.1f}"
    assert e_chain < e_single / 3, (
        f"coarse-to-fine ({e_chain:.1f}) must beat single-scale "
        f"({e_single:.1f}) on large displacement")
