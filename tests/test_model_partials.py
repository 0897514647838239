"""psum-combinable model partials (ops/reductions.model_compute_partial +
model_from_partials) against the plain reference (tests/naive_ref.py), and
the GPU finish kernel (ops/finish_kernel.py, in the Pallas interpreter)
against the plain composition.

The tiled path and the finish kernel reduce an image to these seven sums;
the centroid is applied afterwards through the affine correction in
model_from_partials.  Cases: scale 1, 3 and 5, and events warped by 0, 3
or 60 px over the slice (60 px pushes many of them out of the window,
where the splat must reject them).
"""

import numpy as np
import pytest

import naive_ref
from better_flow.config import SensorConfig
from better_flow.core.events import make_slice
from better_flow.io.synthetic import synthetic_events
from better_flow.models import global_flow as gf
from better_flow.ops.gradient import masked_scharr
from better_flow.ops.reductions import model_compute_partial, model_from_partials
from better_flow.ops.time_image import splat_padded, time_image

SMALL = SensorConfig(24, 32)


CASES = [(1, 0.0), (1, 3.0), (1, 60.0),
         (3, 0.0), (3, 3.0), (3, 60.0),
         (5, 3.0)]


def _warped_slice(scale, drift_px, n=1500):
    d = synthetic_events(n, duration_s=0.1, res_x=24, res_y=32, vx=18.0,
                         vy=-12.0, n_points=60, seed=1)
    ev = make_slice(d["x"], d["y"], d["t_ns"].astype(np.float64),
                    capacity=2048)
    x = np.asarray(ev.x)[:n]
    y = np.asarray(ev.y)[:n]
    t = np.asarray(ev.t)[:n]
    frac = (t / t.max()).astype(np.float32)
    prx = (x + np.float32(drift_px) * frac).astype(np.float32)
    pry = (y - np.float32(drift_px) * frac).astype(np.float32)
    return ev, x, y, t, prx, pry


def _splat_args(ev, prx, pry, scale):
    pad = lambda a: np.pad(a, (0, ev.capacity - len(a)))
    H, W = gf.static_image_shape(scale, SMALL)
    geom = gf.slice_geometry(ev, scale, SMALL)
    return (pad(prx), pad(pry), ev.t, ev.active, scale, geom.x_shift,
            geom.y_shift, geom.w_dyn, geom.h_dyn, H, W), geom


@pytest.mark.parametrize("scale,drift_px", CASES)
def test_partials_match_naive_reference(scale, drift_px):
    ev, x, y, t, prx, pry = _warped_slice(scale, drift_px)
    n = len(x)
    args, geom = _splat_args(ev, prx, pry, scale)
    H, W = args[-2:]
    img = time_image(*args)
    gx, gy = masked_scharr(img)
    cx, cy, terms = model_from_partials(model_compute_partial(img, gx, gy))

    nev = naive_ref.NaiveEvents(
        fr_x=x.astype(np.float64), fr_y=y.astype(np.float64),
        t=t.astype(np.float64), noise=np.zeros(n, bool),
        pr_x=prx.astype(np.float64), pr_y=pry.astype(np.float64))
    w, h = int(geom.w_dyn), int(geom.h_dyn)
    ref_img = naive_ref.get_time_img(nev, w, h, scale, float(geom.x_shift),
                                     float(geom.y_shift))
    np.testing.assert_allclose(np.asarray(img)[:w + scale, :h + scale],
                               ref_img, rtol=0, atol=1e-7)
    rcx, rcy, rcnt = naive_ref.center_of_mass(ref_img)
    rdx, rdy, rrot, rdiv, _ = naive_ref.model_compute(ref_img, rcx, rcy)
    assert int(terms.cnt) == rcnt
    np.testing.assert_allclose([float(cx), float(cy)], [rcx, rcy],
                               rtol=0, atol=1e-4)
    g = np.abs(np.asarray(gx)).mean() + np.abs(np.asarray(gy)).mean()
    np.testing.assert_allclose(
        [float(terms.dx), float(terms.dy)], [rdx, rdy], rtol=1e-4,
        atol=1e-5 * g)
    np.testing.assert_allclose(
        [float(terms.rot), float(terms.div)], [rrot, rdiv], rtol=1e-3,
        atol=1e-4 * g * max(H, W))


@pytest.mark.parametrize("scale,drift_px", CASES)
def test_finish_kernel_matches_plain(scale, drift_px):
    """Box filter + normalize + masked Scharr + partials in one kernel
    (interpret mode) against the XLA composition over the same splat.
    Counts are exact; the sums run in another order."""
    from better_flow.ops.finish_kernel import (
        PARTIAL_KEYS,
        finish_partials,
        halo,
        padded_shape,
    )

    ev, _, _, _, prx, pry = _warped_slice(scale, drift_px)
    args, _ = _splat_args(ev, prx, pry, scale)
    H, W = args[-2:]
    img = time_image(*args)
    gx, gy = masked_scharr(img)
    want = model_compute_partial(img, gx, gy)
    _, HP, WP = padded_shape(scale, H, W)
    padded = splat_padded(*args, halo(scale), HP, WP)
    got = finish_partials(padded, scale, H, W, interpret=True)
    assert float(got["cnt"]) == float(want["cnt"]) > 0
    for k in PARTIAL_KEYS[1:]:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, atol=1e-3, err_msg=k)
