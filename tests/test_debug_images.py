"""Debug imagery and the sampled model variant."""

import numpy as np
import jax
import jax.numpy as jnp

from better_flow.config import SensorConfig
from better_flow.core.events import make_slice
from better_flow.io.synthetic import synthetic_events
from better_flow.models import global_flow as gf
from better_flow.ops.gradient import masked_scharr
from better_flow.ops.reductions import (
    center_of_mass,
    model_compute,
    model_compute_sampled,
)
from better_flow.ops.time_image import time_image
from better_flow.viz.debug_images import (
    gradient_img,
    gradient_img_color,
    lr_gradient_img_color,
    misalignment_img,
)

SMALL = SensorConfig(24, 32)


def _img():
    d = synthetic_events(2000, duration_s=0.1, res_x=24, res_y=32,
                         vx=18.0, vy=-12.0, n_points=60, seed=1)
    ev = make_slice(d["x"], d["y"], d["t_ns"].astype(np.float64))
    H, W = gf.static_image_shape(3, SMALL)
    geom = gf.slice_geometry(ev, 3, SMALL)
    img = time_image(ev.x, ev.y, ev.t, ev.active, 3, geom.x_shift,
                     geom.y_shift, geom.w_dyn, geom.h_dyn, H, W)
    return img, ev, geom


def test_debug_images_shapes():
    img, _, _ = _img()
    pr = np.full(img.shape, 100, np.uint8)
    g = gradient_img(img, pr, wsize=9)
    assert g.shape == img.shape and g.dtype == np.uint8
    gc = gradient_img_color(img)
    assert gc.shape == img.shape + (3,)
    lc = lr_gradient_img_color(img, wsize=5)
    assert lc.shape == img.shape + (3,)


def test_misalignment_walks():
    # a ramp: walks follow the gradient; a plateau: walk length 1
    img = np.zeros((16, 16), np.float32)
    img[4:12, 4:12] = np.linspace(0.1, 0.8, 8)[None, :].repeat(8, 0)
    out = misalignment_img(img, max_steps=32)
    assert out.shape == (16, 16)
    assert out.max() > 0
    # interior of the ramp should have longer combined walks than the
    # extrema columns
    assert out[8, 8] >= out[8, 4] or out[8, 8] >= out[8, 11]


def test_sampled_model_close_to_dense():
    img, ev, geom = _img()
    cx, cy, _ = center_of_mass(img)
    gx, gy = masked_scharr(img)
    dense = model_compute(img, gx, gy, cx, cy)
    sampled = model_compute_sampled(
        img, ev.x, ev.y, ev.valid, cx, cy, 3,
        geom.x_shift, geom.y_shift, jax.random.key(0), p=0.5,
    )
    # Monte-Carlo estimate over event locations: same sign and order of
    # magnitude for the translation deltas (the estimator weights pixels by
    # event density, so exact equality is not expected)
    assert np.sign(float(sampled.dx)) == np.sign(float(dense.dx)) or abs(float(dense.dx)) < 1.0
    assert abs(float(sampled.dx)) < 60 * max(abs(float(dense.dx)), 1.0)
    assert float(sampled.cnt) > 0
