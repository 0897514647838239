"""Warp math vs closed form and vs the naive C++ transcription."""

import numpy as np
import jax.numpy as jnp

from better_flow.config import NZ, UV_FACTOR
from better_flow.ops.warp import (
    apply_project,
    compute_uv,
    n_from_u,
    project_4param,
    project_4param_reinit,
)

import naive_ref


def _rand_events(rng, n=64, res=(180, 240), tmax=2e8):
    fx = rng.integers(0, res[0], n).astype(np.float64)
    fy = rng.integers(0, res[1], n).astype(np.float64)
    t = rng.integers(0, int(tmax), n).astype(np.float64)
    return fx, fy, t


def test_apply_project_matches_naive(rng):
    fx, fy, t = _rand_events(rng)
    nx = rng.normal(0, 0.05, len(fx))
    ny = rng.normal(0, 0.05, len(fx))
    px, py = apply_project(
        jnp.asarray(fx, jnp.float32), jnp.asarray(fy, jnp.float32),
        jnp.asarray(t, jnp.float32), jnp.asarray(nx, jnp.float32),
        jnp.asarray(ny, jnp.float32),
    )
    for i in range(len(fx)):
        ex, ey = naive_ref.apply_project_one(fx[i], fy[i], t[i], nx[i], ny[i])
        np.testing.assert_allclose(float(px[i]), ex, rtol=2e-5, atol=2e-4)
        np.testing.assert_allclose(float(py[i]), ey, rtol=2e-5, atol=2e-4)


def test_zero_flow_is_identity(rng):
    fx, fy, t = _rand_events(rng)
    px, py = apply_project(fx, fy, t, np.zeros_like(fx), np.zeros_like(fx))
    np.testing.assert_array_equal(np.asarray(px), fx)
    np.testing.assert_array_equal(np.asarray(py), fy)


def test_project_4param_reinit_matches_naive(rng):
    fx, fy, t = _rand_events(rng, n=128)
    ev = naive_ref.NaiveEvents(fx, fy, t, np.zeros(len(fx), bool))
    # two chained applications to exercise the pr-iterative behaviour
    params1 = (-0.02, 0.01, 90.0, 120.0, 1e-4, -2e-4)
    params2 = (0.015, -0.03, 80.0, 100.0, -2e-4, 1e-4)
    naive_ref.project_4param_reinit(ev, *params1)
    naive_ref.project_4param_reinit(ev, *params2)

    px = jnp.asarray(fx, jnp.float32)
    py = jnp.asarray(fy, jnp.float32)
    tt = jnp.asarray(t, jnp.float32)
    prx, pry = px, py
    nx = jnp.zeros_like(px)
    ny = jnp.zeros_like(px)
    for params in (params1, params2):
        prx, pry, nx, ny = project_4param_reinit(px, py, tt, prx, pry, *params)

    np.testing.assert_allclose(np.asarray(prx), ev.pr_x, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(pry), ev.pr_y, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(nx), ev.nx, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ny), ev.ny, rtol=1e-4, atol=1e-5)


def test_reinit_overwrites_while_4param_accumulates(rng):
    """reinit sets n from scratch; project_4param adds to existing n
    (event.h:88-96 vs :99-110)."""
    fx = np.array([10.0]); fy = np.array([20.0]); t = np.array([1e7])
    nx0 = np.array([0.05]); ny0 = np.array([-0.02])
    prx0, pry0 = apply_project(fx, fy, t, nx0, ny0)
    args = (0.01, 0.01, 5.0, 5.0, 0.0, 0.0)
    _, _, nx_a, ny_a = project_4param(fx, fy, t, prx0, pry0, nx0, ny0, *args)
    _, _, nx_r, ny_r = project_4param_reinit(fx, fy, t, prx0, pry0, *args)
    np.testing.assert_allclose(np.asarray(nx_a), nx0 + 0.01, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(nx_r), [0.01], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ny_a), ny0 + 0.01, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ny_r), [0.01], rtol=1e-6)


def test_project_dn_increments_n(rng):
    """project_dn accumulates n += dn then re-projects from fr
    (event.h:72-76)."""
    from better_flow.ops.warp import project_dn

    fx = np.array([10.0]); fy = np.array([20.0]); t = np.array([1e7])
    nx0 = np.array([0.05]); ny0 = np.array([-0.02])
    prx, pry, nx, ny = project_dn(fx, fy, t, nx0, ny0, 0.01, -0.03)
    np.testing.assert_allclose(np.asarray(nx), nx0 + 0.01, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ny), ny0 - 0.03, rtol=1e-6)
    exp_x, exp_y = apply_project(fx, fy, t, nx0 + 0.01, ny0 - 0.03)
    np.testing.assert_allclose(np.asarray(prx), np.asarray(exp_x), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(pry), np.asarray(exp_y), rtol=1e-6)


def test_compute_uv_matches_naive_and_inverts(rng):
    nx = np.concatenate([[0.0], rng.normal(0, 0.05, 31)])
    ny = np.concatenate([[0.0], rng.normal(0, 0.05, 31)])
    u, v = compute_uv(nx, ny)
    for i in range(len(nx)):
        eu, ev_ = naive_ref.compute_uv(nx[i], ny[i])
        np.testing.assert_allclose(float(u[i]), eu, rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(float(v[i]), ev_, rtol=1e-5, atol=1e-8)
    # n_from_u inverts compute_uv (event.h:131-133)
    np.testing.assert_allclose(np.asarray(n_from_u(u)), nx, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(n_from_u(v)), ny, rtol=1e-5, atol=1e-8)


def test_uv_factor():
    assert UV_FACTOR == 1e5
    assert NZ == 127
