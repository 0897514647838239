"""The per-event warp — pure vectorized functions over SoA event tensors.

Reference: Event's projection methods (event.h:65-168).  An event at pixel
``fr`` with slice-local time ``t`` (ns) and direction vector ``n = (nx, ny,
nz)`` is warped to

    pr = fr - (n_xy / nz) * (t / T_DIVIDER) / 1e4        (event.h:164-168)

The 4-parameter variants additionally rotate/diverge the *current projected*
position about a centroid before updating n — note they are iterative in
``pr``: each call reads the previous pr (event.h:88-110, gpu_impl.cl:1-21).

All functions are shape-polymorphic elementwise ops: inputs are f32 arrays of
any matching shape (typically [N]); no masking is needed because warping
padding events is harmless.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from better_flow.config import NZ, UV_FACTOR, WARP_TIME_DIV


def apply_project(fr_x, fr_y, t, nx, ny, nz=float(NZ)):
    """pr = fr - (n/nz) * t/1e4 (Event::apply_project, event.h:164-168)."""
    kx = nx / nz
    ky = ny / nz
    ts = t / jnp.float32(WARP_TIME_DIV)
    return fr_x - kx * ts, fr_y - ky * ts


def _divcrl_dn(pr_x, pr_y, cx, cy, div, crl):
    """Rotation+divergence delta about centroid (event.h:78-86).

    r  = pr - c;  r' = R(crl) r;  dn = -r' * div + (r' - r)
    """
    rx = pr_x - cx
    ry = pr_y - cy
    c = jnp.cos(crl)
    s = jnp.sin(crl)
    rpx = c * rx - s * ry
    rpy = s * rx + c * ry
    dnx = -rpx * div + (rpx - rx)
    dny = -rpy * div + (rpy - ry)
    return dnx, dny


def project_divcrl(fr_x, fr_y, t, pr_x, pr_y, nx, ny, cx, cy, div, crl, nz=float(NZ)):
    """Event::project_divcrl (event.h:78-86): n += dn, then re-project."""
    dnx, dny = _divcrl_dn(pr_x, pr_y, cx, cy, div, crl)
    nx = nx + dnx
    ny = ny + dny
    pr_x, pr_y = apply_project(fr_x, fr_y, t, nx, ny, nz)
    return pr_x, pr_y, nx, ny


def project_dn(fr_x, fr_y, t, nx, ny, dnx, dny, nz=float(NZ)):
    """Event::project_dn (event.h:72-76): incremental update n += dn, then
    re-project from the original pixel.  Unused by the shipped reference
    pipeline (kept for API surface parity)."""
    nx = nx + dnx
    ny = ny + dny
    pr_x, pr_y = apply_project(fr_x, fr_y, t, nx, ny, nz)
    return pr_x, pr_y, nx, ny


def project_4param(
    fr_x, fr_y, t, pr_x, pr_y, nx, ny, dnx_, dny_, cx, cy, div, crl, nz=float(NZ)
):
    """Event::project_4param (event.h:88-96): n += dn + (dnx_, dny_)."""
    dnx, dny = _divcrl_dn(pr_x, pr_y, cx, cy, div, crl)
    nx = nx + dnx + dnx_
    ny = ny + dny + dny_
    pr_x, pr_y = apply_project(fr_x, fr_y, t, nx, ny, nz)
    return pr_x, pr_y, nx, ny


def project_4param_reinit(
    fr_x, fr_y, t, pr_x, pr_y, dnx_, dny_, cx, cy, div, crl, nz=float(NZ)
):
    """Event::project_4param_reinit (event.h:99-110).

    The production warp (optimizer_rolling.h:340-344): the rotation delta is
    computed from the *current* pr, but n is overwritten (not accumulated)
    with dn + (dnx_, dny_), and pr is recomputed from the original pixel fr.
    Call sites pass the model's *accumulated totals* with the sign pattern
    (-total_dx, -total_dy, cx, cy, total_div, -total_rot).

    Model scalars are cast to f32 on entry: the warp computes in f32
    regardless of the carry's accumulation precision (MotionModel.zero
    totals_dtype), pinning one per-event op order for both modes — the C++
    similarly truncates to float inside apply_project (event.h:156-167).
    """
    dnx_, dny_, cx, cy, div, crl = (
        jnp.asarray(a, jnp.float32) for a in (dnx_, dny_, cx, cy, div, crl)
    )
    dnx, dny = _divcrl_dn(pr_x, pr_y, cx, cy, div, crl)
    nx = dnx + dnx_
    ny = dny + dny_
    pr_x, pr_y = apply_project(fr_x, fr_y, t, nx, ny, nz)
    return pr_x, pr_y, nx, ny


def compute_uv(nx, ny, nz=float(NZ)) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Direction vector -> optical flow in px/s (Event::compute_uv,
    event.h:135-142).

    speed = |n_xy| / (nz / 1e5); u = speed * nx/|n_xy|, i.e. u = nx * 1e5/nz
    (with the 0/0 case defined as 0, which the algebraic form satisfies).
    """
    f = jnp.float32(UV_FACTOR) / nz
    return nx * f, ny * f


def n_from_u(vel, nz=float(NZ)):
    """Inverse of compute_uv (Event::n_from_u, event.h:131-133)."""
    return vel * (nz / jnp.float32(UV_FACTOR))
