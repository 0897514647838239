"""Event-at-a-time numpy transcription of the reference C++ semantics.

This is the test oracle: deliberately slow, loopy, and structured exactly
like the C++ (better_flow_core), so the vectorized/jitted implementations
can be checked against it on small inputs.  Citations point into
/root/reference.  Not used by the framework itself.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

NZ = 127.0
EPS = 0.000001


@dataclass
class NaiveEvents:
    """SoA mirror of Event fields (event.h:9-24)."""

    fr_x: np.ndarray  # float (uint in C++)
    fr_y: np.ndarray
    t: np.ndarray     # slice-local time, ns (sll in C++)
    noise: np.ndarray
    pr_x: np.ndarray = field(default=None)
    pr_y: np.ndarray = field(default=None)
    nx: np.ndarray = field(default=None)
    ny: np.ndarray = field(default=None)

    def __post_init__(self):
        n = len(self.fr_x)
        if self.pr_x is None:
            self.pr_x = self.fr_x.astype(np.float64).copy()
            self.pr_y = self.fr_y.astype(np.float64).copy()
        if self.nx is None:
            self.nx = np.zeros(n)
            self.ny = np.zeros(n)

    def reset(self):
        """Event::reset (event.h:54-59).  Does NOT clear noise."""
        self.pr_x = self.fr_x.astype(np.float64).copy()
        self.pr_y = self.fr_y.astype(np.float64).copy()
        self.nx = np.zeros(len(self.fr_x))
        self.ny = np.zeros(len(self.fr_x))


def apply_project_one(fr_x, fr_y, t, nx, ny, nz=NZ):
    """Event::apply_project (event.h:164-168) with its float32 casts."""
    kx = np.float32(nx) / nz
    ky = np.float32(ny) / nz
    pr_x = np.float32(fr_x) - kx * np.float32(t) / 10000.0
    pr_y = np.float32(fr_y) - ky * np.float32(t) / 10000.0
    return pr_x, pr_y


def project_4param_reinit(ev: NaiveEvents, dnx_, dny_, cx, cy, div, crl):
    """Event::project_4param_reinit over a cloud (event.h:99-110,
    accel_lib.h:263-267)."""
    for i in range(len(ev.fr_x)):
        rx = ev.pr_x[i] - cx
        ry = ev.pr_y[i] - cy
        rpx = math.cos(crl) * rx - math.sin(crl) * ry
        rpy = math.sin(crl) * rx + math.cos(crl) * ry
        dnx = -rpx * div + (rpx - rx)
        dny = -rpy * div + (rpy - ry)
        ev.nx[i] = dnx + dnx_
        ev.ny[i] = dny + dny_
        ev.pr_x[i], ev.pr_y[i] = apply_project_one(
            ev.fr_x[i], ev.fr_y[i], ev.t[i], ev.nx[i], ev.ny[i]
        )


def compute_uv(nx, ny, nz=NZ):
    """Event::compute_uv (event.h:135-142)."""
    xy_len = math.hypot(nx, ny)
    speed = xy_len / (nz / (1000000000 / 10000))
    u = 0.0 if xy_len == 0 else speed * nx / xy_len
    v = 0.0 if xy_len == 0 else speed * ny / xy_len
    return u, v


def get_time_img(ev: NaiveEvents, w, h, scale, x_sh, y_sh):
    """AccelLib::get_time_img_cpu (accel_lib.h:147-178)."""
    avg = np.zeros((w + scale, h + scale), np.float32)
    cnt = np.zeros((w + scale, h + scale), np.float32)
    half = scale // 2
    for i in range(len(ev.fr_x)):
        if ev.noise[i]:
            continue
        x = int(ev.pr_x[i] * scale + x_sh)  # C int cast truncates toward 0
        y = int(ev.pr_y[i] * scale + y_sh)
        if x >= w + half or x < half or y >= h + half or y < half:
            continue
        for jx in range(x - half, x + half + 1):
            for jy in range(y - half, y + half + 1):
                avg[jx, jy] += np.float32(ev.t[i] / 1000000000.0)
                cnt[jx, jy] += 1
    nz = cnt >= 1
    avg[nz] /= cnt[nz]
    return avg


def sobel_point(img, i, j):
    """AccelLib::sobel_point (accel_lib.h:545-615).  ``i`` is the column,
    ``j`` the row, as at the call site (accel_lib.h:536)."""
    sharr_x = [3, 0, -3, 10, 0, -10, 3, 0, -3]
    sharr_y = [3, 10, 3, 0, 0, 0, -3, -10, -3]
    idx = 0
    dx = dy = 0.0
    for k in range(3):
        for m in range(3):
            val = img[m + j - 1, k + i - 1]
            if val <= EPS:
                return None
            dx += val * sharr_x[idx]
            dy += val * sharr_y[idx]
            idx += 1
    return dx, dy


def sobel_cpu(img):
    """AccelLib::Sobel_cpu (accel_lib.h:513-543)."""
    gx = np.zeros_like(img)
    gy = np.zeros_like(img)
    H, W = img.shape
    for i in range(1, H - 1):
        for j in range(1, W - 1):
            if img[i, j] <= EPS:
                continue
            r = sobel_point(img, j, i)
            if r is not None:
                gx[i, j], gy[i, j] = r
    return gx, gy


def lr_sobel_point(i, j, wsize, img):
    """AccelLib::LR_sobel_point (accel_lib.h:495-510); i=col, j=row."""
    ret = 0.0
    cnt = 0
    for k in range(wsize):
        for m in range(wsize):
            val = img[m + j - wsize // 2, k + i - wsize // 2]
            if abs(val) > 1e-8:
                cnt += 1
                ret += val
    if cnt < (wsize * wsize) // 4:
        return None
    return 0.0 if cnt == 0 else ret / cnt


def lr_sobel(img, wsize):
    """AccelLib::LR_Sobel (accel_lib.h:466-493)."""
    gx_h, gy_h = sobel_cpu(img)
    gx = np.zeros_like(img)
    gy = np.zeros_like(img)
    H, W = img.shape
    for i in range(wsize // 2, H - wsize // 2):
        for j in range(wsize // 2, W - wsize // 2):
            r = lr_sobel_point(j, i, wsize, gx_h)
            if r is not None:
                gx[i, j] = r
            r = lr_sobel_point(j, i, wsize, gy_h)
            if r is not None:
                gy[i, j] = r
    return gx, gy


def center_of_mass(img):
    """ObjectModel::center_of_mass (object_model.cpp:103-126)."""
    cx = cy = 0.0
    cnt = 0
    H, W = img.shape
    for i in range(H):
        for j in range(W):
            if img[i, j] > EPS:
                cx += i
                cy += j
                cnt += 1
    assert cnt > 0
    return cx / cnt, cy / cnt, cnt


def model_compute(img, cx, cy):
    """ObjectModel::compute (object_model.cpp:4-39): Scharr + 4 masked means."""
    gx, gy = sobel_cpu(img)
    dx = dy = rot = div = 0.0
    cnt = 0
    H, W = img.shape
    for i in range(H):
        for j in range(W):
            if img[i, j] > EPS:
                rx, ry = i - cx, j - cy
                dx += gx[i, j]
                dy += gy[i, j]
                rot += rx * gy[i, j] - ry * gx[i, j]
                div += rx * gx[i, j] + ry * gy[i, j]
                cnt += 1
    return dx / cnt, dy / cnt, rot / cnt, div / cnt, cnt


def nonzero_average(img):
    """EventFile::nonzero_average (event_file.cpp:282-294)."""
    flat = img.ravel()
    nz = flat[flat != 0]
    return 0.0 if len(nz) == 0 else float(nz.sum()) / len(nz)


@dataclass
class NaiveModel:
    """ObjectModel state (object_model.h:10-13)."""

    cx: float = 0.0
    cy: float = 0.0
    dx: float = 0.0
    dy: float = 0.0
    rot: float = 0.0
    div: float = 0.0
    cnt: int = 0
    total_dx: float = 0.0
    total_dy: float = 0.0
    total_rot: float = 0.0
    total_div: float = 0.0

    def update_accumulators(self, d1, d2, d3, d4):
        """object_model.h:48-53."""
        self.total_rot += self.rot / d1
        self.total_div += self.div / d2
        self.total_dx += self.dx / d3
        self.total_dy += self.dy / d4


class NaiveOptimizerRolling:
    """OptimizerRolling (optimizer_rolling.h) without GPU/manual paths."""

    def __init__(self, res_x=180, res_y=240):
        self.res_x = res_x
        self.res_y = res_y
        self.model = NaiveModel()
        self.max_itercount = -1
        self.itercount = 0

    def set_cloud(self, ev: NaiveEvents, scale):
        """optimizer_rolling.h:248-283 (set_cloud + set_scale)."""
        self.ev = ev
        self.scale = scale
        assert scale % 2 != 0 or scale == 1  # :274 (odd)
        self.x_min = int(ev.fr_x.min())
        self.x_max = int(ev.fr_x.max())
        self.y_min = int(ev.fr_y.min())
        self.y_max = int(ev.fr_y.max())
        ev.reset()
        self.wx = scale * (self.x_max - self.x_min)
        self.wy = scale * (self.y_max - self.y_min)
        self.scale_img_x = self.wx + scale
        self.scale_img_y = self.wy + scale
        self.x_shift = (
            -float((self.x_max - self.x_min) // 2 + self.x_min) * scale
            + self.wx / 2.0
            + scale // 2
        )
        self.y_shift = (
            -float((self.y_max - self.y_min) // 2 + self.y_min) * scale
            + self.wy / 2.0
            + scale // 2
        )

    def set_model(self, m: NaiveModel):
        """Warm start (optimizer_rolling.h:289-299)."""
        self.model = m
        project_4param_reinit(
            self.ev, -m.total_dx, -m.total_dy, m.cx, m.cy, m.total_div, -m.total_rot
        )

    def iteration_step(self):
        """optimizer_rolling.h:305-347."""
        img = get_time_img(self.ev, self.wx, self.wy, self.scale, self.x_shift, self.y_shift)
        cx, cy, _ = center_of_mass(img)
        self.model.cx, self.model.cy = cx, cy
        dx, dy, rot, div, cnt = model_compute(img, cx, cy)
        self.model.dx, self.model.dy = dx, dy
        self.model.rot, self.model.div = rot, div
        self.model.cnt = cnt
        self.model.update_accumulators(
            self.rot_divider, self.div_divider, self.x_divider, self.y_divider
        )
        cx_ev = (self.model.cx - self.x_shift) / self.scale
        cy_ev = (self.model.cy - self.y_shift) / self.scale
        project_4param_reinit(
            self.ev,
            -self.model.total_dx,
            -self.model.total_dy,
            cx_ev,
            cy_ev,
            self.model.total_div,
            -self.model.total_rot,
        )
        self.model.cx = cx_ev
        self.model.cy = cy_ev
        return img

    def run(self):
        """optimizer_rolling.h:48-125."""
        if (
            self.scale_img_x < self.scale * self.res_x // 15
            and self.scale_img_y < self.scale * self.res_y // 15
        ):
            self.ev.noise[:] = True
            return 1
        if len(self.ev.fr_x) < 1000:
            return 1

        self.itercount = 0
        self.x_divider = self.y_divider = 1.0
        self.rot_divider = self.div_divider = 10000.0

        self.iteration_step()
        self.itercount += 1

        while (
            self.x_divider < 32 * 10
            or self.y_divider < 32 * 10
            or self.rot_divider < 32 * 1000
            or self.div_divider < 32 * 1000
        ):
            if (
                abs(self.model.dx / self.x_divider) < 1e-5
                and abs(self.model.dy / self.y_divider) < 1e-5
                and abs(self.model.rot / self.rot_divider) < 1e-4
                and abs(self.model.div / self.div_divider) < 1e-1
            ):
                break
            old = (self.model.dx, self.model.dy, self.model.rot, self.model.div)
            self.iteration_step()
            self.itercount += 1
            if self.max_itercount > 0 and self.itercount > self.max_itercount:
                break
            if self.model.dx * old[0] < 0:
                self.x_divider *= 2
            if self.model.dy * old[1] < 0:
                self.y_divider *= 2
            if self.model.rot * old[2] < 0:
                self.rot_divider *= 2
            if self.model.div * old[3] < 0:
                self.div_divider *= 2
        return 0
