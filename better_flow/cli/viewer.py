"""bf_viewer — the self-contained event-file explorer.

The reference's bf_viewer.cpp deliberately does NOT use the core library: it
re-implements projection, scoring, and a 2-parameter gradient descent in one
file (bf_viewer.cpp:96-154, 491-577) as a second, simpler implementation of
the same math, plus analysis tools (histogram percentiles, Sobel magnitude,
FFT spectrum, metric-landscape dump).  This transcription keeps that
independence — it uses numpy/OpenCV directly, not the jit pipeline — so it
remains a cross-check of the core.

Usage:
    python -m better_flow.cli.viewer <file> <start_time> <end_time>
        [--out-prefix P] [--metric-plot] [--interactive]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


class Viewer:
    def __init__(self, x, y, t_ns, res_x=240, res_y=180, verbose=True):
        """Note: bf_viewer uses resolution_x=240, resolution_y=180 and does
        NOT swap x/y on read (bf_viewer.cpp:26-27, 70-73) — its x is the
        file's x.  We keep its convention inside this tool."""
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.t = np.asarray(t_ns, np.int64)
        self.res_x = res_x
        self.res_y = res_y
        self.verbose = verbose
        self.min_slice_time = 0       # ms*10 units (bf_viewer.cpp:41-42)
        self.width_slice_time = 1000

    def _slice_mask(self):
        lo = self.min_slice_time * 100000
        hi = (self.min_slice_time + self.width_slice_time) * 100000
        return (self.t > lo) & (self.t <= hi), lo

    def project_events(self, nx, ny, nz=127.0):
        """bf_viewer.cpp:96-154: warp x - kx*(t-t0)/1e4, splat [x, x+scale),
        Gaussian blur, uint8 saturating counts."""
        import cv2

        scale = 3
        H = self.res_x * scale + scale
        W = self.res_y * scale + scale
        img = np.zeros((H, W), np.uint8)
        if nz == 0:
            return img
        sel, lo = self._slice_mask()
        kx, ky = nx / nz, ny / nz
        ts = (self.t[sel] - lo).astype(np.float64)
        px = scale * (self.x[sel] - ts / 10000.0 * kx)
        py = scale * (self.y[sel] - ts / 10000.0 * ky)
        ix = np.trunc(px).astype(np.int64)
        iy = np.trunc(py).astype(np.int64)
        ok = (ix >= 0) & (ix < scale * self.res_x) & (iy >= 0) & (iy < scale * self.res_y)
        cnt = np.zeros((H, W), np.int64)
        # splat [x, x+scale) x [y, y+scale)
        for dx in range(scale):
            for dy in range(scale):
                np.add.at(cnt, (ix[ok] + dx, iy[ok] + dy), 1)
        img = np.minimum(cnt, 255).astype(np.uint8)
        k = scale + 1 if scale % 2 == 0 else scale
        img = cv2.GaussianBlur(img, (k, k), 0, 0)
        return img

    def project_events_color(self, nx, ny, nz=127.0):
        """bf_viewer.cpp:158-249 (project_events_color): HSV time-surface
        of the warped slice — each event splats (cos a, sin a) with phase
        angle a = 2*3.14 * (t - t_min)/(t_max - t_min) over its scale^2
        footprint; per-pixel circular mean becomes hue = angle/2,
        saturation = |mean|*255, value = 255, then HSV->BGR.  Quirks kept
        from the C++: the 3.14/3.1416 pi constants and the uint8 counter
        (a pixel whose count wraps to 0 mod 256 is skipped)."""
        import cv2

        scale = 3
        H = self.res_x * scale + scale
        W = self.res_y * scale + scale
        out = np.zeros((H, W, 3), np.uint8)
        if nz == 0:
            return out
        sel, lo = self._slice_mask()
        ts = (self.t[sel] - lo).astype(np.float64)
        if len(ts) == 0:
            return out
        kx, ky = nx / nz, ny / nz
        px = scale * (self.x[sel] - ts / 10000.0 * kx)
        py = scale * (self.y[sel] - ts / 10000.0 * ky)
        ix = np.trunc(px).astype(np.int64)
        iy = np.trunc(py).astype(np.int64)
        ok = (ix >= 0) & (ix < scale * self.res_x) & (iy >= 0) & (
            iy < scale * self.res_y)
        t_sel = self.t[sel]
        t_min = int(t_sel[0])
        t_max = int(t_sel.max())
        span = float(t_max - t_min) if t_max > t_min else 1.0
        ang = 2.0 * 3.14 * ((t_sel - t_min).astype(np.float64) / span)
        ca, sa = np.cos(ang)[ok], np.sin(ang)[ok]
        acc_c = np.zeros((H, W), np.float64)
        acc_s = np.zeros((H, W), np.float64)
        cnt = np.zeros((H, W), np.int64)
        for dx in range(scale):
            for dy in range(scale):
                np.add.at(acc_c, (ix[ok] + dx, iy[ok] + dy), ca)
                np.add.at(acc_s, (ix[ok] + dx, iy[ok] + dy), sa)
                np.add.at(cnt, (ix[ok] + dx, iy[ok] + dy), 1)
        cnt_u8 = (cnt & 255).astype(np.float64)   # uchar counter quirk
        nzm = cnt_u8 > 0
        vx = np.where(nzm, acc_c / np.maximum(cnt_u8, 1), 0.0)
        vy = np.where(nzm, acc_s / np.maximum(cnt_u8, 1), 0.0)
        speed = np.hypot(vx, vy)
        angle = np.where(speed != 0,
                         (np.arctan2(vy, vx) + 3.1416) * 180.0 / 3.1416,
                         0.0)
        hsv = np.zeros((H, W, 3), np.uint8)
        hsv[..., 0] = np.where(nzm, angle / 2.0, 0).astype(np.uint8)
        hsv[..., 1] = np.clip(np.where(nzm, speed * 255.0, 0),
                              0, 255).astype(np.uint8)
        hsv[..., 2] = np.where(nzm, 255, 0).astype(np.uint8)
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)

    @staticmethod
    def nonzero_average(img) -> float:
        flat = np.asarray(img).ravel()
        nz = flat[flat != 0]
        return float(nz.sum()) / len(nz) if len(nz) else 0.0

    def score(self, nx, ny) -> float:
        return self.nonzero_average(self.project_events(nx, ny))

    def gradient_descent(self):
        """bf_viewer.cpp:497-577: x sweep, y sweep, then joint refinement at
        dn_th/10, with halve-and-flip on strict score decrease."""
        dnx = dny = 0.1
        dn_th = 0.001
        nx = ny = 0.0
        last = self.score(nx, ny)

        def step_x(nx, ny, dnx, last):
            nx2 = nx + dnx
            s = self.score(nx2, ny)
            if s - last < 0:
                dnx = -dnx / 2.0
            return nx2, dnx, s

        def step_y(nx, ny, dny, last):
            ny2 = ny + dny
            s = self.score(nx, ny2)
            if s - last < 0:
                dny = -dny / 2.0
            return ny2, dny, s

        while abs(dnx) > dn_th:
            nx, dnx, last = step_x(nx, ny, dnx, last)
        while abs(dny) > dn_th:
            ny, dny, last = step_y(nx, ny, dny, last)
        dn_th /= 10
        while np.hypot(dnx, dny) > dn_th:
            nx, dnx, last = step_x(nx, ny, dnx, last)
            ny, dny, last = step_y(nx, ny, dny, last)
        if self.verbose:
            print(f"gradient_descent: nx={nx:.5f} ny={ny:.5f} score={last:.3f}")
        return nx, ny, last

    def do_hist(self, img, percentile=90):
        """bf_viewer.cpp:279-351: histogram percentile cut points."""
        hist, _ = np.histogram(np.asarray(img).ravel(), bins=256, range=(0, 256))
        hist[0] = 0
        total = hist.sum()
        frac = (100 - percentile) / 100.0
        small = 0
        left = 0
        for left in range(256):
            small += hist[left]
            if small > frac * (total - small):
                break
        large = 0
        right = 255
        for right in range(255, -1, -1):
            large += hist[right]
            if large > frac * (total - large):
                break
        return left, right

    def do_sobel(self, img):
        """bf_viewer.cpp:354-393: Sobel magnitude, scaled by 4."""
        import cv2

        gx = cv2.Sobel(img, cv2.CV_32F, 1, 0, ksize=3)
        gy = cv2.Sobel(img, cv2.CV_32F, 0, 1, ksize=3)
        mag = cv2.magnitude(gx, gy)
        return cv2.convertScaleAbs(mag, alpha=4.0)

    def do_fft(self, img):
        """bf_viewer.cpp:396-459: log-magnitude spectrum, normalized."""
        import cv2

        f = np.fft.fft2(np.asarray(img, np.float32))
        mag = np.log1p(np.abs(f))
        return cv2.normalize(mag, None, 0, 1, cv2.NORM_MINMAX)

    def generate_metric_plot(self, rng=0.1, step=0.001):
        """bf_viewer.cpp:462-488: sharpness landscape over (nx, ny)."""
        nxs = np.arange(-rng, rng, step)
        nys = np.arange(-rng, rng, step)
        out = np.zeros((len(nxs), len(nys)))
        for i, nx in enumerate(nxs):
            for j, ny in enumerate(nys):
                img = self.project_events(nx, ny)
                out[i, j] = self.nonzero_average(self.do_sobel(img))
        return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bf_viewer")
    p.add_argument("file")
    p.add_argument("start_time", type=float)
    p.add_argument("end_time", type=float)
    p.add_argument("--out-prefix", default="./bf_viewer")
    p.add_argument("--metric-plot", action="store_true")
    p.add_argument("--color-time", action="store_true",
                   help="also write the HSV time-surface view "
                        "(bf_viewer.cpp:158-249)")
    p.add_argument("--metric-step", type=float, default=0.01)
    p.add_argument("--interactive", action="store_true")
    args = p.parse_args(argv)

    import cv2

    # read_events (bf_viewer.cpp:45-93): skip to llimit, keep to hlimit,
    # times rebased to llimit, NO x/y swap.
    rows = []
    with open(args.file) as f:
        first = f.readline().split()
        t0 = float(first[0])
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            t = float(parts[0]) - t0
            if t <= args.start_time:
                continue
            if t > args.end_time:
                break
            rows.append((float(parts[1]), float(parts[2]),
                         (t - args.start_time) * 1e9))
    if not rows:
        print("no events in window", file=sys.stderr)
        return 1
    arr = np.asarray(rows)
    print(f"Read {len(arr)} events, time diff "
          f"{(arr[-1, 2] - arr[0, 2]) / 1e9:.4f} sec.")
    v = Viewer(arr[:, 0], arr[:, 1], arr[:, 2])

    nx, ny, score = v.gradient_descent()
    u = nx / 127.0 * 1e5
    w = ny / 127.0 * 1e5
    print(f"flow: u={u:.2f} v={w:.2f} px/s (nx={nx:.5f}, ny={ny:.5f})")

    img = v.project_events(nx, ny)
    img_scaled = cv2.convertScaleAbs(img, alpha=127.0 / max(v.nonzero_average(img), 1e-9))
    cv2.imwrite(args.out_prefix + "_projected.png", img_scaled)
    cv2.imwrite(args.out_prefix + "_unwarped.png", v.project_events(0, 0))
    cv2.imwrite(args.out_prefix + "_sobel.png", v.do_sobel(img))
    cv2.imwrite(args.out_prefix + "_fft.png",
                (v.do_fft(img) * 255).astype(np.uint8))
    left, right = v.do_hist(img)
    print(f"histogram percentile cut: [{left}, {right}]")

    if args.color_time:
        cv2.imwrite(args.out_prefix + "_color_time.png",
                    v.project_events_color(nx, ny))
        print(f"color time surface -> {args.out_prefix}_color_time.png")

    if args.metric_plot:
        plot = v.generate_metric_plot(step=args.metric_step)
        np.savetxt(args.out_prefix + "_metric.csv", plot, delimiter=",")
        print(f"metric landscape -> {args.out_prefix}_metric.csv")

    if args.interactive:
        _interactive(v)
    return 0


def _interactive(v: Viewer):
    """flow_multitilt trackbars (bf_viewer.cpp:580-628); needs a display."""
    import cv2

    win = "Projected"
    cv2.namedWindow(win, cv2.WINDOW_NORMAL)
    cv2.createTrackbar("x tilt", win, 127, 255, lambda *_: None)
    cv2.createTrackbar("y tilt", win, 127, 255, lambda *_: None)
    cv2.createTrackbar("fine/coarse", win, 500, 1000, lambda *_: None)
    while cv2.waitKey(33) != 27:
        fine = cv2.getTrackbarPos("fine/coarse", win)
        nx = (cv2.getTrackbarPos("x tilt", win) - 127) / (fine + 1)
        ny = (cv2.getTrackbarPos("y tilt", win) - 127) / (fine + 1)
        img = v.project_events(nx, ny)
        scalev = 127.0 / max(v.nonzero_average(img), 1e-9)
        cv2.imshow(win, cv2.convertScaleAbs(img, alpha=scalev))


if __name__ == "__main__":
    raise SystemExit(main())
