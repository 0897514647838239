"""Per-pixel event storage — the EventCloud equivalent.

Reference: EventCloudTemplate (datastructures.h:263-393): an SX x SY grid of
per-pixel CircularArrays (capacity MAX_EVENT_PER_PX=100, span
MAX_TIME_MS=100 ms; common.h:49-56), with an iterator that walks non-empty
pixel columns.  The shipped pipeline never uses it — it was infrastructure
for the unreleased segmentation stage — but the capability belongs to the
surface, and per-pixel recency maps are genuinely useful (noise filters,
time surfaces).

Dense form: a dense [res_x, res_y, K] tensor of the most recent K
event timestamps per pixel, maintained vectorized on the host, with
span-based invalidation on read — the same bounded-memory semantics without
per-pixel ring objects.
"""

from __future__ import annotations

import numpy as np


class PixelEventMap:
    def __init__(self, res_x: int = 180, res_y: int = 240,
                 per_px: int = 100, span_ns: int = 100_000_000):
        self.res_x = res_x
        self.res_y = res_y
        self.per_px = per_px
        self.span_ns = span_ns
        # timestamps, newest at slot (head-1); -1 = empty
        self.ts = np.full((res_x, res_y, per_px), -1, np.int64)
        self.head = np.zeros((res_x, res_y), np.int32)
        self.count = np.zeros((res_x, res_y), np.int32)
        self.latest = 0

    def push_batch(self, x, y, t_ns) -> None:
        """Insert events (chronological); per-pixel overwrite-oldest.

        Vectorized per unique pixel via sorting: events are grouped by
        pixel, and each group's tail (up to per_px newest) written at the
        pixel's rolling head.
        """
        xi = np.asarray(x).astype(np.int64)
        yi = np.asarray(y).astype(np.int64)
        t = np.asarray(t_ns, np.int64)
        n = len(t)
        if n == 0:
            return
        self.latest = max(self.latest, int(t[-1]))
        lin = xi * self.res_y + yi
        order = np.argsort(lin, kind="stable")
        ls, ts = lin[order], t[order]
        starts = np.r_[0, np.nonzero(ls[1:] != ls[:-1])[0] + 1]
        ends = np.r_[starts[1:], n]
        for s, e in zip(starts, ends):
            px, py = divmod(int(ls[s]), self.res_y)
            grp = ts[s:e][-self.per_px:]
            k = len(grp)
            h = int(self.head[px, py])
            idx = (h + np.arange(k)) % self.per_px
            self.ts[px, py, idx] = grp
            self.head[px, py] = (h + k) % self.per_px
            self.count[px, py] = min(int(self.count[px, py]) + k, self.per_px)

    def counts(self) -> np.ndarray:
        """Live per-pixel counts after span invalidation (the fix_span rule:
        keep events with latest - ts <= span)."""
        live = (self.ts >= 0) & (self.latest - self.ts <= self.span_ns)
        return live.sum(axis=2).astype(np.int32)

    def time_surface(self) -> np.ndarray:
        """Most recent in-span timestamp per pixel (ns; -1 where empty) —
        the classic 'time surface' view."""
        live = (self.ts >= 0) & (self.latest - self.ts <= self.span_ns)
        masked = np.where(live, self.ts, -1)
        return masked.max(axis=2)

    def nonempty_pixels(self) -> np.ndarray:
        """[K, 2] coordinates of pixels with live events — the reference
        iterator's skip-empty-columns walk (datastructures.h:376-384)."""
        return np.argwhere(self.counts() > 0)
