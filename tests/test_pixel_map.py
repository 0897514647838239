"""PixelEventMap (EventCloud equivalent) and cluster visualization."""

import numpy as np

from better_flow.core.pixel_map import PixelEventMap
from better_flow.viz.images import color_clusters_img


class TestPixelMap:
    def test_push_and_counts(self):
        m = PixelEventMap(res_x=8, res_y=8, per_px=4, span_ns=1000)
        m.push_batch([1, 1, 2], [1, 1, 3], [100, 200, 300])
        c = m.counts()
        assert c[1, 1] == 2 and c[2, 3] == 1 and c.sum() == 3

    def test_per_pixel_capacity(self):
        m = PixelEventMap(res_x=4, res_y=4, per_px=3, span_ns=10**9)
        m.push_batch([0] * 10, [0] * 10, np.arange(10))
        assert m.counts()[0, 0] == 3  # overwrite-oldest at capacity

    def test_span_invalidation(self):
        m = PixelEventMap(res_x=4, res_y=4, per_px=8, span_ns=100)
        m.push_batch([0, 0, 0], [0, 0, 0], [0, 50, 500])
        # latest=500, span=100 -> only ts=500 (and 400<=ts) live
        assert m.counts()[0, 0] == 1
        assert m.time_surface()[0, 0] == 500

    def test_nonempty_iteration(self):
        m = PixelEventMap(res_x=6, res_y=6, per_px=4, span_ns=10**9)
        m.push_batch([1, 4], [2, 5], [10, 20])
        px = m.nonempty_pixels()
        assert sorted(map(tuple, px)) == [(1, 2), (4, 5)]


def test_color_clusters_img():
    rng = np.random.default_rng(0)
    n = 300
    x = np.concatenate([rng.normal(6, 0.5, n), rng.normal(18, 0.5, n)])
    y = np.concatenate([rng.normal(6, 0.5, n), rng.normal(24, 0.5, n)])
    cid = np.concatenate([np.zeros(n, int), np.ones(n, int)])
    img = color_clusters_img(x, y, cid, scale=3, res_x=24, res_y=32)
    assert img.ndim == 3 and img.shape[2] == 3
    assert img.any()
    # unclustered events only -> empty image
    empty = color_clusters_img(x, y, np.full(2 * n, -1), scale=3,
                               res_x=24, res_y=32)
    assert empty.size == 0
