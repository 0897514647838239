"""Auxiliary subsystems: clustering, checkpoint/resume, profiling, native IO."""

import os

import numpy as np
import pytest

from better_flow.config import (
    OptimizerConfig,
    PipelineConfig,
    SensorConfig,
    SliceConfig,
)
from better_flow.io.synthetic import synthetic_events
from better_flow.models.clustering import cluster_events, label_components, merge_clusters
from better_flow.profiling import Spans, realtime_factor
from better_flow.runtime.checkpoint import load_checkpoint, save_checkpoint
from better_flow.runtime.dvs_flow import DVSFlow

import jax.numpy as jnp

SMALL = SensorConfig(24, 32)


def small_cfg():
    return PipelineConfig(
        sensor=SMALL,
        slice=SliceConfig(max_events=4000, span_ns=int(0.1e9),
                          refresh_events=1500, refresh_time_ns=int(0.04e9)),
        optimizer=OptimizerConfig(scale=3, min_events=500),
        accumulate=True,
    )


class TestClustering:
    def test_label_components(self):
        occ = np.zeros((16, 16), bool)
        occ[2:5, 2:5] = True       # blob A
        occ[10:13, 10:14] = True   # blob B
        lab = np.asarray(label_components(jnp.asarray(occ)))
        a = lab[3, 3]
        b = lab[11, 11]
        assert a > 0 and b > 0 and a != b
        assert (lab[2:5, 2:5] == a).all()
        assert (lab[10:13, 10:14] == b).all()
        assert lab[0, 0] == 0

    def test_cluster_events_two_blobs(self):
        rng = np.random.default_rng(0)
        n = 400
        x = np.concatenate([rng.normal(6, 0.5, n), rng.normal(18, 0.5, n)])
        y = np.concatenate([rng.normal(6, 0.5, n), rng.normal(24, 0.5, n)])
        u = np.concatenate([np.full(n, 10.0), np.full(n, -5.0)])
        v = np.zeros(2 * n)
        out = cluster_events(x, y, u, v, np.ones(2 * n, bool), scale=1,
                             res_x=24, res_y=32)
        assert out["n_clusters"] == 2
        ids = out["cluster_id"]
        assert ids[0] != ids[-1] and (ids >= 0).mean() > 0.9
        ms = sorted(out["mean_u"])
        assert abs(ms[0] + 5.0) < 1.0 and abs(ms[1] - 10.0) < 1.0

    def test_merge(self):
        ids = np.array([0, 1, 1, 2])
        out = merge_clusters(ids, 0, 1)
        np.testing.assert_array_equal(out, [0, 0, 0, 2])


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        d = synthetic_events(8000, duration_s=0.25, res_x=24, res_y=32,
                             vx=22.0, vy=-8.0, seed=4)
        e1 = DVSFlow(small_cfg())
        half = len(d["x"]) // 2
        e1.add_events(d["x"][:half], d["y"][:half], d["t_ns"][:half])
        path = str(tmp_path / "ckpt.npz")
        save_checkpoint(path, e1)

        e2 = load_checkpoint(path, DVSFlow(small_cfg()))
        assert e2.event_diff == e1.event_diff
        assert e2.last_slice_time == e1.last_slice_time
        assert len(e2.buffer) == len(e1.buffer)
        assert len(e2.slices) == len(e1.slices)
        np.testing.assert_allclose(
            float(e2.last_model.total_dx), float(e1.last_model.total_dx)
        )

        # resuming produces the same slice structure as an uninterrupted run
        e_full = DVSFlow(small_cfg())
        e_full.add_events(d["x"], d["y"], d["t_ns"])
        e2.add_events(d["x"][half:], d["y"][half:], d["t_ns"][half:])
        assert len(e2.slices) == len(e_full.slices)
        r_a, r_b = e2.slices[-1], e_full.slices[-1]
        np.testing.assert_array_equal(r_a.timestamp, r_b.timestamp)
        np.testing.assert_allclose(r_a.u, r_b.u, rtol=1e-4, atol=1e-4)


class TestProfiling:
    def test_spans(self):
        s = Spans()
        with s("projection"):
            pass
        with s("image"):
            pass
        line = s.report()
        assert "projection" in line and "image" in line

    def test_realtime_factor(self):
        assert realtime_factor(int(0.5e9), 0.25) == 2.0


class TestNativeIO:
    def test_native_matches_python(self, tmp_path):
        from better_flow.io import native
        from better_flow.io.event_file import _load_columns, write_events

        if native.get_lib() is None:
            pytest.skip("native lib not built")
        d = synthetic_events(5000, duration_s=0.1, res_x=24, res_y=32, seed=6)
        p = str(tmp_path / "rec.txt")
        write_events(p, d["x"], d["y"], d["t_ns"], d["polarity"])
        nat = native.parse_events(p)
        raw = _load_columns(p, 4)
        t = raw[:, 0] - raw[0, 0]
        t[0] = 0
        np.testing.assert_array_equal(nat["x"], raw[:, 2])
        np.testing.assert_array_equal(nat["y"], raw[:, 1])
        np.testing.assert_allclose(nat["t_ns"], (1e9 * t).astype(np.int64))

    def test_native_writer_format(self, tmp_path):
        from better_flow.io import native

        if native.get_lib() is None:
            pytest.skip("native lib not built")
        p = str(tmp_path / "out.txt")
        n = native.write_events_uv(
            p, [3.0], [7.0], [1_500_000_000], [1.25], [-2.5]
        )
        assert n == 1
        assert open(p).read().strip() == "1.500000000 7 3 1 -2.500000000 1.250000000"
