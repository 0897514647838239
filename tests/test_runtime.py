"""Ring buffer, triggers, streaming pipeline, accumulation."""

import numpy as np
import pytest

from better_flow.config import (
    OptimizerConfig,
    PipelineConfig,
    SensorConfig,
    SliceConfig,
)
from better_flow.io.synthetic import synthetic_events
from better_flow.runtime.accumulate import merge_slices
from better_flow.runtime.dvs_flow import DVSFlow
from better_flow.runtime.offline import compensate_recording
from better_flow.runtime.slice_buffer import EventRingBuffer

SMALL = SensorConfig(res_x=24, res_y=32)


def small_cfg(**kw):
    return PipelineConfig(
        sensor=SMALL,
        slice=SliceConfig(
            max_events=4000,
            span_ns=int(0.1e9),
            refresh_events=1500,
            refresh_time_ns=int(0.04e9),
        ),
        optimizer=OptimizerConfig(scale=3, min_events=500),
        **kw,
    )


class TestRingBuffer:
    def test_overwrite_oldest(self):
        buf = EventRingBuffer(4, span_ns=10**12)
        for i in range(6):
            buf.push(i, i, i * 100)
        assert len(buf) == 4
        snap = buf.snapshot()
        np.testing.assert_array_equal(snap["timestamp"], [200, 300, 400, 500])

    def test_span_eviction(self):
        buf = EventRingBuffer(100, span_ns=1000)
        for i in range(10):
            buf.push(i, i, i * 300)
        # latest = 2700; keep ts >= 1700 -> 2700,2400,2100,1800
        assert len(buf) == 4
        snap = buf.snapshot()
        assert snap["timestamp"][0] == 1800

    def test_batch_equals_sequential(self):
        rng = np.random.default_rng(3)
        ts = np.sort(rng.integers(0, 10**9, 500))
        xs = rng.random(500).astype(np.float32)
        ys = rng.random(500).astype(np.float32)
        b1 = EventRingBuffer(128, span_ns=int(2e8))
        b2 = EventRingBuffer(128, span_ns=int(2e8))
        for i in range(500):
            b1.push(xs[i], ys[i], ts[i])
        b2.push_batch(xs, ys, ts)
        s1, s2 = b1.snapshot(), b2.snapshot()
        np.testing.assert_array_equal(s1["timestamp"], s2["timestamp"])
        np.testing.assert_array_equal(s1["x"], s2["x"])


class TestTriggers:
    def _mk(self):
        return DVSFlow(small_cfg())

    def test_count_trigger(self):
        eng = self._mk()
        fired = 0
        for i in range(3000):
            fired += eng.add_event(5.0, 5.0, i * 1000)  # 1 us apart: no time trig
        assert fired == 2  # at events 1500 and 3000

    def test_time_trigger(self):
        eng = self._mk()
        fired = 0
        for i in range(10):
            fired += eng.add_event(5.0, 5.0, i * int(0.03e9))
        # time_diff hits 0.04s at ts=0.06 (i=2), then every 2 events
        assert fired >= 3

    def test_batch_feed_matches_eventwise(self):
        d = synthetic_events(6000, duration_s=0.3, res_x=SMALL.res_x,
                             res_y=SMALL.res_y, vx=20, vy=-10, seed=5)
        e1, e2 = self._mk(), self._mk()
        e1.cfg = e1.cfg.replace(accumulate=True)
        e2.cfg = e2.cfg.replace(accumulate=True)
        for i in range(len(d["x"])):
            e1.add_event(d["x"][i], d["y"][i], int(d["t_ns"][i]))
        e2.add_events(d["x"], d["y"], d["t_ns"])
        assert len(e1.slices) == len(e2.slices)
        for r1, r2 in zip(e1.slices, e2.slices):
            assert r1.n_events == r2.n_events
            np.testing.assert_array_equal(r1.timestamp, r2.timestamp)


class TestPipeline:
    def test_end_to_end_flow_recovery(self):
        d = synthetic_events(20000, duration_s=0.5, res_x=SMALL.res_x,
                             res_y=SMALL.res_y, vx=20.0, vy=-14.0, seed=2)
        out = compensate_recording(d["x"], d["y"], d["t_ns"], small_cfg())
        acc = out["accumulated"]
        assert out["stats"]["n_slices"] >= 5
        assert len(acc["x"]) > 0
        ok = ~acc["noise"]
        med_u = np.median(acc["u"][ok])
        med_v = np.median(acc["v"][ok])
        assert abs(med_u - 20.0) < 8.0
        assert abs(med_v + 14.0) < 8.0

    def test_warm_start_carries_model(self):
        d = synthetic_events(8000, duration_s=0.25, res_x=SMALL.res_x,
                             res_y=SMALL.res_y, vx=22.0, vy=0.0, seed=4)
        out = compensate_recording(d["x"], d["y"], d["t_ns"], small_cfg())
        eng = out["engine"]
        # later slices should converge in fewer iterations than the first
        iters = [r.iters for r in eng.slices if r.iters > 0]
        assert len(iters) >= 2
        assert iters[-1] <= iters[0]

    def test_stm_disable(self):
        d = synthetic_events(8000, duration_s=0.25, res_x=SMALL.res_x,
                             res_y=SMALL.res_y, vx=22.0, vy=0.0, seed=4)
        out = compensate_recording(
            d["x"], d["y"], d["t_ns"], small_cfg(stm_disable=True)
        )
        assert out["stats"]["n_slices"] >= 2  # still works without warm start


class TestAccumulate:
    def test_dedupe_overlapping_slices(self):
        class S:
            pass

        def mk(xs, ts, sl):
            s = S()
            s.x = np.array(xs, np.float32)
            s.y = np.zeros(len(xs), np.float32)
            s.timestamp = np.array(ts, np.int64)
            s.u = np.full(len(xs), sl, np.float32)
            s.v = np.zeros(len(xs), np.float32)
            s.noise = np.zeros(len(xs), bool)
            return s

        s1 = mk([1, 2, 3], [100, 200, 300], 1.0)
        s2 = mk([2, 3, 4], [200, 300, 400], 2.0)  # overlaps events 2,3
        merged = merge_slices([s1, s2])
        assert len(merged["x"]) == 4
        # earliest slice's estimate wins for the duplicates
        u_for_2 = merged["u"][merged["timestamp"] == 200][0]
        assert u_for_2 == 1.0

    def test_near_match_tombstone(self):
        class S:
            pass

        def mk(xs, ts, sl):
            s = S()
            s.x = np.array(xs, np.float32)
            s.y = np.zeros(len(xs), np.float32)
            s.timestamp = np.array(ts, np.int64)
            s.u = np.full(len(xs), sl, np.float32)
            s.v = np.zeros(len(xs), np.float32)
            s.noise = np.zeros(len(xs), bool)
            return s

        # same pixel, later slice has ts 50us earlier -> merged (dt < 0.1ms)
        s1 = mk([5], [1_000_000], 1.0)
        s2 = mk([5], [950_000], 2.0)
        merged = merge_slices([s1, s2])
        assert len(merged["x"]) == 1
        assert merged["u"][0] == 1.0


class TestPipelinedStreaming:
    """Round-5: DVSFlow dispatch pipelining (pipeline_depth K) and the
    compact u8 fetch.  Pipelined runs must be BIT-IDENTICAL to the
    synchronous path — the model/seed carry never leaves the device, and
    the only cross-slice host state a later slice reads (buffer noise
    flags, sourced solely from the window_small gate) is applied at
    dispatch time."""

    def _run(self, depth, compact=False, accumulate=True):
        cfg = small_cfg().replace(accumulate=accumulate)
        d = synthetic_events(24000, duration_s=0.4, res_x=24, res_y=32,
                             n_points=80, seed=5, vx=4.0, vy=-3.0,
                             rot=0.5, div=0.15)
        flow = DVSFlow(cfg, pipeline_depth=depth, compact_fetch=compact)
        flow.add_events(d["x"], d["y"], d["t_ns"])
        if len(flow.buffer):
            flow.recompute()
        flow.flush()
        return flow

    def test_pipelined_bit_identical(self):
        sync = self._run(0)
        for depth in (1, 3):
            pipe = self._run(depth)
            assert len(pipe.slices) == len(sync.slices)
            for a, b in zip(sync.slices, pipe.slices):
                np.testing.assert_array_equal(a.u, b.u)
                np.testing.assert_array_equal(a.v, b.v)
                np.testing.assert_array_equal(a.noise, b.noise)
                assert a.iters == b.iters

    def test_pipelined_fills_then_drains(self):
        cfg = small_cfg()
        d = synthetic_events(24000, duration_s=0.4, res_x=24, res_y=32,
                             n_points=80, seed=5)
        flow = DVSFlow(cfg, pipeline_depth=2)
        fired = flow.add_events(d["x"], d["y"], d["t_ns"])
        assert fired > 3
        assert len(flow._pending) == 2       # pipe holds depth slices
        drained = flow.flush()
        assert len(drained) == 2 and not flow._pending

    def test_pipelined_noise_gate_identical(self):
        """A degenerate (single-pixel) stream fires the window gate on
        every slice; pipelined noise flags must match synchronous ones
        exactly (the gate is applied at dispatch)."""
        rng = np.random.default_rng(0)
        t = np.sort(rng.integers(0, int(3e8), 5000)).astype(np.int64)
        x = np.full(5000, 3.0, np.float32)
        y = np.full(5000, 4.0, np.float32)
        outs = []
        for depth in (0, 2):
            cfg = small_cfg()
            flow = DVSFlow(cfg, pipeline_depth=depth)
            flow.add_events(x, y, t)
            if len(flow.buffer):
                flow.recompute()
            flow.flush()
            outs.append(flow.slices)
        assert len(outs[0]) == len(outs[1])
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a.noise, b.noise)
            assert a.noise.all()

    def test_compact_fetch_quality(self):
        """The u8/f16 fetch may only quantize: flow within f16 epsilon of
        the f32 fetch, identical noise flags and iteration counts."""
        full = self._run(1, compact=False)
        comp = self._run(1, compact=True)
        assert len(full.slices) == len(comp.slices)
        for a, b in zip(full.slices, comp.slices):
            np.testing.assert_array_equal(a.noise, b.noise)
            assert a.iters == b.iters
            scale = np.maximum(np.abs(a.u), 1.0)
            assert np.max(np.abs(a.u - b.u) / scale) < 2e-3
            assert np.max(np.abs(a.v - b.v) / np.maximum(np.abs(a.v), 1.0)) < 2e-3
            assert np.max(np.abs(a.pr_x - b.pr_x)) < 0.2
