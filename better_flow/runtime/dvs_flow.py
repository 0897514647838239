"""The streaming slice manager — DVS_flow re-designed for a jit pipeline.

Reference: DVS_flow<MAX_SZ, SPAN> (dvs_flow.h:21-389).  Event ingestion and
trigger logic stay on the host (they are branchy, latency-bound bookkeeping);
each fired slice is materialized as a fixed-capacity padded tensor and
processed by a single jit-compiled program (models.global_flow.process_slice)
with the motion model carried across slices as the warm start
(dvs_flow.h:38-39, 215-224).

``add_events`` is the vectorized feed: trigger boundaries inside a batch are
computed arithmetically (count trigger) and with searchsorted (time trigger),
giving semantics identical to calling add_event per event
(dvs_flow.h:163-181) without a Python-level per-event loop.

Latency pipelining: a synchronous slice waits for its device round trip
before the next slice can be staged.  With ``pipeline_depth`` K > 0,
``recompute`` DISPATCHES the
slice (one packed h2d transfer; the model/seed warm-start carry never
leaves the device, so the sequential chain of the reference is unbroken)
and defers the result fetch: up to K slices are in flight, and a call
returns the (K-dispatches-old) finalized record, or ``None`` while the
pipe fills.  Host-visible outputs are bit-identical to depth 0 — the only
cross-slice state a later slice READS is the buffer noise flags, whose
single source is the window_small gate (optimizer_rolling.h:52-54), which
is purely geometric (bbox + min_window_fraction) and therefore applied
host-side AT DISPATCH; u/v/pr writebacks only feed views and are guarded
against slots the ring has since recycled.  ``flush()`` drains the pipe
(the reference's final recompute, bf_motion_compensator.cpp:208).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import jax
import numpy as np

from better_flow.config import PipelineConfig
from better_flow.core.events import EventSlice
from better_flow.core.model import MotionModel
from better_flow.models.global_flow import process_slice
from better_flow.runtime.slice_buffer import EventRingBuffer

import jax.numpy as jnp
from jax import lax


class SliceRecord:
    """Per-slice outputs retained for accumulation / inspection
    (the reference's ``accumulated`` vector + motion_memory deque,
    dvs_flow.h:43-46, 238-252, 340-346)."""

    __slots__ = ("x", "y", "timestamp", "t_local", "u", "v", "noise",
                 "pr_x", "pr_y", "model", "iters", "wall_s", "n_events",
                 "slice_start_time", "interval_s")

    def __init__(self, **kw):
        self.interval_s = None
        for k, v in kw.items():
            setattr(self, k, v)


class DVSFlow:
    def __init__(self, cfg: PipelineConfig, pipeline_depth: int = 0,
                 compact_fetch: bool = False):
        """``pipeline_depth``: number of slices allowed in flight beyond
        the one being finalized (0 = the reference's fully synchronous
        behavior).  ``compact_fetch``: fetch results as one (10, cap) u8
        array — f16 u/v/pr + u8 noise, 10 B/event instead of 24 — for
        links whose device->host bandwidth is the bottleneck;
        u/v quantization is ~1e-3 relative (f16), pr ~0.12 px at a
        240 px sensor (documented trade-off, off by default)."""
        self.cfg = cfg
        sl = cfg.slice
        self.buffer = EventRingBuffer(sl.max_events, sl.span_ns)
        import jax.numpy as _jnp

        self.last_model = MotionModel.zero(
            _jnp.float64 if cfg.f64_totals else _jnp.float32
        )
        self.last_seed = _jnp.zeros(8, _jnp.float32)
        # Trigger state (dvs_flow.h:30-36).
        self.event_diff = 0
        self.time_diff = 0
        self.last_slice_time = 0
        self.current_slice_time = 0
        self._started = False
        self.slices: List[SliceRecord] = []
        self.frame_count = 0
        self.on_slice: Optional[Callable[[SliceRecord], None]] = None
        self.pipeline_depth = int(pipeline_depth)
        self.compact_fetch = bool(compact_fetch)
        self._pending: List[dict] = []
        self._last_final_t: Optional[float] = None

        def _process(inp, model, seed, opt, sensor, warm_start, compact):
            # One packed (5, cap) f32 input so the host pays a SINGLE
            # host->device transfer per slice (x, y, t_local, noise, and a
            # scalar row [bbox x4, n]) instead of five.
            cap = inp.shape[1]
            n = inp[4, 4].astype(jnp.int32)
            ev = EventSlice(
                x=inp[0], y=inp[1], t=inp[2],
                valid=jnp.arange(cap, dtype=jnp.int32) < n,
                noise=inp[3] > 0.5,
            )
            bbox = inp[4, 0:4].astype(jnp.int32)
            res = process_slice(ev, model, opt, sensor,
                                warm_start=warm_start,
                                seed=seed, bbox=bbox, n_valid=n)
            if compact:
                # (10, cap) u8: rows 0-7 = f16 bytes of [u, v, pr_x,
                # pr_y], row 8 = noise, row 9 = scalars (iters,
                # window_small) — one-third the d2h bytes of the f32 pack.
                f16 = jnp.stack(
                    [res.u, res.v, res.pr_x, res.pr_y]).astype(jnp.float16)
                b8 = jnp.moveaxis(
                    lax.bitcast_convert_type(f16, jnp.uint8), 2, 1
                ).reshape(8, cap)
                noise_row = res.noise.astype(jnp.uint8)[None, :]
                scal = jnp.zeros((cap,), jnp.uint8)
                scal = scal.at[0].set(res.iters.astype(jnp.uint8))
                scal = scal.at[1].set(res.window_small.astype(jnp.uint8))
                packed = jnp.concatenate([b8, noise_row, scal[None, :]])
            else:
                # One packed (6, cap) f32 output: a SINGLE device->host
                # fetch per slice (five separate np.asarray fetches were
                # 70% of streaming wall time).  Row 5 carries the scalars.
                scal_row = jnp.zeros((cap,), jnp.float32)
                scal_row = scal_row.at[0].set(
                    res.iters.astype(jnp.float32))
                scal_row = scal_row.at[1].set(
                    res.window_small.astype(jnp.float32))
                packed = jnp.stack([
                    res.u, res.v, res.pr_x, res.pr_y,
                    res.noise.astype(jnp.float32), scal_row,
                ])
            return res.model, res.seed, packed

        self._jit = jax.jit(
            _process,
            static_argnames=("opt", "sensor", "warm_start", "compact"),
        )

    # ------------------------------------------------------------------ feed
    def add_event(self, x: float, y: float, timestamp: int) -> bool:
        """DVS_flow::add_event (dvs_flow.h:163-181).  Returns True if a
        recompute fired."""
        self.buffer.push(x, y, timestamp)
        self.event_diff += 1
        self.current_slice_time = int(timestamp)
        self.time_diff = self.current_slice_time - self.last_slice_time
        if (
            self.event_diff < self.cfg.slice.refresh_events
            and self.time_diff < self.cfg.slice.refresh_time_ns
        ):
            return False
        self.recompute()
        return True

    def add_events(self, x, y, timestamp) -> int:
        """Vectorized feed of a sorted batch; returns recompute count."""
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        ts = np.asarray(timestamp, np.int64)
        n = len(ts)
        fired = 0
        start = 0
        ev_th = self.cfg.slice.refresh_events
        t_th = self.cfg.slice.refresh_time_ns
        while start < n:
            # Next count trigger: when event_diff reaches ev_th.
            i_count = start + (ev_th - self.event_diff) - 1
            # Next time trigger: first i with ts[i] - last_slice_time >= t_th.
            i_time = int(
                np.searchsorted(ts[start:], self.last_slice_time + t_th, "left")
            ) + start
            i = min(i_count, i_time)
            if i >= n:
                self.buffer.push_batch(x[start:], y[start:], ts[start:])
                self.event_diff += n - start
                self.current_slice_time = int(ts[-1])
                self.time_diff = self.current_slice_time - self.last_slice_time
                break
            self.buffer.push_batch(x[start : i + 1], y[start : i + 1], ts[start : i + 1])
            self.event_diff += i + 1 - start
            self.current_slice_time = int(ts[i])
            self.time_diff = self.current_slice_time - self.last_slice_time
            self.recompute()
            fired += 1
            start = i + 1
        return fired

    # ------------------------------------------------------------- recompute
    def recompute(self) -> Optional[SliceRecord]:
        """DVS_flow::recompute (dvs_flow.h:184-347) minus the OpenCV HUD.

        With pipeline_depth 0 (default): fully synchronous — returns this
        slice's record.  With depth K > 0: dispatches this slice, returns
        the oldest in-flight slice's record once more than K are pending
        (``None`` while the pipe fills); ``flush()`` drains the rest."""
        t_begin = time.perf_counter()
        snap = self.buffer.snapshot()
        n = len(snap["x"])

        # Slice start time (dvs_flow.h:186-193).
        if n == self.buffer.capacity:
            slice_start = int(snap["timestamp"][0])
        else:
            slice_start = max(self.current_slice_time - self.buffer.span_ns, 0)

        t_local = (snap["timestamp"] - slice_start).astype(np.float32)

        # Host-side spatial sort, as the scan's staging does, so that
        # neighbouring events splat into neighbouring pixels.
        key = (snap["x"].astype(np.int64) // 32) * 4096 + snap["y"].astype(
            np.int64
        )
        order = np.argsort(key, kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(n)

        cap = self.buffer.capacity
        pad = cap - n
        if n > 0:
            bbox = (int(snap["x"].min()), int(snap["x"].max()),
                    int(snap["y"].min()), int(snap["y"].max()))
        else:
            bbox = (0, 0, 0, 0)
        # window_small is purely geometric — the same formula the device
        # applies (global_flow.geometry_from_bbox) — so the host can mark
        # the buffer's noise flags AT DISPATCH: the only cross-slice state
        # a later slice READS is these flags, which keeps pipelined runs
        # bit-identical to synchronous ones.
        opt = self.cfg.optimizer
        scale = opt.scale
        frac = opt.min_window_fraction
        wx = scale * (bbox[1] - bbox[0])
        wy = scale * (bbox[3] - bbox[2])
        window_small = ((wx + scale) < (scale * self.cfg.sensor.res_x) // frac
                        and (wy + scale) <
                        (scale * self.cfg.sensor.res_y) // frac)
        if window_small and n > 0:
            self.buffer.noise[snap["index"]] = True

        inp = np.zeros((5, cap), np.float32)
        inp[0, :n] = snap["x"][order]
        inp[1, :n] = snap["y"][order]
        inp[2, :n] = t_local[order]
        inp[3, :n] = snap["noise"][order]
        inp[4, 0:4] = bbox
        inp[4, 4] = n
        model_out, seed_out, packed = self._jit(
            jnp.asarray(inp),
            self.last_model,
            self.last_seed,
            self.cfg.optimizer,
            self.cfg.sensor,
            warm_start=not self.cfg.stm_disable,
            compact=self.compact_fetch,
        )

        # last_model = optimizer.get_model() (dvs_flow.h:224).  When stm is
        # disabled the optimizer started from zero; its result still becomes
        # the stored model, matching the C++ (set_model simply not called).
        # Both stay on device (no fetch); only ``packed`` is fetched.
        self.last_model = model_out
        self.last_seed = seed_out
        try:
            packed.copy_to_host_async()
        except AttributeError:
            pass

        self._pending.append(dict(
            snap=snap, inv=inv, n=n, slice_start=slice_start,
            t_local=t_local, t_dispatch=t_begin, packed=packed,
            model=model_out,
        ))

        # Reset triggers (dvs_flow.h:337-338).
        self.event_diff = 0
        self.last_slice_time = self.current_slice_time

        if len(self._pending) > self.pipeline_depth:
            return self._finalize(self._pending.pop(0))
        return None

    def _finalize(self, ent: dict) -> SliceRecord:
        """Fetch + decode one dispatched slice; write results back into
        still-live ring slots; emit the record."""
        snap, inv, n = ent["snap"], ent["inv"], ent["n"]
        packed_h = np.asarray(ent["packed"])     # the one per-slice fetch
        if self.compact_fetch:
            b = np.ascontiguousarray(
                np.moveaxis(packed_h[:8].reshape(4, 2, -1), 1, 2))
            f16 = b.view(np.float16)[..., 0]
            u = f16[0, :n].astype(np.float32)[inv]
            v = f16[1, :n].astype(np.float32)[inv]
            pr_x = f16[2, :n].astype(np.float32)[inv]
            pr_y = f16[3, :n].astype(np.float32)[inv]
            noise = packed_h[8, :n][inv] > 0
            n_iters = int(packed_h[9, 0])
        else:
            u = packed_h[0, :n][inv]
            v = packed_h[1, :n][inv]
            pr_x = packed_h[2, :n][inv]
            pr_y = packed_h[3, :n][inv]
            noise = packed_h[4, :n][inv] > 0.5
            n_iters = int(packed_h[5, 0])
        # u/v/pr writebacks feed only views/accumulation; under pipelining
        # the ring may have recycled some slots — guard on timestamp
        # identity so a deferred writeback cannot stomp newer events.
        # (Noise was already applied at dispatch; see recompute.)
        idx = snap["index"]
        still = self.buffer.timestamp[idx] == snap["timestamp"]
        if still.all():
            self.buffer.writeback(idx, noise=noise, u=u, v=v,
                                  pr_x=pr_x, pr_y=pr_y)
        elif still.any():
            self.buffer.writeback(idx[still], noise=noise[still],
                                  u=u[still], v=v[still],
                                  pr_x=pr_x[still], pr_y=pr_y[still])

        t_done = time.perf_counter()
        wall = t_done - ent["t_dispatch"]
        rec = SliceRecord(
            x=snap["x"].copy(),
            y=snap["y"].copy(),
            timestamp=snap["timestamp"].copy(),
            t_local=ent["t_local"],
            u=u,
            v=v,
            noise=noise,
            pr_x=pr_x,
            pr_y=pr_y,
            model=ent["model"],
            iters=n_iters,
            wall_s=wall,
            n_events=n,
            slice_start_time=ent["slice_start"],
        )
        rec.interval_s = (t_done - self._last_final_t
                          if self._last_final_t is not None else wall)
        self._last_final_t = t_done
        if self.cfg.accumulate:
            self.slices.append(rec)
        if self.on_slice is not None:
            self.on_slice(rec)
        return rec

    def flush(self) -> List[SliceRecord]:
        """Drain the pipeline: finalize every in-flight slice (the
        reference's final recompute flush)."""
        out = []
        while self._pending:
            out.append(self._finalize(self._pending.pop(0)))
        return out

    # ---------------------------------------------------------- introspection
    def get_buf_size(self) -> int:
        return len(self.buffer)

    def get_time_diff(self) -> int:
        return self.time_diff

    def get_buf_time_diff(self) -> int:
        """dvs_flow.h:150-159."""
        if len(self.buffer) == self.buffer.capacity:
            start = self.buffer.oldest_timestamp()
        else:
            start = max(self.current_slice_time - self.buffer.span_ns, 0)
        return self.current_slice_time - start

    def realtime_factor(self) -> float:
        """%realtime — slice time-span / wall time (dvs_flow.h:275-282).
        Under pipelining wall_s is the slice's true dispatch-to-results
        latency; use interval_s for the sustained (throughput) factor."""
        if not self.slices:
            return 0.0
        r = self.slices[-1]
        span_s = (r.timestamp[-1] - r.slice_start_time) / 1e9 if r.n_events else 0.0
        return span_s / r.wall_s if r.wall_s > 0 else 0.0

    def get_accumulated(self):
        from better_flow.runtime.accumulate import merge_slices

        self.flush()
        return merge_slices(self.slices)
