"""Event-parallel slice processing: shard events, psum images.

The reference parallelizes within one CPU via TBB parallel_for over image
rows (accel_lib.h:168-175, 528-542) and has no cross-device story.  The
equivalent here for the *event-dominated* regime: shard the event
tensors of one slice across a mesh axis; each device scatters its local
events into pre-filter images that are combined with one ``psum`` per
optimizer iteration, after which the cheap image-space model
update is computed redundantly on every device — keeping the model exactly
replicated with zero extra communication.  All collectives are inserted
inside the jitted while-loop; convergence decisions are identical on every
device because they depend only on the psum'd model.

For megapixel sensors where the image dominates, see
better_flow.parallel.spatial (tiled images + halo exchange).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from better_flow.config import OptimizerConfig, SensorConfig
from better_flow.core.events import EventSlice
from better_flow.core.model import MotionModel
from better_flow.models.global_flow import SliceResult, process_slice

AXIS = "ev"


def process_slice_event_parallel(
    ev: EventSlice,
    last_model: MotionModel,
    cfg: OptimizerConfig,
    sensor: SensorConfig,
    mesh: Mesh,
    warm_start: bool = True,
) -> SliceResult:
    """Sharded equivalent of models.global_flow.process_slice.

    Event arrays are sharded along mesh axis 'ev' (capacity must divide the
    axis size); the model is replicated.  Returns a SliceResult whose
    per-event arrays are sharded and whose model/scalars are replicated.
    """
    n_dev = mesh.shape[AXIS]
    if ev.capacity % n_dev != 0:
        raise ValueError(
            f"capacity {ev.capacity} not divisible by mesh axis {n_dev}"
        )

    ev_spec = EventSlice(x=P(AXIS), y=P(AXIS), t=P(AXIS), valid=P(AXIS), noise=P(AXIS))
    model_spec = jax.tree_util.tree_map(lambda _: P(), last_model)
    out_spec = SliceResult(
        model=model_spec,
        pr_x=P(AXIS), pr_y=P(AXIS), nx=P(AXIS), ny=P(AXIS),
        u=P(AXIS), v=P(AXIS), noise=P(AXIS),
        iters=P(), ran=P(), window_small=P(), seed=P(),
    )

    fn = jax.shard_map(
        partial(
            process_slice,
            cfg=cfg,
            sensor=sensor,
            warm_start=warm_start,
            axis_name=AXIS,
        ),
        mesh=mesh,
        in_specs=(ev_spec, model_spec),
        out_specs=out_spec,
        check_vma=False,
    )
    return fn(ev, last_model)


def jit_event_parallel(cfg, sensor, mesh, warm_start=True):
    """jit-compiled sharded slice processor (static over cfg/sensor/mesh)."""
    return jax.jit(
        partial(
            process_slice_event_parallel,
            cfg=cfg,
            sensor=sensor,
            mesh=mesh,
            warm_start=warm_start,
        )
    )


def _carry_spec(carry0):
    """Replicated partition specs for a make_carry tuple."""
    return jax.tree_util.tree_map(lambda _: P(), carry0)


@partial(jax.jit, static_argnames=("cfg", "hist_k", "mesh"))
def _sharded_scan(xs, ys, ts, idx, starts, ends, bbox, nval, carry0, cfg,
                  hist_k, mesh: Mesh):
    """One compiled program: the slice scan with every slice's event slab
    sharded over mesh axis 'ev'.  The shard-local body is the SAME scan
    driver as the single-device path (scan_pipeline._run_scan) with
    axis_name='ev': each shard splats its events and the pre-filter
    images are psum'd per iteration (ops.time_image.scatter_images)."""
    from better_flow.runtime.scan_pipeline import _run_scan

    carry_spec = _carry_spec(carry0)
    body = partial(_run_scan, cfg=cfg, hist_k=hist_k, axis_name=AXIS)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, AXIS), P(None, AXIS), P(None, AXIS),
                  P(None, AXIS), P(None), P(None), P(None), P(None),
                  carry_spec),
        out_specs=(carry_spec,
                   (P(None, AXIS, None, None), P(None), P(None)),
                   P()),
        check_vma=False,
    )(xs, ys, ts, idx, starts, ends, bbox, nval, carry0)


@partial(jax.jit, static_argnames=("cfg", "hist_k", "mesh"))
def _sharded_scan_compact(xs16, ys16, ts, perm, starts, ends, bbox, nval,
                          carry0, cfg, hist_k, mesh: Mesh):
    """Compact-transfer sharded scan: u16 coordinate and permutation slabs
    ride the host->device link (10 B/slot instead of 16) and each shard
    reconstructs its f32 views elementwise — the same encoding as
    scan_pipeline._scan_slices_compact, sharded over 'ev'."""
    from better_flow.runtime.scan_pipeline import PERM_SENTINEL, _run_scan

    carry_spec = _carry_spec(carry0)

    def body(xs16, ys16, ts, perm, starts, ends, bbox, nval, carry0):
        valid = perm != PERM_SENTINEL
        sidx = jnp.where(valid, starts[:, None] + perm.astype(jnp.int32), -1)
        return _run_scan(xs16.astype(jnp.float32), ys16.astype(jnp.float32),
                         ts, sidx, starts, ends, bbox, nval, carry0,
                         cfg, hist_k, axis_name=AXIS)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, AXIS), P(None, AXIS), P(None, AXIS),
                  P(None, AXIS), P(None), P(None), P(None), P(None),
                  carry_spec),
        out_specs=(carry_spec,
                   (P(None, AXIS, None, None), P(None), P(None)),
                   P()),
        check_vma=False,
    )(xs16, ys16, ts, perm, starts, ends, bbox, nval, carry0)


def prepare_recording_sharded(x, y, t_ns, cfg, n_dev: int, slice_range=None):
    """Host-side staging for the sharded scan: delegates to
    scan_pipeline.prepare_recording (native threaded counting sort +
    pipelined compact u16 transfer) with the padded capacity rounded to a
    multiple of n_dev * CHUNK so every device's shard holds whole chunks
    of the (n_chunks, 3, CHUNK) output packing."""
    from better_flow.runtime.scan_pipeline import CHUNK, prepare_recording

    return prepare_recording(x, y, t_ns, cfg, slice_range=slice_range,
                             pad_quantum=n_dev * CHUNK)


def compensate_recording_scan_sharded(
    x, y, t_ns, cfg, mesh: Mesh, init_model: Optional[MotionModel] = None,
    prepared: Optional[dict] = None,
) -> dict:
    """Multi-chip offline pipeline: the device-resident slice scan with each
    slice's events sharded over mesh axis 'ev'.

    Inside shard_map, every device warps and splats its event shard; the
    pre-filter images are psum'd per iteration via axis_name='ev' and the
    image-space finish + model update run replicated, so the warm-start
    model is identical on every device.
    Cross-slice noise persistence needs NO communication: the only noise
    source is the per-slice window gate (whose verdict is already
    replicated via the psum'd bounding box), so each shard reconstructs
    its events' flags from a replicated scalar history of
    (window_small, start, end) — see scan_pipeline._run_scan.

    This is the 1-host/N-device and (over multi-host meshes) N-host
    configuration.  Pass ``prepared``
    from prepare_recording_sharded to reuse host staging across runs.
    """
    import time as _time

    from better_flow.runtime.scan_pipeline import make_carry

    n_dev = mesh.shape[AXIS]
    if prepared is None:
        prepared = prepare_recording_sharded(x, y, t_ns, cfg, n_dev)
    plan = prepared["plan"]
    n_total = prepared["n"]
    S = len(plan.ends)

    ws_h, st_h, en_h = prepared.get("hist0", (None, None, None))
    carry0 = make_carry(init_model or MotionModel.zero(),
                        prepared["hist_k"], ws_h=ws_h, st_h=st_h, en_h=en_h)
    t0 = _time.perf_counter()
    if prepared["compact"]:
        carry_out, (uvn, iters, ran), chk = _sharded_scan_compact(
            prepared["xs16"], prepared["ys16"], prepared["ts"],
            prepared["perm"], prepared["starts"], prepared["ends"],
            prepared["bbox"], prepared["nval"], carry0, cfg,
            prepared["hist_k"], mesh,
        )
    else:
        carry_out, (uvn, iters, ran), chk = _sharded_scan(
            prepared["xs"], prepared["ys"], prepared["ts"], prepared["idx"],
            prepared["starts"], prepared["ends"],
            prepared["bbox"], prepared["nval"], carry0, cfg,
            prepared["hist_k"], mesh,
        )
    float(np.asarray(chk))  # host fetch: forces true completion
    run_s = _time.perf_counter() - t0
    final_model = carry_out[0]

    # First-slice-wins by ORIGINAL index (band-padded layouts interleave
    # padding inside the slice, so mask on idx >= 0, not a length prefix).
    from better_flow.runtime.scan_pipeline import _accumulate_first_wins

    acc_u, acc_v, acc_noise = _accumulate_first_wins(prepared, uvn)

    return {
        "u": acc_u, "v": acc_v, "noise": acc_noise, "model": final_model,
        "carry": carry_out,
        "iters": np.asarray(iters), "ran": np.asarray(ran),
        "stats": {
            "n_events": n_total, "n_slices": S, "n_devices": n_dev,
            "plan_s": prepared["plan_s"], "run_s": run_s,
            "events_per_s": n_total / run_s if run_s > 0 else 0.0,
            "mean_iters": float(np.mean(np.asarray(iters))),
        },
    }
