"""Temporal (slice) parallelism.

The reference's only scaling axis is time: bounded slices marching through
the stream (SURVEY.md §5 "long-context" analog).  Two forms here:

* warm-start pipelining: the sequential `lax.scan` with the model as carry
  (runtime/scan_pipeline.py) — exact reference semantics;
* independent-slice data parallelism: with the warm start disabled
  (--stm-disable, dvs_flow.h:137-139) slices share no state, so a batch of
  slices shards over a 'slice' mesh axis, optionally combined with event
  parallelism within each slice over an 'ev' axis.  This module implements
  that second form; `__graft_entry__.dryrun_multichip` drives it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from better_flow.config import OptimizerConfig, SensorConfig
from better_flow.core.events import EventSlice
from better_flow.core.model import MotionModel
from better_flow.models.global_flow import SliceResult, process_slice

AX_SLICE, AX_EV = "slice", "ev"


def process_slices_batch(
    ev_batch: EventSlice,
    models: MotionModel,
    cfg: OptimizerConfig,
    sensor: SensorConfig,
    mesh: Mesh,
    warm_start: bool = False,
) -> SliceResult:
    """Process a [S, N] batch of independent slices over a
    ('slice', 'ev') mesh: slices sharded across AX_SLICE, each slice's
    events sharded across AX_EV (psum'd images).  ``warm_start`` applies
    each slice's *given* model (no cross-slice chaining — that requires the
    sequential scan)."""

    def per_slice(ev, model):
        return process_slice(ev, model, cfg, sensor, warm_start=warm_start,
                             axis_name=AX_EV)

    ev_spec = EventSlice(*(P(AX_SLICE, AX_EV) for _ in EventSlice._fields))
    model_spec = jax.tree_util.tree_map(lambda _: P(AX_SLICE), MotionModel.zero())
    out_spec = SliceResult(
        model=jax.tree_util.tree_map(lambda _: P(AX_SLICE), MotionModel.zero()),
        pr_x=P(AX_SLICE, AX_EV), pr_y=P(AX_SLICE, AX_EV),
        nx=P(AX_SLICE, AX_EV), ny=P(AX_SLICE, AX_EV),
        u=P(AX_SLICE, AX_EV), v=P(AX_SLICE, AX_EV),
        noise=P(AX_SLICE, AX_EV),
        iters=P(AX_SLICE), ran=P(AX_SLICE), window_small=P(AX_SLICE),
        seed=P(AX_SLICE),
    )
    fn = jax.jit(
        jax.shard_map(
            jax.vmap(per_slice, in_axes=(0, 0)),
            mesh=mesh,
            in_specs=(ev_spec, model_spec),
            out_specs=out_spec,
            check_vma=False,
        )
    )
    return fn(ev_batch, models)
