"""Dense SoA event tensors — the accelerator replacement for the reference's Event
objects and pointer-chasing containers.

The reference stores events as mutable objects (event.h:7-170) inside a
circular array (datastructures.h:6-115) and mutates them in place through
LinearEventPtrs views.  Here a slice of events is a fixed-capacity,
immutable SoA pytree; "eviction" and "noise" become masks, and per-event
mutable state (pr, n) lives in the optimizer's loop carry instead.

This is the same flattening the reference itself performs when mirroring
events into OpenCL SoA buffers fr_x/fr_y/t/nx/ny/pr_x/pr_y
(accel_lib.h:83-99) — confirmation that events need no object identity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np


class EventSlice(NamedTuple):
    """A fixed-capacity slice of events, SoA layout.

    All arrays share the leading capacity dimension ``N`` (static under jit).

    x, y     : f32[N]  pixel coordinates.  ``x`` indexes image rows,
               ``y`` columns, matching the reference's swapped convention
               (Event::fr_x/fr_y after the file-read swap, event_file.h:60).
    t        : f32[N]  slice-local time in nanoseconds
               (Event::set_local_time, event.h:61-63).
    valid    : bool[N] True for real events, False for padding.
    noise    : bool[N] events flagged as noise by a degenerate slice
               (optimizer_rolling.h:52-54); excluded from images
               (accel_lib.h:152) but still present in the buffer.
    """

    x: jnp.ndarray
    y: jnp.ndarray
    t: jnp.ndarray
    valid: jnp.ndarray
    noise: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    @property
    def active(self) -> jnp.ndarray:
        """Mask of events that contribute to images: valid and not noise."""
        return self.valid & ~self.noise


def make_slice(
    x,
    y,
    t,
    capacity: Optional[int] = None,
    noise=None,
) -> EventSlice:
    """Build an EventSlice from host arrays, padding to ``capacity``.

    Padding events get x=y=0, t=0, valid=False — they are masked out of every
    downstream op, mirroring how the reference simply has fewer events.
    """
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    t = np.asarray(t, np.float32)
    n = x.shape[0]
    if noise is None:
        noise = np.zeros(n, bool)
    else:
        noise = np.asarray(noise, bool)
    cap = capacity if capacity is not None else n
    if n > cap:
        raise ValueError(f"{n} events exceed capacity {cap}")
    pad = cap - n
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])

    def _pad(a, fill=0):
        return np.concatenate([a, np.full(pad, fill, a.dtype)])

    return EventSlice(
        x=jnp.asarray(_pad(x)),
        y=jnp.asarray(_pad(y)),
        t=jnp.asarray(_pad(t)),
        valid=jnp.asarray(valid),
        noise=jnp.asarray(_pad(noise, False)),
    )


def bounding_box(ev: EventSlice, axis_name=None):
    """Integer bbox (x_min, x_max, y_min, y_max) over *all* valid events.

    Matches OptimizerRolling::set_cloud (optimizer_rolling.h:252-261), which
    scans every event in the cloud — including noise-flagged ones — when
    sizing the window.  Returns int32 scalars; for an empty slice the bbox
    degenerates to (0, 0, 0, 0) (the window-size gate then rejects it).

    With ``axis_name`` (events sharded across a mesh axis inside shard_map)
    the bbox is reduced globally with pmin/pmax.
    """
    import jax

    big = jnp.int32(1 << 30)
    xi = ev.x.astype(jnp.int32)
    yi = ev.y.astype(jnp.int32)
    x_min = jnp.min(jnp.where(ev.valid, xi, big))
    y_min = jnp.min(jnp.where(ev.valid, yi, big))
    x_max = jnp.max(jnp.where(ev.valid, xi, -big))
    y_max = jnp.max(jnp.where(ev.valid, yi, -big))
    any_valid = jnp.any(ev.valid)
    if axis_name is not None:
        x_min = jax.lax.pmin(x_min, axis_name)
        y_min = jax.lax.pmin(y_min, axis_name)
        x_max = jax.lax.pmax(x_max, axis_name)
        y_max = jax.lax.pmax(y_max, axis_name)
        any_valid = jax.lax.pmax(any_valid.astype(jnp.int32), axis_name) > 0
    zero = jnp.int32(0)
    return (
        jnp.where(any_valid, x_min, zero),
        jnp.where(any_valid, x_max, zero),
        jnp.where(any_valid, y_min, zero),
        jnp.where(any_valid, y_max, zero),
    )
