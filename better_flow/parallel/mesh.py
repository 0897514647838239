"""Device-mesh helpers.

The reference has no distributed execution (SURVEY.md §2); scale-out here is
a capability-equivalent designed for device meshes: a ``jax.sharding.Mesh``
whose axes mirror the structure of the workload —

    ev      event parallelism within a slice (scatter sharded, images psum'd)
    tile_x/tile_y   spatial tiling of the image plane (megapixel sensors)
    slice   temporal parallelism across independent slices (stm disabled)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_event_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over ('ev',) for event-parallel slice processing."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return jax.make_mesh((n,), ("ev",), devices=devs[:n])


def make_tiled_mesh(tiles: Tuple[int, int]) -> Mesh:
    """2-D mesh over ('tile_x', 'tile_y') for spatially tiled images."""
    return jax.make_mesh(tiles, ("tile_x", "tile_y"))


def make_pipeline_mesh(n_slices: int, n_ev: int) -> Mesh:
    """2-D mesh over ('slice', 'ev'): independent slices across one axis,
    event parallelism within each slice across the other."""
    return jax.make_mesh((n_slices, n_ev), ("slice", "ev"))
