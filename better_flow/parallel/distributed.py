"""Multi-host (multi-process) execution: jax.distributed + DCN-aware meshes.

The reference is strictly single-process (SURVEY §2 "Parallelism &
distribution"); the north star (BASELINE.json config 5) demands N>=2 hosts.
The shape of that here is standard JAX SPMD:

* every host runs the SAME program over globally-sharded arrays,
* the device mesh is laid out so the *event* axis (one psum of pre-filter
  images per optimizer iteration — the hot collective,
  parallel/event_parallel.py) maps onto the intra-host interconnect
  (NVLink between the GPUs of a host), while the *slice*
  axis (independent or pipelined slices; at most one small model exchange
  per slice) spans hosts over DCN — the slow network carries the cold
  traffic.  This is the canonical mesh recipe: inner mesh axes = fast
  interconnect, outer axes = DCN.

Nothing here is specific to one accelerator: the same code paths run
multi-process on
CPU (each process exposing virtual devices), which is how
tests/test_distributed.py exercises real cross-process collectives
without a cluster.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed from arguments or environment.

    Environment fallbacks: BF_COORDINATOR, BF_NUM_PROCESSES, BF_PROCESS_ID
    (alongside JAX's own cluster auto-detection, for clusters whose
    scheduler publishes them).  Returns True
    if distributed mode was initialized, False for single-process runs
    (nothing configured — the offline/streaming paths work unchanged).
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get("BF_COORDINATOR")
    if num_processes is None and "BF_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["BF_NUM_PROCESSES"])
    if process_id is None and "BF_PROCESS_ID" in os.environ:
        process_id = int(os.environ["BF_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_host_mesh(ev_per_host: Optional[int] = None,
                   host_axis: str = "slice", ev_axis: str = "ev"):
    """Global (host, ev) mesh: the outer axis spans processes (DCN), the
    inner axis each process's local devices (ICI).

    ``jax.devices()`` orders devices by process, so reshaping to
    (n_processes, local_count) puts every host's devices contiguous on the
    inner axis — collectives over ``ev_axis`` never cross DCN.
    """
    import jax
    from jax.sharding import Mesh

    n_proc = jax.process_count()
    all_devs = np.asarray(jax.devices())
    local_all = len(all_devs) // n_proc
    use = ev_per_host or local_all
    if use > local_all:
        raise ValueError(
            f"ev_per_host {use} > {local_all} local devices per process"
        )
    grid = all_devs.reshape(n_proc, local_all)[:, :use]
    return Mesh(grid, (host_axis, ev_axis))


def process_local_slice_range(n_slices: int) -> Tuple[int, int]:
    """Contiguous slice range owned by this process under slice-parallel
    multi-host processing (stm_disable mode, where slices are independent;
    with warm-start chaining, hosts pipeline ranges and hand the model
    carry to the next host — one 15-scalar transfer per boundary)."""
    import jax

    p = jax.process_index()
    n = jax.process_count()
    per = (n_slices + n - 1) // n
    lo = min(p * per, n_slices)
    return lo, min(lo + per, n_slices)
