"""Multi-host recording processing: slice ranges across processes (the
inter-host network), event parallelism on each host's local devices.

The reference is strictly single-process (SURVEY §2); BASELINE.json's
scaling row demands N>=2 hosts processing a recording.  The shape here
follows the canonical mesh recipe (outer axis = slow interconnect):

* each process OWNS a contiguous range of the global trigger plan
  (``distributed.process_local_slice_range``) and stages ONLY that range
  (host memory and host->device transfer scale 1/N — the reason to go
  multi-host on bufferized recordings at all);
* within a host, each slice's events are sharded over the LOCAL devices
  ('ev' axis): the per-iteration psum of pre-filter images — the hot
  collective — stays on the host and never crosses the network
  (parallel/event_parallel._sharded_scan_compact);
* across hosts, the only traffic is the scan carry hand-off at range
  boundaries — the 15 model scalars plus the secant seed and the
  window-gate history (scan_pipeline.make_carry) — via one
  ``broadcast_one_to_all`` per boundary over the network.

Two boundary semantics:

* ``boundary="chain"`` (default, matches the single-host pipeline
  exactly): range k starts from range k-1's final carry, so hosts execute
  their device scans SEQUENTIALLY — wall-clock does not scale, but
  memory, staging and I/O do.  This is the honest shape of the
  reference's warm-start chain (dvs_flow.h:215-224): the chain is a
  sequential dependence, and no mesh layout can parallelize it without
  changing semantics.
* ``boundary="cold"`` (exact for cfg.stm_disable, approximate otherwise):
  every range starts from a zero model, so hosts run CONCURRENTLY —
  wall-clock scales ~1/N.  With stm_disable (the reference's
  --stm-disable mode) this is bit-for-bit the single-host result; with
  warm start it resets the model chain at N-1 range boundaries (first
  slice of each range converges from scratch, like the recording's first
  slice).

Per-range outputs are disjoint by construction — a host claims only
events whose FIRST containing slice is local (original index beyond the
previous range's last trigger; scan_pipeline.compensate_recording_scan) —
so the full-recording result is the elementwise union, assembled with one
``process_allgather`` when ``gather=True``.

Noise-flag exactness at boundaries needs no communication: the window
gate is purely geometric, so each host reconstructs the previous hist_k
slices' gate outcomes from the recording itself
(scan_pipeline.prepare_recording's pre-range history).

Single-process fallback: with jax.distributed uninitialized the same code
runs all ranges locally in sequence — which is also how the range logic
is CI-tested without spawning processes (tests/test_distributed.py spawns
2 real processes for the cross-process path).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from better_flow.config import PipelineConfig
from better_flow.parallel import event_parallel
from better_flow.parallel.distributed import process_local_slice_range
from better_flow.runtime.scan_pipeline import (_initial_model, make_carry,
                                                    plan_slices)


def _local_ev_mesh(ev_per_host: Optional[int]):
    from jax.sharding import Mesh

    devs = jax.local_devices()
    n = ev_per_host or len(devs)
    return Mesh(np.asarray(devs[:n]), (event_parallel.AXIS,))


def compensate_recording_multihost(
    x,
    y,
    t_ns,
    cfg: Optional[PipelineConfig] = None,
    boundary: str = "chain",
    ev_per_host: Optional[int] = None,
    gather: bool = True,
) -> dict:
    """Process a recording across all participating processes.

    Every process must call this with the SAME recording and arguments
    (standard multi-controller SPMD).  Returns the full-recording result
    on every process when ``gather=True``; otherwise ``u``/``v``/``noise``
    hold only this process's claimed events (zeros elsewhere) and
    ``stats['slice_range']`` says which range this is.
    """
    cfg = cfg or PipelineConfig()
    if boundary not in ("chain", "cold"):
        raise ValueError(f"boundary must be 'chain' or 'cold': {boundary}")

    n_proc = jax.process_count()
    pid = jax.process_index()
    t_ns = np.ascontiguousarray(t_ns, np.int64)
    S = len(plan_slices(t_ns, cfg).ends)
    lo, hi = process_local_slice_range(S)

    mesh = _local_ev_mesh(ev_per_host)
    n_ev = mesh.shape[event_parallel.AXIS]
    prepared = event_parallel.prepare_recording_sharded(
        x, y, t_ns, cfg, n_ev, slice_range=(lo, hi)
    )

    def run_range(carry_in):
        # The local-range scan, event-parallel over this host's devices.
        from better_flow.runtime.scan_pipeline import (
            compensate_recording_scan,
        )

        if n_ev == 1:
            return compensate_recording_scan(None, None, None, cfg,
                                             prepared=prepared,
                                             carry_in=carry_in)
        return _sharded_range(prepared, cfg, mesh, carry_in)

    if boundary == "cold" or cfg.stm_disable or n_proc == 1:
        ws_h, st_h, en_h = prepared["hist0"]
        carry0 = make_carry(_initial_model(cfg), prepared["hist_k"],
                            ws_h=ws_h, st_h=st_h, en_h=en_h)
        out = run_range(carry0)
    else:
        # Sequential chain: wait for the previous range's carry, run, hand
        # off.  broadcast_one_to_all is a collective — every process
        # participates at every boundary, which is what serializes the
        # ranges (and what makes the hand-off a single DCN transfer of
        # ~15 scalars + the small histories).
        from jax.experimental import multihost_utils

        ws_h, st_h, en_h = prepared["hist0"]
        carry = make_carry(_initial_model(cfg), prepared["hist_k"],
                           ws_h=ws_h, st_h=st_h, en_h=en_h)
        out = None
        for h in range(n_proc):
            if h == pid:
                out = run_range(carry)
                nxt = out["carry"]
            else:
                nxt = carry  # placeholder of identical structure
            if h < n_proc - 1:
                if n_proc > 1:
                    carry = multihost_utils.broadcast_one_to_all(
                        nxt, is_source=(h == pid)
                    )
                else:
                    carry = nxt
        assert out is not None

    n = len(x)
    if gather and n_proc > 1:
        from jax.experimental import multihost_utils

        # Per-range claims are disjoint: elementwise sum/or assembles the
        # exact full-recording first-slice-wins result.
        def combine(a):
            g = multihost_utils.process_allgather(jnp.asarray(a))
            return np.asarray(g).sum(axis=0)

        u = combine(out["u"]).astype(np.float32)
        v = combine(out["v"]).astype(np.float32)
        noise = combine(out["noise"].astype(np.int8)) > 0
    else:
        u, v, noise = out["u"], out["v"], out["noise"]
    iters = out["iters"]  # per-slice iters stay range-local

    st = dict(out["stats"])
    st.update(n_events=n, n_processes=n_proc, slice_range=(lo, hi),
              n_slices_total=S, boundary=boundary, ev_per_host=n_ev)
    return {"u": u, "v": v, "noise": noise, "model": out["model"],
            "carry": out["carry"], "iters": iters, "stats": st}


def _sharded_range(prepared, cfg, mesh, carry_in):
    """Event-parallel scan over a prepared slice range with an explicit
    carry (the hand-off-aware twin of
    event_parallel.compensate_recording_scan_sharded)."""
    import time as _time

    plan = prepared["plan"]
    n_total = prepared["n"]
    S = len(plan.ends)
    t0 = _time.perf_counter()
    if prepared["compact"]:
        carry_out, (uvn, iters, ran), chk = \
            event_parallel._sharded_scan_compact(
                prepared["xs16"], prepared["ys16"], prepared["ts"],
                prepared["perm"], prepared["starts"], prepared["ends"],
                prepared["bbox"], prepared["nval"], carry_in, cfg,
                prepared["hist_k"], mesh,
            )
    else:
        carry_out, (uvn, iters, ran), chk = \
            event_parallel._sharded_scan(
                prepared["xs"], prepared["ys"], prepared["ts"],
                prepared["idx"], prepared["starts"], prepared["ends"],
                prepared["bbox"], prepared["nval"], carry_in, cfg,
                prepared["hist_k"], mesh,
            )
    float(np.asarray(chk))
    run_s = _time.perf_counter() - t0

    from better_flow.runtime.scan_pipeline import _accumulate_first_wins

    acc_u, acc_v, acc_noise = _accumulate_first_wins(prepared, uvn)

    return {
        "u": acc_u, "v": acc_v, "noise": acc_noise, "model": carry_out[0],
        "carry": carry_out, "iters": np.asarray(iters),
        "stats": {
            "n_events": n_total, "n_slices": S,
            "plan_s": prepared["plan_s"], "run_s": run_s,
            "mean_iters": float(np.mean(np.asarray(iters))) if S else 0.0,
        },
    }
