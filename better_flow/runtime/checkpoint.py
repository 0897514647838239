"""Checkpoint / resume for the STREAMING pipeline (DVSFlow).

The reference has no persistence at all — its only cross-slice state is the
in-memory ``last_model`` warm start (dvs_flow.h:38-39; SURVEY.md §5 flags
this as the gap to fill).  Here the full pipeline state — motion model,
trigger counters, ring-buffer contents, and accumulated slices — is a
checkpointable dict saved as a single .npz, so long recordings and live
pipelines survive restarts mid-stream.

The OFFLINE (batch/cold) pipeline has its own checkpoint/resume at batch
boundaries — see runtime.scan_pipeline.save_offline_checkpoint and
``compensate_recording_cold(checkpoint_path=..., resume=True)`` (the CLI's
``--cold --checkpoint PATH [--resume]``): the persisted payload there is
the scan carry (model + secant seed + window-gate history, the multihost
hand-off) plus completed batches' results, and a resumed run is
bit-identical to an uninterrupted one.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from better_flow.core.model import MotionModel
from better_flow.runtime.dvs_flow import DVSFlow, SliceRecord

_FORMAT_VERSION = 2  # v2: MotionModel gained Kahan compensation fields
_MODEL_FIELDS = list(MotionModel._fields)


def save_checkpoint(path: str, engine: DVSFlow) -> None:
    buf = engine.buffer
    snap = buf.snapshot()
    state = {
        "version": _FORMAT_VERSION,
        "event_diff": engine.event_diff,
        "time_diff": engine.time_diff,
        "last_slice_time": engine.last_slice_time,
        "current_slice_time": engine.current_slice_time,
        "frame_count": engine.frame_count,
        "buf_x": snap["x"],
        "buf_y": snap["y"],
        "buf_ts": snap["timestamp"],
        "buf_noise": snap["noise"],
        "n_slices": len(engine.slices),
    }
    for f in _MODEL_FIELDS:
        state[f"model_{f}"] = np.asarray(getattr(engine.last_model, f))
    # accumulated slices (flat, with slice boundaries)
    if engine.slices:
        for key in ("x", "y", "timestamp", "u", "v", "noise"):
            state[f"acc_{key}"] = np.concatenate(
                [np.asarray(getattr(r, key)) for r in engine.slices]
            )
        state["acc_len"] = np.array([r.n_events for r in engine.slices])
        state["acc_start"] = np.array([r.slice_start_time for r in engine.slices])
        state["acc_iters"] = np.array([r.iters for r in engine.slices])
    np.savez_compressed(path, **state)


def load_checkpoint(path: str, engine: DVSFlow) -> DVSFlow:
    """Restore state into a freshly constructed engine (same config)."""
    z = np.load(path, allow_pickle=False)
    assert int(z["version"]) == _FORMAT_VERSION
    engine.event_diff = int(z["event_diff"])
    engine.time_diff = int(z["time_diff"])
    engine.last_slice_time = int(z["last_slice_time"])
    engine.current_slice_time = int(z["current_slice_time"])
    engine.frame_count = int(z["frame_count"])
    engine.last_model = MotionModel(
        *(jnp.asarray(z[f"model_{f}"]) for f in _MODEL_FIELDS)
    )
    engine.buffer.push_batch(z["buf_x"], z["buf_y"], z["buf_ts"])
    snap = engine.buffer.snapshot()
    engine.buffer.noise[snap["index"]] = z["buf_noise"]

    engine.slices = []
    if "acc_len" in z:
        off = 0
        for i, n in enumerate(z["acc_len"]):
            n = int(n)
            sl = slice(off, off + n)
            engine.slices.append(
                SliceRecord(
                    x=z["acc_x"][sl], y=z["acc_y"][sl],
                    timestamp=z["acc_timestamp"][sl],
                    t_local=(z["acc_timestamp"][sl] - int(z["acc_start"][i])).astype(np.float32),
                    u=z["acc_u"][sl], v=z["acc_v"][sl], noise=z["acc_noise"][sl],
                    pr_x=z["acc_x"][sl], pr_y=z["acc_y"][sl],
                    model=engine.last_model, iters=int(z["acc_iters"][i]),
                    wall_s=0.0, n_events=n,
                    slice_start_time=int(z["acc_start"][i]),
                )
            )
            off += n
    return engine
