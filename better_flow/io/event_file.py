"""Event .txt readers/writers, bit-compatible with the reference format.

Format (event_file.h:34-289): whitespace-separated ``t x y p`` rows (plus
``u v`` for ground-truth files), timestamps in seconds rebased to the first
row.  Two quirks are preserved deliberately so outputs are directly
comparable with the C++ binaries:

* x/y swap on read: the file's (x, y) become (fr_y, fr_x) — i.e. our
  ``x`` (image row) is the file's ``y`` column (event_file.h:60, 162).
* the writer emits ``t  fr_y  fr_x  1  best_v  best_u`` — swapped back,
  documented in the reference at event_file.h:245.
* windowed reads drop the first event past the window start
  (event_file.h:50-53 consumes it in the skip loop).

Parsing uses pandas' C reader (the reference's iostream parsing is its file
I/O bottleneck); a native C++ parser is available via
better_flow.io.native when built.
"""

from __future__ import annotations

import io as _io
from typing import Optional

import numpy as np


def _load_columns(path_or_buf, ncols: int) -> np.ndarray:
    """Fast whitespace-table load -> float64 array [rows, ncols]."""
    try:
        import pandas as pd

        df = pd.read_csv(
            path_or_buf,
            sep=r"\s+",
            header=None,
            usecols=range(ncols),
            dtype=np.float64,
            engine="c",
            comment=None,
        )
        return df.to_numpy()
    except ImportError:  # pragma: no cover
        return np.loadtxt(path_or_buf, usecols=range(ncols), ndmin=2)


def read_events(
    path,
    max_t: Optional[float] = None,
    window_s: float = 0.1,
) -> dict:
    """EventFile::from_file (event_file.h:141-176; windowed :34-74).

    Returns dict(x, y, t_ns, polarity) with the x/y swap applied and
    timestamps rebased to the first row (FROM_SEC truncation).  With
    ``max_t`` set, keeps events in (max_t - window_s, max_t] with the
    reference's drop-first-past-threshold quirk.

    Full reads of real files go through the native C++ parser when built
    (native/bf_native.cpp); windowed reads and file-like inputs use the
    Python path.
    """
    if max_t is None and isinstance(path, (str, bytes)) or (
        max_t is None and hasattr(path, "__fspath__")
    ):
        try:
            from better_flow.io import native

            parsed = native.parse_events(path)
            if parsed is not None:
                return parsed
        except FileNotFoundError:
            raise
        except Exception:
            pass
    raw = _load_columns(path, 4)
    if raw.shape[0] == 0:
        return {
            "x": np.zeros(0),
            "y": np.zeros(0),
            "t_ns": np.zeros(0, np.int64),
            "polarity": np.zeros(0, np.int8),
        }
    t0 = raw[0, 0]
    t = raw[:, 0] - t0
    fx = raw[:, 2]  # file y -> our x (row)
    fy = raw[:, 1]  # file x -> our y (col)
    p = raw[:, 3]

    if max_t is None:
        # Full read: first row kept with t = 0 (event_file.h:154-157).
        t = t.copy()
        t[0] = 0.0
        keep = np.ones(len(t), bool)
    else:
        t_low = max_t - window_s
        past = np.nonzero(t > t_low)[0]
        keep = np.zeros(len(t), bool)
        if len(past):
            start = past[0] + 1  # the first event past t_low is dropped
            keep[start:] = t[start:] <= max_t
            beyond = np.nonzero(t[start:] > max_t)[0]
            if len(beyond):
                keep[start + beyond[0]:] = False
        # row 0 (the t_0 row) is never stored in windowed mode

    return {
        "x": fx[keep],
        "y": fy[keep],
        "t_ns": (1e9 * t[keep]).astype(np.int64),  # FROM_SEC truncation
        "polarity": p[keep].astype(np.int8),
    }


def read_events_uv(path) -> dict:
    """EventFile::from_file_uv (event_file.h:179-234).

    Ground-truth rows ``t x y p u v``.  The reference reconstructs the
    direction vector with the u/v *swapped* relative to its field names
    (nx = n_from_u(v), ny = n_from_u(u), event_file.h:206-207), verifies the
    round trip, and skips non-finite rows.  We return the flow in our (row,
    col) convention: u_row = file v, v_col = file u.
    """
    raw = _load_columns(path, 6)
    t0 = raw[0, 0]
    t = raw[:, 0] - t0
    finite = np.isfinite(raw).all(axis=1)
    return {
        "x": raw[finite, 2],
        "y": raw[finite, 1],
        "t_ns": (1e9 * t[finite]).astype(np.int64),
        "polarity": raw[finite, 3].astype(np.int8),
        "u": raw[finite, 5],  # file v -> flow along our x (rows)
        "v": raw[finite, 4],  # file u -> flow along our y (cols)
    }


def write_events_uv(path, x, y, t_ns, u, v, maxt: float = 0.0) -> int:
    """EventFile::to_file_uv (event_file.h:238-289).

    Emits ``t  y  x  1  v  u`` at 9-decimal fixed precision with the
    documented swap (comment at event_file.h:245), t in seconds (+maxt).
    Returns number of rows written.  Uses the native C++ writer when built.
    """
    if isinstance(path, (str, bytes)) or hasattr(path, "__fspath__"):
        try:
            from better_flow.io import native

            n = native.write_events_uv(path, x, y, t_ns, u, v, maxt)
            if n is not None:
                return n
        except Exception:
            pass
    x = np.asarray(x)
    y = np.asarray(y)
    t_s = np.asarray(t_ns, np.float64) / 1e9 + maxt
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    buf = _io.StringIO()
    for i in range(len(x)):
        buf.write(
            f"{t_s[i]:.9f} {int(y[i])} {int(x[i])} 1 {v[i]:.9f} {u[i]:.9f}\n"
        )
    data = buf.getvalue()
    if hasattr(path, "write"):
        path.write(data)
    else:
        with open(path, "w") as f:
            f.write(data)
    return len(x)


def write_events(path, x, y, t_ns, polarity=None) -> int:
    """Write a plain ``t x y p`` recording (the reference's input format),
    applying the inverse coordinate swap so the file round-trips through
    read_events."""
    x = np.asarray(x)
    y = np.asarray(y)
    t_s = np.asarray(t_ns, np.float64) / 1e9
    if polarity is None:
        polarity = np.zeros(len(x), np.int8)
    lines = [
        f"{t_s[i]:.9f} {int(y[i])} {int(x[i])} {int(polarity[i])}\n"
        for i in range(len(x))
    ]
    data = "".join(lines)
    if hasattr(path, "write"):
        path.write(data)
    else:
        with open(path, "w") as f:
            f.write(data)
    return len(x)
