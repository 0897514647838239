"""Host-side ring buffer with count + time-span eviction.

Reference: CircularArray<Event, MAX_SZ, SPAN> (datastructures.h:6-115) — a
fixed-capacity ring where push_back overwrites the oldest entry (:31-44) and
``fix_span`` lazily shrinks the live window so latest - oldest <= SPAN
(:46-59).  Here it is a preallocated numpy SoA (the device never sees the
ring; slices are materialized as padded tensors).  A C++ backend with the
same layout is available via better_flow.io.native when built.
"""

from __future__ import annotations

import numpy as np


class EventRingBuffer:
    def __init__(self, capacity: int, span_ns: int):
        self.capacity = int(capacity)
        self.span_ns = int(span_ns)
        self.x = np.zeros(capacity, np.float32)
        self.y = np.zeros(capacity, np.float32)
        self.timestamp = np.zeros(capacity, np.int64)
        self.noise = np.zeros(capacity, bool)
        self.u = np.zeros(capacity, np.float32)
        self.v = np.zeros(capacity, np.float32)
        self.pr_x = np.zeros(capacity, np.float32)
        self.pr_y = np.zeros(capacity, np.float32)
        self._head = -1      # index of newest element
        self._size = 0       # live element count (after span fix)

    def __len__(self) -> int:
        self.fix_span()
        return self._size

    @property
    def is_full(self) -> bool:
        return len(self) == self.capacity

    def push(self, x: float, y: float, timestamp: int) -> None:
        """push_back (datastructures.h:31-44): overwrite oldest when full."""
        self._head = (self._head + 1) % self.capacity
        i = self._head
        self.x[i] = x
        self.y[i] = y
        self.timestamp[i] = timestamp
        self.noise[i] = False
        self.u[i] = self.v[i] = 0.0
        self.pr_x[i] = x
        self.pr_y[i] = y
        self._size = min(self._size + 1, self.capacity)

    def push_batch(self, x, y, timestamp) -> None:
        """Vectorized push of a chronologically sorted batch."""
        n = len(x)
        if n == 0:
            return
        if n >= self.capacity:
            # Only the newest ``capacity`` events survive.
            x, y, timestamp = (
                x[-self.capacity:], y[-self.capacity:], timestamp[-self.capacity:],
            )
            n = self.capacity
        idx = (self._head + 1 + np.arange(n)) % self.capacity
        self.x[idx] = x
        self.y[idx] = y
        self.timestamp[idx] = timestamp
        self.noise[idx] = False
        self.u[idx] = self.v[idx] = 0.0
        self.pr_x[idx] = x
        self.pr_y[idx] = y
        self._head = int(idx[-1])
        self._size = min(self._size + n, self.capacity)

    def fix_span(self) -> None:
        """Drop the oldest events until latest - oldest <= span
        (datastructures.h:46-59).  Timestamps are nondecreasing, so this is
        'keep events with latest - ts <= span'."""
        if self._size == 0:
            return
        latest = self.timestamp[self._head]
        idx = self._live_indices()
        ts = self.timestamp[idx]
        # number of leading (oldest) entries violating the span
        keep_from = np.searchsorted(ts, latest - self.span_ns, side="left")
        # C++ condition is (latest - tail) > SPAN -> evict; keep when
        # latest - ts <= SPAN i.e. ts >= latest - SPAN.
        self._size -= int(keep_from)

    def _live_indices(self) -> np.ndarray:
        """Indices oldest -> newest of the live window (no span fix)."""
        start = (self._head - self._size + 1) % self.capacity
        return (start + np.arange(self._size)) % self.capacity

    def snapshot(self):
        """Live events, oldest -> newest, as a dict of array views + the ring
        indices (for writing back noise/flow after processing)."""
        self.fix_span()
        idx = self._live_indices()
        return {
            "index": idx,
            "x": self.x[idx],
            "y": self.y[idx],
            "timestamp": self.timestamp[idx],
            "noise": self.noise[idx],
        }

    def writeback(self, idx, noise=None, u=None, v=None, pr_x=None, pr_y=None):
        """Store per-event results back into the ring (the reference mutates
        events in place through LinearEventPtrs, dvs_flow.h:196-198)."""
        if noise is not None:
            self.noise[idx] = noise
        if u is not None:
            self.u[idx] = u
        if v is not None:
            self.v[idx] = v
        if pr_x is not None:
            self.pr_x[idx] = pr_x
        if pr_y is not None:
            self.pr_y[idx] = pr_y

    def oldest_timestamp(self) -> int:
        idx = (self._head - self._size + 1) % self.capacity
        return int(self.timestamp[idx])

    def newest_timestamp(self) -> int:
        return int(self.timestamp[self._head]) if self._size else 0
