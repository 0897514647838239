"""Event file I/O: format quirks, round trips, windowed reads."""

import io

import numpy as np
import pytest

from better_flow.config import NZ, UV_FACTOR
from better_flow.io.event_file import (
    read_events,
    read_events_uv,
    write_events,
    write_events_uv,
)


def test_xy_swap_roundtrip(tmp_path):
    """write_events applies the inverse swap so read_events round-trips."""
    p = str(tmp_path / "r.txt")
    x = np.array([3.0, 10.0])  # our x = image row
    y = np.array([7.0, 20.0])
    t = np.array([0, 1_000_000], np.int64)
    write_events(p, x, y, t, [1, 0])
    # on disk the file columns are t, file-x (= our y), file-y (= our x)
    cols = open(p).readline().split()
    assert cols[1] == "7" and cols[2] == "3"
    r = read_events(p)
    np.testing.assert_array_equal(r["x"], x)
    np.testing.assert_array_equal(r["y"], y)
    np.testing.assert_array_equal(r["t_ns"], t)


def test_rebase_first_row_zero(tmp_path):
    """Full reads rebase to the first row, which keeps t=0
    (event_file.h:154-157)."""
    p = str(tmp_path / "r.txt")
    with open(p, "w") as f:
        f.write("5.5 1 2 0\n5.6 3 4 1\n5.7 5 6 0\n")
    r = read_events(p)
    np.testing.assert_allclose(r["t_ns"], [0, int(0.1e9), int(0.2e9)], atol=200)


def test_windowed_read_drops_first_past_threshold(tmp_path):
    """The windowed reader consumes-and-drops the first event past
    max_t - window (event_file.h:50-53) and never stores the t0 row."""
    p = str(tmp_path / "r.txt")
    ts = [0.0, 0.05, 0.11, 0.12, 0.19, 0.25]
    with open(p, "w") as f:
        for i, t in enumerate(ts):
            f.write(f"{t} {i} {i} 0\n")
    # maxt=0.2, window 0.1 -> t_low=0.1; rows with t>0.1: 0.11 (dropped),
    # then 0.12, 0.19 kept; 0.25 > maxt stops
    r = read_events(p, max_t=0.2, window_s=0.1)
    np.testing.assert_allclose(r["t_ns"] / 1e9, [0.12, 0.19], atol=1e-6)


def test_uv_writer_format_and_swap(tmp_path):
    p = str(tmp_path / "o.txt")
    write_events_uv(p, [3.0], [7.0], [1_500_000_000], [1.25], [-2.5])
    line = open(p).readline().strip()
    # t  y  x  1  v  u  at 9 decimals (event_file.h:245-248)
    assert line == "1.500000000 7 3 1 -2.500000000 1.250000000"


def test_uv_reader_roundtrip(tmp_path):
    """read_events_uv inverts to_file_uv including the u/v swap."""
    p = str(tmp_path / "o.txt")
    x = np.array([3.0, 9.0])
    y = np.array([7.0, 11.0])
    t = np.array([0, 2_000_000], np.int64)
    u = np.array([12.5, -3.0])
    v = np.array([-8.0, 4.5])
    write_events_uv(p, x, y, t, u, v)
    r = read_events_uv(p)
    np.testing.assert_array_equal(r["x"], x)
    np.testing.assert_array_equal(r["y"], y)
    np.testing.assert_allclose(r["u"], u, atol=1e-6)
    np.testing.assert_allclose(r["v"], v, atol=1e-6)


def test_uv_reader_skips_nonfinite(tmp_path):
    p = str(tmp_path / "o.txt")
    with open(p, "w") as f:
        f.write("0.0 1 2 1 0.5 0.5\n")
        f.write("0.1 3 4 1 nan 0.5\n")
        f.write("0.2 5 6 1 0.5 0.5\n")
    r = read_events_uv(p)
    assert len(r["x"]) == 2


def test_stringio_input():
    buf = io.StringIO("0.0 1 2 0\n0.5 3 4 1\n")
    r = read_events(buf)
    assert len(r["x"]) == 2
    np.testing.assert_array_equal(r["y"], [1.0, 3.0])
