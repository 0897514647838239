"""Spatially tiled slice processing: image tiles + halo exchange.

For megapixel sensors (BASELINE.json config 5) the image plane is sharded
over a 2-D mesh ('tile_x', 'tile_y').  Each device owns a tile of the
scaled image plus a halo ring, and the events whose *original* pixels fall
in its tile.  One optimizer iteration:

1. warp local events (the shared model is replicated, so the warp needs no
   communication);
2. scatter their single-pixel centres into the local (tile + 2*halo)^2
   accumulator — a warped event may land in the halo, i.e. in a
   neighbour's territory;
3. halo exchange, phase 1 (fold-in): two ``lax.ppermute`` phases (x then y,
   so corners ride through) ADD each device's halo strips into the
   neighbours that own those pixels — the deterministic reconciliation of
   cross-tile splats the north star mandates;
4. halo exchange, phase 2 (broadcast-back): completed edge strips of width
   1 + scale//2 are copied back into neighbours' halos so the local box
   filter + masked Scharr read exact values across tile seams; then the
   image-space ops run tile-locally;
5. partial model reductions over the owned tile only, combined with one
   ``psum`` over both mesh axes (ops.reductions.model_compute_partial);
6. every device updates the identical model and re-warps its events.

Events whose warped centre drifts beyond the halo ring (they would land
deeper inside a neighbour's tile) are reconciled EXACTLY through a
fixed-capacity **escape lane**: each device compacts its escapees (prefix-
sum ranking, no sort) into an (esc_cap, 3) buffer, one small ``all_gather``
ships every device's buffer everywhere, and each device scatter-adds the
gathered events that fall inside its owned region — so any displacement is
supported, not just <= halo.  The lane is sized by ``esc_cap``; if a device
ever overflows it (escapes are empty in steady state — the halo covers
typical per-slice drift) the dropped count is reported in
``TiledSliceResult.escaped_dropped`` so callers can resize.  ``halo``
therefore tunes bandwidth, not correctness.

The optimizer schedule is the reference's adaptive divider loop
(optimizer_rolling.h:60-111) running replicated — every device sees
identical psum'd reductions, so the data-dependent iteration count is
identical everywhere and the collective schedule inside the while_loop body
stays static.  Pass ``n_iters`` to force a fixed count instead (the
low-latency megapixel preset; bf_visualizer.cpp:102-104 fixes max_iter=10).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from better_flow.config import NONZERO_EPS, OptimizerConfig, SensorConfig
from better_flow.core.model import MotionModel
from better_flow.ops.gradient import masked_scharr
from better_flow.ops.reductions import model_compute_partial, model_from_partials
from better_flow.ops.time_image import box_filter
from better_flow.ops.warp import compute_uv, project_4param_reinit

AX_X, AX_Y = "tile_x", "tile_y"

# jitted recording-scan programs keyed on (cfg, mesh, halo, esc_cap,
# hist_k) — see compensate_recording_tiled.
_TILED_SCAN_CACHE: dict = {}




def _halo_exchange_add(img: jnp.ndarray, halo: int, axis: int, axis_name: str):
    """Add this device's halo strips into the neighbours along one axis.

    ``img`` is (T+2h, ...) along ``axis``.  The low strip [0:h] belongs to
    the left neighbour's high interior; the high strip [-h:] to the right
    neighbour's low interior.  After the exchange the local interior
    contains every contribution whose centre landed within h of the owned
    region.  Edge tiles wrap (the mesh is a torus for ppermute); wrapped
    contributions land in the off-sensor border of the neighbour and are
    zero by the scatter bounds check, so torus wrap is harmless.
    """
    n = lax.axis_size(axis_name)
    if n == 1:
        return img
    idx = lax.axis_index(axis_name)
    h = halo

    def take(sl):
        return lax.slice_in_dim(img, *sl, axis=axis)

    T = img.shape[axis] - 2 * h
    lo_strip = take((0, h))            # goes to left neighbour
    hi_strip = take((T + h, T + 2 * h))  # goes to right neighbour
    right = [(i, (i + 1) % n) for i in range(n)]
    left = [(i, (i - 1) % n) for i in range(n)]
    from_left = lax.ppermute(hi_strip, axis_name, right)   # left nb's hi strip
    from_right = lax.ppermute(lo_strip, axis_name, left)   # right nb's lo strip
    # Torus wrap would deliver the opposite sensor edge to boundary tiles;
    # those global rows do not exist, so zero the wrapped strips.
    from_left = jnp.where(idx == 0, 0.0, from_left)
    from_right = jnp.where(idx == n - 1, 0.0, from_right)
    # left neighbour's hi strip covers our interior rows [h, 2h);
    # right neighbour's lo strip covers [T, T+h).
    out = img
    interior_lo = lax.slice_in_dim(out, h, 2 * h, axis=axis) + from_left
    out = _set_slice(out, interior_lo, h, axis)
    interior_hi = lax.slice_in_dim(out, T, T + h, axis=axis) + from_right
    out = _set_slice(out, interior_hi, T, axis)
    return out


def _halo_broadcast(img: jnp.ndarray, halo: int, g: int, axis: int, axis_name: str):
    """After fold-in, copy each neighbour's *complete* edge interior (width
    ``g``) back into this device's halo so local stencils see correct
    values: my halo rows [h-g, h) get the left neighbour's rows
    [T+h-g, T+h); rows [T+h, T+h+g) get the right neighbour's [h, h+g).
    Sensor-boundary tiles keep zeros (there is nothing beyond the image).
    """
    n = lax.axis_size(axis_name)
    if n == 1:
        return img
    idx = lax.axis_index(axis_name)
    h = halo
    T = img.shape[axis] - 2 * h
    bottom = lax.slice_in_dim(img, T + h - g, T + h, axis=axis)  # my complete bottom
    top = lax.slice_in_dim(img, h, h + g, axis=axis)             # my complete top
    right = [(i, (i + 1) % n) for i in range(n)]
    left = [(i, (i - 1) % n) for i in range(n)]
    from_left = lax.ppermute(bottom, axis_name, right)
    from_right = lax.ppermute(top, axis_name, left)
    from_left = jnp.where(idx == 0, 0.0, from_left)
    from_right = jnp.where(idx == n - 1, 0.0, from_right)
    out = _set_slice(img, from_left, h - g, axis)
    out = _set_slice(out, from_right, T + h, axis)
    return out


def _set_slice(arr, val, start, axis):
    idx = [0] * arr.ndim
    idx[axis] = start
    return lax.dynamic_update_slice(arr, val, tuple(idx))


class TiledSliceResult(NamedTuple):
    model: MotionModel
    pr_x: jnp.ndarray
    pr_y: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    iters: jnp.ndarray
    # max over iterations of events dropped from the escape lane (psum'd;
    # 0 = the tiled result is exact).  Resize esc_cap if ever nonzero.
    escaped_dropped: jnp.ndarray


def _escape_lane(gx, gy, t, escaped, esc_cap: int):
    """Compact escaped events into an (esc_cap,) SoA buffer by prefix-sum
    rank (no sort), all_gather every device's buffer, and return the
    gathered (gx, gy, t, n_dropped).  Empty slots carry gx = -1."""
    rank = jnp.cumsum(escaped.astype(jnp.int32)) - 1
    pos = jnp.where(escaped, rank, esc_cap)
    buf_x = jnp.full((esc_cap,), -1, jnp.int32).at[pos].set(
        jnp.where(escaped, gx, -1), mode="drop")
    buf_y = jnp.zeros((esc_cap,), jnp.int32).at[pos].set(gy, mode="drop")
    buf_t = jnp.zeros((esc_cap,), jnp.float32).at[pos].set(t, mode="drop")
    n_esc = jnp.sum(escaped.astype(jnp.int32))
    dropped = jnp.maximum(n_esc - esc_cap, 0)
    gather = lambda b: lax.all_gather(b, (AX_X, AX_Y), axis=0, tiled=True)
    return gather(buf_x), gather(buf_y), gather(buf_t), lax.psum(
        dropped, (AX_X, AX_Y))


def _tiled_iteration(
    state, x, y, t, active, model, dividers, scale: int,
    tile_h: int, tile_w: int, halo: int, img_h: int, img_w: int,
    esc_cap: int, geom=None, update_fn=None,
):
    """One optimizer iteration on a tiled image (see module docstring).

    ``geom`` (x_shift, y_shift, w_dyn, h_dyn — a SliceGeometry or tuple)
    applies the untiled path's dynamic bbox-window shift and rejection
    bounds (optimizer_rolling.h:279-283); None keeps the whole-sensor
    window (zero shift) of the single-slice megapixel demo.  ``update_fn``
    replaces update_accumulators for the fast schedule (see
    models.global_flow._drive_loop)."""
    pr_x, pr_y = state
    x_div, y_div, rot_div, div_div = dividers
    ti = lax.axis_index(AX_X)
    tj = lax.axis_index(AX_Y)
    # Global scaled-image offsets of this tile's owned region.
    row0 = ti * tile_h
    col0 = tj * tile_w
    H = tile_h + 2 * halo
    W = tile_w + 2 * halo

    # Scatter local events' centres into the padded local image.
    half = scale // 2
    if geom is None:
        x_sh = jnp.float32(half)
        y_sh = jnp.float32(half)
        fx = pr_x * scale + x_sh
        fy = pr_y * scale + y_sh
        gx = fx.astype(jnp.int32)
        gy = fy.astype(jnp.int32)
        # Acceptance uses the TRUE scaled-sensor extent (res*scale),
        # matching the untiled path regardless of tile rounding.
        inb = (active & (gx >= half) & (gx < img_h - half)
               & (gy >= half) & (gy < img_w - half))
    else:
        x_sh, y_sh, wd, hd = geom[0], geom[1], geom[2], geom[3]
        fx = pr_x * scale + x_sh
        fy = pr_y * scale + y_sh
        gx = fx.astype(jnp.int32)   # trunc toward zero, like the C++ cast
        gy = fy.astype(jnp.int32)
        # The untiled kernel's acceptance (ops/time_image, fused kernels):
        # half <= g < w_dyn + half in the shifted window frame.
        inb = (
            active
            & (gx >= half) & (gx.astype(jnp.float32) < wd + half)
            & (gy >= half) & (gy.astype(jnp.float32) < hd + half)
        )
    lx = gx - row0 + halo
    ly = gy - col0 + halo
    in_halo = (lx >= 0) & (lx < H) & (ly >= 0) & (ly < W)
    ok = inb & in_halo
    lin = jnp.where(ok, lx * W + ly, H * W)
    tsum = jnp.zeros((H * W,), jnp.float32).at[lin].add(
        t / 1e9, mode="drop").reshape(H, W)
    cnt = jnp.zeros((H * W,), jnp.float32).at[lin].add(
        1.0, mode="drop").reshape(H, W)

    # Reconcile cross-tile splats: exchange+add halos (x then y; corners
    # ride through because the y-phase exchanges already-merged x strips).
    tsum = _halo_exchange_add(tsum, halo, 0, AX_X)
    tsum = _halo_exchange_add(tsum, halo, 1, AX_Y)
    cnt = _halo_exchange_add(cnt, halo, 0, AX_X)
    cnt = _halo_exchange_add(cnt, halo, 1, AX_Y)

    # Exact reconciliation of BEYOND-halo drifts: ship escaped events
    # through the fixed-capacity escape lane and add the ones whose global
    # pixel falls in this device's owned region (before broadcast-back, so
    # completed edge strips include them).
    escaped = inb & ~in_halo
    # The lane's compaction scatter, all_gather and image scatter-add
    # cost time every iteration even when EMPTY (escapes are empty in
    # steady state — the halo covers typical drift), so the whole lane
    # runs under a cond gated on a REPLICATED
    # any-escaped flag (psum over both mesh axes keeps the branch
    # decision uniform, so the collective inside the taken branch stays
    # SPMD-safe).
    any_esc = lax.psum(jnp.sum(escaped.astype(jnp.int32)),
                       (AX_X, AX_Y)) > 0

    def _lane(args):
        tsum, cnt = args
        eg_x, eg_y, eg_t, dropped = _escape_lane(gx, gy, t, escaped,
                                                 esc_cap)
        own = (
            (eg_x >= row0) & (eg_x < row0 + tile_h)
            & (eg_y >= col0) & (eg_y < col0 + tile_w)
        )
        elx = eg_x - row0 + halo
        ely = eg_y - col0 + halo
        elin = jnp.where(own, elx * W + ely, H * W)
        tsum = tsum.reshape(-1).at[elin].add(
            jnp.where(own, eg_t / 1e9, 0.0), mode="drop").reshape(H, W)
        cnt = cnt.reshape(-1).at[elin].add(
            own.astype(jnp.float32), mode="drop").reshape(H, W)
        return tsum, cnt, dropped

    tsum, cnt, dropped = lax.cond(
        any_esc, _lane, lambda a: (a[0], a[1], jnp.int32(0)),
        (tsum, cnt))

    # Broadcast completed edge strips back so the box filter and Scharr at
    # tile edges read correct neighbour values (width: 1 for the Scharr ring
    # + scale//2 for the box support).
    g = 1 + half
    tsum = _halo_broadcast(tsum, halo, g, 0, AX_X)
    tsum = _halo_broadcast(tsum, halo, g, 1, AX_Y)
    cnt = _halo_broadcast(cnt, halo, g, 0, AX_X)
    cnt = _halo_broadcast(cnt, halo, g, 1, AX_Y)

    tsum = box_filter(tsum, scale)
    cnt_f = box_filter(cnt, scale)
    img = jnp.where(cnt_f >= 1, tsum / jnp.maximum(cnt_f, 1), 0.0)

    # Local stencil; only the owned region feeds the reductions.
    gxg, gyg = masked_scharr(img)
    own = jnp.zeros((H, W), bool).at[
        halo : halo + tile_h, halo : halo + tile_w].set(True)
    img_own = jnp.where(own, img, 0.0)
    gx_own = jnp.where(own, gxg, 0.0)
    gy_own = jnp.where(own, gyg, 0.0)
    p = model_compute_partial(img_own, gx_own, gy_own)
    # Shift row/col-weighted partials into global coordinates:
    off_r = jnp.float32(row0 - halo)
    off_c = jnp.float32(col0 - halo)
    p = dict(p)
    p["s_rg"] = p["s_rg"] + off_r * p["s_gy"] - off_c * p["s_gx"]
    p["s_dg"] = p["s_dg"] + off_r * p["s_gx"] + off_c * p["s_gy"]
    p["s_row"] = p["s_row"] + off_r * p["cnt"]
    p["s_col"] = p["s_col"] + off_c * p["cnt"]
    p = jax.tree_util.tree_map(lambda v: lax.psum(v, (AX_X, AX_Y)), p)
    cx_img, cy_img, terms = model_from_partials(p)

    model = model._replace(
        cx=cx_img, cy=cy_img, dx=terms.dx, dy=terms.dy,
        rot=terms.rot, div=terms.div, cnt=terms.cnt,
    )
    if update_fn is None:
        model = model.update_accumulators(rot_div, div_div, x_div, y_div)
    else:
        model = update_fn(model)
    cx_ev = (model.cx - x_sh) / scale
    cy_ev = (model.cy - y_sh) / scale
    pr_x, pr_y, nx, ny = project_4param_reinit(
        x, y, t, pr_x, pr_y,
        -model.total_dx, -model.total_dy, cx_ev, cy_ev,
        model.total_div, -model.total_rot,
    )
    model = model._replace(cx=cx_ev, cy=cy_ev)
    return (pr_x, pr_y), nx, ny, model, dropped


class TiledFlowState(NamedTuple):
    """Loop carry of the tiled optimizer.  Field names match
    models.global_flow.GlobalFlowState so _adaptive_loop drives it
    unchanged (duck-typed via _replace/attribute access); ``esc`` rides
    along as the worst per-iteration escape-lane overflow."""

    pr_x: jnp.ndarray
    pr_y: jnp.ndarray
    nx: jnp.ndarray
    ny: jnp.ndarray
    model: MotionModel
    x_div: jnp.ndarray
    y_div: jnp.ndarray
    rot_div: jnp.ndarray
    div_div: jnp.ndarray
    iters: jnp.ndarray
    esc: jnp.ndarray


def process_slice_tiled(
    x, y, t, active, init_model: MotionModel, cfg: OptimizerConfig,
    sensor: SensorConfig, mesh: Mesh, halo: int = 32, n_iters: int = None,
    esc_cap: int = 4096,
) -> TiledSliceResult:
    """Run the 4-param optimizer with a tiled image over mesh
    ('tile_x', 'tile_y').  Event arrays are sharded over AX_X (pre-bucketed
    per tile by the caller via bucket_events); the model is replicated.

    By default runs the reference's ADAPTIVE divider schedule
    (optimizer_rolling.h:60-111) as a while_loop with replicated decisions
    — every device sees identical psum'd reductions, so the data-dependent
    iteration count is identical everywhere.  Pass ``n_iters`` for a fixed
    count instead (static collective schedule; the low-latency megapixel
    regime, mirroring the live preset's max_iter=10,
    bf_visualizer.cpp:102-104).

    ``esc_cap`` sizes the per-device escape lane for beyond-halo drifts
    (module docstring); TiledSliceResult.escaped_dropped reports overflow
    (0 = exact).
    """
    from better_flow.models.global_flow import _adaptive_loop

    scale = cfg.scale
    n_x = mesh.shape[AX_X]
    n_y = mesh.shape[AX_Y]
    img_h = sensor.res_x * scale + scale
    img_w = sensor.res_y * scale + scale
    tile_h = -(-img_h // n_x)
    tile_w = -(-img_w // n_y)
    # The halo exchange is neighbor-only (one ppermute per direction), so a
    # halo wider than the tile would need multi-hop folds — and the caller's
    # bucketing (bucket_events_2d) assigns home tiles by the UNclamped tile
    # size, so silently growing tiles here would disagree with it and push
    # most events through the escape lane.  Refuse instead.
    if tile_h < halo or tile_w < halo:
        raise ValueError(
            f"halo {halo} exceeds the natural tile size "
            f"({tile_h}x{tile_w} for a {img_h}x{img_w} image over a "
            f"{n_x}x{n_y} mesh); use fewer tiles or a smaller halo"
        )

    def local_fn(x, y, t, active, model):
        def step(s: TiledFlowState) -> TiledFlowState:
            pr2, nx, ny, model2, dropped = _tiled_iteration(
                (s.pr_x, s.pr_y), x, y, t, active, s.model,
                (s.x_div, s.y_div, s.rot_div, s.div_div),
                scale, tile_h, tile_w, halo, img_h, img_w, esc_cap,
            )
            return s._replace(
                pr_x=pr2[0], pr_y=pr2[1], nx=nx, ny=ny, model=model2,
                iters=s.iters + 1, esc=jnp.maximum(s.esc, dropped),
            )

        init = TiledFlowState(
            pr_x=x, pr_y=y, nx=jnp.zeros_like(x), ny=jnp.zeros_like(x),
            model=model,
            x_div=jnp.float32(cfg.init_xy_divider),
            y_div=jnp.float32(cfg.init_xy_divider),
            rot_div=jnp.float32(cfg.init_rotdiv_divider),
            div_div=jnp.float32(cfg.init_rotdiv_divider),
            iters=jnp.int32(0), esc=jnp.int32(0),
        )
        if n_iters is None:
            # Reference adaptive schedule (replicated decisions): reuse the
            # untiled driver — sign-flip divider doubling, dual gates.
            final = _adaptive_loop(init, step, cfg)
        else:
            # Zero the warm model's per-iteration deltas so the first fixed
            # step never doubles a divider against stale values.
            init = init._replace(model=init.model._replace(
                dx=jnp.float32(0), dy=jnp.float32(0),
                rot=jnp.float32(0), div=jnp.float32(0)))

            def body(carry, _):
                s = step(carry)
                old = (carry.model.dx, carry.model.dy,
                       carry.model.rot, carry.model.div)
                m = s.model
                return s._replace(
                    x_div=jnp.where(m.dx * old[0] < 0, s.x_div * 2, s.x_div),
                    y_div=jnp.where(m.dy * old[1] < 0, s.y_div * 2, s.y_div),
                    rot_div=jnp.where(m.rot * old[2] < 0,
                                      s.rot_div * 2, s.rot_div),
                    div_div=jnp.where(m.div * old[3] < 0,
                                      s.div_div * 2, s.div_div),
                ), None

            final, _ = lax.scan(body, init, None, length=n_iters)
        u, v = compute_uv(final.nx, final.ny)
        return TiledSliceResult(
            model=final.model, pr_x=final.pr_x, pr_y=final.pr_y, u=u, v=v,
            iters=final.iters, escaped_dropped=final.esc,
        )

    # Events are sharded over BOTH tile axes (device-major order produced
    # by bucket_events / bucket_events_2d): each device owns the events
    # whose ORIGINAL pixel falls in its tile, so only true warp drift uses
    # the escape lane.
    ev_spec = P((AX_X, AX_Y))
    model_spec = jax.tree_util.tree_map(lambda _: P(), init_model)
    out_spec = TiledSliceResult(
        model=model_spec, pr_x=ev_spec, pr_y=ev_spec,
        u=ev_spec, v=ev_spec, iters=P(), escaped_dropped=P(),
    )
    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(ev_spec, ev_spec, ev_spec, ev_spec, model_spec),
        out_specs=out_spec,
        check_vma=False,
    )
    return fn(x, y, t, active, init_model)


def bucket_events(x, y, t, res_x: int, scale: int, n_tiles_x: int, cap_per_tile: int):
    """Host-side bucketing of events by home tile row (1-D row meshes):
    returns [n_tiles_x * cap] arrays ordered tile-major with validity."""
    return bucket_events_2d(x, y, t, res_x, 0, scale, n_tiles_x, 1,
                            cap_per_tile)


def bucket_events_2d(x, y, t, res_x: int, res_y: int, scale: int,
                     n_tx: int, n_ty: int, cap_per_tile: int,
                     on_overflow: str = "raise", idx=None):
    """Host-side bucketing by home tile (tx, ty) for a 2-D tile mesh:
    returns (xs, ys, ts, ok[, idx_out]) as [n_tx * n_ty * cap] arrays in
    device-major order (tx-major, ty-minor — the flattened order of mesh
    axes (AX_X, AX_Y)), so sharding the arrays with P((AX_X, AX_Y)) hands
    each device exactly the events whose ORIGINAL pixel falls in its tile.

    Tile overflow is never silent: with ``on_overflow="raise"`` (default)
    a too-small ``cap_per_tile`` raises with the required capacity; pass
    ``cap_per_tile=None`` to auto-size to the fullest tile.  ``idx``
    (optional per-event original indices) is bucketed alongside and
    returned as a 5th array (-1 in padding slots) — what recording
    pipelines need for first-slice-wins accumulation."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    t = np.asarray(t, np.float32)
    img_h = res_x * scale + scale
    tile_h = -(-img_h // n_tx)
    home_x = np.minimum((x * scale).astype(np.int64) // tile_h, n_tx - 1)
    if n_ty > 1:
        img_w = res_y * scale + scale
        tile_w = -(-img_w // n_ty)
        home_y = np.minimum((y * scale).astype(np.int64) // tile_w, n_ty - 1)
    else:
        home_y = np.zeros(len(x), np.int64)
    home = home_x * n_ty + home_y
    n_tiles = n_tx * n_ty
    counts = np.bincount(home, minlength=n_tiles)
    need = int(counts.max()) if len(x) else 0
    if cap_per_tile is None:
        cap_per_tile = max(need, 1)
    elif need > cap_per_tile:
        if on_overflow == "raise":
            raise ValueError(
                f"tile overflow: fullest tile holds {need} events > "
                f"cap_per_tile {cap_per_tile}; pass cap_per_tile=None to "
                f"auto-size"
            )
    xs = np.zeros(n_tiles * cap_per_tile, np.float32)
    ys = np.zeros_like(xs)
    ts = np.zeros_like(xs)
    ok = np.zeros(n_tiles * cap_per_tile, bool)
    idx_out = np.full(n_tiles * cap_per_tile, -1, np.int32)
    for tile in range(n_tiles):
        sel = np.nonzero(home == tile)[0][:cap_per_tile]
        # Spatial (x, y) order within the bucket, so that neighbouring
        # events splat into neighbouring pixels.  Order never leaks: every
        # per-event consumer maps through idx.
        if len(sel):
            sel = sel[np.lexsort((y[sel], x[sel]))]
        base = tile * cap_per_tile
        xs[base : base + len(sel)] = x[sel]
        ys[base : base + len(sel)] = y[sel]
        ts[base : base + len(sel)] = t[sel]
        ok[base : base + len(sel)] = True
        if idx is not None:
            idx_out[base : base + len(sel)] = np.asarray(idx)[sel]
    if idx is not None:
        return xs, ys, ts, ok, idx_out
    return xs, ys, ts, ok


# --------------------------------------------------------------------------
# Recording-level tiled pipeline (BASELINE.json config 5: megapixel stream
# spatially tiled across a device mesh).  Same slice semantics as the untiled
# scan (runtime/scan_pipeline): trigger plan, bbox-window geometry, the
# window/min-event gates, warm-start model carry, secant seed carry and the
# scalar noise history — but each slice's image lives tiled over the
# ('tile_x', 'tile_y') mesh with halo exchange + the exact escape lane.

def prepare_recording_tiled(x, y, t_ns, cfg, n_tx: int, n_ty: int,
                            cap_per_tile=None):
    """Host staging: trigger plan + per-slice per-tile bucketed slabs.

    Auto-sizes ``cap_per_tile`` to the fullest (slice, tile) bucket when
    None — bucketing never drops events (bucket_events_2d raises on
    overflow otherwise).  Returns device-ready [S, NT*cap] slabs plus the
    original-index matrix for first-slice-wins accumulation.  (This is a
    numpy loop per slice — the tiled pipeline's staging is not on the
    cold-throughput path; the native counting sort covers the untiled
    scan.)"""
    import time as _time

    from better_flow.runtime.scan_pipeline import host_bbox, plan_slices

    t0 = _time.perf_counter()
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    t_ns = np.ascontiguousarray(t_ns, np.int64)
    plan = plan_slices(t_ns, cfg)
    S = len(plan.ends)
    scale = cfg.optimizer.scale
    bbox, nval = host_bbox(x, y, plan)

    # Two passes: size the cap exactly, then fill.
    slabs = []
    if cap_per_tile is None:
        need = 1
        for s in range(S):
            a, b = int(plan.starts[s]), int(plan.ends[s]) + 1
            img_h = cfg.sensor.res_x * scale + scale
            tile_h = -(-img_h // n_tx)
            hx = np.minimum((x[a:b] * scale).astype(np.int64) // tile_h,
                            n_tx - 1)
            if n_ty > 1:
                img_w = cfg.sensor.res_y * scale + scale
                tile_w = -(-img_w // n_ty)
                hy = np.minimum((y[a:b] * scale).astype(np.int64) // tile_w,
                                n_ty - 1)
            else:
                hy = np.zeros(b - a, np.int64)
            c = np.bincount(hx * n_ty + hy, minlength=n_tx * n_ty)
            need = max(need, int(c.max()))
        cap_per_tile = -(-need // 8) * 8
    for s in range(S):
        a, b = int(plan.starts[s]), int(plan.ends[s]) + 1
        ts_local = (t_ns[a:b] - plan.slice_start_ns[s]).astype(np.float32)
        slabs.append(bucket_events_2d(
            x[a:b], y[a:b], ts_local, cfg.sensor.res_x, cfg.sensor.res_y,
            scale, n_tx, n_ty, cap_per_tile,
            idx=np.arange(a, b, dtype=np.int32),
        ))
    xb = np.stack([s_[0] for s_ in slabs])
    yb = np.stack([s_[1] for s_ in slabs])
    tb = np.stack([s_[2] for s_ in slabs])
    idx = np.stack([s_[4] for s_ in slabs])
    first_overlap = np.searchsorted(plan.ends, plan.starts)
    hist_k = max(1, int(np.max(np.arange(S) - first_overlap, initial=1)))
    return {
        "plan": plan, "n": len(x), "idx_host": idx, "hist_k": hist_k,
        "cap_per_tile": cap_per_tile,
        "xb": jnp.asarray(xb), "yb": jnp.asarray(yb), "tb": jnp.asarray(tb),
        "idx": jnp.asarray(idx),
        "starts": jnp.asarray(plan.starts.astype(np.int32)),
        "ends": jnp.asarray(plan.ends.astype(np.int32)),
        "bbox": jnp.asarray(bbox), "nval": jnp.asarray(nval),
        "plan_s": _time.perf_counter() - t0,
    }


def compensate_recording_tiled(
    x, y, t_ns, cfg, mesh: Mesh, halo: int = 32, esc_cap: int = 4096,
    prepared=None, init_model: MotionModel = None,
):
    """Process a whole recording with tiled images: the tiled twin of
    runtime.scan_pipeline.compensate_recording_scan.

    One jitted shard_map over mesh ('tile_x', 'tile_y') whose body scans
    the slices: per slice, the warm-start warp, the bbox-window geometry
    and window/min-event gates (host-precomputed bbox, replicated — no
    collective), the tiled optimizer loop (reference or fast schedule;
    halo fold-in/broadcast-back + escape lane per iteration,
    _tiled_iteration), noise marking from the scalar gate history, and
    the warm-start model + secant-seed carry.  Escape-lane overflow is
    REPORTED per recording in stats['escaped_dropped'] (0 = the tiled
    result is exact for any drift).
    """
    import time as _time

    from functools import partial as _partial

    from better_flow.models.global_flow import (
        _drive_loop,
        geometry_from_bbox,
    )
    from better_flow.runtime.scan_pipeline import PERM_SENTINEL  # noqa: F401

    cfg = cfg  # PipelineConfig
    n_tx = mesh.shape[AX_X]
    n_ty = mesh.shape[AX_Y]
    if prepared is None:
        prepared = prepare_recording_tiled(x, y, t_ns, cfg, n_tx, n_ty)
    plan = prepared["plan"]
    n = prepared["n"]
    S = len(plan.ends)
    opt = cfg.optimizer
    scale = opt.scale
    sensor = cfg.sensor
    img_h = sensor.res_x * scale + scale
    img_w = sensor.res_y * scale + scale
    tile_h = -(-img_h // n_tx)
    tile_w = -(-img_w // n_ty)
    # Same constraint as process_slice_tiled: the staging
    # (prepare_recording_tiled / bucket_events_2d) assigns home tiles by
    # this natural tile size; clamping to halo here would disagree with it.
    if tile_h < halo or tile_w < halo:
        raise ValueError(
            f"halo {halo} exceeds the natural tile size "
            f"({tile_h}x{tile_w} for a {img_h}x{img_w} image over a "
            f"{n_tx}x{n_ty} mesh); use fewer tiles or a smaller halo"
        )
    hist_k = prepared["hist_k"]
    warm = not cfg.stm_disable

    def local_fn(xb, yb, tb, sidx, starts, ends, bbox, nval, model0,
                 acc0):
        def step(carry, inputs):
            model, sd, ws_h, st_h, en_h = carry
            sx, sy, st, si, start, end, bb, nv = inputs
            valid = si >= 0
            noise = jnp.zeros_like(valid)
            for j in range(hist_k):
                noise |= ws_h[j] & (si >= st_h[j]) & (si <= en_h[j])
            active = valid & ~noise
            geom = geometry_from_bbox(bb[0], bb[1], bb[2], bb[3], scale,
                                      sensor, opt.min_window_fraction)
            mdl = model if warm else MotionModel.zero()
            ran = ~geom.window_small & (nv >= opt.min_events)

            # Warm-start warp (set_model): replicated model, local events.
            pr0x, pr0y, nx0, ny0 = project_4param_reinit(
                sx, sy, st, sx, sy,
                -mdl.total_dx, -mdl.total_dy, mdl.cx, mdl.cy,
                mdl.total_div, -mdl.total_rot,
            )

            def run(_):
                init = TiledFlowState(
                    pr_x=pr0x, pr_y=pr0y, nx=nx0, ny=ny0, model=mdl,
                    x_div=jnp.float32(opt.init_xy_divider),
                    y_div=jnp.float32(opt.init_xy_divider),
                    rot_div=jnp.float32(opt.init_rotdiv_divider),
                    div_div=jnp.float32(opt.init_rotdiv_divider),
                    iters=jnp.int32(0), esc=jnp.int32(0),
                )

                def stepfn(s, update_fn=None):
                    uf = None if update_fn is None else (
                        lambda m: update_fn(m, s))
                    pr2, nx, ny, model2, dropped = _tiled_iteration(
                        (s.pr_x, s.pr_y), sx, sy, st, active, s.model,
                        (s.x_div, s.y_div, s.rot_div, s.div_div),
                        scale, tile_h, tile_w, halo, img_h, img_w,
                        esc_cap, geom=geom, update_fn=uf,
                    )
                    return s._replace(
                        pr_x=pr2[0], pr_y=pr2[1], nx=nx, ny=ny,
                        model=model2, iters=s.iters + 1,
                        esc=jnp.maximum(s.esc, dropped),
                    )

                final, seed_out = _drive_loop(init, stepfn, opt, seed=sd)
                return (final.model, final.nx, final.ny, final.iters,
                        final.esc, seed_out)

            def skip(_):
                return (mdl, nx0, ny0, jnp.int32(0), jnp.int32(0),
                        jnp.zeros(8, jnp.float32))

            fmodel, nx, ny, iters, esc, seed_out = lax.cond(ran, run, skip, 0)
            u, v = compute_uv(nx, ny)
            ev_noise = (noise | (geom.window_small & valid)) & valid
            ws_h = jnp.concatenate([ws_h[1:], geom.window_small[None]])
            st_h = jnp.concatenate([st_h[1:], start[None]])
            en_h = jnp.concatenate([en_h[1:], end[None]])
            return ((fmodel, seed_out, ws_h, st_h, en_h),
                    (u, v, ev_noise, iters, esc))

        carry0 = (
            model0,
            jnp.zeros(8, jnp.float32),
            jnp.zeros((hist_k,), bool),
            jnp.zeros((hist_k,), jnp.int32),
            jnp.full((hist_k,), -1, jnp.int32),
        )
        (fmodel, *_), outs = lax.scan(
            step, carry0, (xb, yb, tb, sidx, starts, ends, bbox, nval))
        u_rows, v_rows, n_rows, iters, esc = outs
        # First-slice-wins accumulation by ORIGINAL index, on device:
        # each device scatters ITS events (bucketing assigns an original
        # pixel to exactly one tile, so per-device claims are disjoint)
        # into full-recording [n] arrays in REVERSE slice order — the
        # first containing slice's write lands last — and one psum
        # unions the tiles.  The host then fetches n events' worth of
        # results instead of the overlapping [S, NT*cap] slabs and a
        # host-side numpy loop over them.
        n_total = acc0[0].shape[0]

        def astep(acc, inp):
            au, av, an, si = acc[0], acc[1], acc[2], inp[3]
            tgt = jnp.where(si >= 0, si, n_total)
            au = au.at[tgt].set(inp[0], mode="drop")
            av = av.at[tgt].set(inp[1], mode="drop")
            an = an.at[tgt].set(inp[2].astype(jnp.float32), mode="drop")
            return (au, av, an), None

        (au, av, an), _ = lax.scan(
            astep, acc0,
            (u_rows[::-1], v_rows[::-1], n_rows[::-1], sidx[::-1]))
        au = lax.psum(au, (AX_X, AX_Y))
        av = lax.psum(av, (AX_X, AX_Y))
        an = lax.psum(an, (AX_X, AX_Y))
        chk = jnp.sum(au) + jnp.sum(av)
        return fmodel, (au, av, an, iters, esc), chk

    ev_spec = P(None, (AX_X, AX_Y))
    model0 = init_model or MotionModel.zero()
    model_spec = jax.tree_util.tree_map(lambda _: P(), model0)
    # Cache the jitted shard_map per static configuration: a fresh
    # closure per call is a fresh jit identity, which would recompile the
    # whole scan on EVERY call.
    fn_key = (cfg, mesh, halo, esc_cap, hist_k)
    fn = _TILED_SCAN_CACHE.get(fn_key)
    if fn is None:
        fn = jax.jit(jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(ev_spec, ev_spec, ev_spec, ev_spec,
                      P(None), P(None), P(None), P(None), model_spec,
                      (P(), P(), P())),
            out_specs=(model_spec,
                       (P(), P(), P(), P(None), P(None)),
                       P()),
            check_vma=False,
        ))
        _TILED_SCAN_CACHE[fn_key] = fn
    acc0 = (jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32),
            jnp.zeros(n, jnp.float32))
    t0 = _time.perf_counter()
    fmodel, (au, av, an, iters, esc), chk = fn(
        prepared["xb"], prepared["yb"], prepared["tb"], prepared["idx"],
        prepared["starts"], prepared["ends"], prepared["bbox"],
        prepared["nval"], model0, acc0,
    )
    float(np.asarray(chk))
    run_s = _time.perf_counter() - t0

    acc_u = np.asarray(au)
    acc_v = np.asarray(av)
    acc_noise = np.asarray(an) > 0

    return {
        "u": acc_u, "v": acc_v, "noise": acc_noise, "model": fmodel,
        "iters": np.asarray(iters),
        "stats": {
            "n_events": n, "n_slices": S, "n_tiles": (n_tx, n_ty),
            "cap_per_tile": prepared["cap_per_tile"],
            "escaped_dropped": int(np.asarray(esc).max(initial=0)),
            "plan_s": prepared["plan_s"], "run_s": run_s,
            "mean_iters": float(np.mean(np.asarray(iters))) if S else 0.0,
        },
    }
