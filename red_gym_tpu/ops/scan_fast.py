"""Fast lidar: precomputed range texture + trilinear lookup.

This is the throughput-mode design the BASELINE north star prescribes: the
range field R(x, y, theta) is precomputed ONCE per map on device with the
exact sphere march, and each runtime beam becomes a handful of gathers +
lerps instead of ~35 data-dependent march iterations.

Accuracy: trilinear interpolation of a range field is exact for planar walls
away from visibility discontinuities; near occlusion edges it blends
foreground/background ranges.  Use scan_mode="exact" for reference parity;
"fast" for RL throughput (tests pin the error distribution).
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from red_gym_tpu.config import SimConfig
from red_gym_tpu.maps.loader import TrackMap
from red_gym_tpu.ops import scan as scan_ops


class RangeTexture(NamedTuple):
    """Precomputed ranges on a (rows x cols x theta_bins) pose grid.

    ``fmat``/``gmat`` serve the all-matmul fast path (trace_fast_mxu): the
    per-agent integer circular roll of the theta row is performed exactly in
    the DFT domain (constant rfft matrix -> per-agent phase twiddle ->
    constant matrix fusing the inverse transform with the one-hot beam
    shuffle), so the runtime scan contains no dynamic gathers at all beyond
    the 4 contiguous texture-row fetches.

    ``rt`` rows may carry auxiliary CHANNELS concatenated after the T range
    bins (layout [R | e w | gx gy], presence cfg-derived — see
    SimConfig.rt_channels): ``e`` = sub-bin position of the visibility
    discontinuity between theta bins k and k+1 (bisection-refined at build,
    0.5 when none), ``w`` = transition width of that pair (0 = hard
    occlusion edge -> render a step, 1 = smooth -> plain lerp), ``gx/gy`` =
    dR/dpose (analytic, from the wall tangent of adjacent hit points;
    zeroed at edges/max-range).  One contiguous row gather fetches all
    channels."""

    rt: jnp.ndarray        # (Hc * Wc, C * T) ranges [m] + aux channels;
                           # STORAGE dtype may be bfloat16 (cfg.rt_dtype) —
                           # compute upcasts
    valid: jnp.ndarray     # (Hc * Wc,) free-space mask (occupied rows are 0)
    hc: jnp.ndarray        # int32 rows
    wc: jnp.ndarray        # int32 cols
    cell: jnp.ndarray      # cell size [m] = stride * map resolution
    fmat: jnp.ndarray      # (T, T) packed real rfft: [Re 0..T/2 | Im 1..T/2-1]
    gmat: jnp.ndarray      # (T, 3B) packed irfft fused with the beam shuffle
    smat: jnp.ndarray      # (T, B) Lanczos-windowed trig evaluation at the
                           # static beam offsets (scan_interp="spectral")


def _texture_cache_path(tmap: TrackMap, cfg: SimConfig):
    """Content-addressed cache file for the marched (rt, valid) arrays.

    Keyed on the dt texture bytes + every config field the march reads, so
    edited maps or changed settings never hit a stale entry.  Cache dir:
    $RED_GYM_TPU_TEXTURE_CACHE, default ~/.cache/red_gym_tpu; set it to
    "0"/"off" to disable.
    """
    import hashlib

    root = os.environ.get("RED_GYM_TPU_TEXTURE_CACHE",
                          os.path.join(os.path.expanduser("~"),
                                       ".cache", "red_gym_tpu"))
    if root.lower() in ("0", "off", "none", ""):
        return None
    h = hashlib.sha256()
    h.update(b"rtex-v8|")   # build-recipe version (v8: delimited key tuple
                            # incl. rotation/extents/shape; v7: e pinned)
    dt = np.ascontiguousarray(np.asarray(tmap.dt))
    h.update(dt.tobytes())
    # hash one delimited repr of the full key tuple — undelimited per-field
    # repr streams can alias across adjacent fields (e.g. 2|128 vs 21|28).
    # The march reads the map's world placement (origin + ROTATION via
    # rows_to_world) and the true extents (the validity crop), so they are
    # part of the key even though dt bytes don't change with them; dt.shape
    # disambiguates byte-identical (H,W)/(W,H) transposes.
    key = (cfg.rt_pose_stride, cfg.rt_theta_bins, cfg.max_range, cfg.eps,
           cfg.march_iters,   # trace_angles: fixed fori budget vs while
           cfg.rt_eff_occlusion == "edge", cfg.rt_grad,
           cfg.rt_occlusion_cells, cfg.rt_edge_iters,
           float(np.asarray(tmap.resolution)),
           float(np.asarray(tmap.orig_x)), float(np.asarray(tmap.orig_y)),
           float(np.asarray(tmap.orig_c)), float(np.asarray(tmap.orig_s)),
           int(np.asarray(tmap.height)), int(np.asarray(tmap.width)),
           tuple(dt.shape), str(np.dtype(tmap.dt.dtype)))
    h.update(repr(key).encode())
    return os.path.join(root, f"rtex_{h.hexdigest()[:24]}.npz")


def build_range_texture(tmap: TrackMap, cfg: SimConfig,
                        batch_rows: int = 8) -> RangeTexture:
    """March every theta bin from every texture cell center (on device).

    Runs in row batches to bound memory; one-time cost per map (~seconds to
    tens of seconds depending on rt_pose_stride), memoized to disk by
    content hash (see _texture_cache_path) so repeated runs — multi-seed
    training sweeps, multi-process launches — pay it once per machine.
    """
    stride = cfg.rt_pose_stride
    t_bins = cfg.rt_theta_bins
    # texture extents from the PADDED dt shape (== true shape for unpadded
    # maps): padded cells are occupied, so their rows zero out and carry
    # valid=False — and equally-padded maps yield stackable textures.
    h, w = int(tmap.dt.shape[-2]), int(tmap.dt.shape[-1])
    hc = (h + stride - 1) // stride
    wc = (w + stride - 1) // stride
    res = float(tmap.resolution)
    cell = stride * res
    dtype = tmap.dt.dtype

    angles = jnp.asarray(
        np.arange(t_bins) * (2 * math.pi / t_bins), dtype=dtype)

    # texture cell centers in map-rotated coords -> world coords
    ox, oy = tmap.orig_x, tmap.orig_y
    oc, os_ = tmap.orig_c, tmap.orig_s

    def rows_to_world(r_idx, c_idx):
        x_rot = (c_idx.astype(dtype) + 0.5) * cell
        y_rot = (r_idx.astype(dtype) + 0.5) * cell
        x = x_rot * oc - y_rot * os_ + ox
        y = x_rot * os_ + y_rot * oc + oy
        return x, y

    cfg_march = cfg  # same eps/max_range semantics as the exact mode
    need_edge = cfg.rt_eff_occlusion == "edge"
    need_grad = cfg.rt_grad
    n_chan = cfg.rt_channels
    two_pi = 2.0 * math.pi
    dth = two_pi / t_bins
    thr = cfg.rt_occlusion_cells * cell
    n_grid = 8

    @jax.jit
    def _dense_rows(r0):
        r_idx = r0 + jnp.arange(batch_rows)[:, None]            # (B, Wc)
        c_idx = jnp.broadcast_to(jnp.arange(wc)[None, :], (batch_rows, wc))
        x, y = rows_to_world(r_idx, c_idx)
        origins = jnp.stack([x, y], axis=-1)                    # (B, Wc, 2)
        ranges = scan_ops.trace_angles(origins, angles, tmap, cfg_march)
        # valid rows must be strictly positive EVERYWHERE: the runtime
        # kernel reads validity off theta column 0 alone (no 128-wide
        # max-reduce over the gathered rows); 1 mm floor, below the
        # texture's error scale
        ranges = jnp.maximum(ranges, 1e-3)
        free = scan_ops.dt_lookup(x, y, tmap) > 0.0
        # cells whose center lies beyond the TRUE map extents must be
        # invalid: dt_lookup's OOB read wraps to dt[-1,-1] (the reference
        # numpy quirk), which is free on maps whose corner pixel is free —
        # that would mark garbage marched rows valid and bleed into scans
        # near the map edge
        cy = (r_idx.astype(dtype) + 0.5) * stride
        cx = (c_idx.astype(dtype) + 0.5) * stride
        free = free & (cy < tmap.height.astype(dtype)) \
                    & (cx < tmap.width.astype(dtype))

        chans = [ranges]
        shape3 = ranges.shape                                   # (B, Wc, T)
        x3 = jnp.broadcast_to(x[..., None], shape3)
        y3 = jnp.broadcast_to(y[..., None], shape3)
        nxt = jnp.roll(ranges, -1, axis=-1)     # pair (k, k+1), circular
        jump = jnp.abs(nxt - ranges)
        if need_edge:
            # Localize the dominant range discontinuity inside each bin
            # pair.  A pure bisection on "closer to the left value" can
            # converge to a smooth mean-crossing when the pair is
            # non-monotone (measured failure mode: a 17 m jump classified
            # smooth), so first an 8-point fine grid finds the steepest
            # interval, then bisection refines WITHIN it with a local
            # bracket.
            is_edge = jump > thr
            samples = [ranges]
            for j in range(1, n_grid):
                ang = angles[None, None, :] + (j / n_grid) * dth
                samples.append(scan_ops.march(x3, y3, jnp.cos(ang),
                                              jnp.sin(ang), tmap, cfg_march))
            samples.append(nxt)
            m = jnp.stack(samples, axis=0)            # (n_grid+1, B, Wc, T)
            d = jnp.abs(m[1:] - m[:-1])               # (n_grid, ...)
            jidx = jnp.argmax(d, axis=0)
            lo = jidx.astype(dtype) / n_grid
            hi = (jidx.astype(dtype) + 1.0) / n_grid
            mlo = jnp.take_along_axis(m, jidx[None], axis=0)[0]
            mhi = jnp.take_along_axis(m, jidx[None] + 1, axis=0)[0]
            for _ in range(cfg.rt_edge_iters):
                mid = 0.5 * (lo + hi)
                ang = angles[None, None, :] + mid * dth
                rm = scan_ops.march(x3, y3, jnp.cos(ang), jnp.sin(ang),
                                    tmap, cfg_march)
                left = jnp.abs(rm - mlo) < jnp.abs(rm - mhi)
                lo = jnp.where(left, mid, lo)
                hi = jnp.where(left, hi, mid)
                mlo = jnp.where(left, rm, mlo)
                mhi = jnp.where(left, mhi, rm)
            e = 0.5 * (lo + hi)
            # transition width from a LOCAL +-h probe around the localized
            # position: a hard edge realizes ~the whole pair jump within 2h
            # (w -> 0); a smooth ramp — even a strongly curved one, whose
            # steepest grid interval exceeds the uniform share — realizes
            # only slope*2h of it (w -> 1, rendering ~the plain lerp).
            # (An interval-share width definition was measured to misread
            # curvature as edginess: >1cell tail 6.7% -> 21%.)
            hh = 1.0 / (n_grid * 2 ** cfg.rt_edge_iters)
            ang_m = angles[None, None, :] + jnp.clip(e - hh, 0.0, 1.0) * dth
            ang_p = angles[None, None, :] + jnp.clip(e + hh, 0.0, 1.0) * dth
            r_m = scan_ops.march(x3, y3, jnp.cos(ang_m), jnp.sin(ang_m),
                                 tmap, cfg_march)
            r_p = scan_ops.march(x3, y3, jnp.cos(ang_p), jnp.sin(ang_p),
                                 tmap, cfg_march)
            frac_disc = jnp.abs(r_p - r_m) / jnp.maximum(jump, 1e-6)
            w = jnp.clip(1.0 - frac_disc, 0.0, 1.0)
            # partially-smooth pairs (w -> 1): the ramp must converge to
            # the PLAIN LERP, i.e. its center must sit at 0.5 — pin e
            # toward 0.5 by w.  Without this, a wide ramp centered on the
            # steepest interval of a smooth grazing wall displaces the
            # whole interpolation (measured: >1cell tail 6.7% -> 21%).
            e = 0.5 * w + e * (1.0 - w)
            chans.append(jnp.where(is_edge, e, 0.5))
            chans.append(jnp.where(is_edge, w, 1.0))
        if need_grad:
            # analytic pose-gradient of the range field: adjacent hit
            # points give the wall tangent t, grad = -n / (n . d) for the
            # sensor-facing normal n (scale-invariant in n).  |grad| =
            # 1/cos(incidence) is clamped; edges and max-range bins are
            # zeroed (no well-defined wall there).
            cos_t = jnp.cos(angles)[None, None, :]
            sin_t = jnp.sin(angles)[None, None, :]
            hx = x3 + ranges * cos_t
            hy = y3 + ranges * sin_t
            # wall tangent from adjacent hit points — ONE-SIDED at
            # visibility edges (the cross-edge neighbor lies on a different
            # surface and would corrupt the tangent); both sides cut ->
            # no defined wall -> zero gradient
            jl = jnp.roll(jump, 1, axis=-1) > thr     # cut to bin k-1
            jr = jump > thr                           # cut to bin k+1
            txr = jnp.roll(hx, -1, axis=-1) - hx
            tyr = jnp.roll(hy, -1, axis=-1) - hy
            txl = hx - jnp.roll(hx, 1, axis=-1)
            tyl = hy - jnp.roll(hy, 1, axis=-1)
            tx = jnp.where(jl, txr, jnp.where(jr, txl, txr + txl))
            ty = jnp.where(jl, tyr, jnp.where(jr, tyl, tyr + tyl))
            nx, ny = -ty, tx
            nd = nx * cos_t + ny * sin_t
            sgn = jnp.where(nd > 0, -1.0, 1.0)
            nx, ny, nd = nx * sgn, ny * sgn, nd * sgn
            nd = jnp.minimum(nd, -1e-9)          # facing the sensor
            gx = -nx / nd
            gy = -ny / nd
            gn = jnp.sqrt(gx * gx + gy * gy)
            sc = jnp.minimum(1.0, 8.0 / jnp.maximum(gn, 1e-9))
            rmax = 0.999 * cfg.max_range
            side_r = jnp.roll(ranges, -1, axis=-1) >= rmax
            side_l = jnp.roll(ranges, 1, axis=-1) >= rmax
            bad = (jl & jr) | (ranges >= rmax) \
                | (jnp.where(jl, side_r, jnp.where(jr, side_l,
                                                   side_r | side_l)))
            sc = jnp.where(bad, 0.0, sc)
            chans.append(gx * sc)
            chans.append(gy * sc)
        # concat channels along the row: one contiguous row gather at
        # runtime fetches range + aux together
        out = jnp.concatenate(chans, axis=-1)                   # (B, Wc, C*T)
        return out * free[..., None].astype(dtype), free

    # ------------------------------------------------------------------
    # Compact build (default): the dense path above marches the 8-point
    # fine grid + rt_edge_iters bisection + 2 width probes (15 extra full
    # marches at the defaults) over EVERY theta-bin pair, but only the
    # bins with jump > thr keep the result (the is_edge select) and only
    # free in-map cells survive the final validity mask — typically a few
    # percent of the texture.  Gathering exactly those bins and running
    # the same elementwise math on the compacted vector is bit-identical
    # (no reductions cross bins; verified on the CPU backend by
    # tests/test_scan_fast.py::test_compact_build_matches_dense — other
    # backends may re-associate fma contraction differently across the two
    # compilation contexts) and turns the ~13-minute cold build of a
    # 1600^2 map into ~3 min on one CPU core.  Dense stays reachable via
    # RGT_TEXTURE_BUILD=dense.
    #
    # Edge bins are processed in fixed-size chunks of EDGE_CHUNK so
    # _edge_bins compiles exactly ONCE per build regardless of map size
    # (a per-batch power-of-two bucketing re-jitted up to ~8 times, which
    # can cost more than the marches it saved).
    # ------------------------------------------------------------------

    @jax.jit
    def _base_rows(r0):
        r_idx = r0 + jnp.arange(batch_rows)[:, None]            # (B, Wc)
        c_idx = jnp.broadcast_to(jnp.arange(wc)[None, :], (batch_rows, wc))
        x, y = rows_to_world(r_idx, c_idx)
        origins = jnp.stack([x, y], axis=-1)                    # (B, Wc, 2)
        ranges = scan_ops.trace_angles(origins, angles, tmap, cfg_march)
        ranges = jnp.maximum(ranges, 1e-3)      # column-0 validity floor
        free = scan_ops.dt_lookup(x, y, tmap) > 0.0
        cy = (r_idx.astype(dtype) + 0.5) * stride
        cx = (c_idx.astype(dtype) + 0.5) * stride
        free = free & (cy < tmap.height.astype(dtype)) \
                    & (cx < tmap.width.astype(dtype))
        return ranges, free, x, y

    @jax.jit
    def _edge_bins(xk, yk, ang0, rl, rr, jk):
        """Edge localization on a compacted (K,) vector of edge bins only —
        the same fine-grid + bisection + width-probe math as _dense_rows,
        elementwise, so the results are bit-identical per bin."""
        samples = [rl]
        for j in range(1, n_grid):
            ang = ang0 + (j / n_grid) * dth
            samples.append(scan_ops.march(xk, yk, jnp.cos(ang), jnp.sin(ang),
                                          tmap, cfg_march))
        samples.append(rr)
        m = jnp.stack(samples, axis=0)                  # (n_grid+1, K)
        d = jnp.abs(m[1:] - m[:-1])
        jidx = jnp.argmax(d, axis=0)
        lo = jidx.astype(dtype) / n_grid
        hi = (jidx.astype(dtype) + 1.0) / n_grid
        mlo = jnp.take_along_axis(m, jidx[None], axis=0)[0]
        mhi = jnp.take_along_axis(m, jidx[None] + 1, axis=0)[0]
        for _ in range(cfg.rt_edge_iters):
            mid = 0.5 * (lo + hi)
            ang = ang0 + mid * dth
            rm = scan_ops.march(xk, yk, jnp.cos(ang), jnp.sin(ang),
                                tmap, cfg_march)
            left = jnp.abs(rm - mlo) < jnp.abs(rm - mhi)
            lo = jnp.where(left, mid, lo)
            hi = jnp.where(left, hi, mid)
            mlo = jnp.where(left, rm, mlo)
            mhi = jnp.where(left, mhi, rm)
        e = 0.5 * (lo + hi)
        hh = 1.0 / (n_grid * 2 ** cfg.rt_edge_iters)
        ang_m = ang0 + jnp.clip(e - hh, 0.0, 1.0) * dth
        ang_p = ang0 + jnp.clip(e + hh, 0.0, 1.0) * dth
        r_m = scan_ops.march(xk, yk, jnp.cos(ang_m), jnp.sin(ang_m),
                             tmap, cfg_march)
        r_p = scan_ops.march(xk, yk, jnp.cos(ang_p), jnp.sin(ang_p),
                             tmap, cfg_march)
        frac_disc = jnp.abs(r_p - r_m) / jnp.maximum(jk, 1e-6)
        w = jnp.clip(1.0 - frac_disc, 0.0, 1.0)
        e = 0.5 * w + e * (1.0 - w)
        return e, w

    @jax.jit
    def _finish_rows(ranges, free, x, y, ew):
        """Channel assembly for one row batch: (e, w) arrive pre-scattered
        (host side) with the non-edge defaults (0.5, 1.0) — exactly what
        the dense path's is_edge select produces."""
        chans = [ranges]
        shape3 = ranges.shape
        x3 = jnp.broadcast_to(x[..., None], shape3)
        y3 = jnp.broadcast_to(y[..., None], shape3)
        nxt = jnp.roll(ranges, -1, axis=-1)
        jump = jnp.abs(nxt - ranges)
        if need_edge:
            chans.extend(ew)
        if need_grad:
            cos_t = jnp.cos(angles)[None, None, :]
            sin_t = jnp.sin(angles)[None, None, :]
            hx = x3 + ranges * cos_t
            hy = y3 + ranges * sin_t
            jl = jnp.roll(jump, 1, axis=-1) > thr
            jr = jump > thr
            txr = jnp.roll(hx, -1, axis=-1) - hx
            tyr = jnp.roll(hy, -1, axis=-1) - hy
            txl = hx - jnp.roll(hx, 1, axis=-1)
            tyl = hy - jnp.roll(hy, 1, axis=-1)
            tx = jnp.where(jl, txr, jnp.where(jr, txl, txr + txl))
            ty = jnp.where(jl, tyr, jnp.where(jr, tyl, tyr + tyl))
            nx, ny = -ty, tx
            nd = nx * cos_t + ny * sin_t
            sgn = jnp.where(nd > 0, -1.0, 1.0)
            nx, ny, nd = nx * sgn, ny * sgn, nd * sgn
            nd = jnp.minimum(nd, -1e-9)
            gx = -nx / nd
            gy = -ny / nd
            gn = jnp.sqrt(gx * gx + gy * gy)
            sc = jnp.minimum(1.0, 8.0 / jnp.maximum(gn, 1e-9))
            rmax = 0.999 * cfg.max_range
            side_r = jnp.roll(ranges, -1, axis=-1) >= rmax
            side_l = jnp.roll(ranges, 1, axis=-1) >= rmax
            bad = (jl & jr) | (ranges >= rmax) \
                | (jnp.where(jl, side_r, jnp.where(jr, side_l,
                                                   side_r | side_l)))
            sc = jnp.where(bad, 0.0, sc)
            chans.append(gx * sc)
            chans.append(gy * sc)
        out = jnp.concatenate(chans, axis=-1)                   # (B, Wc, C*T)
        return out * free[..., None].astype(dtype)

    EDGE_CHUNK = 4096  # fixed _edge_bins shape: ONE compile per build

    def _compact_rows(r0):
        ranges, free, x, y = _base_rows(jnp.int32(r0))
        ew = ()
        n_edge = 0
        if need_edge:
            ranges_np = np.asarray(ranges)
            npdt = ranges_np.dtype
            nxt = np.roll(ranges_np, -1, axis=-1)
            jump = np.abs(nxt - ranges_np)
            # & free: bins in occupied/out-of-map cells are zeroed by the
            # validity mask either way, so skipping their marches is exact
            mask = (jump > thr) & np.asarray(free)[..., None]
            idx = np.nonzero(mask.ravel())[0]
            e_np = np.full(ranges_np.shape, 0.5, npdt)
            w_np = np.ones(ranges_np.shape, npdt)
            if idx.size:
                n_edge = int(idx.size)
                # pad to a multiple of the fixed chunk; np.resize repeats
                # the index sequence, so rows [:n_edge] of the result are
                # exactly the unique bins.  Every _edge_bins call has the
                # same (EDGE_CHUNK,) shape -> exactly one jit build.
                K = ((n_edge + EDGE_CHUNK - 1) // EDGE_CHUNK) * EDGE_CHUNK
                pad = np.resize(idx, K)
                cell_i, t_i = pad // t_bins, pad % t_bins
                xi = np.asarray(x).ravel()[cell_i]
                yi = np.asarray(y).ravel()[cell_i]
                ai = np.asarray(angles)[t_i]
                rli = ranges_np.ravel()[pad]
                rri = nxt.ravel()[pad]
                jki = jump.ravel()[pad]
                e_parts, w_parts = [], []
                for c0 in range(0, K, EDGE_CHUNK):
                    sl = slice(c0, c0 + EDGE_CHUNK)
                    e_k, w_k = _edge_bins(
                        jnp.asarray(xi[sl]), jnp.asarray(yi[sl]),
                        jnp.asarray(ai[sl]), jnp.asarray(rli[sl]),
                        jnp.asarray(rri[sl]), jnp.asarray(jki[sl]))
                    e_parts.append(np.asarray(e_k))
                    w_parts.append(np.asarray(w_k))
                e_np.ravel()[idx] = np.concatenate(e_parts)[:n_edge]
                w_np.ravel()[idx] = np.concatenate(w_parts)[:n_edge]
            ew = (jnp.asarray(e_np), jnp.asarray(w_np))
        out = _finish_rows(ranges, free, x, y, ew)
        return out, free, n_edge

    cache = _texture_cache_path(tmap, cfg)
    if cache is not None and os.path.exists(cache):
        with np.load(cache) as z:
            rt = jnp.asarray(z["rt"], dtype)   # cache holds full precision
            valid = jnp.asarray(z["valid"])
    else:
        rt_rows = []
        valid_rows = []
        n_batches = (hc + batch_rows - 1) // batch_rows
        t_build = time.time()
        dense = os.environ.get("RGT_TEXTURE_BUILD", "").lower() == "dense"
        n_edge_total = 0
        for i, r0 in enumerate(range(0, hc, batch_rows)):
            if dense:
                rng, fr = _dense_rows(jnp.int32(r0))
            else:
                rng, fr, n_e = _compact_rows(r0)
                n_edge_total += n_e
            # sync per batch: bounds device memory in flight and makes
            # the progress line truthful (the compact path already synced
            # via its host round trips)
            jax.block_until_ready(fr)
            rt_rows.append(rng)
            valid_rows.append(fr)
            if i % 32 == 31 or i == n_batches - 1:
                edge_note = ""
                if not dense and need_edge:
                    n_bins = (i + 1) * batch_rows * wc * t_bins
                    edge_note = (f", {n_edge_total} edge bins "
                                 f"({100.0 * n_edge_total / n_bins:.1f}%)")
                print(f"[range-texture] {i + 1}/{n_batches} row batches "
                      f"({time.time() - t_build:.0f}s{edge_note}, cold build "
                      f"— cached to disk when done)",
                      file=sys.stderr, flush=True)
        rt = jnp.concatenate(rt_rows, axis=0)[:hc] \
                .reshape(hc * wc, n_chan * t_bins)
        valid = jnp.concatenate(valid_rows, axis=0)[:hc].reshape(hc * wc)
        if cache is not None:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            tmp = cache + f".{os.getpid()}.tmp.npz"  # .npz: savez keeps name
            np.savez(tmp, rt=np.asarray(rt), valid=np.asarray(valid))
            os.replace(tmp, cache)  # atomic: concurrent builders race safely

    # Constant beam-shuffle matrix: beam b's theta offset c_b = angle_b*T/2pi
    # split into integer kb and fraction gb; emat column t*B+b one-hots bin
    # (kb_b + t) mod T of the per-agent ROLLED theta row (see trace_fast_mxu).
    # kb MUST come from the same dtype arithmetic the kernel uses for gb, or
    # a beam whose c_b rounds across an integer gets a whole-bin offset.
    np_dtype = np.dtype(dtype)
    incr = cfg.fov / (cfg.num_beams - 1)
    angles = (-cfg.fov / 2.0 + np.arange(cfg.num_beams) * incr).astype(np_dtype)
    c_b = angles * np_dtype.type(t_bins / (2.0 * math.pi))
    kb = np.floor(c_b).astype(np.int64)
    b_n = cfg.num_beams
    emat = np.zeros((t_bins, 3 * b_n), dtype=np.float64)
    for t in range(3):
        emat[(kb + t) % t_bins, t * b_n + np.arange(b_n)] = 1.0

    # DFT-domain exact integer roll: fmat = real rfft basis; gmat = inverse
    # transform of the real/imag unit coefficients, fused with emat.  The
    # spectrum is PACKED to exactly T reals — [Re 0..T/2, Im 1..T/2-1] — by
    # dropping the DC and Nyquist imaginaries, which are identically zero
    # for real input and stay zero under integer-roll twiddles.  T = 128
    # keeps both matmul contraction dims one 128-wide tile.
    f_bins = t_bins // 2 + 1
    rf = np.fft.rfft(np.eye(t_bins), axis=1)                  # (T, F)
    fmat = np.concatenate([rf.real, rf.imag[:, 1:-1]], axis=1)  # (T, T)
    r_basis = np.fft.irfft(np.eye(f_bins), n=t_bins, axis=1)  # (F, T)
    s_basis = np.fft.irfft(1j * np.eye(f_bins), n=t_bins, axis=1)
    gmat = np.concatenate([r_basis @ emat,
                           (s_basis @ emat)[1:-1]], axis=0)   # (T, 3B)

    # Spectral evaluation matrix: trig reconstruction of the (rolled) theta
    # row AT the static beam offsets c_b, with a Lanczos window damping the
    # Gibbs ringing at occlusion discontinuities.  Row layout matches the
    # packed spectrum: [Re 0..T/2 | Im 1..T/2-1].
    freqs = np.arange(f_bins)
    sigma = np.sinc(freqs / (t_bins // 2))                    # Lanczos window
    scale = np.where((freqs == 0) | (freqs == t_bins // 2), 1.0, 2.0) / t_bins
    wf = (sigma * scale)[:, None]                             # (F, 1)
    omega_c = (2.0 * math.pi / t_bins) * np.outer(freqs, c_b)  # (F, B)
    smat = np.concatenate([wf * np.cos(omega_c),
                           (-wf * np.sin(omega_c))[1:-1]], axis=0)  # (T, B)

    return RangeTexture(rt=rt.astype(cfg.rt_jdtype), valid=valid,
                        hc=jnp.asarray(hc, jnp.int32),
                        wc=jnp.asarray(wc, jnp.int32),
                        cell=jnp.asarray(cell, dtype),
                        fmat=jnp.asarray(fmat, dtype),
                        gmat=jnp.asarray(gmat, dtype),
                        smat=jnp.asarray(smat, dtype))


def pad_texture(rtex: RangeTexture, hc_new: int, wc_new: int) -> RangeTexture:
    """Grow a texture's cell grid to (hc_new, wc_new) with invalid rows.

    Padded cells get all-zero rows and valid=False — exactly what
    build_range_texture produces for occupied/out-of-map cells — so padding
    AFTER the build equals building on a zero-padded map for any map whose
    border is occupied (every packaged track; rays terminate at real walls
    before the boundary).  This is what makes multi-map stacking reuse the
    per-map texture cache: the build runs on the RAW map (content-hash
    stable across stack compositions) and only this cheap reshape depends
    on the stack's common padded shape.  It also makes a map's scans
    identical whether it runs standalone or stacked."""
    hc, wc = int(rtex.hc), int(rtex.wc)
    if (hc_new, wc_new) == (hc, wc):
        return rtex
    if hc_new < hc or wc_new < wc:
        raise ValueError(f"pad target {(hc_new, wc_new)} smaller than "
                         f"texture grid {(hc, wc)}")
    ct = rtex.rt.shape[-1]
    rt = jnp.pad(rtex.rt.reshape(hc, wc, ct),
                 ((0, hc_new - hc), (0, wc_new - wc), (0, 0))
                 ).reshape(hc_new * wc_new, ct)
    valid = jnp.pad(rtex.valid.reshape(hc, wc),
                    ((0, hc_new - hc), (0, wc_new - wc))
                    ).reshape(hc_new * wc_new)
    return rtex._replace(rt=rt, valid=valid,
                         hc=jnp.asarray(hc_new, jnp.int32),
                         wc=jnp.asarray(wc_new, jnp.int32))


def stack_textures(rtexs):
    """Stack equal-shaped RangeTextures along a leading (per-env map) axis.

    The constant interpolation matrices (fmat/gmat/smat) are config-static
    and identical across maps, so they stay unbatched — see ``batch_axes``
    for the matching vmap in_axes spec."""
    first = rtexs[0]
    return RangeTexture(
        rt=jnp.stack([r.rt for r in rtexs]),
        valid=jnp.stack([r.valid for r in rtexs]),
        hc=jnp.stack([r.hc for r in rtexs]),
        wc=jnp.stack([r.wc for r in rtexs]),
        cell=jnp.stack([r.cell for r in rtexs]),
        fmat=first.fmat, gmat=first.gmat, smat=first.smat)


def batch_axes(axis: int = 0) -> "RangeTexture":
    """vmap in_axes spec for a stacked RangeTexture."""
    return RangeTexture(rt=axis, valid=axis, hc=axis, wc=axis, cell=axis,
                        fmat=None, gmat=None, smat=None)


def _resolve_ew_dtype(cfg: SimConfig, dtype):
    """Resolve cfg.rt_ew_dtype (the edge e/w channel-tap matmul dtype) for
    the CURRENT platform: explicit values win; "auto" is bfloat16 when
    tracing for the GPU (one tensor-core pass and half the tap-intermediate
    bytes; ~2^-8 relative error on a [0, 1] channel — far below the
    2^-6-bin build precision; on the H100 it measured 17% faster than f32
    taps for the same accuracy, PERF.md) and the scan dtype elsewhere (CPU
    matmuls have no fast bf16 path)."""
    if cfg.rt_ew_dtype == "bfloat16":
        return jnp.bfloat16
    if cfg.rt_ew_dtype == "float32":
        # "no bf16": keep the scan dtype (f64 scans keep f64 taps)
        return dtype
    return jnp.bfloat16 if jax.devices()[0].platform == "gpu" else dtype


def _compute_dtype(rtex: RangeTexture):
    """Interpolation compute dtype: the full-precision build dtype (fmat's),
    independent of the possibly-bfloat16 rt STORAGE dtype."""
    return rtex.fmat.dtype


def _cells_and_theta(pose, tables, tmap, rtex: RangeTexture, cfg: SimConfig,
                     midx=None):
    """Shared geometry for the fast lookups: bilinear cells + theta coords.

    Returns (rows (..., K), wgt (..., K), u (..., B), dx (..., K),
    dy (..., K)) where K = 1 (nearest1) or 4, and dx/dy is the pose's WORLD
    offset from each cell center (consumed by the gradient / edge-parallax
    corrections).  With ``midx`` and a map-stacked texture, rows are offset
    into the flat (M*Hc*Wc, C*T) table."""
    t_bins = cfg.rt_theta_bins
    dtype = _compute_dtype(rtex)
    two_pi = 2.0 * math.pi

    phi = pose[..., 2:3] + tables.scan_angles                   # (..., B)
    u = jnp.mod(phi, two_pi) * (t_bins / two_pi)

    if midx is None:
        ox, oy, oc, osn = tmap.orig_x, tmap.orig_y, tmap.orig_c, tmap.orig_s
        cell, wc, hc = rtex.cell, rtex.wc, rtex.hc
        row_base = 0
    else:
        ox, oy, oc, osn = (tmap.orig_x[midx], tmap.orig_y[midx],
                           tmap.orig_c[midx], tmap.orig_s[midx])
        cell, wc, hc = rtex.cell[midx], rtex.wc[midx], rtex.hc[midx]
        assert rtex.rt.ndim == 3, "midx requires a map-stacked RangeTexture"
        # midx may be a scalar (one map per call) or a per-ROW (N,) array
        # (a flattened (env x agent) batch)
        row_base = jnp.asarray(midx) * rtex.rt.shape[-2]
        if row_base.ndim:
            row_base = row_base[..., None]

    x_t = pose[..., 0] - ox
    y_t = pose[..., 1] - oy
    gx = (x_t * oc + y_t * osn) / cell - 0.5
    gy = (-x_t * osn + y_t * oc) / cell - 0.5

    # per-map scalars broadcast against the (..., K) cell axis; with a
    # per-ROW (N,) midx (the flattened batched entry) they carry a row
    # axis and need the trailing K axis made explicit
    def _k(v):
        v = jnp.asarray(v)
        return v[..., None] if v.ndim else v

    hc_k, wc_k, cell_k = _k(hc), _k(wc), _k(cell)
    oc_k, osn_k, ox_k, oy_k = _k(oc), _k(osn), _k(ox), _k(oy)

    if cfg.rt_spatial == "nearest1":
        # single rounded cell: ONE texture-row gather instead of four —
        # the row gather is the hottest kernel of the whole env step
        rr = jnp.round(gy).astype(jnp.int32)[..., None]        # (..., 1)
        cc = jnp.round(gx).astype(jnp.int32)[..., None]
        wgt = jnp.ones(rr.shape, dtype)
    else:
        c0 = jnp.floor(gx).astype(jnp.int32)
        r0 = jnp.floor(gy).astype(jnp.int32)
        fx = (gx - c0).astype(dtype)
        fy = (gy - r0).astype(dtype)

        rr = jnp.stack([r0, r0, r0 + 1, r0 + 1], axis=-1)
        cc = jnp.stack([c0, c0 + 1, c0, c0 + 1], axis=-1)
        wgt = jnp.stack([(1 - fy) * (1 - fx), (1 - fy) * fx,
                         fy * (1 - fx), fy * fx], axis=-1).astype(dtype)
    in_bounds = (rr >= 0) & (rr < hc_k) & (cc >= 0) & (cc < wc_k)
    rows = jnp.clip(rr, 0, hc_k - 1) * wc_k + jnp.clip(cc, 0, wc_k - 1)
    if midx is not None:
        rows = rows + row_base

    # pose offset from each gathered cell's center, in WORLD coordinates
    # (cheap inverse of the map rotation; weights zero out-of-bounds cells
    # so clipped indices never contribute)
    cxr = (rr.astype(dtype) + 0.5) * cell_k  # rotated-frame y of center
    cxc = (cc.astype(dtype) + 0.5) * cell_k  # rotated-frame x of center
    cwx = cxc * oc_k - cxr * osn_k + ox_k
    cwy = cxc * osn_k + cxr * oc_k + oy_k
    dx = pose[..., 0:1] - cwx                                   # (..., K)
    dy = pose[..., 1:2] - cwy

    # NB: weights here cover in-bounds only; callers must still drop
    # invalid (occupied-center) cells.  trace_fast_mxu derives that from the
    # gathered rows themselves (invalid rows are all-zero) — a per-element
    # gather of rtex.valid would be one more pass over every beam row.
    wgt = wgt * in_bounds.astype(dtype)
    return rows, wgt, u, dx.astype(dtype), dy.astype(dtype)


def trace_fast_mxu(pose, tables: scan_ops.ScanTables, tmap: TrackMap,
                   rtex: RangeTexture, cfg: SimConfig, midx=None):
    """Matmul formulation of the fast scan: contiguous gathers + constant
    matmuls.

    Decompose every beam's theta coordinate u_b = s + c_b where s depends
    only on the agent pose and c_b = scan_angle_b * T/2pi is static:

      1. gather the 4 surrounding texture ROWS (contiguous slices — the fast
         XLA gather path) and blend them spatially (bilinear weights);
      2. circular-roll the blended theta row by the integer i_s = floor(s) —
         done EXACTLY in the DFT domain: one constant rfft matmul, a
         per-agent phase twiddle (2F trig values), and the inverse transform
         pre-fused with step 3's constant matrix;
      3. the per-beam theta gather on the rolled row has STATIC indices
         (kb_b + t) mod T, t in {0,1,2} — a constant one-hot matmul;
      4. linear theta interpolation = elementwise blend of the three
         shuffled copies with weights from alpha_b = frac(s) + frac(c_b).

    Identical interpolation semantics to trace_fast (bilinear x linear), up
    to DFT-roundtrip rounding, with no dynamic gathers beyond the row
    fetches.
    """
    t_bins = cfg.rt_theta_bins
    b_n = cfg.num_beams
    f_bins = t_bins // 2 + 1
    dtype = _compute_dtype(rtex)
    two_pi = 2.0 * math.pi
    n_chan = cfg.rt_channels
    eff_occ = cfg.rt_eff_occlusion
    rows, wgt, _, dx, dy = _cells_and_theta(pose, tables, tmap, rtex, cfg,
                                            midx)

    # per-agent theta decomposition (beam offsets enter via constant gmat)
    s = jnp.mod(pose[..., 2], two_pi) * (t_bins / two_pi)       # (...,)
    i_s = jnp.floor(s)
    f_s = (s - i_s).astype(dtype)
    i_i = i_s.astype(jnp.int32)
    # s can round up to exactly T (theta just under 2pi): wrap, don't clamp
    i_i = jnp.where(i_i >= t_bins, i_i - t_bins, i_i)

    rt2d = rtex.rt.reshape((-1, rtex.rt.shape[-1])) \
        if rtex.rt.ndim == 3 else rtex.rt
    assert rt2d.shape[-1] == n_chan * t_bins, (
        f"texture carries {rt2d.shape[-1] // t_bins} channels but the "
        f"config expects {n_chan} — rebuild the range texture with this "
        f"config (see SimConfig.rt_channels)")
    # indices are pre-clipped in _cells_and_theta: promise_in_bounds
    # drops XLA's clamp/select pass over the gather output
    rows_v = rt2d.at[rows].get(
        mode="promise_in_bounds")                        # (...,K,C*T)

    rr = rows_v[..., :t_bins]
    # cell validity from the rows themselves: invalid (occupied-center)
    # cells were zeroed at build time and valid rows are >= 1mm EVERYWHERE
    # (build-time floor), so column 0 alone carries validity — a 128-wide
    # max-reduce here would re-read the whole gather output
    cell_ok = rr[..., 0] > 0                                    # (..., K)
    wgt = wgt * cell_ok.astype(dtype)
    k_cells = wgt.shape[-1]
    if cfg.rt_spatial == "nearest":
        # single best valid cell: the theta row is a REAL marched scan from
        # one quantized pose, so occlusion edges never mix foreground and
        # background ranges spatially (see SimConfig.rt_spatial)
        wgt = jax.nn.one_hot(jnp.argmax(wgt, axis=-1), k_cells, dtype=dtype) \
            * (jnp.max(wgt, axis=-1, keepdims=True) > 0).astype(dtype)
    wsum = jnp.sum(wgt, axis=-1, keepdims=True)
    wnorm = wgt / jnp.maximum(wsum, jnp.asarray(1e-12, dtype))

    # ---- per-cell channel corrections (all (..., K, T) elementwise) ----
    off = t_bins
    e_rows = w_rows = None
    rr_c = rr.astype(dtype)
    if eff_occ == "edge":
        e_rows = rows_v[..., off:off + t_bins].astype(dtype)
        w_rows = rows_v[..., off + t_bins:off + 2 * t_bins].astype(dtype)
        off += 2 * t_bins
    if cfg.rt_grad:
        gxr = rows_v[..., off:off + t_bins].astype(dtype)
        gyr = rows_v[..., off + t_bins:off + 2 * t_bins].astype(dtype)
        # first-order range correction for the pose's offset from the cell
        # center: folds the gradient channels into the row BEFORE any
        # matmul — nearest1 reaches bilinear-class accuracy from one gather
        rr_c = jnp.clip(rr_c + dx[..., None] * gxr + dy[..., None] * gyr,
                        0.0, cfg.max_range)
    if eff_occ == "edge":
        # EXACT parallax: the visibility edge is a fixed world point (the
        # occluding corner).  Reconstruct it from the stored sub-bin angle e
        # and the foreground range, then recompute its bearing from the
        # actual pose — valid at any offset, unlike a first-order shift.
        # Gated by (1 - w): smooth pairs (w = 1) keep e = 0.5 exactly.
        dth = two_pi / t_bins
        theta_e = (jnp.arange(t_bins, dtype=dtype) + e_rows) * dth
        r_fore = jnp.maximum(
            jnp.minimum(rr, jnp.roll(rr, -1, axis=-1)).astype(dtype), 0.05)
        ex = r_fore * jnp.cos(theta_e) - dx[..., None]   # corner - pose
        ey = r_fore * jnp.sin(theta_e) - dy[..., None]
        beta = jnp.arctan2(ey, ex)
        dbeta = beta - theta_e
        dbeta = dbeta - jnp.round(dbeta / two_pi) * two_pi   # wrap [-pi, pi)
        e_rows = e_rows + (1.0 - w_rows) * dbeta / dth

    # ---- spatial blend (+ per-bin occlusion snap for bilinear) ----
    # explicit multiply-reduce (not dot_general) fuses with the gather;
    # a bfloat16 rows_v upcasts against the f32 weights right here
    def blend(v):
        return jnp.sum(v * wnorm[..., :, None], axis=-2)        # (..., T)

    blended = blend(rr_c)
    e_b = blend(e_rows) if e_rows is not None else None
    w_b = blend(w_rows) if w_rows is not None else None
    if eff_occ != "off" and k_cells > 1:
        # spatially mixing foreground and background cells across a
        # visibility edge is the same artifact as the theta lerp: where the
        # valid cells disagree by more than the edge threshold, take the
        # max-weight cell's value instead of the blend
        ok = wgt > 0
        big = jnp.asarray(1e9, dtype)
        vmax = jnp.max(jnp.where(ok[..., None], rr_c, -big), axis=-2)
        vmin = jnp.min(jnp.where(ok[..., None], rr_c, big), axis=-2)
        spread = vmax - vmin                                    # (..., T)
        snap = spread > cfg.rt_occlusion_cells * _cell_size(rtex, midx, dtype)
        best = jnp.argmax(wgt, axis=-1)[..., None, None]
        take_best = lambda v: jnp.take_along_axis(v, best, axis=-2)[..., 0, :]
        blended = jnp.where(snap, take_best(rr_c), blended)
        if e_b is not None:
            e_b = jnp.where(snap, take_best(e_rows), e_b)
            w_b = jnp.where(snap, take_best(w_rows), w_b)

    # ---- exact integer roll in the packed DFT domain + beam taps ----
    # NB: bf16 matmul INPUTS were measured at only +1.5% end-to-end while
    # costing ~5x compile time and extra contract error — the constant
    # matmuls stay full precision; only the rt STORAGE is bf16
    if e_b is not None:
        # aux channels ride the same roll/shuffle pipeline as extra rows
        blended = jnp.stack([blended, e_b, w_b], axis=-2)       # (..., 3, T)
    spec = jnp.matmul(blended, rtex.fmat,
                      preferred_element_type=dtype)             # (..., [3,] T)
    re, im = spec[..., :f_bins], spec[..., f_bins:]             # (...,F),(...,F-2)

    if cfg.scan_interp == "spectral":
        # full REAL-valued roll in the DFT phase; beams evaluated by one
        # constant (windowed) trig matrix — no per-beam elementwise tail.
        freqs = jnp.arange(f_bins, dtype=s.dtype)
        m = jnp.mod(freqs * s[..., None], float(t_bins))
        phi = m.astype(dtype) * (two_pi / t_bins)               # (..., F)
        cphi, sphi = jnp.cos(phi), jnp.sin(phi)
        zero = jnp.zeros_like(re[..., 0:1])
        im_full = jnp.concatenate([zero, im, zero], axis=-1)
        re_r = re * cphi - im_full * sphi
        im_r = (re * sphi + im_full * cphi)[..., 1:-1]
        spec_r = jnp.concatenate([re_r, im_r], axis=-1)         # (..., T)
        out = jnp.matmul(spec_r, rtex.smat,
                         preferred_element_type=dtype)          # (..., B)
        out = jnp.where(wsum[..., 0:1] > 0, out, 0.0)
        return jnp.clip(out, 0.0, cfg.max_range)

    # exact integer roll by i_i in the packed DFT domain.  Phases come from
    # integer modular arithmetic so f=T/2 lands on exactly {0, pi} and its
    # imaginary part stays (numerically) zero — the packed layout is closed
    # under integer-roll twiddles.
    m = jnp.mod(i_i[..., None] * jnp.arange(f_bins, dtype=jnp.int32), t_bins)
    phi = m.astype(dtype) * (two_pi / t_bins)                   # (..., F)
    cphi, sphi = jnp.cos(phi), jnp.sin(phi)
    if e_b is not None:
        cphi, sphi = cphi[..., None, :], sphi[..., None, :]
    zero = jnp.zeros_like(re[..., 0:1])
    im_full = jnp.concatenate([zero, im, zero], axis=-1)        # (..., F)
    re_r = re * cphi - im_full * sphi
    im_r = (re * sphi + im_full * cphi)[..., 1:-1]
    spec_r = jnp.concatenate([re_r, im_r], axis=-1)             # (..., [3,] T)

    c_frac = jnp.mod(tables.scan_angles * (t_bins / two_pi), 1.0).astype(dtype)

    if e_b is not None:
        # The edge render only ever selects taps 0/1 of the (e, w) channels
        # (the active pair's LEFT bin: `jnp.where(lt, g_e[:B], g_e[B:2B])`
        # below), so their shuffle matmul is narrowed to gmat's first 2B
        # columns, and — per rt_ew_dtype — runs in bfloat16: together this
        # cuts the post-shuffle tap intermediate from 9B f32 columns to
        # 3B f32 + 4B bf16 per row, the dominant device-memory traffic of
        # the XLA edge path.
        ew_dtype = _resolve_ew_dtype(cfg, dtype)
        g = jnp.matmul(spec_r[..., 0, :], rtex.gmat,
                       preferred_element_type=dtype)            # (..., 3B)
        g_ew = jnp.matmul(spec_r[..., 1:, :].astype(ew_dtype),
                          rtex.gmat[:, :2 * b_n].astype(ew_dtype),
                          preferred_element_type=dtype)
        # store the intermediate at ew_dtype (the convert fuses into the
        # matmul epilogue); consumers upcast on read
        g_ew = g_ew.astype(ew_dtype)
        g_e = g_ew[..., 0, :].astype(dtype)                     # (..., 2B)
        g_w = g_ew[..., 1, :].astype(dtype)
    else:
        g = jnp.matmul(spec_r, rtex.gmat,
                       preferred_element_type=dtype)            # (..., 3B)
    g0, g1, g2 = g[..., :b_n], g[..., b_n:2 * b_n], g[..., 2 * b_n:]

    alpha = f_s[..., None] + c_frac                              # (..., B) in [0,2)
    if eff_occ == "off":
        w0 = jnp.maximum(1.0 - alpha, 0.0)
        w2 = jnp.maximum(alpha - 1.0, 0.0)
        w1 = 1.0 - w0 - w2
        out = w0 * g0 + w1 * g1 + w2 * g2
    else:
        # active pair: taps (0,1) for alpha < 1, (1,2) otherwise; frac is
        # the within-pair coordinate (== frac of the gather variant's u)
        frac = alpha - jnp.floor(alpha)
        lt = alpha < 1.0
        ga = jnp.where(lt, g0, g1)
        gb = jnp.where(lt, g1, g2)
        if eff_occ == "snap":
            thr = cfg.rt_occlusion_cells * _cell_size(rtex, midx, dtype)
            lerp = ga + frac * (gb - ga)
            out = jnp.where(jnp.abs(gb - ga) > thr,
                            jnp.where(frac < 0.5, ga, gb), lerp)
        else:  # "edge": ramp through the stored (e, w) knots — a smooth
            # pair has (e, w) = (0.5, 1), which reduces EXACTLY to the lerp
            e_sel = jnp.clip(jnp.where(lt, g_e[..., :b_n],
                                       g_e[..., b_n:2 * b_n]), 0.0, 1.0)
            w_sel = jnp.clip(jnp.where(lt, g_w[..., :b_n],
                                       g_w[..., b_n:2 * b_n]),
                             1.0 / 32.0, 1.0)
            aa = jnp.clip((frac - (e_sel - 0.5 * w_sel)) / w_sel, 0.0, 1.0)
            out = ga + aa * (gb - ga)

    out = jnp.where(wsum[..., 0:1] > 0, out, 0.0)
    return jnp.clip(out, 0.0, cfg.max_range)


def _cell_size(rtex: RangeTexture, midx, dtype):
    """Texture cell size [m], broadcastable against (..., B)/(..., T)."""
    c = rtex.cell if midx is None else rtex.cell[midx]
    c = jnp.asarray(c, dtype)
    return c[..., None] if c.ndim else c


def trace_fast(pose, tables: scan_ops.ScanTables, tmap: TrackMap,
               rtex: RangeTexture, cfg: SimConfig, midx=None):
    """Scan via the range texture: pose (..., 3) -> (..., num_beams).

    Spatial blend over the surrounding texture cells (invalid cells dropped
    and weights renormalized) then linear/edge-aware interpolation over the
    2 neighboring theta bins — element-gather formulation.  Prefer
    trace_fast_mxu for speed; this variant is the readable definition both are
    tested against (same channel corrections: gradient fold, edge-parallax,
    (e, w) ramp rendering — see trace_fast_mxu).
    """
    t_bins = cfg.rt_theta_bins
    n_chan = cfg.rt_channels
    eff_occ = cfg.rt_eff_occlusion
    two_pi = 2.0 * math.pi
    dtype = _compute_dtype(rtex)
    rows, wgt, u, dx, dy = _cells_and_theta(pose, tables, tmap, rtex, cfg,
                                            midx)
    assert rtex.rt.shape[-1] == n_chan * t_bins, (
        f"texture carries {rtex.rt.shape[-1] // t_bins} channels but the "
        f"config expects {n_chan} — rebuild the range texture")
    wgt = wgt * jnp.take(rtex.valid.reshape((-1,)), rows).astype(dtype)
    k_cells = wgt.shape[-1]
    if cfg.rt_spatial == "nearest":
        wgt = jax.nn.one_hot(jnp.argmax(wgt, axis=-1), k_cells, dtype=dtype) \
            * (jnp.max(wgt, axis=-1, keepdims=True) > 0).astype(dtype)
    wsum = jnp.sum(wgt, axis=-1, keepdims=True)
    wnorm = wgt / jnp.maximum(wsum, jnp.asarray(1e-12, dtype))

    i0 = jnp.floor(u).astype(jnp.int32) % t_bins
    i1 = (i0 + 1) % t_bins
    a = (u - jnp.floor(u)).astype(dtype)                         # (..., B)

    rt_flat = rtex.rt.reshape((-1,))
    row_w = n_chan * t_bins

    def gath(chan, ibin):
        """Channel value at theta bin ibin for every cell: (..., K, B)."""
        flat = rows[..., :, None] * row_w + chan * t_bins + ibin[..., None, :]
        return jnp.take(rt_flat, flat).astype(dtype)

    r0 = gath(0, i0)
    r1 = gath(0, i1)
    chan = 1
    if eff_occ == "edge":
        e0 = gath(chan, i0)
        w0 = gath(chan + 1, i0)
        chan += 2
    if cfg.rt_grad:
        r0 = jnp.clip(r0 + dx[..., None] * gath(chan, i0)
                      + dy[..., None] * gath(chan + 1, i0), 0.0, cfg.max_range)
        r1 = jnp.clip(r1 + dx[..., None] * gath(chan, i1)
                      + dy[..., None] * gath(chan + 1, i1), 0.0, cfg.max_range)
    if eff_occ == "edge":
        # exact corner-bearing parallax (same formula as the matmul row stage,
        # evaluated at bin i0 only — the active pair's left)
        dth = two_pi / t_bins
        theta_e = (i0[..., None, :].astype(dtype) + e0) * dth
        r_fore = jnp.maximum(jnp.minimum(gath(0, i0), gath(0, i1)), 0.05)
        ex = r_fore * jnp.cos(theta_e) - dx[..., None]
        ey = r_fore * jnp.sin(theta_e) - dy[..., None]
        beta = jnp.arctan2(ey, ex)
        dbeta = beta - theta_e
        dbeta = dbeta - jnp.round(dbeta / two_pi) * two_pi
        e0 = e0 + (1.0 - w0) * dbeta / dth

    def blend(v):
        return jnp.sum(v * wnorm[..., :, None], axis=-2)         # (..., B)

    v0b, v1b = blend(r0), blend(r1)
    e0b = blend(e0) if eff_occ == "edge" else None
    w0b = blend(w0) if eff_occ == "edge" else None
    if eff_occ != "off" and k_cells > 1:
        # per-bin spatial occlusion snap, mirroring the matmul variant
        thr = cfg.rt_occlusion_cells * _cell_size(rtex, midx, dtype)
        ok = wgt[..., None] > 0
        big = jnp.asarray(1e9, dtype)
        best = jnp.argmax(wgt, axis=-1)[..., None, None]
        tb = lambda v: jnp.take_along_axis(v, best, axis=-2)[..., 0, :]

        def snap_blend(v, vb):
            spread = jnp.max(jnp.where(ok, v, -big), axis=-2) \
                - jnp.min(jnp.where(ok, v, big), axis=-2)
            return jnp.where(spread > thr, tb(v), vb), spread > thr

        v0b, s0 = snap_blend(r0, v0b)
        v1b, _ = snap_blend(r1, v1b)
        if e0b is not None:
            e0b = jnp.where(s0, tb(e0), e0b)
            w0b = jnp.where(s0, tb(w0), w0b)

    if eff_occ == "off":
        out = v0b * (1 - a) + v1b * a
    elif eff_occ == "snap":
        thr = cfg.rt_occlusion_cells * _cell_size(rtex, midx, dtype)
        lerp = v0b + a * (v1b - v0b)
        out = jnp.where(jnp.abs(v1b - v0b) > thr,
                        jnp.where(a < 0.5, v0b, v1b), lerp)
    else:  # "edge"
        e_sel = jnp.clip(e0b, 0.0, 1.0)
        w_sel = jnp.clip(w0b, 1.0 / 32.0, 1.0)
        aa = jnp.clip((a - (e_sel - 0.5 * w_sel)) / w_sel, 0.0, 1.0)
        out = v0b + aa * (v1b - v0b)

    # outside the texture / inside walls: fall back to 0 (collided anyway)
    out = jnp.where(wsum[..., 0:1] > 0, out, 0.0)
    return jnp.clip(out, 0.0, cfg.max_range)
