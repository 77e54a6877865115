"""2D lidar scan simulation: vectorized sphere marching on the map EDT.

The reference marches each of the 1080 beams in a serial Numba loop with
data-dependent trip count (reference: gym/f110_gym/envs/laser_models.py:
107-186).  Here every beam of every car of every env marches in lockstep:
the state is a (batch..., beams) front of ray tips, one march iteration is a
gather from the distance-transform texture plus two fused FMAs,
and the loop runs as `lax.while_loop` until every ray in the batch has
terminated (or a fixed `fori_loop` budget when a static schedule is
preferred).  The arithmetic sequence per beam is identical to the reference,
so float64 runs are bit-exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from red_gym_tpu.config import SimConfig
from red_gym_tpu.maps.loader import TrackMap


class ScanTables(NamedTuple):
    """Static per-config lidar tables, precomputed on host in float64.

    Mirrors the reference's precomputes: the theta-discretization sin/cos
    tables (laser_models.py:378-381) and the per-beam angles / cosines /
    car-edge distances (base_classes.py:116-156).
    """

    sines: jnp.ndarray           # (theta_dis,)
    cosines: jnp.ndarray         # (theta_dis,)
    scan_angles: jnp.ndarray     # (num_beams,) beam angle in body frame
    beam_cosines: jnp.ndarray    # (num_beams,) cos(scan_angles)
    beam_sines: jnp.ndarray      # (num_beams,) sin(scan_angles)
    side_distances: jnp.ndarray  # (num_beams,) lidar->car-edge distance


def build_tables(cfg: SimConfig, width: float, length: float,
                 dtype=None) -> ScanTables:
    """Host-side float64 precompute (numpy, matching reference bit-for-bit)."""
    dtype = dtype or cfg.jdtype
    theta_arr = np.linspace(0.0, 2 * np.pi, num=cfg.theta_dis)
    sines = np.sin(theta_arr)
    cosines = np.cos(theta_arr)

    incr = cfg.fov / (cfg.num_beams - 1)
    angles = -cfg.fov / 2.0 + np.arange(cfg.num_beams) * incr
    beam_cos = np.cos(angles)
    beam_sin = np.sin(angles)

    # distance from the lidar (car center) to the body edge along each beam
    # (reference base_classes.py:127-156, quadrant-literal formulas kept)
    dist_sides = width / 2.0
    dist_fr = length / 2.0
    with np.errstate(divide="ignore"):
        to_side = np.where(
            angles > 0,
            np.where(angles < np.pi / 2,
                     dist_sides / np.sin(angles),
                     dist_sides / np.cos(angles - np.pi / 2)),
            np.where(angles > -np.pi / 2,
                     dist_sides / np.sin(-angles),
                     dist_sides / np.cos(-angles - np.pi / 2)),
        )
        to_fr = np.where(
            angles > 0,
            np.where(angles < np.pi / 2,
                     dist_fr / np.cos(angles),
                     dist_fr / np.sin(angles - np.pi / 2)),
            np.where(angles > -np.pi / 2,
                     dist_fr / np.cos(-angles),
                     dist_fr / np.sin(-angles - np.pi / 2)),
        )
    side_distances = np.minimum(to_side, to_fr)

    return ScanTables(
        sines=jnp.asarray(sines, dtype=dtype),
        cosines=jnp.asarray(cosines, dtype=dtype),
        scan_angles=jnp.asarray(angles, dtype=dtype),
        beam_cosines=jnp.asarray(beam_cos, dtype=dtype),
        beam_sines=jnp.asarray(beam_sin, dtype=dtype),
        side_distances=jnp.asarray(side_distances, dtype=dtype),
    )


def map_scalars(tmap: TrackMap, midx=None):
    """Per-map scalar fields, selected by map index when the TrackMap
    carries a leading map axis shared by many envs (copy-free multi-map)."""
    if midx is None:
        return (tmap.orig_x, tmap.orig_y, tmap.orig_c, tmap.orig_s,
                tmap.resolution, tmap.height, tmap.width)
    return (tmap.orig_x[midx], tmap.orig_y[midx], tmap.orig_c[midx],
            tmap.orig_s[midx], tmap.resolution[midx], tmap.height[midx],
            tmap.width[midx])


def dt_lookup(x, y, tmap: TrackMap, midx=None):
    """Gather the distance-to-obstacle at world point(s) (x, y).

    Replicates reference xy_2_rc semantics (laser_models.py:56-104) including
    the out-of-bounds quirk: OOB points read dt[-1, -1] (numpy wraps the -1
    sentinel to the last cell).  With ``midx`` (scalar map index) and a
    (M, H, W) stacked dt, the lookup is offset into the flat texture — many
    envs share M maps with no per-env copies.
    """
    ox, oy, oc, osn, res, height, width = map_scalars(tmap, midx)
    x_trans = x - ox
    y_trans = y - oy
    x_rot = x_trans * oc + y_trans * osn
    y_rot = -x_trans * osn + y_trans * oc

    w_m = width.astype(x_rot.dtype) * res
    h_m = height.astype(y_rot.dtype) * res
    oob = (x_rot < 0) | (x_rot >= w_m) | (y_rot < 0) | (y_rot >= h_m)

    c = (x_rot / res).astype(jnp.int32)
    r = (y_rot / res).astype(jnp.int32)
    full_h, full_w = tmap.dt.shape[-2], tmap.dt.shape[-1]
    r = jnp.where(oob, height - 1, jnp.clip(r, 0, full_h - 1))
    c = jnp.where(oob, width - 1, jnp.clip(c, 0, full_w - 1))

    idx = r * full_w + c
    if midx is not None:
        flat = tmap.dt.reshape((-1,))
        return jnp.take(flat, midx * (full_h * full_w) + idx)
    flat = tmap.dt.reshape(tmap.dt.shape[:-2] + (-1,))
    return jnp.take(flat, idx, axis=-1)


def beam_theta_indices(pose_theta, cfg: SimConfig):
    """Discretized theta-table index for every beam of a pose (..., ) ->
    int32 (..., num_beams).  Vectorized form of the reference's wrap-as-you-go
    accumulation (laser_models.py:166-184)."""
    theta_dis = cfg.theta_dis
    inc = theta_dis * (cfg.fov / (cfg.num_beams - 1)) / (2.0 * np.pi)
    t0 = theta_dis * (pose_theta - cfg.fov / 2.0) / (2.0 * np.pi)
    t0 = jnp.mod(t0, float(theta_dis))  # jnp.mod result is already >= 0
    ti = t0[..., None] + inc * jnp.arange(cfg.num_beams, dtype=pose_theta.dtype)
    ti = jnp.mod(ti, float(theta_dis))
    return ti.astype(jnp.int32)


def march(x, y, c, s, tmap: TrackMap, cfg: SimConfig, midx=None):
    """Sphere march from points (x, y) along directions (c, s), all same
    shape.  Arithmetic identical to reference trace_ray
    (laser_models.py:107-146): step the full safe distance until within eps
    of an obstacle or beyond max_range, then clamp to max_range."""
    d = dt_lookup(x, y, tmap, midx)
    total = d

    eps = jnp.asarray(cfg.eps, d.dtype)
    max_range = jnp.asarray(cfg.max_range, d.dtype)

    def active_mask(d, total):
        return (d > eps) & (total <= max_range)

    def body(carry):
        x, y, d, total, _ = carry
        act = active_mask(d, total)
        x = jnp.where(act, x + d * c, x)
        y = jnp.where(act, y + d * s, y)
        d_new = dt_lookup(x, y, tmap, midx)
        d = jnp.where(act, d_new, d)
        total = jnp.where(act, total + d_new, total)
        return x, y, d, total, jnp.any(active_mask(d, total))

    if cfg.march_iters > 0:
        carry = (x, y, d, total, jnp.array(True))
        carry = lax.fori_loop(0, cfg.march_iters, lambda i, cr: body(cr), carry)
        total = carry[3]
    else:
        carry = (x, y, d, total, jnp.any(active_mask(d, total)))
        carry = lax.while_loop(lambda cr: cr[4], body, carry)
        total = carry[3]

    return jnp.minimum(total, max_range)


def trace(pose, tables: ScanTables, tmap: TrackMap, cfg: SimConfig,
          midx=None):
    """Noiseless scan for pose(s) (..., 3) -> (..., num_beams) via the
    theta-discretized beam table (reference get_scan, laser_models.py:
    149-186).  ``midx``: optional per-pose map index into a stacked map."""
    idx = beam_theta_indices(pose[..., 2], cfg)
    c = jnp.take(tables.cosines, idx)
    s = jnp.take(tables.sines, idx)

    shape = idx.shape
    x = jnp.broadcast_to(pose[..., 0:1], shape)
    y = jnp.broadcast_to(pose[..., 1:2], shape)
    if midx is not None:
        midx = jnp.broadcast_to(jnp.asarray(midx)[..., None], shape)
    return march(x, y, c, s, tmap, cfg, midx)


def trace_angles(origins, angles, tmap: TrackMap, cfg: SimConfig):
    """Scan at exact world angles (no theta-table discretization).

    origins (..., 2), angles (A,) -> (..., A).  Used to precompute the fast
    range texture."""
    c = jnp.cos(angles)
    s = jnp.sin(angles)
    shape = origins.shape[:-1] + angles.shape
    x = jnp.broadcast_to(origins[..., 0:1], shape)
    y = jnp.broadcast_to(origins[..., 1:2], shape)
    c = jnp.broadcast_to(c, shape)
    s = jnp.broadcast_to(s, shape)
    return march(x, y, c, s, tmap, cfg)


def scan(pose, key, tables: ScanTables, tmap: TrackMap, cfg: SimConfig):
    """Scan with gaussian beam noise (reference laser_models.py:429-454).

    ``key`` may be None for a noiseless scan.  Matching the reference's
    all-cars-share-one-seed quirk (base_classes.py:117,202) is the caller's
    choice of key: the env steps fold the step counter into one per-env key
    and broadcast the same noise to every agent.
    """
    out = trace(pose, tables, tmap, cfg)
    if key is not None and cfg.scan_noise_std > 0:
        out = out + cfg.scan_noise_std * jax.random.normal(key, out.shape, out.dtype)
    return out
