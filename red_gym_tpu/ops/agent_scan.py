"""Scan post-processing against other agents: iTTC and opponent ray casting.

Reference: gym/f110_gym/envs/laser_models.py:188-346.  The reference narrows
the opponent ray cast to an argmin-derived index window and mutates the scan
in place per opponent; here every beam x edge intersection is computed in one
fused broadcast and the window becomes a mask, which keeps shapes static and
the whole thing vmappable over (env, agent, opponent).  Results are
beam-for-beam identical because min-accumulation over opponents is
order-independent.
"""

from __future__ import annotations

import jax.numpy as jnp

from red_gym_tpu.ops.scan import ScanTables


def check_ttc(scan, vel, tables: ScanTables, ttc_thresh):
    """Instantaneous time-to-collision wall check.

    Vectorized min-reduce form of reference check_ttc_jit
    (laser_models.py:188-217): collision iff any beam's
    (range - side_distance) / (v * cos(angle)) lands in [0, thresh).
    The quotient test is evaluated in multiplied-out form — sign-split on
    the denominator — so the hot path carries no per-beam division.
    scan (..., B), vel (...) -> bool (...).
    """
    proj_vel = vel[..., None] * tables.beam_cosines
    num = scan - tables.side_distances
    hit = jnp.where(proj_vel > 0,
                    (num >= 0) & (num < ttc_thresh * proj_vel),
                    (proj_vel < 0) & (num <= 0) & (num > ttc_thresh * proj_vel))
    return jnp.any(hit, axis=-1) & (vel != 0.0)


def _wrap_pi(a):
    """Wrap to (-pi, pi] with the reference's single-correction form
    (laser_models.py:304-307)."""
    a = jnp.where(a > jnp.pi, a - 2 * jnp.pi, a)
    a = jnp.where(a < -jnp.pi, a + 2 * jnp.pi, a)
    return a


def get_range(pose, beam_theta, va, vb):
    """Distance from pose along world angle beam_theta to segment va->vb.

    Branch-free form of reference get_range (laser_models.py:250-280),
    including the collinear fallback.  All args broadcast.
    """
    o = pose[..., 0:2]
    v1 = o - va
    v2 = vb - va
    v3 = jnp.stack([jnp.cos(beam_theta + jnp.pi / 2.0),
                    jnp.sin(beam_theta + jnp.pi / 2.0)], axis=-1)

    denom = jnp.sum(v2 * v3, axis=-1)
    d1 = (v2[..., 0] * v1[..., 1] - v2[..., 1] * v1[..., 0]) / denom
    d2 = jnp.sum(v1 * v3, axis=-1) / denom
    valid = (jnp.abs(denom) > 0.0) & (d1 >= 0.0) & (d2 >= 0.0) & (d2 <= 1.0)

    # collinear fallback (only reachable when denom == 0)
    ba = vb - va
    ca = va - o
    cross = ba[..., 0] * ca[..., 1] - ba[..., 1] * ca[..., 0]
    collinear = (jnp.abs(denom) <= 0.0) & (jnp.abs(cross) < 1e-8)
    d_col = jnp.minimum(jnp.linalg.norm(va - o, axis=-1),
                        jnp.linalg.norm(vb - o, axis=-1))

    inf = jnp.asarray(jnp.inf, d1.dtype)
    return jnp.where(valid, d1, jnp.where(collinear, d_col, inf))


def blocked_view_window(pose, vertices, tables: ScanTables):
    """(lo, hi) int32 beam-index window blocked by an opponent body.

    The arithmetic core of reference get_blocked_view_indices
    (laser_models.py:283-315): the four pose->vertex bearings snapped to
    the uniform beam grid; the reference's argmin over all beams becomes a
    round.  pose (..., 3), vertices (..., 4, 2) -> ((...,), (...,)).
    """
    vecs = vertices - pose[..., None, 0:2]
    unit_angle = jnp.arctan2(vecs[..., 1], vecs[..., 0])          # (..., 4)
    ego_angle = jnp.arctan2(jnp.sin(pose[..., 2]), jnp.cos(pose[..., 2]))
    rel = _wrap_pi(ego_angle[..., None] - unit_angle)
    bearings = -rel                                               # (..., 4)

    n_b = tables.scan_angles.shape[0]
    a0 = tables.scan_angles[0]
    incr = (tables.scan_angles[-1] - a0) / (n_b - 1)
    inds = jnp.clip(jnp.round((bearings - a0) / incr), 0, n_b - 1)
    inds = inds.astype(jnp.int32)                                 # (..., 4)
    return jnp.min(inds, axis=-1), jnp.max(inds, axis=-1)


def blocked_view_mask(pose, vertices, tables: ScanTables):
    """Beam mask [min_ind, max_ind] blocked by an opponent body (boolean
    form of blocked_view_window).  pose (..., 3), vertices (..., 4, 2)
    -> bool (..., B)."""
    lo, hi = blocked_view_window(pose, vertices, tables)
    beam_idx = jnp.arange(tables.scan_angles.shape[0])
    return (beam_idx >= lo[..., None]) & (beam_idx <= hi[..., None])


def beam_dirs(pose_theta, tables: ScanTables):
    """World-frame unit direction of every beam: (...,) -> (..., B, 2).

    Angle addition against the static per-beam sin/cos tables — two
    transcendentals per agent instead of two per beam."""
    ct, st = jnp.cos(pose_theta)[..., None], jnp.sin(pose_theta)[..., None]
    dx = ct * tables.beam_cosines - st * tables.beam_sines
    dy = st * tables.beam_cosines + ct * tables.beam_sines
    return jnp.stack([dx, dy], axis=-1)


def _slab(o_u, o_w, d_u, d_w, hu, hw):
    """Ray-vs-OBB slab intersection in the opponent's body frame.

    Origin (o_u, o_w) and direction (d_u, d_w) in box axes, half extents
    (hu, hw); returns the nonnegative ray parameter of the hit or +inf.
    Equivalent to the min over the reference's four per-edge intersections
    (laser_models.py:250-346) with a fixed cost of two divisions per beam
    and no edge axis at all.
    """
    inf = jnp.asarray(jnp.inf, d_u.dtype)

    def axis(o, d, h):
        inv = 1.0 / d
        t1 = (-h - o) * inv
        t2 = (h - o) * inv
        near = jnp.minimum(t1, t2)
        far = jnp.maximum(t1, t2)
        # parallel beam: inside the slab -> (-inf, inf), outside -> miss.
        # (also rescues the 0 * inf = NaN case, which only arises here)
        par = d == 0.0
        inside = jnp.abs(o) <= h
        near = jnp.where(par, jnp.where(inside, -inf, inf), near)
        far = jnp.where(par, jnp.where(inside, inf, -inf), far)
        return near, far

    near_u, far_u = axis(o_u, d_u, hu)
    near_w, far_w = axis(o_w, d_w, hw)
    tmin = jnp.maximum(near_u, near_w)
    tmax = jnp.minimum(far_u, far_w)
    hit = (tmax >= tmin) & (tmax >= 0.0)
    t = jnp.where(tmin >= 0.0, tmin, tmax)   # from inside: exit distance
    return jnp.where(hit, t, inf)


def ray_cast_opponent(pose, scan, vertices, tables: ScanTables, dirs=None):
    """Shorten scan beams blocked by one opponent rectangle.

    Reference ray_cast (laser_models.py:319-346): within the blocked window,
    each beam takes the min over its current range and the body intersection
    (slab form — same geometry as the reference's 4 per-edge tests).
    pose (..., 3), scan (..., B), vertices (..., 4, 2).  Pass precomputed
    ``dirs`` = beam_dirs(pose_theta) to share them across opponents.
    """
    mask = blocked_view_mask(pose, vertices, tables)
    if dirs is None:
        dirs = beam_dirs(pose[..., 2], tables)            # (..., B, 2)

    # opponent box frame from its corners (get_vertices ordering:
    # [rear-left, rear-right, front-right, front-left])
    center = jnp.mean(vertices, axis=-2)                   # (..., 2)
    e_l = vertices[..., 3, :] - vertices[..., 0, :]        # length axis
    e_w = vertices[..., 0, :] - vertices[..., 1, :]        # width axis
    len_l = jnp.linalg.norm(e_l, axis=-1, keepdims=True)
    len_w = jnp.linalg.norm(e_w, axis=-1, keepdims=True)
    u = e_l / len_l
    w = e_w / len_w
    hu = 0.5 * len_l                                       # (..., 1)
    hw = 0.5 * len_w

    o = pose[..., 0:2] - center                            # (..., 2)
    o_u = jnp.sum(o * u, axis=-1, keepdims=True)           # (..., 1)
    o_w = jnp.sum(o * w, axis=-1, keepdims=True)
    d_u = dirs[..., 0] * u[..., 0:1] + dirs[..., 1] * u[..., 1:2]  # (..., B)
    d_w = dirs[..., 0] * w[..., 0:1] + dirs[..., 1] * w[..., 1:2]

    t = _slab(o_u, o_w, d_u, d_w, hu, hw)                  # (..., B)
    return jnp.where(mask, jnp.minimum(scan, t), scan)


def ray_cast_all_opponents(poses, scans, all_vertices, tables: ScanTables):
    """Apply opponent ray casting for every agent against every other agent.

    poses (A, 3), scans (A, B), all_vertices (A, 4, 2) -> (A, B).
    Equivalent to the reference's sequential per-opponent loop
    (base_classes.py:204-225) because min-accumulation commutes.  Opponents
    are paired by rolling the vertex array A-1 times: A(A-1) beam-sized
    evaluations, no self-pair waste, shared beam directions.
    """
    num_agents = poses.shape[0]
    if num_agents == 1:
        return scans
    dirs = beam_dirs(poses[..., 2], tables)                # (A, B, 2)
    if num_agents <= 4:
        # the rolled sequential form traces A-1 passes; at small A it fuses
        # into fewer/larger kernels than the batched form and measured
        # slightly faster — keep it for the common racing configs
        out = scans
        for k in range(1, num_agents):
            verts_k = jnp.roll(all_vertices, -k, axis=0)   # opponent (i+k)%A
            out = ray_cast_opponent(poses, out, verts_k, tables, dirs)
        return out
    # batched (A-1, A, ...) opponent axis: ONE ray_cast_opponent evaluation
    # with the min-reduce over opponents — program size stays O(1) in A
    # instead of A-1 traced passes (compile time at A=8-16), same
    # arithmetic, same result because min-accumulation commutes.
    idx = (jnp.arange(num_agents)[None, :]
           + jnp.arange(1, num_agents)[:, None]) % num_agents  # (A-1, A)
    verts_k = all_vertices[idx]                            # (A-1, A, 4, 2)
    inf_scan = jnp.full_like(scans, jnp.inf)
    t_all = ray_cast_opponent(poses[None], inf_scan[None], verts_k, tables,
                              dirs[None])                  # (A-1, A, B)
    return jnp.minimum(scans, jnp.min(t_all, axis=0))
