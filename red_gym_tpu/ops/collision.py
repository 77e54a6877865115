"""Vehicle body geometry and pairwise collision checks.

The reference uses an iterative GJK overlap test ported from kroitor/gjk.c
(reference: gym/f110_gym/envs/collision_models.py:34-212) inside a Python
O(N^2) double loop.  GJK's data-dependent while-loop is hostile to XLA, and
for two convex quads the separating-axis theorem (SAT) gives the identical
boolean answer with a fixed amount of branch-free arithmetic — so the
design here is an all-pairs SAT evaluated as one fused broadcast over
(env, pair, axis) with no loops at all.

Semantics notes for parity with the reference GJK:
  * bodies that merely touch (zero-measure contact) count as NOT colliding,
    matching GJK's ``d.dot(a) <= 0 -> False`` early-outs;
  * ``collision_idx[k]`` is the *largest-index* colliding partner of body k
    (the reference's loop-ordering overwrite behavior,
    collision_models.py:199-210), or -1.
"""

from __future__ import annotations

import jax.numpy as jnp


def get_vertices(pose, length, width):
    """Body corners [rear-left, rear-right, front-right, front-left].

    Vectorized equivalent of the homogeneous-transform routine
    (reference: collision_models.py:218-260); pose (..., 3) -> (..., 4, 2).
    """
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    c, s = jnp.cos(th), jnp.sin(th)
    hl, hw = length / 2.0, width / 2.0

    # local corner offsets in the reference's ordering
    lx = jnp.stack([-hl, -hl, hl, hl], axis=-1)   # (..., 4)
    ly = jnp.stack([hw, -hw, -hw, hw], axis=-1)
    wx = x[..., None] + c[..., None] * lx - s[..., None] * ly
    wy = y[..., None] + s[..., None] * lx + c[..., None] * ly
    return jnp.stack([wx, wy], axis=-1)


def _project_interval(verts, axis):
    """Min/max of vertices (..., 4, 2) projected on axis (..., 2)."""
    proj = jnp.einsum("...vk,...k->...v", verts, axis)
    return proj.min(axis=-1), proj.max(axis=-1)


def collision(verts1, verts2):
    """SAT overlap test for two convex quads (..., 4, 2) -> bool (...).

    GJK-equivalent boolean (reference: collision_models.py:113-182): True iff
    the interiors intersect.  Touching contact counts as no collision.
    """
    # candidate separating axes: edge normals of both bodies (8 per pair)
    def edge_normals(v):
        e = jnp.roll(v, -1, axis=-2) - v                      # (..., 4, 2)
        return jnp.stack([-e[..., 1], e[..., 0]], axis=-1)    # perpendicular

    axes = jnp.concatenate([edge_normals(verts1), edge_normals(verts2)], axis=-2)

    p1 = jnp.einsum("...vk,...ak->...av", verts1, axes)       # (..., 8, 4)
    p2 = jnp.einsum("...vk,...ak->...av", verts2, axes)
    separated = (p1.max(-1) <= p2.min(-1)) | (p2.max(-1) <= p1.min(-1))  # per axis
    return ~jnp.any(separated, axis=-1)


def _obb_overlap(pose1, pose2, hl1, hw1, hl2, hw2):
    """Rectangle-vs-rectangle SAT directly from poses — no vertex tensors.

    The general quad SAT above broadcasts (..., pair, 8 axes, 4 verts)
    einsums whose tiny trailing dims pad badly on accelerator tile layouts.
    For
    rectangles only 4 distinct axes exist and every projection has a closed
    form, so the whole test is ~30 scalar elementwise ops that fuse into
    the step's other (E, A) arithmetic.  Boolean semantics identical to
    `collision` (touching = separated = no hit).

    pose* (..., 3); h* half extents (length/2, width/2), broadcastable.
    """
    dx = pose2[..., 0] - pose1[..., 0]
    dy = pose2[..., 1] - pose1[..., 1]
    c1, s1 = jnp.cos(pose1[..., 2]), jnp.sin(pose1[..., 2])
    c2, s2 = jnp.cos(pose2[..., 2]), jnp.sin(pose2[..., 2])

    # |cos/sin of the relative heading| = all four |axis . axis| dot products
    a_uu = jnp.abs(c1 * c2 + s1 * s2)    # |u1.u2| = |w1.w2|
    a_uw = jnp.abs(s1 * c2 - c1 * s2)    # |u1.w2| = |w1.u2|

    sep = ((jnp.abs(dx * c1 + dy * s1) >= hl1 + hl2 * a_uu + hw2 * a_uw)
           | (jnp.abs(-dx * s1 + dy * c1) >= hw1 + hl2 * a_uw + hw2 * a_uu)
           | (jnp.abs(dx * c2 + dy * s2) >= hl2 + hl1 * a_uu + hw1 * a_uw)
           | (jnp.abs(-dx * s2 + dy * c2) >= hw2 + hl1 * a_uw + hw1 * a_uu))
    return ~sep


def pairwise_hits_from_poses(poses, length, width):
    """Per-agent body-collision flags straight from poses (A, 3) -> bool (A,).

    The env hot path needs only "does agent i overlap anyone" — not the
    partner index — so agents are paired by rolling the pose array
    (ceil((A-1)/2) rectangle-SAT passes, each shared by both ends of the
    pair) instead of materializing the (A, A, 8, 4) projection tensors of
    `collision_multiple`.  length/width scalars or (A,) per-agent.
    """
    a_n = poses.shape[0]
    hl = jnp.broadcast_to(length / 2.0, (a_n,))
    hw = jnp.broadcast_to(width / 2.0, (a_n,))
    if a_n <= 4:
        # rolled passes: fuses into the step's other (E, A) elementwise
        # arithmetic at the common racing sizes
        hits = jnp.zeros((a_n,), bool)
        for k in range(1, a_n // 2 + 1):
            other = jnp.roll(poses, -k, axis=0)
            hl2 = jnp.roll(hl, -k)
            hw2 = jnp.roll(hw, -k)
            o = _obb_overlap(poses, other, hl, hw, hl2, hw2)
            hits = hits | o
            if not (a_n % 2 == 0 and k == a_n // 2):
                # agent (i+k) collides with i too; the even-A middle pass
                # already sees each pair from both sides
                hits = hits | jnp.roll(o, k)
        return hits
    # batched (K, A) roll axis for larger fields: program size stays O(1)
    # in A (the unrolled form traced ceil((A-1)/2) passes — compile time,
    # not runtime, was the cost at A=8-16)
    ks = jnp.arange(1, a_n // 2 + 1)                        # (K,)
    idx = (jnp.arange(a_n)[None, :] + ks[:, None]) % a_n    # (K, A)
    o = _obb_overlap(poses[None], poses[idx], hl[None], hw[None],
                     hl[idx], hw[idx])                      # (K, A) bool
    hits = jnp.any(o, axis=0)
    # scatter each pass's hits back onto the partner (i+k); the even-A
    # middle pass pairs i with i+A/2 symmetrically and must not double in
    o_back = o if a_n % 2 != 0 else o[:-1]
    ks_back = ks if a_n % 2 != 0 else ks[:-1]
    # o_back is never empty here: this path runs only for a_n > 4, where
    # ks has >= 2 entries and at most one (the symmetric middle pass) is
    # dropped
    idx_back = (jnp.arange(a_n)[None, :] + ks_back[:, None]) % a_n
    back = jnp.zeros((a_n,), bool).at[idx_back.reshape(-1)].max(
        o_back.reshape(-1))
    return hits | back


def collision_multiple(vertices):
    """All-pairs collision over bodies (..., N, 4, 2).

    Returns (collisions (..., N) float, collision_idx (..., N) float) with the
    reference's output conventions (collision_models.py:184-212).
    """
    n = vertices.shape[-3]
    vi = vertices[..., :, None, :, :]   # (..., N, 1, 4, 2)
    vj = vertices[..., None, :, :, :]   # (..., 1, N, 4, 2)
    hits = collision(jnp.broadcast_to(vi, vi.shape[:-4] + (n, n, 4, 2)),
                     jnp.broadcast_to(vj, vj.shape[:-4] + (n, n, 4, 2)))
    eye = jnp.eye(n, dtype=bool)
    hits = hits & ~eye                  # ignore self-pairs

    any_hit = jnp.any(hits, axis=-1)
    idx = jnp.arange(n)
    partner = jnp.max(jnp.where(hits, idx, -1), axis=-1)
    collisions = any_hit.astype(vertices.dtype)
    collision_idx = jnp.where(any_hit, partner, -1).astype(vertices.dtype)
    return collisions, collision_idx
