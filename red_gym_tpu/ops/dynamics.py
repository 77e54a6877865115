"""Single-track vehicle dynamics, input constraints and the low-level PID map.

An on-device re-expression of the reference Numba kernels
(reference: gym/f110_gym/envs/dynamic_models.py:29-221).  Everything here is
pure, branch-free jnp that broadcasts over arbitrary leading batch axes
(env, agent): the conditional branches of the reference become `jnp.where`
selects so one fused XLA kernel evaluates the right-hand side for an entire
fleet of cars at once.

State layout (reference: base_classes.py:95):
    ``x = [x, y, steer_angle, vel, yaw_angle, yaw_rate, slip_angle]``
Control layout: ``u = [steering_velocity, longitudinal_acceleration]``.
"""

from __future__ import annotations

import jax.numpy as jnp

from red_gym_tpu.config import VehicleParams

G = 9.81


def accl_constraints(vel, accl, v_switch, a_max, v_min, v_max):
    """Acceleration limits incl. the wheel-spin power cap above ``v_switch``.

    Branch-free equivalent of reference dynamic_models.py:29-60: first the
    clamp to ``[-a_max, pos_limit]``, then the hard zero when pushing against
    a velocity bound.
    """
    above_switch = vel > v_switch
    vel_safe = jnp.where(above_switch, vel, 1.0)  # keep the untaken lane's grad finite
    pos_limit = jnp.where(above_switch, a_max * v_switch / vel_safe, a_max)
    clamped = jnp.clip(accl, -a_max, pos_limit)
    pinned = ((vel <= v_min) & (accl <= 0.0)) | ((vel >= v_max) & (accl >= 0.0))
    return jnp.where(pinned, 0.0, clamped)


def steering_constraint(steering_angle, steering_velocity, s_min, s_max, sv_min, sv_max):
    """Steering-rate limits (reference dynamic_models.py:62-87)."""
    clamped = jnp.clip(steering_velocity, sv_min, sv_max)
    pinned = ((steering_angle <= s_min) & (steering_velocity <= 0.0)) | (
        (steering_angle >= s_max) & (steering_velocity >= 0.0)
    )
    return jnp.where(pinned, 0.0, clamped)


def constrain_inputs_t(steer, vel, sv0, ac0, p: VehicleParams):
    """Apply both input constraints on unpacked components -> (sv, ac)."""
    sv = steering_constraint(steer, sv0, p.s_min, p.s_max, p.sv_min, p.sv_max)
    ac = accl_constraints(vel, ac0, p.v_switch, p.a_max, p.v_min, p.v_max)
    return sv, ac


def constrain_inputs(x, u_init, p: VehicleParams):
    """Apply both input constraints; returns constrained ``u``(..., 2)."""
    sv, ac = constrain_inputs_t(x[..., 2], x[..., 3],
                                u_init[..., 0], u_init[..., 1], p)
    return jnp.stack([sv, ac], axis=-1)


def vehicle_dynamics_ks_t(xt, sv0, ac0, p: VehicleParams):
    """Kinematic single-track RHS on a 5-tuple of state components.

    Component (struct-of-arrays) form: no stack/slice per evaluation, so a
    whole RK4 step fuses into a handful of XLA kernels instead of ~50
    (reference math: dynamic_models.py:91-121).
    """
    sv, ac = constrain_inputs_t(xt[2], xt[3], sv0, ac0, p)
    lwb = p.lf + p.lr
    return (
        xt[3] * jnp.cos(xt[4]),
        xt[3] * jnp.sin(xt[4]),
        sv,
        ac,
        xt[3] / lwb * jnp.tan(xt[2]),
    )


def vehicle_dynamics_ks(x, u_init, p: VehicleParams):
    """Kinematic single-track RHS for state (..., 5).

    Reference: dynamic_models.py:91-121.
    """
    xt = tuple(x[..., i] for i in range(5))
    return jnp.stack(vehicle_dynamics_ks_t(xt, u_init[..., 0], u_init[..., 1], p),
                     axis=-1)


def vehicle_dynamics_st_t(xt, sv0, ac0, p: VehicleParams):
    """Dynamic single-track RHS on a 7-tuple of state components.

    Reference: dynamic_models.py:123-176.  The |v| < 0.5 kinematic fallback
    becomes a lane-wise select: both branches are evaluated (cheap, fully
    vectorized) and `jnp.where` picks per car.  The ST branch divides by v,
    so v is substituted with 1 where the kinematic branch is selected to keep
    the untaken lane finite (protects reverse-mode AD through the select).
    """
    sv, ac = constrain_inputs_t(xt[2], xt[3], sv0, ac0, p)
    lwb = p.lf + p.lr

    use_ks = jnp.abs(xt[3]) < 0.5

    # --- kinematic branch, lifted to 7 states (dynamic_models.py:152-160).
    # The reference feeds the already-constrained u through the KS RHS, which
    # re-applies the (idempotent) constraints; we call the same path.
    f_ks5 = vehicle_dynamics_ks_t(xt[:5], sv, ac, p)
    cos_s = jnp.cos(xt[2])
    # NB the denominator associates as lwb*(cos^2) — the reference writes
    # lwb*np.cos(x[2])**2 (dynamic_models.py:159); (lwb*cos)*cos differs by
    # an ulp and breaks bit-exact trajectory parity
    f_ks_6 = ac / lwb * jnp.tan(xt[2]) + xt[3] / (lwb * (cos_s * cos_s)) * sv

    # --- dynamic branch (dynamic_models.py:162-174), v guarded where unused.
    v = jnp.where(use_ks, 1.0, xt[3])
    delta = xt[2]
    psi = xt[4]
    wz = xt[5]
    beta = xt[6]

    glr_f = G * p.lr - ac * p.h   # front axle load lever
    glf_r = G * p.lf + ac * p.h   # rear axle load lever
    denom = p.lr + p.lf

    f_st = (
        v * jnp.cos(beta + psi),
        v * jnp.sin(beta + psi),
        sv,
        ac,
        wz,
        -p.mu * p.m / (v * p.I * denom)
        * (p.lf**2 * p.C_Sf * glr_f + p.lr**2 * p.C_Sr * glf_r) * wz
        + p.mu * p.m / (p.I * denom)
        * (p.lr * p.C_Sr * glf_r - p.lf * p.C_Sf * glr_f) * beta
        + p.mu * p.m / (p.I * denom) * p.lf * p.C_Sf * glr_f * delta,
        (p.mu / (v**2 * denom) * (p.C_Sr * glf_r * p.lr - p.C_Sf * glr_f * p.lf) - 1.0) * wz
        - p.mu / (v * denom) * (p.C_Sr * glf_r + p.C_Sf * glr_f) * beta
        + p.mu / (v * denom) * (p.C_Sf * glr_f) * delta,
    )

    f_ks7 = f_ks5 + (f_ks_6, jnp.zeros_like(f_ks_6))
    return tuple(jnp.where(use_ks, a, b) for a, b in zip(f_ks7, f_st))


def vehicle_dynamics_st(x, u_init, p: VehicleParams):
    """Dynamic single-track RHS for state (..., 7) (array API; see the
    _t form for the fused component version the env step uses)."""
    xt = tuple(x[..., i] for i in range(7))
    return jnp.stack(vehicle_dynamics_st_t(xt, u_init[..., 0], u_init[..., 1], p),
                     axis=-1)


def pid(speed, steer, current_speed, current_steer, max_sv, max_a, max_v, min_v):
    """Desired (speed, steer) -> (accl, steering velocity).

    Reference: dynamic_models.py:178-221 — bang-bang steering rate plus an
    asymmetric proportional speed loop (gain 10x forward, 2x reverse).
    """
    steer_diff = steer - current_steer
    sv = jnp.where(jnp.abs(steer_diff) > 1e-4, jnp.sign(steer_diff) * max_sv, 0.0)

    vel_diff = speed - current_speed
    fwd_gain = jnp.where(vel_diff > 0.0, 10.0 * max_a / max_v, 10.0 * max_a / (-min_v))
    rev_gain = jnp.where(vel_diff > 0.0, 2.0 * max_a / max_v, 2.0 * max_a / (-min_v))
    kp = jnp.where(current_speed > 0.0, fwd_gain, rev_gain)
    accl = kp * vel_diff
    return accl, sv
