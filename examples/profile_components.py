"""Per-component step-time profile on the current backend.

Times each phase of the env step in isolation over a large env batch so
optimization effort goes where the microseconds are (the reference's
equivalent is the ad-hoc FPS prints in its in-module perf tests, e.g.
reference gym/f110_gym/envs/laser_models.py:534-552).

Usage:  python examples/profile_components.py [n_envs]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from red_gym_tpu.config import Integrator, SimConfig
from red_gym_tpu import env as envlib
from red_gym_tpu.assets import example_map_yaml
from red_gym_tpu.ops import agent_scan, collision as col, dynamics as dyn
from red_gym_tpu.ops import integrate, scan as scan_ops, scan_fast

N_ENVS = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
N_AGENTS = 2
REPS = 20


def timeit(name, fn, *args, reps=REPS):
    """Times reps dispatches with ONE final forcing transfer.

    NB: forcing a result costs a fixed device->host round trip — it must
    be amortized over all reps, never paid per call, or every figure gains
    a phantom ~reps-independent constant."""
    out = fn(*args)  # compile
    float(jnp.sum(jax.tree.leaves(out)[0].astype(jnp.float32)))  # force
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    float(jnp.sum(jax.tree.leaves(out)[0].astype(jnp.float32)))
    dt = (time.time() - t0 - _FORCE_COST) / reps
    rate = N_ENVS / dt
    print(f"{name:34s} {dt * 1e3:9.3f} ms/call  {rate / 1e6:8.2f} M env/s")
    return dt


def _measure_force_cost():
    """One device->host forcing round trip (constant per timed region)."""
    f = jax.jit(lambda x: x + 1.0)
    x = jnp.zeros((8,), jnp.float32)
    float(jnp.sum(f(x)))  # compile + warm
    samples = []
    for _ in range(5):
        t0 = time.time()
        float(jnp.sum(f(x)))
        samples.append(time.time() - t0)
    return min(samples)


_FORCE_COST = 0.0


def main():
    cfg_fast = SimConfig(num_agents=N_AGENTS, num_beams=1080, timestep=0.01,
                         integrator=Integrator.RK4, dtype="float32",
                         scan_mode="fast")
    cfg_exact = SimConfig(num_agents=N_AGENTS, num_beams=1080, timestep=0.01,
                          integrator=Integrator.RK4, dtype="float32",
                          scan_mode="exact", march_iters=64)
    params = envlib.make_params(cfg_fast, example_map_yaml(), ".png")

    start = envlib.staggered_start_poses(N_AGENTS)
    poses3 = jnp.tile(jnp.asarray(start[:N_AGENTS], jnp.float32),
                      (N_ENVS, 1, 1))
    init = jax.jit(jax.vmap(lambda po, k: envlib.init_state(cfg_fast, po, k)))
    states = init(poses3, jax.random.split(jax.random.PRNGKey(0), N_ENVS))
    actions = jnp.tile(jnp.asarray([[0.05, 3.0], [-0.05, 2.0]], jnp.float32),
                       (N_ENVS, 1, 1))
    x = states.x
    u = jnp.zeros((N_ENVS, N_AGENTS, 2), jnp.float32)
    p = params.vehicle

    global _FORCE_COST
    _FORCE_COST = _measure_force_cost()
    print(f"backend={jax.default_backend()}  envs={N_ENVS}  agents={N_AGENTS}  "
          f"(forcing round trip {_FORCE_COST * 1e3:.1f} ms, subtracted)")

    # NB: always pass params as jit ARGUMENTS — closing over them embeds the
    # map/range textures as HLO constants, which bloats every executable.
    timeit("noop (dispatch floor)", jax.jit(lambda x: x + 1.0), x)

    timeit("dynamics RK4 (ST)", jax.jit(
        lambda x, u: integrate.integrate(Integrator.RK4,
                                         dyn.vehicle_dynamics_st, x, u,
                                         cfg_fast.timestep, p)), x, u)

    timeit("scan exact (march 64)", jax.jit(
        lambda pr, po: scan_ops.trace(po, pr.tables, pr.tmap, cfg_exact)),
        params, poses3, reps=2)

    timeit("scan fast (element gather)", jax.jit(
        lambda pr, po: scan_fast.trace_fast(po, pr.tables, pr.tmap,
                                            pr.rtex, cfg_fast)), params, poses3)

    timeit("scan fast (matmul)", jax.jit(
        lambda pr, po: scan_fast.trace_fast_mxu(po, pr.tables, pr.tmap,
                                                pr.rtex, cfg_fast)), params, poses3)

    scans = jax.jit(lambda pr, po: scan_fast.trace_fast_mxu(
        po, pr.tables, pr.tmap, pr.rtex, cfg_fast))(params, poses3)
    verts = jax.jit(lambda po: col.get_vertices(po, p.length, p.width))(poses3)

    timeit("collision SAT (pairwise)", jax.jit(
        jax.vmap(lambda v: col.collision_multiple(v))), verts)

    timeit("iTTC check", jax.jit(
        lambda sc: agent_scan.check_ttc(sc, x[..., 3], params.tables,
                                        cfg_fast.ttc_thresh)), scans)

    timeit("opponent raycast", jax.jit(
        jax.vmap(lambda po, sc, v: agent_scan.ray_cast_all_opponents(
            po, sc, v, params.tables))), poses3, scans, verts)

    step_fast = jax.jit(jax.vmap(
        lambda pr, s, a: envlib.step(cfg_fast, pr, s, a),
        in_axes=(None, 0, 0)))
    timeit("FULL step (fast scan)", step_fast, params, states, actions)

    params_exact = params._replace(rtex=None)
    step_exact = jax.jit(jax.vmap(
        lambda pr, s, a: envlib.step(cfg_exact, pr, s, a),
        in_axes=(None, 0, 0)))
    timeit("FULL step (exact scan)", step_exact, params_exact, states,
           actions, reps=2)


if __name__ == "__main__":
    main()
