"""Pure-pursuit waypoint following on the example map.

On-device counterpart of the reference demo (reference:
examples/waypoint_follow.py:241-290): the whole closed loop — planner +
simulator — runs on device inside one jitted lax.scan, then the trajectory
is (optionally) rendered host-side.

Usage:
    python examples/waypoint_follow.py [--steps 6000] [--render out.png]
"""

import argparse
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


from red_gym_tpu.config import Integrator, SimConfig, VehicleParams  # noqa: E402
from red_gym_tpu import env as envlib  # noqa: E402
from red_gym_tpu.agents import pure_pursuit as pp  # noqa: E402
from red_gym_tpu.assets import (example_map_yaml, example_waypoints_csv,  # noqa: E402
                                waypoints_csv_for)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--map", type=str, default=example_map_yaml())
    ap.add_argument("--waypoints", type=str, default=example_waypoints_csv())
    ap.add_argument("--render", type=str, default="",
                    help="write a trajectory plot to this png path")
    args = ap.parse_args()

    cfg = SimConfig(num_agents=1, num_beams=1080, timestep=0.01,
                    integrator=Integrator.RK4, dtype="float32")
    params = envlib.make_params(cfg, args.map, ".png")
    wpts = pp.load_waypoints_csv(args.waypoints, dtype=jnp.float32)
    ppp = pp.make_params(wpts)

    start = jnp.asarray(envlib.staggered_start_poses(
                            1, waypoints_csv_for(args.map)),
                        dtype=jnp.float32)

    def body(carry, _):
        state, obs = carry
        speed, steer = pp.plan(obs.poses_x[0], obs.poses_y[0],
                               obs.poses_theta[0], ppp)
        action = jnp.stack([steer, speed])[None, :]
        state, obs, reward, done, _ = envlib.step(cfg, params, state, action)
        return (state, obs), (obs.poses_x[0], obs.poses_y[0], done)

    @jax.jit
    def rollout(state, obs):
        return jax.lax.scan(body, (state, obs), None, length=args.steps)

    state, obs, _, _, _ = envlib.reset(cfg, params, start, jax.random.PRNGKey(12345))

    t0 = time.time()
    (state, obs), (xs, ys, dones) = rollout(state, obs)
    jax.block_until_ready(xs)
    compile_and_run = time.time() - t0

    t0 = time.time()
    state2, obs2, _, _, _ = envlib.reset(cfg, params, start, jax.random.PRNGKey(12345))
    (state2, _), _ = rollout(state2, obs2)
    jax.block_until_ready(state2.x)
    run = time.time() - t0

    dones = np.asarray(dones)
    done_step = int(np.argmax(dones)) if dones.any() else args.steps
    sim_time = (done_step + 2) * cfg.timestep  # +2: reset consumed one step
    print(f"backend={jax.default_backend()} steps={args.steps}")
    print(f"Sim elapsed time: {sim_time if dones.any() else float('nan')} "
          f"(two laps done: {bool(dones.any())})")
    print(f"Real elapsed time: {run:.3f}s ({args.steps / run:.0f} steps/s; "
          f"first call incl. compile {compile_and_run:.1f}s)")

    if args.render:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        occ = np.asarray(params.tmap.occupancy)
        res = float(params.tmap.resolution)
        ox, oy = float(params.tmap.orig_x), float(params.tmap.orig_y)
        h, w = occ.shape
        plt.figure(figsize=(8, 8))
        plt.imshow(occ, cmap="gray", origin="lower",
                   extent=[ox, ox + w * res, oy, oy + h * res])
        n = done_step if dones.any() else args.steps
        plt.plot(np.asarray(xs)[:n], np.asarray(ys)[:n], "r-", lw=1)
        plt.title("pure pursuit on " + os.path.basename(args.map))
        plt.savefig(args.render, dpi=120)
        print("wrote", args.render)


if __name__ == "__main__":
    main()
