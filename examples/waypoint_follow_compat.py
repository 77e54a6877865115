"""The reference's waypoint_follow main loop, ported with ONE import change.

The body below mirrors the structure of the reference script
(/root/reference/examples/waypoint_follow.py:241-290): classic gym.make with
the f110 env id, 4-tuple reset(poses)/step, obs-dict field access, a render
callback, laptime accumulated from step rewards.  The only framework change
a reference user needs is the import marked below.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax

if os.environ.get("F110_CPU"):
    # the classic one-env host loop forces a device->host transfer every
    # step — run it on the CPU (for batched throughput use vec_env/rollout
    # instead of this legacy API)
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

# the one-line port: reference scripts say `import gym`
from red_gym_tpu import gym_compat as gym
from red_gym_tpu.config import Integrator
from red_gym_tpu.agents import pure_pursuit as pp

MAP = os.environ.get(
    "F110_MAP", "/root/reference/examples/example_map")
WPTS = os.environ.get(
    "F110_WPTS", "/root/reference/examples/example_waypoints.csv")


def main():
    work = {"tlad": 0.82461887897713965, "vgain": 1.375}
    sx, sy, stheta = 0.7, 0.0, 1.37079632679

    wpts = pp.load_waypoints_csv(WPTS, dtype=jnp.float32)
    planner = pp.make_params(wpts, tlad=work["tlad"], vgain=work["vgain"])

    def render_callback(viewer):
        viewer.draw_polyline(np.asarray(wpts[:, 1:3]), color="tab:green")

    env = gym.make("f110_gym:f110-v0", map=MAP, map_ext=".png",
                   num_agents=1, timestep=0.01, integrator=Integrator.RK4)
    if os.environ.get("F110_RENDER"):
        env.add_render_callback(render_callback)

    obs, step_reward, done, _ = env.reset(np.array([[sx, sy, stheta]]))

    laptime = 0.0
    start = time.time()
    steps = 0
    while not done and steps < 300_000:
        speed, steer = pp.plan(obs["poses_x"][0], obs["poses_y"][0],
                               obs["poses_theta"][0], planner)
        obs, step_reward, done, info = env.step(
            np.array([[float(steer), float(speed)]]))
        laptime += step_reward
        steps += 1
        if os.environ.get("F110_RENDER"):
            env.render(mode="human_fast")

    print("Sim elapsed time:", laptime,
          "Real elapsed time:", time.time() - start)
    return laptime, steps


if __name__ == "__main__":
    main()
