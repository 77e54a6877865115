"""CMA-ES lap-time parameter search with whole-population device evaluation.

On-device counterpart of the reference's parameter-search experiment
(reference: examples/config_example_map.yaml — bounds for mass/lf/tlad/vgain,
optim_method 'CMA', popsize/budget): each CMA generation races the ENTIRE
population in one jitted batched rollout (one env row per candidate, its own
VehicleParams + pure-pursuit tlad/vgain), instead of one sequential rollout
per candidate.

Usage:
    python examples/param_search_cma.py [--popsize 50] [--generations 15]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax.numpy as jnp

from red_gym_tpu.config import Integrator, SimConfig
from red_gym_tpu.agents import pure_pursuit as pp
from red_gym_tpu.assets import example_map_yaml, example_waypoints_csv
from red_gym_tpu.env import staggered_start_poses
from red_gym_tpu.tuning import search


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--popsize", type=int, default=50)
    ap.add_argument("--generations", type=int, default=15)
    ap.add_argument("--steps", type=int, default=4500)
    ap.add_argument("--beams", type=int, default=64)
    args = ap.parse_args()

    cfg = SimConfig(num_agents=1, num_beams=args.beams, timestep=0.01,
                    integrator=Integrator.RK4, dtype="float32",
                    march_iters=32, scan_noise_std=0.0)
    wpts = pp.load_waypoints_csv(example_waypoints_csv(), dtype=jnp.float32)

    t0 = time.time()
    best, best_f = search(cfg, example_map_yaml(), wpts,
                          start_pose=staggered_start_poses(1)[0].tolist(),
                          popsize=args.popsize, generations=args.generations,
                          steps=args.steps)
    dt = time.time() - t0
    evals = args.popsize * args.generations
    print(f"best two-lap time: {best_f:.3f}s with {best}")
    print(f"{evals} full-rollout evaluations in {dt:.1f}s "
          f"({evals / dt:.1f} rollouts/s, {args.steps} steps each)")


if __name__ == "__main__":
    main()
