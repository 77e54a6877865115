"""Lidar bitmap visualization while driving pure pursuit.

Counterpart of the reference demo (reference: examples/lidar_example.py):
drives the example map with pure pursuit and writes RAYS/POLYGON/FILL
bitmap frames of the live scan.

Usage: python examples/lidar_bitmap_example.py [--steps 400] [--outdir /tmp]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import numpy as np
import jax
import jax.numpy as jnp

from red_gym_tpu.config import SimConfig
from red_gym_tpu import env as envlib
from red_gym_tpu.agents import pure_pursuit as pp
from red_gym_tpu.ops.rasterize import lidar_to_bitmap
from red_gym_tpu.assets import example_map_yaml, example_waypoints_csv


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--every", type=int, default=100)
    ap.add_argument("--outdir", type=str, default="/tmp/lidar_bitmaps")
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)

    cfg = SimConfig(num_agents=1, num_beams=1080, timestep=0.01, dtype="float32")
    params = envlib.make_params(cfg, example_map_yaml(), ".png")
    ppp = pp.make_params(pp.load_waypoints_csv(example_waypoints_csv(),
                                               dtype=jnp.float32))

    state, obs, *_ = envlib.reset(
        cfg, params, jnp.asarray(envlib.staggered_start_poses(1), jnp.float32),
        jax.random.PRNGKey(0))
    step = jax.jit(lambda s, a: envlib.step(cfg, params, s, a))
    raster = {m: jax.jit(lambda s, m=m: lidar_to_bitmap(
        s, bg_color="black", draw_mode=m)) for m in ("RAYS", "POLYGON", "FILL")}

    from PIL import Image

    for t in range(args.steps):
        speed, steer = pp.plan(obs.poses_x[0], obs.poses_y[0],
                               obs.poses_theta[0], ppp)
        state, obs, _, done, _ = step(state, jnp.stack([steer, speed])[None, :])
        if t % args.every == 0:
            for mode, fn in raster.items():
                img = np.asarray(fn(obs.scans[0]))
                Image.fromarray(img).save(
                    os.path.join(args.outdir, f"{mode.lower()}_{t:05d}.png"))
            print(f"step {t}: wrote {len(raster)} bitmaps", flush=True)
        if bool(done):
            break
    print("frames in", args.outdir)


if __name__ == "__main__":
    main()
