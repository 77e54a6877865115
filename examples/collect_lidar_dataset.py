"""Batched lidar dataset collector.

Counterpart of the reference collector (reference:
f1tenth_gym/examples/lidar.py:158-258 — random spawns, random actions, lidar
-> 256x256 occupancy tensors saved as npz), rebuilt batched: thousands of
episodes collected in one lax.scan, rasterized on device, saved as one npz.

Usage: python examples/collect_lidar_dataset.py --episodes 64 --steps 10
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
from red_gym_tpu.ops.rasterize import lidar_to_bitmap
from red_gym_tpu.assets import example_map_yaml


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=64,
                    help="parallel episodes (envs)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", type=str, default="lidar_dataset.npz")
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--legacy-npz", type=str, default=None,
                    help="also write an npz in the REFERENCE collector's "
                         "schema: single key 'data', (N, 256, 256) uint8 "
                         "occupancy tensors (f1tenth_gym/examples/"
                         "lidar.py:214-257 semantics) — consumable by "
                         "pipelines written against the reference's "
                         "shipped datasets")
    args = ap.parse_args()

    cfg = SimConfig(num_agents=1, num_beams=1080, timestep=0.01, dtype="float32")
    params = envlib.make_params(cfg, example_map_yaml(), ".png")

    # random free-space spawns
    occ = np.asarray(params.tmap.occupancy)
    dt_np = np.asarray(params.tmap.dt)
    res = float(params.tmap.resolution)
    rng = np.random.default_rng(0)
    spawns = []
    while len(spawns) < args.episodes:
        r, c = rng.integers(0, occ.shape[0]), rng.integers(0, occ.shape[1])
        # free (>0.6 m clearance) but WITH a wall inside 8 m: the example
        # map's image is mostly empty space outside the track, where every
        # beam exceeds the legacy tensors' 10 m box and the occupancy
        # tensor comes out all-zero
        if 0.6 < dt_np[r, c] < 8.0:
            spawns.append([c * res + float(params.tmap.orig_x),
                           r * res + float(params.tmap.orig_y),
                           rng.uniform(0, 2 * np.pi)])
    poses = jnp.asarray(spawns, jnp.float32)[:, None, :]

    keys = jax.random.split(jax.random.PRNGKey(1), args.episodes)
    reset_v = jax.jit(jax.vmap(lambda po, k: envlib.reset(cfg, params, po, k)))
    states, obs, *_ = reset_v(poses, keys)

    dims = (args.image_size, args.image_size)
    raster = jax.vmap(lambda s: lidar_to_bitmap(
        s, bg_color="black", draw_mode="FILL", output_image_dims=dims))

    @jax.jit
    def collect(states, obs, key):
        def body(carry, _):
            states, obs, key = carry
            key, ka = jax.random.split(key)
            act = jnp.stack(
                [0.4 * jax.random.uniform(ka, (args.episodes, 1), jnp.float32, -1, 1),
                 jax.random.uniform(ka, (args.episodes, 1), jnp.float32, 1.0, 5.0)],
                axis=-1)
            states, obs, _, done, _ = jax.vmap(
                lambda s, a: envlib.step(cfg, params, s, a))(states, act)
            return (states, obs, key), (raster(obs.scans[:, 0]),
                                        obs.scans[:, 0], act[:, 0])
        (_, _, _), out = jax.lax.scan(body, (states, obs, key), None,
                                      length=args.steps)
        return out

    bitmaps, scans, actions = collect(states, obs, jax.random.PRNGKey(2))
    np.savez_compressed(
        args.out,
        bitmaps=np.asarray(bitmaps, np.uint8),   # (T, E, H, W)
        scans=np.asarray(scans, np.float32),     # (T, E, 1080)
        actions=np.asarray(actions, np.float32), # (T, E, 2)
        spawns=np.asarray(spawns, np.float32))
    print(f"wrote {args.out}: bitmaps {bitmaps.shape}, scans {scans.shape}")

    if args.legacy_npz:
        from red_gym_tpu.ops.rasterize import scans_to_legacy_tensors

        # episode-major ordering like the reference (all steps of episode 0,
        # then episode 1, ...); the reference also truncates episodes at
        # done — here collisions freeze the car so late tensors repeat the
        # terminal view, which downstream occupancy consumers tolerate
        flat = np.asarray(scans).transpose(1, 0, 2).reshape(-1, scans.shape[-1])
        data = scans_to_legacy_tensors(flat)
        np.savez_compressed(args.legacy_npz, data=data)
        print(f"wrote {args.legacy_npz}: data {data.shape} {data.dtype} "
              f"(reference collector schema)")


if __name__ == "__main__":
    main()
