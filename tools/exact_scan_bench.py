"""Exact-mode (reference-parity sphere march) lidar throughput on a GPU.

Can the exact 1080-beam scan (ops/scan.py::trace, the lockstep march that
mirrors reference laser_models.py:107-186) run fast enough on the card to
make on-device parity spot checks practical?  Target: >= 50k scans/s (one
scan = one 1080-beam pose).

The march is a while/fori loop of random 2-D gathers from the EDT texture.
This tool measures it at float32 with a fixed march budget (march_iters,
so the loop is a static pipeline), across batch sizes, and fails without a
GPU.

Usage: python tools/exact_scan_bench.py [--batches 256 1024 4096 16384]
       [--iters 48] [--steps 20]
Prints one JSON line per batch, naming the card.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from red_gym_tpu.config import SimConfig  # noqa: E402
from red_gym_tpu.maps.loader import load_map  # noqa: E402
from red_gym_tpu.ops import scan as scan_ops  # noqa: E402
from red_gym_tpu.utils import runtime  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[256, 1024, 4096, 16384])
    ap.add_argument("--iters", type=int, default=48,
                    help="fixed march budget (reference marches until "
                         "eps/max_range; 48 covers the example map's p100)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--map", default=os.path.join(
        ROOT, "red_gym_tpu", "assets", "data", "track_0007.yaml"))
    args = ap.parse_args()
    card = runtime.card()
    runtime.enable_compile_cache()
    device = runtime.device_record(1)
    runtime.require_gpu()

    cfg = SimConfig(num_agents=1, num_beams=1080, dtype="float32",
                    scan_mode="exact", march_iters=args.iters)
    tmap = load_map(args.map, ".png", dtype=jnp.float32)
    tables = scan_ops.build_tables(cfg, 0.31, 0.58, dtype=jnp.float32)

    dt_np = np.asarray(tmap.dt)
    res = float(tmap.resolution)
    rng = np.random.default_rng(0)
    free = np.argwhere(dt_np > 1.0)

    for batch in args.batches:
        pick = free[rng.integers(0, len(free), batch)]
        poses = jnp.asarray(np.stack(
            [pick[:, 1] * res + float(tmap.orig_x),
             pick[:, 0] * res + float(tmap.orig_y),
             rng.uniform(0, 2 * np.pi, batch)], axis=-1), jnp.float32)

        @jax.jit
        def run(poses):
            def body(p, _):
                out = scan_ops.trace(p, tables, tmap, cfg)
                # rotate the pose so each step re-marches fresh rays
                return p + jnp.asarray([0.0, 0.0, 0.01], jnp.float32), \
                    jnp.sum(out)
            _, sums = jax.lax.scan(body, poses, None, length=args.steps)
            return jnp.sum(sums)

        t0 = time.perf_counter()
        jax.block_until_ready(run(poses))
        compile_s = time.perf_counter() - t0
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(run(poses))
            best = max(best, batch * args.steps / (time.perf_counter() - t0))
        print(json.dumps({
            "card": card, "device": device, "batch": batch,
            "march_iters": args.iters,
            "scans_per_s": round(best, 1),
            "beam_lookups_per_s": round(best * 1080 * args.iters, 0),
            "compile_s": round(compile_s, 1),
            "target_50k": best >= 50000.0}), flush=True)


if __name__ == "__main__":
    main()
