"""Vmapped bitmap-SAC training: the SAL-parity pipeline at scale.

The reference trains its SAC on ONE host-loop env (reference:
src/SAL.py:975-1022): 256x256 lidar FILL bitmaps -> CNN actor/critics ->
32-D path actions tracked by the embedded MPC.  Here the ENTIRE pipeline —
rasterizer, MPC QP, env step, reward shaping — is one jitted function
vmapped over dozens of envs, with an on-device uint8 replay (VERDICT r2
item 5: prove the bitmap pipeline LEARNS, not just steps).

Per-iteration metrics go to --log-csv (docs/media/sac_bitmap_curve.csv is
the committed artifact; tests/test_learning_curves.py gates that the curve
rises).

Usage:
    python examples/train_sac_bitmap_scale.py --iters 2 --steps-per-iter 4  # smoke
    python examples/train_sac_bitmap_scale.py --log-csv curve.csv           # real run
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import numpy as np
import jax
import jax.numpy as jnp

from red_gym_tpu.config import SimConfig
from red_gym_tpu import env as envlib
from red_gym_tpu.agents import planning_env as pe
from red_gym_tpu.agents.sac import SAC, ReplayBuffer
from red_gym_tpu.assets import (example_map_yaml, raceline_poses,
                                waypoints_csv_for)
from red_gym_tpu.utils.profiling import Metrics
from red_gym_tpu.utils import checkpoint as ckpt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--iters", type=int, default=120)
    ap.add_argument("--steps-per-iter", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--updates-per-step", type=int, default=1)
    ap.add_argument("--capacity", type=int, default=25_000)
    ap.add_argument("--bitmap", type=int, default=256)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--warmup-iters", type=int, default=2,
                    help="iterations of random actions before updates start")
    ap.add_argument("--log-csv", type=str, default=None)
    ap.add_argument("--save", type=str, default=None)
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--map", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reward-mode", choices=("sal", "fixed"), default="fixed",
                    help="'sal' reproduces the reference's world-coord-as-"
                         "pixel reward quirk (collision fires ~always once "
                         "the car leaves the world origin); 'fixed' uses "
                         "the env's true collision flag + car-frame "
                         "centering — the trainable signal")
    ap.add_argument("--grad-clip", type=float, default=10.0,
                    help="global-norm gradient clip (0 disables; the plain-"
                         "Adam reference setup diverged to NaN at 64 envs)")
    ap.add_argument("--alpha", type=float, default=0.2,
                    help="SAC entropy coefficient. 0.2 is the reference's "
                         "fixed value (SAL.py:479) — but on this 16-D "
                         "action space that entropy bonus (~3) drowns the "
                         "task reward's ~0.3 dynamic range and the policy "
                         "stays near-uniform (measured: flat reward over "
                         "30k env-steps); ~0.02 makes the signal "
                         "competitive for actual learning runs")
    ap.add_argument("--f32", action="store_true",
                    help="float32 CNN compute instead of bfloat16")
    args = ap.parse_args()
    if args.updates_per_step < 1:
        ap.error("--updates-per-step must be >= 1")

    import jax.numpy as _jnp

    cfg = SimConfig(num_agents=1, num_beams=args.beams, timestep=0.015,
                    dtype="float32")
    map_yaml = args.map or example_map_yaml()
    params = envlib.make_params(cfg, map_yaml, ".png")
    pcfg = pe.default_plan_config()._replace(
        bitmap_dims=(args.bitmap, args.bitmap))
    env = pe.PlanningEnv(cfg, params, pcfg, reward_mode=args.reward_mode)
    sac = SAC(obs_shape=(args.bitmap, args.bitmap), action_dim=pe.ACTION_DIM,
              alpha=args.alpha, grad_clip=args.grad_clip or None,
              compute_dtype=_jnp.float32 if args.f32 else _jnp.bfloat16)

    e = args.envs
    # the map's raceline start (the reference, SAL.py:978, uses its example
    # map's default pose), spread around the lap so replay sees diverse
    # states
    poses = jnp.asarray(raceline_poses(e, 1, waypoints_csv_for(map_yaml)),
                        jnp.float32)

    reset_v = jax.jit(jax.vmap(env.reset, in_axes=(0, 0)))
    step_v = jax.vmap(env.step, in_axes=(0, 0))

    key = jax.random.PRNGKey(args.seed)
    key, kr = jax.random.split(key)
    print("compiling vmapped reset...", flush=True)
    ps = reset_v(poses, jax.random.split(kr, e))
    print("reset ready; initializing SAC...", flush=True)

    sstate = sac.init(jax.random.PRNGKey(args.seed + 1))
    buf = ReplayBuffer.create(args.capacity,
                              (args.bitmap, args.bitmap), pe.ACTION_DIM)
    start_iter = 0
    if args.resume and os.path.isdir(args.resume):
        got = ckpt.restore(args.resume, like={"sstate": sstate, "it": 0})
        sstate = got["sstate"]
        start_iter = int(got["it"])
        print(f"resumed SAC params at iter {start_iter}")

    def body(carry, _, do_update):
        sstate, buf, ps, key, acc = carry
        key, ka, kb, ku, kr2 = jax.random.split(key, 5)

        bitmaps = ps.bitmap                                   # (E, H, W)
        if do_update:
            act = sac.select_action(sstate, bitmaps, ka)
        else:
            act = jax.random.uniform(ka, (e, pe.ACTION_DIM),
                                     jnp.float32, -1.0, 1.0)
        ps2, bitmaps2, r, done, _ = step_v(ps, act)
        buf = buf.push_batch(bitmaps, act, r, bitmaps2, done)

        # auto-reset crashed/finished envs
        rkeys = jax.random.split(kr2, e)
        ps_reset = jax.vmap(env.reset, in_axes=(0, 0))(poses, rkeys)
        sel = lambda a_, b_: jnp.where(
            done.reshape((-1,) + (1,) * (a_.ndim - 1)), a_, b_)
        ps2 = jax.tree.map(sel, ps_reset, ps2)

        actor_loss = jnp.float32(0)
        if do_update:
            for j in range(args.updates_per_step):
                batch = buf.sample(jax.random.fold_in(kb, j), args.batch_size)
                sstate, losses = sac.update(sstate, batch,
                                            jax.random.fold_in(ku, j))
            actor_loss = losses["actor_loss"]
        acc = Metrics.update(acc, reward=r.mean(), done=done.mean(),
                             actor_loss=actor_loss)
        return (sstate, buf, ps2, key, acc), None

    import functools

    @functools.partial(jax.jit, static_argnames="do_update")
    def iteration(sstate, buf, ps, key, do_update):
        acc = Metrics.init(("reward", "done", "actor_loss"))
        (sstate, buf, ps, key, acc), _ = jax.lax.scan(
            functools.partial(body, do_update=do_update),
            (sstate, buf, ps, key, acc), None, length=args.steps_per_iter)
        return sstate, buf, ps, key, acc

    if args.log_csv and start_iter == 0:
        with open(args.log_csv, "w") as f:
            f.write("iter,env_steps,reward_mean,done_rate,actor_loss,secs\n")

    for it in range(start_iter, args.iters):
        t0 = time.time()
        do_update = it >= args.warmup_iters
        sstate, buf, ps, key, acc = iteration(sstate, buf, ps, key, do_update)
        m = Metrics.means(acc)
        secs = time.time() - t0
        row = (it, (it + 1) * args.steps_per_iter * e,
               float(m["reward"]), float(m["done"]),
               float(m["actor_loss"]), round(secs, 2))
        print("iter %d  env-steps %d  reward %.3f  done %.3f  aloss %.4f  %.1fs"
              % row, flush=True)
        if args.log_csv:
            with open(args.log_csv, "a") as f:
                f.write(",".join(str(v) for v in row) + "\n")
        if args.save:
            ckpt.save(args.save, {"sstate": sstate, "it": it + 1})


if __name__ == "__main__":
    main()
