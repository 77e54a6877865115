"""PPO at scale: thousands of envs sharded over the device mesh.

The scaled training loop of BASELINE configs 4/5 (no reference counterpart;
the reference trains one env on host).  Envs shard along a 1-D mesh, policy
params replicate, rollout collection and updates run as one jitted program.

Usage:
    python examples/train_ppo.py --envs 1024 --iters 20       # smoke
    python examples/train_ppo.py --envs 16384 --iters 500     # config 4
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import numpy as np
import jax
import jax.numpy as jnp

from red_gym_tpu.config import Integrator, SimConfig
from red_gym_tpu import env as envlib
from red_gym_tpu.agents.ppo import PPO, PPOConfig
from red_gym_tpu.parallel import sharding as sh
from red_gym_tpu.assets import (example_map_yaml, raceline_poses,
                                waypoints_csv_for)
from red_gym_tpu.utils import runtime
from red_gym_tpu.utils import checkpoint as ckpt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--rollout", type=int, default=32)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--scan-mode", type=str, default="fast",
                    choices=["exact", "fast"])
    ap.add_argument("--rt-spatial", type=str, default="bilinear",
                    choices=["bilinear", "nearest", "nearest1"],
                    help="fast-scan spatial lookup; nearest1 = the "
                         "single-gather ultra-throughput mode")
    ap.add_argument("--ultra", action="store_true",
                    help="train on the spectral ultra-throughput scan "
                         "(nearest1 + spectral interpolation, no edge/grad "
                         "channels — the pre-r3 error class, p99 ~4.5 m); "
                         "the default trains on the accuracy-first "
                         "edge+grad scan")
    ap.add_argument("--save", type=str, default="ppo_ckpt")
    ap.add_argument("--map", type=str, default=None)
    ap.add_argument("--opponents", type=str, default="cruise",
                    choices=["cruise", "pursuit", "self"],
                    help="non-ego agents hold slow-straight, track the "
                         "raceline with pure pursuit, or mirror the learning "
                         "policy (self-play)")
    ap.add_argument("--multi-map", action="store_true",
                    help="train across all packaged tracks: per-env map "
                         "assignment into shared stacked textures")
    ap.add_argument("--resume", action="store_true",
                    help="restore trainer state from --save if present")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N iterations (0 = only at end)")
    ap.add_argument("--eval", action="store_true",
                    help="no training: load --save and roll the mean policy, "
                         "reporting laps/speed/crashes")
    ap.add_argument("--eval-steps", type=int, default=6000)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for env keys and policy init")
    ap.add_argument("--log-csv", type=str, default=None,
                    help="write per-iteration metrics (iter, env_steps, "
                         "loss, reward_mean, done_rate, speed_mean, "
                         "wall_s) to this CSV")
    args = ap.parse_args()
    runtime.enable_compile_cache()

    cfg = SimConfig(num_agents=args.agents, num_beams=args.beams,
                    timestep=0.01, integrator=Integrator.RK4, dtype="float32",
                    scan_mode=args.scan_mode, rt_spatial=args.rt_spatial)
    if args.ultra:
        import dataclasses
        cfg = dataclasses.replace(cfg, rt_spatial="nearest1",
                                  scan_interp="spectral", rt_grad=False,
                                  rt_occlusion="off")

    map_idx = None
    if args.multi_map:
        import glob

        from red_gym_tpu.assets import __file__ as assets_file

        yamls = sorted(glob.glob(os.path.join(
            os.path.dirname(assets_file), "data", "track_*.yaml")))
        env_params = envlib.make_multimap_params(cfg, yamls)
        starts = [envlib.staggered_start_poses(args.agents,
                                               waypoints_csv_for(y))
                  for y in yamls]
        map_idx = jnp.arange(args.envs, dtype=jnp.int32) % len(yamls)
        poses = jnp.asarray(starts, jnp.float32)[map_idx]
        print(f"multi-map: {len(yamls)} tracks, per-env assignment")
    else:
        map_yaml = args.map or example_map_yaml()
        env_params = envlib.make_params(cfg, map_yaml, ".png")
        poses = jnp.asarray(raceline_poses(args.envs, args.agents,
                                           waypoints_csv_for(map_yaml)),
                            jnp.float32)

    mesh = sh.make_env_mesh()
    env_params = sh.shard_params(mesh, env_params)

    keys = jax.random.split(jax.random.PRNGKey(args.seed), args.envs)
    # env_params must be jit ARGUMENTS, not closures: the map/range textures
    # would otherwise be embedded as HLO constants
    if map_idx is None:
        reset_v = jax.jit(jax.vmap(
            lambda pr, po, k: envlib.reset(cfg, pr, po, k),
            in_axes=(None, 0, 0)))
        states, obs, *_ = reset_v(env_params, poses, keys)
    else:
        reset_v = jax.jit(jax.vmap(
            lambda pr, po, k, m: envlib.reset(cfg, pr, po, k, map_idx=m),
            in_axes=(None, 0, 0, 0)))
        states, obs, *_ = reset_v(env_params, poses, keys, map_idx)
    states = sh.shard_envs(mesh, states)
    obs = sh.shard_envs(mesh, obs)

    opponent_plan = None
    if args.opponents == "self":
        opponent_plan = "self"
    elif args.opponents == "pursuit" and args.agents > 1:
        from red_gym_tpu.agents import pure_pursuit as pp
        from red_gym_tpu.agents.ppo import pure_pursuit_opponents
        wpts = pp.load_waypoints_csv(waypoints_csv_for(args.map),
                                     dtype=jnp.float32)
        opponent_plan = pure_pursuit_opponents(pp.make_params(wpts))

    ppo = PPO(cfg, env_params, PPOConfig(rollout_len=args.rollout),
              opponent_plan=opponent_plan)
    pstate = ppo.init(jax.random.PRNGKey(args.seed + 1))
    if (args.resume or args.eval) and os.path.exists(os.path.abspath(args.save)):
        pstate = ckpt.restore(args.save, like=pstate)
        print(f"restored trainer state from {args.save}")

    if args.eval:
        from red_gym_tpu.agents.ppo import action_to_control

        def body(pr, pparams, carry, _):
            states, obs = carry
            mean, _, _ = ppo.policy.apply(pparams, obs.scans[:, 0],
                                          obs.linear_vels_x[:, 0])
            act = ppo._env_actions(mean, obs, pparams)
            states, obs, _, done, _ = jax.vmap(
                lambda p_, s, a: envlib.step(cfg, p_, s, a),
                in_axes=(None, 0, 0))(pr, states, act)
            return (states, obs), (obs.linear_vels_x[:, 0],
                                   obs.collisions[:, 0], states.lap_counts[:, 0])

        @jax.jit
        def rollout(pr, pparams, states, obs):
            return jax.lax.scan(lambda c, x: body(pr, pparams, c, x),
                                (states, obs), None, length=args.eval_steps)

        (states, obs), (vels, colls, laps) = rollout(env_params, pstate.params,
                                                     states, obs)
        vels, colls, laps = map(np.asarray, (vels, colls, laps))
        print(f"eval over {args.envs} envs x {args.eval_steps} steps "
              f"({args.eval_steps * cfg.timestep:.0f}s sim):")
        print(f"  mean speed {vels.mean():.2f} m/s   "
              f"crash rate {(colls.sum(0) > 0).mean():.3f}   "
              f"final laps (mean) {laps[-1].mean():.2f}")
        return

    pstate = sh.replicate(mesh, pstate)
    train = jax.jit(lambda ps, s, o, ep: ppo.train_step(ps, s, o, ep))

    csv_f = None
    if args.log_csv:
        csv_f = open(args.log_csv, "w")
        csv_f.write("iter,env_steps,loss,reward_mean,done_rate,"
                    "speed_mean,wall_s\n")

    steps_per_iter = args.envs * args.rollout
    t_start = time.time()
    for it in range(args.iters):
        t0 = time.time()
        pstate, states, obs, metrics = train(pstate, states, obs, env_params)
        loss = float(metrics["loss"])  # also forces execution
        dt = time.time() - t0
        print(f"iter {it}: loss={loss:.4f} "
              f"reward={float(metrics['reward_mean']):.4f} "
              f"done_rate={float(metrics['done_rate']):.3f} "
              f"speed={float(metrics['speed_mean']):.2f} "
              f"({steps_per_iter / dt:,.0f} env-steps/s)", flush=True)
        if csv_f:
            csv_f.write(f"{it},{(it + 1) * steps_per_iter},{loss:.6f},"
                        f"{float(metrics['reward_mean']):.6f},"
                        f"{float(metrics['done_rate']):.6f},"
                        f"{float(metrics['speed_mean']):.4f},"
                        f"{time.time() - t_start:.2f}\n")
            csv_f.flush()
        if args.ckpt_every and (it + 1) % args.ckpt_every == 0:
            ckpt.save(args.save, pstate)
    if csv_f:
        csv_f.close()

    ckpt.save(args.save, pstate)
    print(f"saved {args.save}")


if __name__ == "__main__":
    main()
