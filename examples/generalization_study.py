"""Held-out-track generalization study.

Trains PPO on a TRAIN split of the packaged generated tracks (default: all
but the last two) and evaluates the resulting mean policy per-track on every
track, including the two never seen during training.  This is a
beyond-reference capability study: the reference can only ever train and
run one map per process (reference gym/f110_gym/envs/f110_env.py:365-373
`update_map` swaps the single global scan texture), so a train/hold-out
track protocol does not exist there at all.

The committed artifact (docs/media/generalization.csv) has one row per
track: split, mean speed, crash rate, mean laps over the eval horizon.
tests/test_learning_curves.py gates that held-out performance stays within
a sane band of the train-split performance.

Usage:
    python examples/generalization_study.py --envs 4096 --iters 100 \
        --log-csv docs/media/generalization.csv
    python examples/generalization_study.py --iters 2 --envs 64 \
        --eval-steps 40        # smoke
"""

import argparse
import glob
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


def track_yamls():
    from red_gym_tpu.assets import __file__ as assets_file

    return sorted(glob.glob(os.path.join(
        os.path.dirname(assets_file), "data", "track_*.yaml")))


def start_rows(yamls, agents):
    """Per-track start poses from the raceline CSVs (same recipe as
    examples/train_ppo.py --multi-map)."""
    starts = []
    for y in yamls:
        w = np.loadtxt(y.replace(".yaml", "_waypoints.csv"),
                       delimiter=";", comments="#")
        th = np.arctan2(w[1, 2] - w[0, 2], w[1, 1] - w[0, 1])
        row = [[w[0, 1], w[0, 2], th], [w[8, 1], w[8, 2], th]][:agents]
        starts.append(row)
    return jnp.asarray(starts, jnp.float32)


def batched_reset(cfg, params, poses, keys, map_idx):
    f = jax.jit(jax.vmap(
        lambda pr, po, k, m: envlib.reset(cfg, pr, po, k, map_idx=m),
        in_axes=(None, 0, 0, 0)))
    return f(params, poses, keys, map_idx)


def evaluate(cfg, ppo, pparams, params, poses, map_idx, keys, steps):
    """Roll the deterministic mean policy; returns per-env (speed sum,
    crashed flag, final laps).

    ``params`` is a jit ARGUMENT, not a closure: closing over the 7-track
    stacked textures embeds them as HLO constants (same lesson as
    examples/train_ppo.py)."""
    states, obs, *_ = batched_reset(cfg, params, poses, keys, map_idx)

    def body(params, pp_, carry, _):
        states, obs = carry
        mean, _, _ = ppo.policy.apply(pp_, obs.scans[:, 0],
                                      obs.linear_vels_x[:, 0])
        act = ppo._env_actions(mean, obs, pp_)
        states, obs, _, done, _ = jax.vmap(
            lambda p_, s, a: envlib.step(cfg, p_, s, a),
            in_axes=(None, 0, 0))(params, states, act)
        return (states, obs), (obs.linear_vels_x[:, 0], obs.collisions[:, 0])

    @jax.jit
    def roll(params, pp_, states, obs):
        (states, _), (vels, colls) = jax.lax.scan(
            lambda c, x: body(params, pp_, c, x), (states, obs), None,
            length=steps)
        return states, vels, colls

    states, vels, colls = roll(params, pparams, states, obs)
    return (np.asarray(vels), np.asarray(colls),
            np.asarray(states.lap_counts[:, 0]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--rollout", type=int, default=32)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--holdout", type=int, default=2,
                    help="number of tracks (from the end of the sorted "
                         "list) excluded from training")
    ap.add_argument("--eval-envs-per-track", type=int, default=128)
    ap.add_argument("--eval-steps", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-csv", type=str, default=None)
    ap.add_argument("--rt-stride", type=int, default=2,
                    help="range-texture pose stride (texture cell = stride "
                         "* map resolution); raise for cheap CPU smokes")
    ap.add_argument("--collision-penalty", type=float, default=10.0,
                    help="crash penalty in the PPO shaping (the default "
                         "10 matches the committed study; raising it "
                         "trades pace for narrow-corridor safety — the "
                         "1000-iter overtraining negative showed the "
                         "speed term dominating, docs/status.md)")
    args = ap.parse_args()

    yamls = track_yamls()
    assert len(yamls) > args.holdout >= 1, (len(yamls), args.holdout)
    train_yamls = yamls[: len(yamls) - args.holdout]
    names = [os.path.basename(y)[: -len(".yaml")] for y in yamls]
    print(f"train tracks: {names[: len(train_yamls)]}")
    print(f"held-out tracks: {names[len(train_yamls):]}")

    cfg = SimConfig(num_agents=args.agents, num_beams=1080, timestep=0.01,
                    integrator=Integrator.RK4, dtype="float32",
                    scan_mode="fast", rt_pose_stride=args.rt_stride)

    # ---- train on the train split ----
    params_tr = envlib.make_multimap_params(cfg, train_yamls)
    starts_tr = start_rows(train_yamls, args.agents)
    map_idx = jnp.arange(args.envs, dtype=jnp.int32) % len(train_yamls)
    poses = starts_tr[map_idx]

    mesh = sh.make_env_mesh()
    params_tr = sh.shard_params(mesh, params_tr)
    keys = jax.random.split(jax.random.PRNGKey(args.seed), args.envs)
    states, obs, *_ = batched_reset(cfg, params_tr, poses, keys, map_idx)
    states = sh.shard_envs(mesh, states)
    obs = sh.shard_envs(mesh, obs)

    from red_gym_tpu.agents.ppo import progress_collision_reward

    ppo = PPO(cfg, params_tr, PPOConfig(rollout_len=args.rollout),
              reward_fn=progress_collision_reward(
                  collision_penalty=args.collision_penalty))
    pstate = sh.replicate(mesh, ppo.init(jax.random.PRNGKey(args.seed + 1)))
    train = jax.jit(lambda ps, s, o, ep: ppo.train_step(ps, s, o, ep))

    spi = args.envs * args.rollout
    for it in range(args.iters):
        t0 = time.time()
        pstate, states, obs, m = train(pstate, states, obs, params_tr)
        loss = float(m["loss"])
        print(f"iter {it}: loss={loss:.4f} "
              f"speed={float(m['speed_mean']):.2f} "
              f"done={float(m['done_rate']):.3f} "
              f"({spi / (time.time() - t0):,.0f} env-steps/s)", flush=True)

    # ---- evaluate per track (all tracks stacked; envs grouped by track) ----
    params_all = envlib.make_multimap_params(cfg, yamls)
    starts_all = start_rows(yamls, args.agents)
    ntr = len(yamls)
    e = args.eval_envs_per_track
    eval_idx = jnp.repeat(jnp.arange(ntr, dtype=jnp.int32), e)
    eval_poses = starts_all[eval_idx]
    ekeys = jax.random.split(jax.random.PRNGKey(args.seed + 2), ntr * e)
    vels, colls, laps = evaluate(cfg, ppo, pstate.params, params_all,
                                 eval_poses, eval_idx, ekeys, args.eval_steps)

    rows = []
    for t in range(ntr):
        sl = slice(t * e, (t + 1) * e)
        split = "train" if t < len(train_yamls) else "holdout"
        rows.append({
            "track": names[t], "split": split,
            "speed_mean": round(float(vels[:, sl].mean()), 3),
            "crash_rate": round(float((colls[:, sl].sum(0) > 0).mean()), 4),
            "laps_mean": round(float(laps[sl].mean()), 3),
        })
        print(f"{names[t]:>12} [{split:7}] speed {rows[-1]['speed_mean']:5.2f} "
              f"m/s  crash {rows[-1]['crash_rate']:.3f}  "
              f"laps {rows[-1]['laps_mean']:.2f}", flush=True)

    tr = [r for r in rows if r["split"] == "train"]
    ho = [r for r in rows if r["split"] == "holdout"]
    ts = np.mean([r["speed_mean"] for r in tr])
    hs = np.mean([r["speed_mean"] for r in ho])
    print(f"train-split mean speed {ts:.2f} m/s; "
          f"held-out {hs:.2f} m/s ({hs / ts:.0%} of train)")

    if args.log_csv:
        import csv

        os.makedirs(os.path.dirname(args.log_csv) or ".", exist_ok=True)
        with open(args.log_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.log_csv}")


if __name__ == "__main__":
    main()
