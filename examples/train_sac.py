"""SAC training on lidar bitmaps through the path-planning env.

On-device counterpart of the reference training loop (reference:
src/SAL.py:975-1022): same agent hyperparameters (batch 64, update every 50
steps after 1000, tau 0.005, gamma 0.99, alpha 0.2) but the env, rasterizer,
MPC and replay buffer all live on device.

Usage:
    python examples/train_sac.py --episodes 2 --steps 200   # smoke
    python examples/train_sac.py                            # full run
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import jax
import jax.numpy as jnp

from red_gym_tpu.config import SimConfig
from red_gym_tpu import env as envlib
from red_gym_tpu.agents import planning_env as pe
from red_gym_tpu.agents.sac import SAC, ReplayBuffer
from red_gym_tpu.assets import example_map_yaml
from red_gym_tpu.utils import checkpoint as ckpt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--update-after", type=int, default=1000)
    ap.add_argument("--update-every", type=int, default=50)
    ap.add_argument("--replay-capacity", type=int, default=50_000)
    ap.add_argument("--bitmap", type=int, default=256)
    ap.add_argument("--save", type=str, default="sac_actor_ckpt")
    ap.add_argument("--map", type=str, default=None)
    args = ap.parse_args()

    cfg = SimConfig(num_agents=1, num_beams=1080, timestep=0.015,
                    dtype="float32")
    params = envlib.make_params(cfg, args.map or example_map_yaml(), ".png")
    pcfg = pe.default_plan_config()._replace(
        bitmap_dims=(args.bitmap, args.bitmap))
    env = pe.PlanningEnv(cfg, params, pcfg)
    sac = SAC(obs_shape=(args.bitmap, args.bitmap), action_dim=pe.ACTION_DIM)

    sac_state = sac.init(jax.random.PRNGKey(0))
    buf = ReplayBuffer.create(args.replay_capacity,
                              (args.bitmap, args.bitmap), pe.ACTION_DIM)

    step = jax.jit(env.step)
    push = jax.jit(lambda b, o, a, r, no, d: b.push(o, a, r, no, d))
    select = jax.jit(lambda st, o, k: sac.select_action(st, o, k))

    start_pose = jnp.asarray([[0.0, 0.0, 1.57]], jnp.float32)  # SAL.py:71
    key = jax.random.PRNGKey(1)
    total_steps = 0
    t0 = time.time()

    for ep in range(args.episodes):
        key, kr = jax.random.split(key)
        ps = env.reset(start_pose, kr)
        obs = ps.bitmap
        ep_reward = 0.0
        for st in range(args.steps):
            key, ka, ku = jax.random.split(key, 3)
            action = select(sac_state, obs, ka)[0]
            ps, next_obs, reward, done, info = step(ps, action)
            buf = push(buf, obs, action, reward, next_obs,
                       jnp.float32(done))
            obs = next_obs
            ep_reward += float(reward)
            total_steps += 1

            if total_steps > args.update_after and \
                    total_steps % args.update_every == 0:
                key, ks, kb = jax.random.split(key, 3)
                batch = buf.sample(kb, args.batch_size)
                sac_state, m = sac.update(sac_state, batch, ks)
                print(f"step {total_steps}: actor={float(m['actor_loss']):.4f} "
                      f"c1={float(m['critic1_loss']):.4f} "
                      f"c2={float(m['critic2_loss']):.4f}", flush=True)
            if bool(done):
                break
        rate = total_steps / (time.time() - t0)
        print(f"episode {ep}: reward={ep_reward:.2f} steps={total_steps} "
              f"({rate:.1f} env-steps/s)", flush=True)

    ckpt.save(args.save, sac_state)
    print(f"training complete; checkpoint saved to {args.save}")


if __name__ == "__main__":
    main()
