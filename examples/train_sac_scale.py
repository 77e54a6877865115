"""SAC at scale: vectorized envs + on-device replay, one jitted program.

The reference SAC loop steps ONE env on host, with a Python deque replay and
a host OSQP MPC in the action path (reference: src/SAL.py:975-1022) — that
compatibility pipeline lives in examples/train_sac.py.  This version is the
on-device scale-out: E envs step in parallel, every transition batch lands
in the device ring buffer, and each iteration (collect N steps + N gradient
updates) runs as a single jitted lax.scan — zero host<->device traffic
inside an iteration.

Usage:
    python examples/train_sac_scale.py --envs 512 --iters 20
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


import jax
import jax.numpy as jnp

from red_gym_tpu.config import Integrator, SimConfig
from red_gym_tpu import env as envlib
from red_gym_tpu.agents import sac as sac_lib
from red_gym_tpu.assets import example_map_yaml, raceline_poses
from red_gym_tpu.utils import checkpoint as ckpt
from red_gym_tpu.utils.profiling import Metrics


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=512)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--steps-per-iter", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--log-csv", type=str, default=None,
                    help="write per-iteration metrics to this CSV")
    ap.add_argument("--updates-per-step", type=int, default=1,
                    help="gradient updates per collected env-step batch "
                         "(raise to keep the replay ratio sane at small "
                         "env counts)")
    ap.add_argument("--capacity", type=int, default=200_000)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--warmup-iters", type=int, default=2)
    ap.add_argument("--save", type=str, default="sac_scale_ckpt")
    args = ap.parse_args()
    if args.updates_per_step < 1:
        ap.error("--updates-per-step must be >= 1")

    cfg = SimConfig(num_agents=1, num_beams=args.beams, timestep=0.01,
                    integrator=Integrator.RK4, dtype="float32",
                    scan_mode="fast", scan_interp="spectral")
    params = envlib.make_params(cfg, example_map_yaml(), ".png")

    sac = sac_lib.SAC(obs_shape=(args.beams,), action_dim=2,
                      actor=sac_lib.ScanActor(action_dim=2),
                      critic=sac_lib.ScanCritic(), obs_dtype=jnp.float32)
    sstate = sac.init(jax.random.PRNGKey(1))
    buf = sac_lib.ReplayBuffer.create(args.capacity, (args.beams,), 2,
                                      obs_dtype=jnp.float32)

    poses = jnp.asarray(raceline_poses(args.envs, 1), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), args.envs)
    reset_v = jax.jit(jax.vmap(
        lambda pr, po, k: envlib.reset(cfg, pr, po, k), in_axes=(None, 0, 0)))
    states, obs, *_ = reset_v(params, poses, keys)

    step_v = jax.vmap(lambda pr, s, a: envlib.step(cfg, pr, s, a),
                      in_axes=(None, 0, 0))
    reset_vj = jax.vmap(lambda pr, po, k: envlib.reset(cfg, pr, po, k),
                        in_axes=(None, 0, 0))

    def to_control(act):
        steer = 0.4 * act[..., 0]
        speed = 4.0 * (act[..., 1] + 1.0)   # tanh output in [-1,1] -> [0,8]
        return jnp.stack([steer, speed], axis=-1)[:, None, :]

    def make_iteration(do_update: bool):
        # env params are a traced ARGUMENT (pr), never a closure: the
        # map/range textures would otherwise become HLO constants and blow
        # remote-compile request limits
        def body(pr, carry, _):
            sstate, buf, states, obs, key, acc = carry
            key, ka, kb, kr, ku = jax.random.split(key, 5)

            scan_obs = obs.scans[:, 0]
            act, _ = sac_lib.sample_action(sstate.actor_params, sac.actor,
                                           scan_obs, ka)
            states2, obs2, _, done, _ = step_v(pr, states, to_control(act))
            # SAL-scale shaping (reference src/SAL.py:219-250 magnitudes:
            # progress x10, crash -100): per-step rewards must dominate the
            # alpha=0.2 entropy term or SAC optimizes entropy alone
            r = (10.0 * obs2.linear_vels_x[:, 0] * cfg.timestep
                 - 100.0 * obs2.collisions[:, 0])
            buf = buf.push_batch(scan_obs, act, r, obs2.scans[:, 0], done)

            rkeys = jax.random.split(kr, done.shape[0])
            r_states, r_obs, *_ = reset_vj(pr, states2.start_pose, rkeys)
            sel = lambda a_, b_: jnp.where(
                done.reshape((-1,) + (1,) * (a_.ndim - 1)), a_, b_)
            states2 = jax.tree.map(sel, r_states, states2)
            obs2 = jax.tree.map(sel, r_obs, obs2)

            actor_loss = jnp.float32(0)
            if do_update:
                for j in range(args.updates_per_step):
                    kb_j = jax.random.fold_in(kb, j)
                    ku_j = jax.random.fold_in(ku, j)
                    batch = buf.sample(kb_j, args.batch_size)
                    sstate, losses = sac.update(sstate, batch, ku_j)
                actor_loss = losses["actor_loss"]
            # on-device metric accumulator carried through the scan —
            # O(1) memory instead of stacking per-step metric pytrees
            acc = Metrics.update(acc, reward=r.mean(), done=done.mean(),
                                 actor_loss=actor_loss)
            return (sstate, buf, states2, obs2, key, acc), None

        @jax.jit
        def iteration(pr, sstate, buf, states, obs, key):
            acc = Metrics.init(("reward", "done", "actor_loss"))
            (sstate, buf, states, obs, key, acc), _ = jax.lax.scan(
                lambda c, x: body(pr, c, x),
                (sstate, buf, states, obs, key, acc),
                None, length=args.steps_per_iter)
            return sstate, buf, states, obs, key, acc

        return iteration

    warmup_it = make_iteration(do_update=False)
    train_it = make_iteration(do_update=True)

    key = jax.random.PRNGKey(2)
    spi = args.envs * args.steps_per_iter
    csv_f = None
    if args.log_csv:
        csv_f = open(args.log_csv, "w")
        csv_f.write("iter,env_steps,reward,done_rate,actor_loss,wall_s\n")
    t_start = time.time()
    for it in range(args.iters):
        t0 = time.time()
        fn = warmup_it if it < args.warmup_iters else train_it
        sstate, buf, states, obs, key, acc = fn(params, sstate, buf, states,
                                                obs, key)
        m = Metrics.means(acc)
        r = m["reward"]
        dt = time.time() - t0
        print(f"iter {it}: reward={r:.4f} done_rate={m['done']:.3f} "
              f"actor_loss={m['actor_loss']:.4f} "
              f"buf={int(buf.size)} ({spi / dt:,.0f} env-steps/s)", flush=True)
        if csv_f:
            csv_f.write(f"{it},{(it + 1) * spi},{r:.6f},{m['done']:.6f},"
                        f"{m['actor_loss']:.6f},{time.time() - t_start:.2f}\n")
            csv_f.flush()
    if csv_f:
        csv_f.close()

    ckpt.save(args.save, sstate)
    print(f"saved {args.save}")


if __name__ == "__main__":
    main()
