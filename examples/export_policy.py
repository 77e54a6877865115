"""Export a trained PPO racer as a deployable StableHLO artifact.

The deployment analogue of the reference's ``torch.save(actor.state_dict(),
"sac_actor.pth")`` (reference src/SAL.py:1017): the greedy
inference head (scan, vel) -> (steer, speed) with the trained weights baked
in is AOT-lowered for cpu+cuda and serialized as versioned StableHLO — the
on-car runtime needs jax only, no red_gym_tpu / checkpoint code.

    python examples/train_ppo.py --envs 4096 --iters 60 --save ppo_ckpt
    python examples/export_policy.py --ckpt ppo_ckpt --out racer.stablehlo
    # on the robot / server:
    python examples/export_policy.py --serve racer.stablehlo
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, default=None,
                    help="orbax dir written by train_ppo.py --save; "
                         "random-init weights if omitted (smoke mode)")
    ap.add_argument("--out", type=str, default="racer.stablehlo")
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--platforms", type=str, default="cpu,cuda")
    ap.add_argument("--serve", type=str, default=None,
                    help="load an exported artifact and time inference "
                         "instead of exporting")
    ap.add_argument("--batch", type=int, default=64,
                    help="--serve benchmark batch size")
    ap.add_argument("--race", type=str, default=None,
                    help="load an exported artifact and drive it closed-"
                         "loop in the simulator (the on-car integration "
                         "smoke: artifact in, laps out)")
    ap.add_argument("--race-steps", type=int, default=3000)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from red_gym_tpu.utils import export as ex

    if args.serve:
        racer = ex.load_policy(args.serve)
        print(f"loaded {args.serve}: platforms={racer.platforms}, "
              f"in={[str(a) for a in racer.in_avals]}")
        beams = int(str(racer.in_avals[0].shape[-1]))
        rng = np.random.default_rng(0)
        scan = jnp.asarray(rng.uniform(0, 30, (args.batch, beams)),
                           jnp.float32)
        vel = jnp.asarray(rng.uniform(0, 8, (args.batch,)), jnp.float32)
        out = np.asarray(racer.call(scan, vel))      # compile + run
        t0 = time.time()
        n = 100
        for _ in range(n):
            out = racer.call(scan, vel)
        np.asarray(out)
        dt = (time.time() - t0) / n
        print(f"controls[0] = {np.asarray(out)[0]}; "
              f"{1e6 * dt:.0f} us/call at batch {args.batch} "
              f"({args.batch / dt:,.0f} agents/s)")
        return

    if args.race:
        from red_gym_tpu.config import Integrator
        from red_gym_tpu import env as envlib
        from red_gym_tpu.assets import example_map_yaml

        racer = ex.load_policy(args.race)
        env = envlib.make(map=example_map_yaml(), map_ext=".png",
                          num_agents=2, timestep=0.01,
                          integrator=Integrator.RK4, scan_mode="fast")
        obs, *_ = env.reset(envlib.staggered_start_poses(2))
        speeds, crashes = [], 0
        for t in range(args.race_steps):
            scan = jnp.asarray(obs["scans"][0:1], jnp.float32)
            vel = jnp.asarray(obs["linear_vels_x"][0:1], jnp.float32)
            ego = np.asarray(racer.call(scan, vel))[0]
            act = np.array([ego, [0.0, 2.0]])     # opponent: slow cruise
            obs, _, done, _ = env.step(act)
            speeds.append(float(obs["linear_vels_x"][0]))
            crashes += int(obs["collisions"][0])
            if done:
                break
        print(f"raced {t + 1} steps: laps={int(obs['lap_counts'][0])}, "
              f"mean speed {np.mean(speeds):.2f} m/s, "
              f"collision steps {crashes}")
        return

    from red_gym_tpu.agents import ppo as ppolib
    from red_gym_tpu.utils import checkpoint as ckpt

    policy = ppolib.ScanPolicy()
    pcfg = ppolib.PPOConfig()
    scan = jnp.zeros((1, args.beams), jnp.float32)
    vel = jnp.zeros((1,), jnp.float32)
    params = policy.init(jax.random.PRNGKey(0), scan, vel)

    if args.ckpt:
        flat = ckpt.restore(args.ckpt)
        # train_ppo saves a PPOState(params, opt_state, key); accept either
        # the full trainer state or a bare params tree
        paths, treedef = jax.tree_util.tree_flatten_with_path(params)
        keys = [jax.tree_util.keystr(p) for p, _ in paths]
        prefix = ".params" if ".params" + keys[0] in flat else ""
        params = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(flat[prefix + k]) for k in keys])
        print(f"restored weights from {args.ckpt}")
    else:
        print("WARNING: no --ckpt given, exporting random-init weights")

    fn = ex.deterministic_ppo_control(policy, pcfg, params)
    exp = ex.save_policy(args.out, fn, (scan, vel),
                         platforms=tuple(args.platforms.split(",")))
    size = os.path.getsize(args.out)
    print(f"exported {args.out}: {size / 1e6:.2f} MB, "
          f"platforms={exp.platforms}, symbolic batch, "
          f"in={[str(a) for a in exp.in_avals]}")


if __name__ == "__main__":
    main()
