"""Worker process for tests/test_distributed.py.

Runs N sharded PPO training steps over a global env mesh and writes the
per-step losses + parameter checksums to a JSON file.  Launch shapes:

* 1 process x 8 virtual CPU devices  (the baseline program)
* 2 processes x 4 devices / 4 processes x 2 devices (multi-host shapes)

All shapes run the SAME global program and must produce the same numbers.
Fault drill: ``--die-at k`` makes the LAST process exit abruptly
(os._exit, no cleanup — a kill -9 equivalent) before step k; ``--resume``
restores {pstate, env states, obs, step} from the orbax checkpoint dir and
continues, and the combined loss sequence must equal an uninterrupted run.

Usage: python _distributed_worker.py <coordinator> <num_procs> <proc_id>
       <out.json> [--steps N] [--ckpt-every E] [--ckpt-dir D]
       [--die-at K] [--resume]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("coord")
    ap.add_argument("nprocs", type=int)
    ap.add_argument("pid", type=int)
    ap.add_argument("out")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--die-at", type=int, default=-1)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args()
    nprocs, pid = args.nprocs, args.pid

    import jax

    # the worker is a CPU process with virtual devices
    jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import jax.numpy as jnp

    from red_gym_tpu.config import Integrator, SimConfig
    from red_gym_tpu import env as envlib
    from red_gym_tpu.agents.ppo import PPO, PPOConfig, ScanPolicy
    from red_gym_tpu.parallel import distributed as dist
    from red_gym_tpu.parallel import sharding as sh
    from red_gym_tpu.utils import checkpoint as ckpt

    if nprocs > 1:
        dist.initialize(args.coord, nprocs, pid)
    assert jax.process_count() == nprocs, (jax.process_count(), nprocs)
    assert len(jax.devices()) == 8, f"want 8 global devices, got {len(jax.devices())}"

    import glob

    data = os.path.join(os.path.dirname(__file__), "..", "red_gym_tpu",
                        "assets", "data")
    map_yaml = sorted(glob.glob(os.path.join(data, "track_*.yaml")))[0]

    cfg = SimConfig(num_agents=2, num_beams=54, timestep=0.01,
                    integrator=Integrator.RK4, dtype="float32",
                    march_iters=8, scan_noise_std=0.0)
    env_params = envlib.make_params(cfg, map_yaml, ".png")

    mesh = dist.make_env_mesh()
    env_params = sh.shard_params(mesh, env_params)

    n_env = 16
    w = np.loadtxt(map_yaml.replace(".yaml", "_waypoints.csv"),
                   delimiter=";", comments="#")
    th = float(np.arctan2(w[1, 2] - w[0, 2], w[1, 1] - w[0, 1]))
    start = np.asarray([[w[0, 1], w[0, 2], th],
                        [w[8, 1], w[8, 2], th]], np.float32)

    # identical global seeds on every process; each materializes only its rows
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(0), n_env))
    rows = dist.process_env_slice(n_env)
    poses_local = np.tile(start, (rows.stop - rows.start, 1, 1))
    keys_local = keys[rows]

    reset_v = jax.jit(jax.vmap(
        lambda pr, po, k: envlib.reset(cfg, pr, po, k), in_axes=(None, 0, 0)))
    states_l, obs_l, *_ = reset_v(env_params, jnp.asarray(poses_local),
                                  jnp.asarray(keys_local))
    states = dist.global_env_tree(mesh, jax.tree.map(np.asarray, states_l))
    obs = dist.global_env_tree(mesh, jax.tree.map(np.asarray, obs_l))

    ppo = PPO(cfg, env_params,
              PPOConfig(rollout_len=4, minibatches=2, epochs=1),
              ScanPolicy(hidden=32, scan_stride=4))
    pstate = ppo.init(jax.random.PRNGKey(1))
    pstate = sh.replicate(mesh, pstate)
    checksum0 = float(sum(jnp.sum(jnp.abs(l)) for l in
                          jax.tree.leaves(pstate.params)))

    start_step = 0
    if args.resume:
        tpl = {"pstate": pstate, "states": states, "obs": obs}
        got = ckpt.restore(args.ckpt_dir, like=tpl)
        pstate, states, obs = got["pstate"], got["states"], got["obs"]
        with open(os.path.join(args.ckpt_dir, "STEP")) as f:
            start_step = int(f.read())

    train = jax.jit(lambda ps, s, o, ep: ppo.train_step(ps, s, o, ep))

    losses, rewards, checksums = [], [], []
    for t in range(start_step, args.steps):
        if t == args.die_at and pid == nprocs - 1:
            sys.stdout.flush()
            os._exit(9)   # abrupt worker death: no cleanup, no barrier
        pstate, states, obs, metrics = train(pstate, states, obs, env_params)
        losses.append(float(metrics["loss"]))
        rewards.append(float(metrics["reward_mean"]))
        checksums.append(float(sum(jnp.sum(jnp.abs(l)) for l in
                                   jax.tree.leaves(pstate.params))))
        if args.ckpt_every and (t + 1) % args.ckpt_every == 0 \
                and (args.die_at < 0 or t + 1 <= args.die_at):
            ckpt.save(args.ckpt_dir,
                      {"pstate": pstate, "states": states, "obs": obs})
            if pid == 0:
                with open(os.path.join(args.ckpt_dir, "STEP"), "w") as f:
                    f.write(str(t + 1))

    out = {"process_count": jax.process_count(),
           "process_index": jax.process_index(),
           "start_step": start_step,
           "losses": losses, "rewards": rewards, "checksums": checksums,
           # single-step back-compat fields (None when a resume restores at
           # start_step == --steps and the loop body never runs)
           "loss": losses[-1] if losses else None,
           "reward_mean": rewards[-1] if rewards else None,
           "param_checksum": checksums[-1] if checksums else None,
           "param_checksum_before": checksum0}
    with open(args.out, "w") as f:
        json.dump(out, f)
    print("worker done:", {k: out[k] for k in
                           ("process_count", "start_step", "loss")})


if __name__ == "__main__":
    main()
