"""On-card smoke test: the simulator and the PPO trainer at full width.

    python chip_smoke.py           # one GPU: phases 1-4
    python chip_smoke.py --multi   # four GPUs: the sharded PPO step only

Phases (one process; any failure exits non-zero before the last line):

1. the card (``nvidia-smi`` in a child that stays off JAX) and the device;
   no GPU -> non-zero exit, no result line;
2. range-texture build for ``track_0007`` (cold: the disk cache is off)
   and the batched env step at 16384 envs x 2 agents x 1080 beams, default
   ``SimConfig(scan_mode="fast")``: compile time, env-steps/s, peak device
   memory, finite scans;
3. accuracy of the fast scan against the float32 exact march on 2048 free
   poses: median / p99 error and the share of beams more than 4 texture
   cells off, at the matmul precision the code sets (XLA's default: TF32
   on the H100) and under ``jax.default_matmul_precision("highest")``;
4. the PPO ``train_step`` at 16384 envs, rollout 32, pure-pursuit
   opponents: finite losses, params change, env-steps/s;
5. (``--multi`` only) the same PPO step sharded over a 1-D ``env`` mesh of
   4 GPUs (parallel/sharding.py: params replicated, gradient psum over
   NVLink) against the same global batch on one GPU: losses agree to
   rtol 1e-4 (at full matmul precision), and each side's rate.

The last line is ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": N}}``.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

# every run measures a cold texture build and writes nothing outside the
# checkout
os.environ["RED_GYM_TPU_TEXTURE_CACHE"] = "off"
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

E_FULL, A_FULL, B_FULL = 16384, 2, 1080


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    """A failed check ends the run (non-zero exit, no result line)."""
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def free_poses(tmap, n, seed, clearance=0.3):
    """n random poses whose position is at least ``clearance`` m from any
    wall, uniform heading."""
    dt = np.asarray(tmap.dt)
    res = float(tmap.resolution)
    rng = np.random.default_rng(seed)
    rr, cc = np.nonzero(dt > clearance)
    pick = rng.integers(0, rr.size, n)
    x = (cc[pick] + 0.5) * res + float(tmap.orig_x)
    y = (rr[pick] + 0.5) * res + float(tmap.orig_y)
    return np.stack([x, y, rng.uniform(0, 2 * np.pi, n)], -1).astype(
        np.float32)


def err_stats(a, b, cell):
    err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return {"median_m": float(np.median(err)),
            "p99_m": float(np.quantile(err, 0.99)),
            "over_4_cells": float(np.mean(err > 4 * cell))}


def phase_env(cfg, card, peak):
    """Phase 2: texture build + full-width env step; returns params."""
    import jax

    import bench
    from red_gym_tpu import assets, env as envlib

    params, build_s = timed(
        lambda: envlib.make_params(cfg, assets.example_map_yaml()))
    log(f"[2] range texture (track_0007, cold build): {build_s:.2f} s, "
        f"rt {tuple(params.rtex.rt.shape)} {params.rtex.rt.dtype}")
    m = bench.measure(cfg, params, E_FULL, 100)
    check(np.isfinite(m.scan_sum), "non-finite scans in the timed rollout")
    log(f"[2] env step {E_FULL} envs x {cfg.num_agents} agents x "
        f"{cfg.num_beams} beams: compile+first run {m.compile_s:.1f} s, "
        f"{m.rate:.1f} env-steps/s ({card})")
    # one observed step: shape and finiteness of every scan
    poses = assets.raceline_poses(E_FULL, cfg.num_agents)
    keys = jax.random.split(jax.random.PRNGKey(3), E_FULL)
    _, obs, *_ = jax.jit(jax.vmap(
        lambda po, k: envlib.reset(cfg, params, po, k)))(poses, keys)
    scans = np.asarray(obs.scans)
    check(scans.shape == (E_FULL, cfg.num_agents, cfg.num_beams),
          f"scan shape {scans.shape}")
    check(np.isfinite(scans).all() and scans.max() > 0, "bad scans")
    log(f"[2] peak_bytes_in_use {peak()} B")
    return params


def phase_accuracy(cfg, params):
    """Phase 3: fast scan vs the float32 exact march."""
    import jax
    import jax.numpy as jnp

    from red_gym_tpu.ops import scan as scan_ops, scan_fast

    tables, tmap, rtex = params.tables, params.tmap, params.rtex
    cell = float(rtex.cell)
    poses = jnp.asarray(free_poses(tmap, 2048, seed=11))
    cfg_exact = dataclasses.replace(cfg, scan_mode="exact")
    exact = jax.jit(lambda p: scan_ops.trace(p, tables, tmap, cfg_exact))(
        poses)
    fast = lambda p: scan_fast.trace_fast_mxu(p, tables, tmap, rtex, cfg)
    rows = {"precision as coded": jax.jit(fast)(poses)}
    with jax.default_matmul_precision("highest"):
        rows["default_matmul_precision=highest"] = jax.jit(fast)(poses)
    for name, fast in rows.items():
        st = err_stats(fast, exact, cell)
        log(f"[3] accuracy vs exact march, 2048 poses, {name}: median "
            f"{st['median_m'] * 100:.3f} cm, p99 {st['p99_m'] * 100:.2f} cm,"
            f" beams > 4 cells ({4 * cell:.3f} m) off "
            f"{st['over_4_cells'] * 100:.3f}%")
        check(np.isfinite(np.asarray(fast)).all(), f"non-finite {name}")


def phase_ppo(cfg, params, card, peak):
    """Phase 4: PPO train_step at full width on one GPU."""
    import jax

    ppo, pstate, states, obs = make_trainer(cfg, params, E_FULL)
    pcfg = ppo.pcfg
    train = jax.jit(lambda ps, s, o, ep: ppo.train_step(ps, s, o, ep))
    p0 = jax.tree.leaves(pstate.params)
    (pstate, states, obs, met), compile_s = timed(train, pstate, states,
                                                   obs, params)
    log(f"[4] PPO train_step {E_FULL} envs, rollout {pcfg.rollout_len}: "
        f"compile+first iteration {compile_s:.1f} s")
    losses, dts = [float(met["loss"])], []
    for _ in range(3):
        (pstate, states, obs, met), dt = timed(train, pstate, states, obs,
                                               params)
        losses.append(float(met["loss"]))
        dts.append(dt)
    check(np.all(np.isfinite(losses)), f"non-finite PPO losses {losses}")
    changed = any(bool((a != b).any()) for a, b in
                  zip(p0, jax.tree.leaves(pstate.params)))
    check(changed, "params unchanged after 4 PPO iterations")
    rate = E_FULL * pcfg.rollout_len / min(dts)
    log(f"[4] PPO losses {losses}; best iteration {min(dts) * 1e3:.1f} ms ="
        f" {rate:.1f} env-steps/s incl. update ({card}); "
        f"peak_bytes_in_use {peak()} B")


def make_trainer(cfg, params, n_envs):
    """PPO (default PPOConfig, pure-pursuit opponents) with reset envs."""
    import jax
    import jax.numpy as jnp

    from red_gym_tpu import assets, env as envlib
    from red_gym_tpu.agents import pure_pursuit as pp
    from red_gym_tpu.agents.ppo import PPO, PPOConfig, pure_pursuit_opponents

    wpts = pp.load_waypoints_csv(assets.example_waypoints_csv(),
                                 dtype=jnp.float32)
    ppo = PPO(cfg, params, PPOConfig(),
              opponent_plan=pure_pursuit_opponents(pp.make_params(wpts)))
    pstate = ppo.init(jax.random.PRNGKey(1))
    poses = jnp.asarray(assets.raceline_poses(n_envs, cfg.num_agents),
                        jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), n_envs)
    states, obs, *_ = jax.jit(jax.vmap(
        lambda pr, po, k: envlib.reset(cfg, pr, po, k),
        in_axes=(None, 0, 0)))(params, poses, keys)
    return ppo, pstate, states, obs


def phase_multi(cfg, card):
    """Phase 5: the sharded PPO step on 4 GPUs vs one GPU, same batch.

    The loss comparison runs at ``default_matmul_precision("highest")``:
    at the default (TF32) the GEMM tiling XLA picks per shard shape
    rounds the scan differently, which alone moves the loss by ~1e-4
    relative; at full precision what is left is the sharding itself.
    Rates are timed at the default precision."""
    import jax

    from red_gym_tpu import assets, env as envlib
    from red_gym_tpu.parallel import sharding as sh

    n = len(jax.devices())
    check(n == 4, f"--multi needs 4 GPUs, JAX sees {n}")
    params = envlib.make_params(cfg, assets.example_map_yaml())
    ppo, pstate, states, obs = make_trainer(cfg, params, E_FULL)
    step = lambda p, s, o, e: ppo.train_step(p, s, o, e)
    loss = {}
    for d in (1, 4):
        mesh = sh.make_env_mesh(d)
        args = (sh.replicate(mesh, pstate), sh.shard_envs(mesh, states),
                sh.shard_envs(mesh, obs), sh.shard_params(mesh, params))
        with jax.default_matmul_precision("highest"):
            met = jax.jit(step)(*args)[3]
        loss[d] = float(met["loss"])
        train = jax.jit(step)
        _, compile_s = timed(train, *args)
        dts = [timed(train, *args)[1] for _ in range(3)]
        log(f"[5] {d} GPU(s): PPO loss at highest precision {loss[d]!r}; "
            f"compile+first {compile_s:.1f} s; best of 3 iterations "
            f"{min(dts) * 1e3:.1f} ms = "
            f"{E_FULL * ppo.pcfg.rollout_len / min(dts):.1f} env-steps/s "
            f"({card})")
    rel = abs(loss[4] - loss[1]) / abs(loss[1])
    log(f"[5] sharded vs single-GPU loss, relative difference {rel!r}")
    check(rel <= 1e-4, "sharded loss differs from the single-GPU run "
                       "beyond rtol 1e-4")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU sharded PPO phase")
    args = ap.parse_args(argv)

    from red_gym_tpu.utils import runtime

    card = runtime.card()
    import jax

    runtime.enable_compile_cache()
    dev = runtime.require_gpu()
    log(f"[1] card: {card}")
    log(f"[1] jax {jax.__version__}: {len(jax.devices())} x "
        f"{dev.device_kind}")

    def peak():
        return max((d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                   for d in jax.local_devices())

    from red_gym_tpu.config import SimConfig

    cfg = SimConfig(num_agents=A_FULL, num_beams=B_FULL, scan_mode="fast")
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(cfg, card)
    else:
        params = phase_env(cfg, card, peak)
        phase_accuracy(cfg, params)
        phase_ppo(cfg, params, card, peak)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True,
                      "device": runtime.device_record()}), flush=True)


if __name__ == "__main__":
    main()
