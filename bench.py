"""Benchmark: aggregate env-steps/s of the batched env step on one GPU,
2-agent races with 1080-beam lidar on the packaged ``track_0007``.

Runs in one process and fails when JAX finds no GPU.  Prints one JSON line
per measured mode; the LAST line is the library-default configuration:
fast scan_mode with nearest1 spatial lookup, linear theta interpolation
with the occlusion edge/width and gradient channels, pool noise.  Each line
names the card as
``nvidia-smi --query-gpu=name,power.limit`` reports it.

The reference publishes no absolute throughput number; its closest claim is
"up to 30x realtime" for the full env (reference docs/index.rst:12), i.e.
~3000 env-steps/s at the 0.01 s physics step on one CPU.  vs_baseline is
the ratio against that claim.

Usage:  python bench.py          (BENCH_MODES=default,ultra,... picks modes;
        BENCH_ENVS / BENCH_AGENTS / BENCH_STEPS override the shape)
"""

import dataclasses
import json
import os
import sys
import time
from typing import NamedTuple

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)

N_ENVS = int(os.environ.get("BENCH_ENVS", 16384))
N_AGENTS = int(os.environ.get("BENCH_AGENTS", 2))
STEPS = int(os.environ.get("BENCH_STEPS", 100))
MODES = os.environ.get("BENCH_MODES", "default").split(",")

MODE_LABELS = {
    "default": "library default: fast/nearest1/linear + edge/grad channels, "
               "pool noise",
    "ultra": "ultra: fast/nearest1/spectral, no edge/grad channels",
    "legacy": "bilinear/linear, no channels",
    "bilinear": "bilinear/linear + edge/grad channels",
    "fresh": "default + noise_mode=fresh (the reference's per-step stream)",
}


def make_cfg(mode: str = "default", num_agents: int = N_AGENTS):
    """The SimConfig of a named bench mode."""
    from red_gym_tpu.config import SimConfig

    cfg = SimConfig(num_agents=num_agents, num_beams=1080, scan_mode="fast")
    return dataclasses.replace(cfg, **{
        "default": {},
        "ultra": dict(scan_interp="spectral", rt_grad=False,
                      rt_occlusion="off"),
        "legacy": dict(rt_occlusion="off", rt_grad=False,
                       rt_spatial="bilinear"),
        "bilinear": dict(rt_spatial="bilinear"),
        "fresh": dict(noise_mode="fresh"),
    }[mode])


class Measured(NamedTuple):
    rate: float          # best-of-3 aggregate env-steps/s
    compile_s: float     # compile + first run of the timed program
    scan_sum: float      # sum of every observed scan (finite check)


def measure(cfg, params=None, n_envs: int = N_ENVS,
            steps: int = STEPS) -> Measured:
    """Time ``steps`` batched env steps (one jitted lax.scan, random steer,
    constant speed, every observation consumed) at ``n_envs`` envs spread
    along the default map's raceline."""
    import jax
    import jax.numpy as jnp

    from red_gym_tpu import assets, env as envlib

    if params is None:
        params = envlib.make_params(cfg, assets.example_map_yaml())
    poses = jnp.asarray(assets.raceline_poses(n_envs, cfg.num_agents),
                        cfg.jdtype)
    init = jax.jit(jax.vmap(lambda po, k: envlib.init_state(cfg, po, k)))
    states = init(poses, jax.random.split(jax.random.PRNGKey(0), n_envs))
    a_n = cfg.num_agents

    @jax.jit
    def run(params, states, key):
        def body(carry, _):
            s, k = carry
            k, ka = jax.random.split(k)
            steer = 0.4 * jax.random.uniform(ka, (n_envs, a_n), cfg.jdtype,
                                             -1.0, 1.0)
            speed = jnp.full((n_envs, a_n), 3.0, cfg.jdtype)
            act = jnp.stack([steer, speed], axis=-1)
            s, obs, _, done, _ = jax.vmap(
                lambda ss, aa: envlib.step(cfg, params, ss, aa))(s, act)
            # consume the full observation every step (a policy would):
            # keeps XLA from dead-code-eliminating the scan pipeline
            return (s, k), (done, jnp.sum(obs.scans))
        (s, _), (dones, ssum) = jax.lax.scan(
            body, (states, key), None, length=steps)
        return s, dones, jnp.sum(ssum)

    t0 = time.perf_counter()
    _, _, ssum = jax.block_until_ready(run(params, states,
                                           jax.random.PRNGKey(1)))
    compile_s = time.perf_counter() - t0
    rate = 0.0
    for i in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(params, states, jax.random.PRNGKey(2 + i)))
        rate = max(rate, n_envs * steps / (time.perf_counter() - t0))
    return Measured(rate, compile_s, float(ssum))


def main():
    from red_gym_tpu.utils import runtime

    card = runtime.card()
    runtime.enable_compile_cache()
    runtime.require_gpu()
    device = runtime.device_record(1)
    modes = [m for m in dict.fromkeys(MODES) if m != "default"] + ["default"]
    for mode in modes:
        m = measure(make_cfg(mode))
        print(json.dumps({
            "metric": f"env-steps/s aggregate ({N_AGENTS}-agent, 1080-beam "
                      f"lidar, {N_ENVS} envs, {MODE_LABELS[mode]})",
            "value": round(m.rate, 1),
            "unit": "env-steps/s",
            "vs_baseline": round(m.rate / 3000.0, 2),
            "compile_s": round(m.compile_s, 1),
            "card": card,
            "device": device,
        }), flush=True)


if __name__ == "__main__":
    main()
