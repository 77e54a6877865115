"""Roofline accounting for the env step on a GPU.

Three measurements of bench.py's timed program (the jitted scan of batched
env steps):

1. **XLA cost analysis** — ``compiled.cost_analysis()`` gives the
   compiler's own FLOP and device-memory byte counts; over the measured
   step time and the card's published peaks (PEAKS, keyed by
   ``device_kind``) they give achieved shares of the matmul and memory
   rooflines.
2. **Profiler per-kernel table** (``--profile``) — a ``jax.profiler``
   trace read back with ``jax.profiler.ProfileData``; device-side event
   durations summed per kernel over the GPU device planes.
3. **Stub ablation** (``--ablate``) — marginal ms/step of each phase by
   re-tracing the step with that phase stubbed out of the library
   (opponent raycast, body SAT, iTTC, the whole lidar).

Usage:
    python tools/roofline.py [--mode default|ultra|...]
        [--envs 16384] [--steps 100] [--profile] [--ablate] [--json out]
"""

import argparse
import glob
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402  (repo-root bench.py: mode configs)

# Published dense peaks per device, keyed by jax device_kind.  Source:
# NVIDIA H100 Tensor Core GPU datasheet (SXM5 part, without sparsity);
# they assume the 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0, "tf32_tflops": 495.0, "fp32_tflops": 67.0,
        "hbm_gbs": 3350.0,
        "source": "NVIDIA H100 datasheet, SXM5, dense",
    },
}


def peaks_for(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise SystemExit(f"no published peaks for device {device_kind!r}; "
                         f"add them to tools/roofline.py PEAKS with their "
                         f"source")
    return PEAKS[device_kind]


def _build_run(cfg, n_envs, steps):
    """bench.measure's program (obs.scans is a data dependency of the
    output), returned unjitted with its arguments."""
    import jax
    import jax.numpy as jnp

    from red_gym_tpu import assets, env as envlib

    params = envlib.make_params(cfg, assets.example_map_yaml())
    poses = jnp.asarray(assets.raceline_poses(n_envs, cfg.num_agents),
                        jnp.float32)
    init = jax.jit(jax.vmap(lambda po, k: envlib.init_state(cfg, po, k)))
    states = init(poses, jax.random.split(jax.random.PRNGKey(0), n_envs))

    def run(params, states, key):
        def body(carry, _):
            s, k = carry
            k, ka = jax.random.split(k)
            steer = 0.4 * jax.random.uniform(ka, (n_envs, cfg.num_agents),
                                             jnp.float32, -1.0, 1.0)
            speed = jnp.full((n_envs, cfg.num_agents), 3.0, jnp.float32)
            act = jnp.stack([steer, speed], axis=-1)
            s, obs, r, d, _ = jax.vmap(
                lambda ss, aa: envlib.step(cfg, params, ss, aa))(s, act)
            return (s, k), (d, jnp.sum(obs.scans))
        (s, _), (dones, ssum) = jax.lax.scan(
            body, (states, key), None, length=steps)
        return s, dones, ssum

    return run, params, states


def measure_mode(cfg, n_envs, steps, repeats=3):
    """(ms/step, cost_analysis dict) for the full scan-of-steps program."""
    import jax

    run, params, states = _build_run(cfg, n_envs, steps)
    compiled = jax.jit(run).lower(params, states,
                                  jax.random.PRNGKey(1)).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    jax.block_until_ready(compiled(params, states, jax.random.PRNGKey(1)))
    best = float("inf")
    for i in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(params, states,
                                       jax.random.PRNGKey(2 + i)))
        best = min(best, time.perf_counter() - t0)
    return best * 1e3 / steps, ca


def profile_kernels(cfg, n_envs, steps, top=25):
    """Per-kernel device time [ms over the window] from a profiler trace
    of one timed call, summed over the GPU device planes."""
    import jax

    run, params, states = _build_run(cfg, n_envs, steps)
    jitted = jax.jit(run)
    jax.block_until_ready(jitted(params, states, jax.random.PRNGKey(1)))
    tmp = tempfile.mkdtemp(prefix="roofline_")
    jax.profiler.start_trace(tmp)
    jax.block_until_ready(jitted(params, states, jax.random.PRNGKey(9)))
    jax.profiler.stop_trace()
    pbs = glob.glob(os.path.join(tmp, "**", "*.xplane.pb"), recursive=True)
    if not pbs:
        raise RuntimeError("profiler wrote no xplane.pb")
    data = jax.profiler.ProfileData.from_file(pbs[0])
    planes = [p for p in data.planes if p.name.startswith("/device:GPU:")]
    if not planes:
        raise RuntimeError(f"no GPU device plane in the trace (planes: "
                           f"{[p.name for p in data.planes]})")
    agg = defaultdict(float)
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                agg[ev.name] += ev.duration_ns / 1e6
    return sorted(agg.items(), key=lambda kv: -kv[1])[:top]


def _ablation_variants():
    """{phase: contextmanager} — each stubs ONE phase out of env.step."""
    import contextlib

    import jax.numpy as jnp

    from red_gym_tpu.ops import agent_scan, collision as col, scan_fast

    @contextlib.contextmanager
    def _patched(obj, name, repl):
        orig = getattr(obj, name)
        setattr(obj, name, repl)
        try:
            yield
        finally:
            setattr(obj, name, orig)

    def zero_scan(pose, tables, tmap, rtex, cfg, midx=None):
        return jnp.zeros(pose.shape[:-1] + (cfg.num_beams,), pose.dtype)

    return {
        "opponent raycast": lambda: _patched(
            agent_scan, "ray_cast_all_opponents",
            lambda poses, scans, verts, tables: scans),
        "body SAT": lambda: _patched(
            col, "pairwise_hits_from_poses",
            lambda poses, length, width: jnp.zeros(poses.shape[:-1],
                                                   poses.dtype)),
        "iTTC": lambda: _patched(
            agent_scan, "check_ttc",
            lambda scans, vel, tables, thr: jnp.zeros(vel.shape, bool)),
        "whole lidar (scan + noise + iTTC)": lambda: _patched(
            scan_fast, "trace_fast_mxu", zero_scan),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="default",
                    help=f"one of {sorted(bench.MODE_LABELS)}")
    ap.add_argument("--envs", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--json", default="")
    args = ap.parse_args()

    from red_gym_tpu.utils import runtime

    card = runtime.card()
    runtime.enable_compile_cache()
    dev = runtime.require_gpu()
    peaks = peaks_for(dev.device_kind)

    cfg = bench.make_cfg(args.mode)
    out = {"mode": args.mode, "envs": args.envs, "steps": args.steps,
           "card": card, "device": runtime.device_record(1)}
    ms, ca = measure_mode(cfg, args.envs, args.steps)
    out["ms_per_step"] = ms
    out["env_steps_per_s"] = args.envs / (ms * 1e-3)
    print(f"[{args.mode}] {ms:.4f} ms/step = {out['env_steps_per_s']:.1f} "
          f"env-steps/s ({args.envs} envs, {card})")

    # XLA's cost analysis counts a while-loop body once, not per trip:
    # for the scan of steps its totals are per step already
    flops = ca["flops"]
    nbytes = ca.get("bytes accessed", 0.0)
    sec = ms * 1e-3
    out["cost_analysis"] = {
        "flops_per_step": flops, "bytes_per_step": nbytes,
        "pct_bf16_peak": 100 * flops / sec / (peaks["bf16_tflops"] * 1e12),
        "pct_tf32_peak": 100 * flops / sec / (peaks["tf32_tflops"] * 1e12),
        "pct_hbm_peak": 100 * nbytes / sec / (peaks["hbm_gbs"] * 1e9),
        "peaks": peaks,
    }
    c = out["cost_analysis"]
    print(f"  XLA cost analysis: {flops / 1e9:.3f} GFLOP/step, "
          f"{nbytes / 1e6:.1f} MB/step -> {c['pct_bf16_peak']:.2f}% of the "
          f"bf16 peak, {c['pct_tf32_peak']:.2f}% of tf32, "
          f"{c['pct_hbm_peak']:.2f}% of HBM bandwidth ({peaks['source']})")

    if args.profile:
        rows = profile_kernels(cfg, args.envs, args.steps)
        print("  top kernels (device ms/step):")
        for name, t in rows:
            print(f"    {t / args.steps:9.4f}  {name[:100]}")
        out["profile"] = [{"kernel": n, "ms_per_step": t / args.steps}
                          for n, t in rows]

    if args.ablate:
        print("  marginal phase costs (phase stubbed out, re-jitted):")
        out["ablation"] = []
        for phase, ctx in _ablation_variants().items():
            with ctx():
                ms_wo, _ = measure_mode(cfg, args.envs, args.steps, 2)
            print(f"    {ms - ms_wo:+.4f} ms/step  {phase}  (without: "
                  f"{ms_wo:.4f} ms/step)")
            out["ablation"].append({"phase": phase,
                                    "marginal_ms": ms - ms_wo,
                                    "without_ms": ms_wo})

    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
