"""Throughput floor gates, mirroring the reference's in-module perf tests
(reference: dynamic_models.py:271-279 >5k RHS calls/s; laser_models.py:
534-552 >500 scans/s; collision_models.py:296-336 >500 checks/s).

Vectorized equivalents with generous CPU margins — these exist to catch
order-of-magnitude regressions (an accidental per-element fallback, a lost
vmap), not to benchmark.  Compile time is excluded.
"""

import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from red_gym_tpu.config import Integrator, SimConfig, VehicleParams
from red_gym_tpu import env as envlib
from red_gym_tpu.ops import collision as col, dynamics as dyn, integrate

from tests._assets import requires_reference

pytestmark = requires_reference

MAP_YAML = "/root/reference/examples/example_map.yaml"


def _rate(fn, *args, reps=3, units=1):
    """Throughput per CPU-second (process_time sums all threads), not per
    wall-second: the CI box has ONE core and other jobs (texture prebuilds,
    parallel lanes) halve wall-clock rates nondeterministically, while
    work-per-cpu-second only regresses when the compiled program itself
    regresses — which is what these gates exist to catch.

    Returns (rate, stolen): `stolen` is the fraction of the timed window's
    wall clock this process did NOT get the CPU for — a direct, per-window
    measurement of external contention (our own threads all count toward
    process_time, so the suite cannot self-trigger it)."""
    out = fn(*args)
    jax.block_until_ready(out)
    w0, t0 = time.monotonic(), time.process_time()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    wall = max(time.monotonic() - w0, 1e-9)
    cpu = max(time.process_time() - t0, 1e-9)
    return units * reps / cpu, max(0.0, (wall - cpu) / wall)


def _gate(rate_stolen, floor):
    """Assert `rate > floor`, but SKIP (not fail) when the timed window was
    visibly time-shared with another process.  process_time already
    excludes other processes' CPU, yet a persistent external hog still
    halves work-per-cpu-second via context-switch cache eviction (measured:
    the full-step gate reads ~10k quiet and ~4.8k while a nice'd SAC
    trainer shares the one core).  The contention signal is measured
    INSIDE the window (wall minus our cpu time), so neither the suite's
    own earlier compiles nor its subprocesses can trigger the skip — on a
    quiet box a miss still fails."""
    rate, stolen = rate_stolen
    if rate > floor:
        return
    if stolen > 0.25:
        pytest.skip(f"rate {rate:.0f} < floor {floor:.0f}, but "
                    f"{100 * stolen:.0f}% of the timed window went to "
                    f"other processes (1-min loadavg {os.getloadavg()[0]:.1f}"
                    f" on {os.cpu_count()} cpus) — gate requires a quiet box")
    raise AssertionError(f"rate {rate:.0f} <= floor {floor:.0f} "
                         f"(window was quiet: {100 * stolen:.0f}% stolen)")


def test_dynamics_rhs_rate():
    """Reference gate: >5,000 serial RHS calls/s.  Vectorized over 4096 cars
    we require >1M car-RHS/s on CPU (typically 100x that)."""
    p = VehicleParams.default(jnp.float64)
    x = jnp.zeros((4096, 7), jnp.float64).at[:, 3].set(3.0)
    u = jnp.zeros((4096, 2), jnp.float64)
    f = jax.jit(lambda x, u: dyn.vehicle_dynamics_st(x, u, p))
    _gate(_rate(f, x, u, units=4096), 1e6)


def test_scan_rate():
    """Reference gate: >500 scans/s (1080 beams).  Batched exact-mode march
    for 64 poses must beat 500 scans/s on CPU with margin."""
    cfg = SimConfig(num_agents=1, num_beams=1080, dtype="float64",
                    march_iters=48)
    params = envlib.make_params(cfg, MAP_YAML, ".png")
    from red_gym_tpu.ops import scan as scan_ops

    poses = jnp.tile(jnp.asarray([[0.7, 0.0, 1.37]], jnp.float64), (64, 1))
    f = jax.jit(lambda pr, po: scan_ops.trace(po, pr.tables, pr.tmap, cfg))
    _gate(_rate(f, params, poses, units=64), 1000)


def test_collision_rate():
    """Reference gate: >500 pairwise GJK checks/s.  Batched SAT for 4096
    pairs must beat 100k checks/s on CPU."""
    rng = np.random.default_rng(0)
    poses = jnp.asarray(rng.uniform(-5, 5, (4096, 2, 3)))
    f = jax.jit(lambda po: col.collision_multiple(
        col.get_vertices(po, 0.58, 0.31))[0])
    _gate(_rate(f, poses, units=4096), 1e5)


@pytest.mark.slow  # ~100s: texture build + 20-step-scan compile dominate;
# the fast lane keeps the reference's three kernel gates above
def test_full_step_rate():
    """Full 2-agent env step, 256 envs, fast scan in the LIBRARY DEFAULT
    mode (r3: nearest1/linear + edge/grad channels): >6k env-steps/s on
    one CPU core (the reference's whole-env claim was ~3k steps/s; the
    pre-r3 plain-lerp mode measured ~10-12k here — the aux-channel theta
    matmuls cost ~15% on CPU f64 and the gate carries headroom against
    the 1-core CI box's scheduling noise)."""
    cfg = SimConfig(num_agents=2, num_beams=270, dtype="float64",
                    scan_mode="fast", rt_theta_bins=32, rt_pose_stride=8)
    params = envlib.make_params(cfg, MAP_YAML, ".png")
    poses = jnp.tile(jnp.asarray(
        [[0.7, 0.0, 1.37], [0.7, -1.0, 1.37]], jnp.float64), (256, 1, 1))
    keys = jax.random.split(jax.random.PRNGKey(0), 256)
    states = jax.jit(jax.vmap(
        lambda pr, po, k: envlib.init_state(cfg, po, k),
        in_axes=(None, 0, 0)))(params, poses, keys)
    acts = jnp.tile(jnp.asarray([[0.05, 2.0], [0.0, 1.5]], jnp.float64),
                    (256, 1, 1))

    @jax.jit
    def step20(pr, s):
        def body(ss, _):
            ss, *_ = jax.vmap(lambda a, b: envlib.step(cfg, pr, a, b))(ss, acts)
            return ss, None
        return jax.lax.scan(body, s, None, length=20)[0]

    _gate(_rate(step20, params, states, units=256 * 20), 6e3)
