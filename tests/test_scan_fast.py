"""Fast-mode (range texture) lidar accuracy and behavioral tests."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from red_gym_tpu.config import SimConfig
from red_gym_tpu.maps.loader import load_map
from red_gym_tpu.ops import scan as scan_ops, scan_fast
from red_gym_tpu import env as envlib
from red_gym_tpu.agents import pure_pursuit as pp

from tests._assets import requires_reference

pytestmark = requires_reference

MAP_YAML = "/root/reference/examples/example_map.yaml"
# coarse texture settings keep the CPU-test precompute cheap; plain-lerp /
# no-gradient mode — the round-3 occlusion/gradient channels have their own
# configs + fixtures below
CFG = SimConfig(num_agents=1, num_beams=270, dtype="float64",
                scan_mode="fast", rt_theta_bins=128, rt_pose_stride=4,
                rt_occlusion="off", rt_grad=False)
# edge/grad-channel config: even coarser stride (the edge build marches
# ~13x per bin pair; stride 8 keeps the 1600^2 example-map fixture cheap)
CFG_EDGE = SimConfig(num_agents=1, num_beams=270, dtype="float64",
                     scan_mode="fast", rt_theta_bins=128, rt_pose_stride=8,
                     rt_occlusion="edge", rt_grad=True)
# plain-lerp config on the SAME stride-8 grid (fair tail comparison)
CFG_OFF8 = SimConfig(num_agents=1, num_beams=270, dtype="float64",
                     scan_mode="fast", rt_theta_bins=128, rt_pose_stride=8,
                     rt_occlusion="off", rt_grad=False)


@pytest.fixture(scope="module")
def setup():
    tmap = load_map(MAP_YAML, ".png", dtype=jnp.float64)
    tables = scan_ops.build_tables(CFG, 0.31, 0.58, dtype=jnp.float64)
    rtex = scan_fast.build_range_texture(tmap, CFG)
    return tmap, tables, rtex


def test_fast_vs_exact_error(setup):
    """Median beam error small; bulk of beams within the texture cell size."""
    tmap, tables, rtex = setup
    rng = np.random.default_rng(0)
    # random free poses well inside the track
    dt_np = np.asarray(tmap.dt)
    res = float(tmap.resolution)
    poses = []
    while len(poses) < 16:
        r, c = rng.integers(0, dt_np.shape[0]), rng.integers(0, dt_np.shape[1])
        if dt_np[r, c] > 1.0:
            poses.append([c * res + float(tmap.orig_x) + res / 2,
                          r * res + float(tmap.orig_y) + res / 2,
                          rng.uniform(0, 2 * np.pi)])
    poses = jnp.asarray(poses)

    exact = np.asarray(scan_ops.trace(poses, tables, tmap, CFG))
    fast = np.asarray(scan_fast.trace_fast(poses, tables, tmap, rtex, CFG))
    err = np.abs(exact - fast)
    cell = float(rtex.cell)
    assert np.median(err) < 0.5 * cell, f"median err {np.median(err):.3f}m"
    assert np.quantile(err, 0.9) < 4 * cell, f"p90 err {np.quantile(err, 0.9):.3f}m"
    assert np.all(fast >= 0) and np.all(fast <= CFG.max_range)


@pytest.mark.slow
def test_fast_mode_env_laps_track(setup):
    """The pure-pursuit car still completes laps with fast-mode lidar (the
    trajectory itself is scan-independent; this exercises the full env)."""
    params = envlib.make_params(CFG, MAP_YAML, ".png")
    assert params.rtex is not None
    wpts = pp.load_waypoints_csv("/root/reference/examples/example_waypoints.csv",
                                 dtype=jnp.float64)
    ppp = pp.make_params(wpts)

    def body(carry, _):
        state, obs = carry
        speed, steer = pp.plan(obs.poses_x[0], obs.poses_y[0],
                               obs.poses_theta[0], ppp)
        state, obs, _, done, _ = envlib.step(
            CFG, params, state, jnp.stack([steer, speed])[None, :])
        return (state, obs), (done, obs.collisions[0])

    state, obs, *_ = envlib.reset(
        CFG, params, jnp.asarray([[0.7, 0.0, 1.37079632679]]),
        jax.random.PRNGKey(0))

    @jax.jit
    def rollout(s, o):
        return jax.lax.scan(body, (s, o), None, length=4000)

    (state, obs), (dones, colls) = rollout(state, obs)
    assert not np.any(np.asarray(colls) > 0), "fast-mode lidar caused a phantom collision"
    assert np.asarray(dones).any(), "lap did not complete in fast mode"


def test_mxu_variant_matches_gather_variant(setup):
    """trace_fast_mxu (matmul interpolation) == trace_fast (element gather)."""
    tmap, tables, rtex = setup
    rng = np.random.default_rng(3)
    dt_np = np.asarray(tmap.dt)
    res = float(tmap.resolution)
    poses = []
    while len(poses) < 8:
        r, c = rng.integers(0, dt_np.shape[0]), rng.integers(0, dt_np.shape[1])
        if dt_np[r, c] > 0.5:
            poses.append([c * res + float(tmap.orig_x), r * res + float(tmap.orig_y),
                          rng.uniform(0, 2 * np.pi)])
    poses = jnp.asarray(poses)
    a = np.asarray(scan_fast.trace_fast(poses, tables, tmap, rtex, CFG))
    b = np.asarray(scan_fast.trace_fast_mxu(poses, tables, tmap, rtex, CFG))
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8)


def test_spectral_interp_accuracy(setup):
    """scan_interp='spectral' (windowed trig interpolation, no elementwise
    tail) stays close to the exact march: same error class as the linear
    fast mode away from occlusion edges."""
    import dataclasses

    tmap, tables, rtex = setup
    cfg_s = dataclasses.replace(CFG, scan_interp="spectral")
    rng = np.random.default_rng(11)
    dt_np = np.asarray(tmap.dt)
    res = float(tmap.resolution)
    poses = []
    while len(poses) < 16:
        r, c = rng.integers(0, dt_np.shape[0]), rng.integers(0, dt_np.shape[1])
        if dt_np[r, c] > 1.0:
            poses.append([c * res + float(tmap.orig_x) + res / 2,
                          r * res + float(tmap.orig_y) + res / 2,
                          rng.uniform(0, 2 * np.pi)])
    poses = jnp.asarray(poses)

    exact = np.asarray(scan_ops.trace(poses, tables, tmap, CFG))
    spec = np.asarray(scan_fast.trace_fast_mxu(poses, tables, tmap, rtex, cfg_s))
    err = np.abs(exact - spec)
    cell = float(rtex.cell)
    assert np.median(err) < 0.75 * cell, f"median err {np.median(err):.3f}m"
    assert np.quantile(err, 0.9) < 5 * cell, f"p90 err {np.quantile(err, 0.9):.3f}m"
    assert np.all(spec >= 0) and np.all(spec <= CFG.max_range)

@pytest.mark.slow
def test_mxu_variant_fov47(setup):
    """The constant-matmul path handles a non-2pi FOV (upstream default
    4.7 rad): beam offsets c_b span only part of the circle, kb stays
    negative at the left edge."""
    import dataclasses

    tmap, _, _ = setup
    cfg = dataclasses.replace(CFG, fov=4.7, num_beams=108)
    tables = scan_ops.build_tables(cfg, 0.31, 0.58, dtype=jnp.float64)
    rtex = scan_fast.build_range_texture(tmap, cfg)
    rng = np.random.default_rng(21)
    poses = jnp.asarray(np.stack([rng.uniform(-5, 5, 6), rng.uniform(-5, 5, 6),
                                  rng.uniform(0, 2 * np.pi, 6)], axis=-1))
    a = np.asarray(scan_fast.trace_fast(poses, tables, tmap, rtex, cfg))
    b = np.asarray(scan_fast.trace_fast_mxu(poses, tables, tmap, rtex, cfg))
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8)


def test_texture_shapes(setup):
    tmap, tables, rtex = setup
    hc, wc = int(rtex.hc), int(rtex.wc)
    assert rtex.rt.shape == (hc * wc, CFG.rt_theta_bins)
    assert rtex.valid.shape == (hc * wc,)
    # occupied rows are zeroed
    occ_rows = np.asarray(rtex.rt)[~np.asarray(rtex.valid)]
    assert occ_rows.size == 0 or np.all(occ_rows == 0)


def _contract_poses(tmap64, n=64, seed=0):
    rng = np.random.default_rng(seed)
    dt_np = np.asarray(tmap64.dt)
    res = float(tmap64.resolution)
    poses = []
    while len(poses) < n:
        r, c = rng.integers(0, dt_np.shape[0]), rng.integers(0, dt_np.shape[1])
        if dt_np[r, c] > 0.3:     # free space including near-wall poses
            poses.append([c * res + float(tmap64.orig_x) + res / 2,
                          r * res + float(tmap64.orig_y) + res / 2,
                          rng.uniform(0, 2 * np.pi)])
    return np.asarray(poses)


def _run_contract(stride, gates):
    """Shared error-contract harness: f32 textures at the given stride on
    track_wide vs the f64 exact march; gates keyed by a config mutation."""
    import dataclasses

    data = os.path.join(os.path.dirname(__file__), "..", "red_gym_tpu",
                        "assets", "data")
    y = os.path.join(data, "track_wide.yaml")
    cfg32 = SimConfig(num_agents=1, num_beams=1080, dtype="float32",
                      scan_mode="fast", rt_pose_stride=stride)
    cfg64 = dataclasses.replace(cfg32, dtype="float64", rt_occlusion="off",
                                rt_grad=False)
    tmap32 = load_map(y, ".png", dtype=jnp.float32)
    tmap64 = load_map(y, ".png", dtype=jnp.float64)
    tab32 = scan_ops.build_tables(cfg32, 0.31, 0.58, dtype=jnp.float32)
    tab64 = scan_ops.build_tables(cfg64, 0.31, 0.58, dtype=jnp.float64)

    poses = _contract_poses(tmap64)
    exact = np.asarray(scan_ops.trace(jnp.asarray(poses), tab64, tmap64,
                                      cfg64))
    textures = {}
    for name, (mut, _) in gates.items():
        ci = dataclasses.replace(cfg32, **mut)
        key = (ci.rt_eff_occlusion, ci.rt_grad)
        if key not in textures:
            textures[key] = scan_fast.build_range_texture(tmap32, ci)
        rtex = textures[key]
        cell = float(rtex.cell)
        fast = np.asarray(scan_fast.trace_fast_mxu(
            jnp.asarray(poses, np.float32), tab32, tmap32, rtex, ci))
        err = np.abs(exact - fast)
        g_med, g_p90, g_p99, g_cell, g_4cell = gates[name][1]
        assert np.median(err) < g_med, (name, np.median(err))
        assert np.quantile(err, 0.9) < g_p90, (name, np.quantile(err, 0.9))
        assert np.quantile(err, 0.99) < g_p99, (name, np.quantile(err, 0.99))
        assert np.mean(err > cell) < g_cell, (name, np.mean(err > cell))
        assert np.mean(err > 4 * cell) < g_4cell, (name,
                                                   np.mean(err > 4 * cell))
        assert np.all(fast >= 0) and np.all(fast <= cfg32.max_range)


@pytest.mark.slow
def test_error_contract_shipped_defaults_f32():
    """Error contract at the SHIPPED configuration: rt_pose_stride=2 (cell =
    0.125 m at the 0.0625 m/px maps), 128 theta bins, float32 textures (the
    throughput dtype), 1080 beams, nearest1/linear with edge+gradient channels
    (the round-3 default).  Gates pin the r3 study values with ~1.5x
    headroom; docs/performance.md carries the measured numbers.

    Measured at pin time (track_wide, 64 poses incl. near-wall):
      default (nearest1/linear/edge+grad): median .031, p90 .102, p99 .375,
        >1cell 6.6%, >4cell 0.79%  (pre-r3 defaults: p99 3.52, >4cell 2.5%)
      spectral ultra mode (grad, no edge):  median .034, p90 .140, p99 4.54,
        >1cell 11.7%, >4cell 3.8%
      legacy bilinear/linear (no channels): median .026, p90 .071, p99 3.52,
        >1cell 4.1%, >4cell 2.5%
    """
    cfg_probe = SimConfig(scan_mode="fast")
    assert (cfg_probe.rt_pose_stride, cfg_probe.rt_theta_bins,
            cfg_probe.rt_spatial, cfg_probe.scan_interp,
            cfg_probe.rt_occlusion, cfg_probe.rt_grad) == \
        (2, 128, "nearest1", "linear", "edge", True), \
        "shipped defaults changed; re-pin this contract"
    _run_contract(stride=2, gates={
        "default": ({}, (0.05, 0.16, 0.55, 0.10, 0.015)),
        "spectral": ({"scan_interp": "spectral"},
                     (0.06, 0.22, 6.0, 0.17, 0.06)),
        "legacy": ({"rt_occlusion": "off", "rt_grad": False,
                    "rt_spatial": "bilinear"},
                   (0.05, 0.12, 5.0, 0.08, 0.04)),
    })


def test_error_contract_sentinel_coarse():
    """Fast-lane sentinel of the same contract at rt_pose_stride=8 (cheap
    fresh build): catches regressions in the edge/grad machinery without
    the stride-2 build cost on cold-cache machines.  Gates scaled to the
    0.5 m cell."""
    _run_contract(stride=8, gates={
        "default": ({}, (0.35, 1.0, 3.2, 0.32, 0.05)),
        # the GPU XLA-path numerics: (e, w) shuffle matmul +
        # intermediate in bfloat16 (rt_ew_dtype docstring) — a bf16 ulp
        # moves the ramp by <0.2% of a bin, so the gates are identical
        "ew_bf16": ({"rt_ew_dtype": "bfloat16"},
                    (0.35, 1.0, 3.2, 0.32, 0.05)),
    })


def _tiny_tmap(seed=0, n=48):
    """Small synthetic TrackMap (box walls + random blobs) — the caching
    logic is map-agnostic, so cache tests need not march the 1600^2
    example map (was 115 s of the fast lane)."""
    from scipy.ndimage import distance_transform_edt

    from red_gym_tpu.maps.loader import TrackMap

    rng = np.random.default_rng(seed)
    occ = np.full((n, n), 255.0)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = 0.0
    for _ in range(4):
        r, c = rng.integers(4, n - 4, 2)
        occ[r - 1:r + 2, c - 1:c + 2] = 0.0
    res = 0.25
    dt = distance_transform_edt(occ) * res
    z = lambda v: jnp.asarray(v, jnp.float64)
    return TrackMap(dt=z(dt), occupancy=z(occ), orig_x=z(0.0), orig_y=z(0.0),
                    orig_c=z(1.0), orig_s=z(0.0), resolution=z(res),
                    height=jnp.asarray(n, jnp.int32),
                    width=jnp.asarray(n, jnp.int32))


def test_compact_build_matches_dense(monkeypatch):
    """The default (compact) cold build gathers only the jump>thr bins of
    free cells for edge localization; the dense path marches every bin and
    selects.  Same elementwise math on the same bins => the texture must be
    BIT-identical (this is what makes the ~10x cold-build speedup free)."""
    import dataclasses

    tmap = _tiny_tmap(seed=11, n=40)
    cfg = dataclasses.replace(CFG, rt_occlusion="edge", rt_grad=True,
                              rt_pose_stride=4)
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
    monkeypatch.delenv("RGT_TEXTURE_BUILD", raising=False)
    compact = scan_fast.build_range_texture(tmap, cfg)
    monkeypatch.setenv("RGT_TEXTURE_BUILD", "dense")
    dense = scan_fast.build_range_texture(tmap, cfg)
    np.testing.assert_array_equal(np.asarray(compact.rt),
                                  np.asarray(dense.rt))
    np.testing.assert_array_equal(np.asarray(compact.valid),
                                  np.asarray(dense.valid))


def test_texture_disk_cache_roundtrip(tmp_path, monkeypatch):
    """The marched texture memoizes to disk by content hash: a rebuild with
    the same map+config loads bit-identical arrays; changing the config
    (including the occlusion/grad channel recipe) misses; disabling via
    env var builds fresh."""
    import dataclasses

    tmap = _tiny_tmap()
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
    fresh = scan_fast.build_range_texture(tmap, CFG)

    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", str(tmp_path))
    r1 = scan_fast.build_range_texture(tmap, CFG)
    files = list(tmp_path.glob("rtex_*.npz"))
    assert len(files) == 1
    r2 = scan_fast.build_range_texture(tmap, CFG)   # cache hit
    np.testing.assert_array_equal(np.asarray(r1.rt), np.asarray(r2.rt))
    np.testing.assert_array_equal(np.asarray(r1.valid), np.asarray(r2.valid))
    # matches the cache-disabled build too
    np.testing.assert_array_equal(np.asarray(r1.rt), np.asarray(fresh.rt))

    cfg2 = dataclasses.replace(CFG, rt_theta_bins=16)
    scan_fast.build_range_texture(tmap, cfg2)
    assert len(list(tmp_path.glob("rtex_*.npz"))) == 2, "config change must miss"

    # channel-recipe change (edge/grad) must also miss — stale single-
    # channel entries would break the runtime layout assert
    cfg3 = dataclasses.replace(CFG, rt_occlusion="edge", rt_grad=True)
    r4 = scan_fast.build_range_texture(tmap, cfg3)
    assert len(list(tmp_path.glob("rtex_*.npz"))) == 3
    assert r4.rt.shape[-1] == 5 * CFG.rt_theta_bins


@pytest.mark.slow  # ablation-only spatial mode; full lane covers it
def test_nearest_spatial_mode(setup):
    """rt_spatial='nearest' (single best cell, one-hot blend): the MXU and
    gather variants agree, and ranges stay within the coarse-texture error
    class of the exact march."""
    import dataclasses

    tmap, tables, rtex = setup
    cfg_n = dataclasses.replace(CFG, rt_spatial="nearest")
    rng = np.random.default_rng(5)
    dt_np = np.asarray(tmap.dt)
    res = float(tmap.resolution)
    poses = []
    while len(poses) < 12:
        r, c = rng.integers(0, dt_np.shape[0]), rng.integers(0, dt_np.shape[1])
        if dt_np[r, c] > 1.0:
            poses.append([c * res + float(tmap.orig_x) + res / 2,
                          r * res + float(tmap.orig_y) + res / 2,
                          rng.uniform(0, 2 * np.pi)])
    poses = jnp.asarray(poses)
    a = np.asarray(scan_fast.trace_fast(poses, tables, tmap, rtex, cfg_n))
    b = np.asarray(scan_fast.trace_fast_mxu(poses, tables, tmap, rtex, cfg_n))
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8)
    exact = np.asarray(scan_ops.trace(poses, tables, tmap, CFG))
    err = np.abs(exact - b)
    cell = float(rtex.cell)
    assert np.median(err) < 1.0 * cell
    assert np.all(b >= 0) and np.all(b <= CFG.max_range)


def test_nearest1_single_gather_mode(setup):
    """rt_spatial='nearest1' (one rounded-cell gather): MXU and gather
    variants agree; error stays in the nearest-cell class; poses whose
    nearest cell center is occupied read scan 0 (they are inside the car's
    own half-width of a wall, i.e. already colliding)."""
    import dataclasses

    tmap, tables, rtex = setup
    cfg_n = dataclasses.replace(CFG, rt_spatial="nearest1")
    rng = np.random.default_rng(6)
    dt_np = np.asarray(tmap.dt)
    res = float(tmap.resolution)
    poses = []
    while len(poses) < 12:
        r, c = rng.integers(0, dt_np.shape[0]), rng.integers(0, dt_np.shape[1])
        if dt_np[r, c] > 1.0:
            poses.append([c * res + float(tmap.orig_x) + res / 2,
                          r * res + float(tmap.orig_y) + res / 2,
                          rng.uniform(0, 2 * np.pi)])
    poses = jnp.asarray(poses)
    a = np.asarray(scan_fast.trace_fast(poses, tables, tmap, rtex, cfg_n))
    b = np.asarray(scan_fast.trace_fast_mxu(poses, tables, tmap, rtex, cfg_n))
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8)
    exact = np.asarray(scan_ops.trace(poses, tables, tmap, CFG))
    err = np.abs(exact - b)
    assert np.median(err) < 1.0 * float(rtex.cell)

    # a pose whose nearest cell center is inside a wall reads all-zero
    occ = np.argwhere(dt_np == 0.0)
    r, c = occ[len(occ) // 2]
    wall_pose = jnp.asarray([[c * res + float(tmap.orig_x) + res / 2,
                              r * res + float(tmap.orig_y) + res / 2, 0.0]])
    z = np.asarray(scan_fast.trace_fast_mxu(wall_pose, tables, tmap, rtex,
                                            cfg_n))
    assert np.all(z == 0.0)


# ---------------------------------------------------------------------------
# round-3 occlusion/gradient channel modes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup_edge():
    tmap = load_map(MAP_YAML, ".png", dtype=jnp.float64)
    tables = scan_ops.build_tables(CFG_EDGE, 0.31, 0.58, dtype=jnp.float64)
    rtex = scan_fast.build_range_texture(tmap, CFG_EDGE)
    return tmap, tables, rtex


def _free_poses(tmap, n, seed, clearance=0.5):
    rng = np.random.default_rng(seed)
    dt_np = np.asarray(tmap.dt)
    res = float(tmap.resolution)
    poses = []
    while len(poses) < n:
        r, c = rng.integers(0, dt_np.shape[0]), rng.integers(0, dt_np.shape[1])
        if dt_np[r, c] > clearance:
            poses.append([c * res + float(tmap.orig_x) + res / 2,
                          r * res + float(tmap.orig_y) + res / 2,
                          rng.uniform(0, 2 * np.pi)])
    return jnp.asarray(poses)


def test_edge_texture_channels(setup_edge):
    """Edge mode textures carry [R | e w | gx gy]; e in [0,1], w in [0,1],
    |grad| clamped, occupied rows all-zero."""
    tmap, tables, rtex = setup_edge
    t = CFG_EDGE.rt_theta_bins
    assert CFG_EDGE.rt_channels == 5
    assert rtex.rt.shape[-1] == 5 * t
    rt = np.asarray(rtex.rt)
    valid = np.asarray(rtex.valid)
    e, w = rt[valid, t:2 * t], rt[valid, 2 * t:3 * t]
    g = rt[valid, 3 * t:]
    assert e.min() >= 0.0 and e.max() <= 1.0
    assert w.min() >= 0.0 and w.max() <= 1.0
    assert np.abs(g).max() <= 8.0 + 1e-6
    assert np.all(rt[~valid] == 0.0)


@pytest.mark.parametrize("spatial", [
    "nearest1",
    pytest.param("bilinear", marks=pytest.mark.slow),  # non-default spatial
])
def test_edge_mode_variants_agree(setup_edge, spatial):
    """trace_fast (element gather) == trace_fast_mxu (matmul pipeline) in
    the full edge+grad configuration, both spatial modes."""
    import dataclasses

    tmap, tables, rtex = setup_edge
    cfg = dataclasses.replace(CFG_EDGE, rt_spatial=spatial)
    poses = _free_poses(tmap, 10, seed=13)
    a = np.asarray(scan_fast.trace_fast(poses, tables, tmap, rtex, cfg))
    b = np.asarray(scan_fast.trace_fast_mxu(poses, tables, tmap, rtex, cfg))
    np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-7)


@pytest.mark.slow  # ~45s interpret-mode kernel; the fast lane keeps the
# STEP-level fused parity (test_fused_ttc_env_step_matches_unfused)
def test_snap_mode_variants_agree(setup):
    """rt_occlusion='snap' needs no extra channels and the two variants
    agree (the plain single-channel texture serves it)."""
    import dataclasses

    tmap, tables, rtex = setup
    cfg = dataclasses.replace(CFG, rt_occlusion="snap")
    assert cfg.rt_channels == 1
    poses = _free_poses(tmap, 8, seed=17)
    a = np.asarray(scan_fast.trace_fast(poses, tables, tmap, rtex, cfg))
    b = np.asarray(scan_fast.trace_fast_mxu(poses, tables, tmap, rtex, cfg))
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8)


def test_edge_mode_cuts_occlusion_tail(setup_edge):
    """The whole point of the e/w channels: the occlusion-edge error tail
    collapses vs plain lerp on the SAME texture grid (p99 and the >4-cell
    fraction both improve)."""
    tmap, tables, rtex_edge = setup_edge
    rtex_off = scan_fast.build_range_texture(tmap, CFG_OFF8)
    poses = _free_poses(tmap, 24, seed=19, clearance=0.3)
    exact = np.asarray(scan_ops.trace(poses, tables, tmap, CFG_OFF8))
    off = np.asarray(scan_fast.trace_fast_mxu(poses, tables, tmap,
                                              rtex_off, CFG_OFF8))
    edge = np.asarray(scan_fast.trace_fast_mxu(poses, tables, tmap,
                                               rtex_edge, CFG_EDGE))
    err_off = np.abs(exact - off)
    err_edge = np.abs(exact - edge)
    cell = float(rtex_off.cell)
    assert np.quantile(err_edge, 0.99) < 0.7 * np.quantile(err_off, 0.99)
    assert np.mean(err_edge > 4 * cell) < np.mean(err_off > 4 * cell)

def test_channel_mismatch_raises(setup, setup_edge):
    """A texture built for one channel layout refuses to serve a config
    expecting another (silent misindexing would be catastrophic)."""
    tmap, tables, rtex_off = setup
    _, _, rtex_edge = setup_edge
    poses = _free_poses(tmap, 2, seed=23)
    with pytest.raises(AssertionError, match="channels"):
        scan_fast.trace_fast_mxu(poses, tables, tmap, rtex_off, CFG_EDGE)
    with pytest.raises(AssertionError, match="channels"):
        scan_fast.trace_fast(poses, tables, tmap, rtex_edge, CFG)


@pytest.mark.slow  # multi-map x edge-channel composition; full lane
def test_edge_channels_with_stacked_maps():
    """Map-STACKED textures carry the edge/grad channels per map: tracing
    with midx=i equals tracing the unstacked texture of map i (the flat-row
    offset indexing must stride by C*T rows correctly)."""
    import jax

    maps = [_tiny_tmap(seed=3, n=40), _tiny_tmap(seed=4, n=40)]
    cfg = SimConfig(num_agents=1, num_beams=90, dtype="float64",
                    scan_mode="fast", rt_theta_bins=32, rt_pose_stride=2,
                    rt_occlusion="edge", rt_grad=True)
    tables = scan_ops.build_tables(cfg, 0.31, 0.58, dtype=jnp.float64)
    rtexs = [scan_fast.build_range_texture(m, cfg) for m in maps]
    stacked_rt = scan_fast.stack_textures(rtexs)
    from red_gym_tpu.maps.loader import stack_maps
    stacked_map = stack_maps(maps)

    rng = np.random.default_rng(9)
    for i, (m, rt) in enumerate(zip(maps, rtexs)):
        poses = []
        dt_np = np.asarray(m.dt)
        while len(poses) < 5:
            r, c = rng.integers(0, 40, 2)
            if dt_np[r, c] > 0.6:
                poses.append([c * 0.25 + 0.125, r * 0.25 + 0.125,
                              rng.uniform(0, 2 * np.pi)])
        poses = jnp.asarray(poses)
        want = np.asarray(scan_fast.trace_fast_mxu(poses, tables, m, rt, cfg))
        got = np.asarray(jax.vmap(
            lambda p: scan_fast.trace_fast_mxu(
                p, tables, stacked_map, stacked_rt, cfg,
                midx=jnp.asarray(i, jnp.int32)))(poses))
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_pad_texture_equals_padded_map_build():
    """pad_texture(build(raw)) is BIT-EQUAL to build(zero-padded map) for
    wall-bounded maps: padded cells are occupied, so their rows are zero
    with valid=False either way, and in-bounds marches terminate at real
    walls before the boundary.  This equivalence is what lets
    make_multimap_params build textures on the RAW maps (stable disk-cache
    key) and pad afterwards — before, any change to a stack's max
    dimensions re-marched every member map."""
    m_raw = _tiny_tmap(seed=7, n=40)
    ph, pw = 56, 64
    m_pad = m_raw._replace(
        dt=jnp.pad(m_raw.dt, ((0, ph - 40), (0, pw - 40))),
        occupancy=jnp.pad(m_raw.occupancy, ((0, ph - 40), (0, pw - 40))))

    cfg = SimConfig(num_agents=1, num_beams=90, dtype="float64",
                    scan_mode="fast", rt_theta_bins=16, rt_pose_stride=4,
                    rt_occlusion="edge", rt_grad=True, rt_edge_iters=3)
    s = cfg.rt_pose_stride
    a = scan_fast.pad_texture(scan_fast.build_range_texture(m_raw, cfg),
                              (ph + s - 1) // s, (pw + s - 1) // s)
    b = scan_fast.build_range_texture(m_pad, cfg)
    assert (int(a.hc), int(a.wc)) == (int(b.hc), int(b.wc))
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    np.testing.assert_array_equal(np.asarray(a.rt), np.asarray(b.rt))
    # no-op and shrink guards
    t = scan_fast.build_range_texture(m_raw, cfg)
    assert scan_fast.pad_texture(t, int(t.hc), int(t.wc)) is t
    with pytest.raises(ValueError):
        scan_fast.pad_texture(t, int(t.hc) - 1, int(t.wc))
