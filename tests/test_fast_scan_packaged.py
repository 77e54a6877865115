"""Fast scan (range texture + matmul interpolation) on the packaged maps:
the coarse error-contract sentinel against the float64 exact march, the
matmul path against its element-gather definition, the e/w tap dtype rule,
and — marked ``gpu`` — the scan's accuracy at the matmul precision the GPU
runs by default."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from red_gym_tpu import assets
from red_gym_tpu.config import SimConfig
from red_gym_tpu.maps.loader import load_map
from red_gym_tpu.ops import scan as scan_ops, scan_fast

CFG32 = SimConfig(num_agents=1, num_beams=1080, dtype="float32",
                  scan_mode="fast", rt_pose_stride=8)


def _poses(tmap, n, seed, clearance=0.2):
    dt = np.asarray(tmap.dt)
    res = float(tmap.resolution)
    rng = np.random.default_rng(seed)
    rr, cc = np.nonzero(dt > clearance)
    k = rng.integers(0, rr.size, n)
    return np.stack([(cc[k] + 0.5) * res + float(tmap.orig_x),
                     (rr[k] + 0.5) * res + float(tmap.orig_y),
                     rng.uniform(0, 2 * np.pi, n)], -1)


@pytest.mark.parametrize("track", ["track_0007", "track_wide"])
def test_error_contract_sentinel_packaged(track):
    """The shipped pipeline (nearest1/linear/edge+grad, float32) at stride
    8 (0.5 m cells) against the float64 exact march on 64 free poses;
    gates as tests/test_scan_fast.py::test_error_contract_sentinel_coarse
    (median, p90, p99 in metres; shares beyond 1 and 4 cells)."""
    y = assets.named_map_yaml(track)
    cfg64 = dataclasses.replace(CFG32, dtype="float64", rt_occlusion="off",
                                rt_grad=False)
    t32 = load_map(y, ".png", dtype=jnp.float32)
    t64 = load_map(y, ".png", dtype=jnp.float64)
    tab32 = scan_ops.build_tables(CFG32, 0.31, 0.58, dtype=jnp.float32)
    tab64 = scan_ops.build_tables(cfg64, 0.31, 0.58, dtype=jnp.float64)
    poses = _poses(t64, 64, seed=0)
    exact = np.asarray(scan_ops.trace(jnp.asarray(poses), tab64, t64, cfg64))
    rtex = scan_fast.build_range_texture(t32, CFG32)
    fast = np.asarray(scan_fast.trace_fast_mxu(
        jnp.asarray(poses, jnp.float32), tab32, t32, rtex, CFG32))
    err = np.abs(exact - fast)
    cell = float(rtex.cell)
    assert np.median(err) < 0.35
    assert np.quantile(err, 0.9) < 1.0
    assert np.quantile(err, 0.99) < 3.2
    assert np.mean(err > cell) < 0.32
    assert np.mean(err > 4 * cell) < 0.05
    assert np.all(fast >= 0) and np.all(fast <= CFG32.max_range)


def test_matmul_variant_matches_gather_definition():
    """trace_fast_mxu (DFT roll + constant matmuls) == trace_fast (element
    gathers) on track_0007, in float64 (bilinear, no channels)."""
    cfg = SimConfig(num_agents=1, num_beams=270, dtype="float64",
                    scan_mode="fast", rt_pose_stride=8, rt_spatial="bilinear",
                    rt_occlusion="off", rt_grad=False)
    tmap = load_map(assets.example_map_yaml(), ".png", dtype=jnp.float64)
    tables = scan_ops.build_tables(cfg, 0.31, 0.58, dtype=jnp.float64)
    rtex = scan_fast.build_range_texture(tmap, cfg)
    poses = jnp.asarray(_poses(tmap, 8, seed=3, clearance=0.5))
    a = np.asarray(scan_fast.trace_fast(poses, tables, tmap, rtex, cfg))
    b = np.asarray(scan_fast.trace_fast_mxu(poses, tables, tmap, rtex, cfg))
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8)


def test_ew_dtype_rule():
    """rt_ew_dtype: explicit values win; "auto" keeps the scan dtype off
    the GPU (bf16 on it)."""
    f32 = jnp.float32
    assert jax.devices()[0].platform != "gpu"
    assert scan_fast._resolve_ew_dtype(CFG32, f32) == f32
    assert scan_fast._resolve_ew_dtype(
        dataclasses.replace(CFG32, rt_ew_dtype="bfloat16"), f32) \
        == jnp.bfloat16
    assert scan_fast._resolve_ew_dtype(
        dataclasses.replace(CFG32, rt_ew_dtype="float32"), jnp.float64) \
        == jnp.float64


@pytest.mark.gpu
def test_default_precision_scan_accuracy_on_gpu(gpu):
    """On a GPU the float32 matmuls run at XLA's default precision (TF32
    on Hopper): the scan's error against the exact march stays within
    1 mm (median) and 2 cm (p99) of the same scan at highest precision."""
    tmap = load_map(assets.example_map_yaml(), ".png", dtype=jnp.float32)
    tables = scan_ops.build_tables(CFG32, 0.31, 0.58, dtype=jnp.float32)
    rtex = scan_fast.build_range_texture(tmap, CFG32)
    poses = jnp.asarray(_poses(tmap, 512, seed=5), jnp.float32)
    exact = np.asarray(jax.jit(lambda p: scan_ops.trace(
        p, tables, tmap, dataclasses.replace(CFG32, scan_mode="exact")))(
        poses))
    fast = lambda p: scan_fast.trace_fast_mxu(p, tables, tmap, rtex, CFG32)
    err = np.abs(np.asarray(jax.jit(fast)(poses)) - exact)
    with jax.default_matmul_precision("highest"):
        err_hi = np.abs(np.asarray(jax.jit(fast)(poses)) - exact)
    assert np.median(err) - np.median(err_hi) < 1e-3
    assert np.quantile(err, 0.99) - np.quantile(err_hi, 0.99) < 2e-2
