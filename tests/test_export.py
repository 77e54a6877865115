"""Deployment-artifact tests: StableHLO policy export (utils/export.py).

The reference ships weights-only deployment (torch.save state_dict,
reference src/SAL.py:1017); here the whole inference program round-trips
through serialized StableHLO with no model code at load time.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from red_gym_tpu.agents import ppo as ppolib
from red_gym_tpu.agents import sac as saclib
from red_gym_tpu.utils import export as ex


@pytest.fixture(scope="module")
def ppo_head():
    policy = ppolib.ScanPolicy(hidden=32, scan_stride=8)
    scan = jnp.ones((3, 1080), jnp.float32) * 5.0
    vel = jnp.ones((3,), jnp.float32)
    params = policy.init(jax.random.PRNGKey(0), scan, vel)
    pcfg = ppolib.PPOConfig()
    return ex.deterministic_ppo_control(policy, pcfg, params), scan, vel


def test_ppo_roundtrip_matches_direct(tmp_path, ppo_head):
    fn, scan, vel = ppo_head
    path = tmp_path / "racer.stablehlo"
    ex.save_policy(path, fn, (scan, vel), platforms=("cpu",))
    loaded = ex.load_policy(path)
    direct = np.asarray(fn(scan, vel))
    served = np.asarray(loaded.call(scan, vel))
    np.testing.assert_allclose(direct, served, rtol=1e-5, atol=1e-5)
    assert served.shape == (3, 2)
    # controls respect the squash bounds
    assert np.all(np.abs(served[:, 0]) <= ppolib.PPOConfig().max_steer)
    assert np.all((served[:, 1] >= 0)
                  & (served[:, 1] <= ppolib.PPOConfig().max_speed))


def test_symbolic_batch_serves_any_size(tmp_path, ppo_head):
    fn, scan, vel = ppo_head
    path = tmp_path / "racer.stablehlo"
    ex.save_policy(path, fn, (scan, vel), platforms=("cpu",))
    loaded = ex.load_policy(path)
    for n in (1, 7, 64):
        rng = np.random.default_rng(n)
        s = jnp.asarray(rng.uniform(0, 30, (n, 1080)), jnp.float32)
        v = jnp.asarray(rng.uniform(0, 8, (n,)), jnp.float32)
        out = np.asarray(loaded.call(s, v))
        assert out.shape == (n, 2)
        # AOT codegen differs from jit at the last ulp
        np.testing.assert_allclose(out, np.asarray(fn(s, v)),
                                   rtol=1e-5, atol=1e-5)


def test_fixed_batch_rejects_other_sizes(tmp_path, ppo_head):
    fn, scan, vel = ppo_head
    path = tmp_path / "racer_fixed.stablehlo"
    ex.save_policy(path, fn, (scan, vel), platforms=("cpu",), batch=None)
    loaded = ex.load_policy(path)
    assert np.asarray(loaded.call(scan, vel)).shape == (3, 2)
    with pytest.raises(Exception):
        loaded.call(jnp.ones((4, 1080), jnp.float32),
                    jnp.ones((4,), jnp.float32))


def test_sac_actor_roundtrip(tmp_path):
    actor = saclib.Actor(action_dim=8, compute_dtype=jnp.float32)
    obs = jnp.asarray(
        np.random.default_rng(0).integers(0, 255, (2, 64, 64)), jnp.uint8)
    params = actor.init(jax.random.PRNGKey(1), obs)
    fn = ex.deterministic_sac_action(actor, params)
    path = tmp_path / "sac.stablehlo"
    ex.save_policy(path, fn, (obs,), platforms=("cpu",))
    loaded = ex.load_policy(path)
    out = np.asarray(loaded.call(obs))
    np.testing.assert_allclose(out, np.asarray(fn(obs)),
                               rtol=1e-5, atol=1e-5)
    assert out.shape == (2, 8) and np.all(np.abs(out) <= 1.0)


def test_multiplatform_lowering_includes_cuda(ppo_head):
    """The deployment artifact is lowered for cpu AND cuda ahead of time —
    exporting for a platform does not require having it attached."""
    fn, scan, vel = ppo_head
    exp = ex.export_policy(fn, (scan, vel))
    assert set(exp.platforms) == {"cpu", "cuda"}
    data = exp.serialize()
    assert len(data) > 1000
    re = ex._jexport.deserialize(data)
    np.testing.assert_allclose(np.asarray(re.call(scan, vel)),
                               np.asarray(fn(scan, vel)),
                               rtol=1e-5, atol=1e-5)
