"""Plain-JAX policy modules (agents/nn.py), the npz checkpoint, and the
main path's import footprint."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from red_gym_tpu.agents import nn, ppo as ppolib, sac as saclib
from red_gym_tpu.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shapes(tree):
    return jax.tree.map(lambda x: tuple(x.shape), tree)


def test_scan_policy_params_and_forward():
    pol = ppolib.ScanPolicy(hidden=32, scan_stride=8)
    scan = jnp.full((5, 1080), 4.0, jnp.float32)
    vel = jnp.ones((5,), jnp.float32)
    params = pol.init(jax.random.PRNGKey(0), scan, vel)
    assert _shapes(params) == {"params": {
        "Dense_0": {"kernel": (136, 32), "bias": (32,)},
        "Dense_1": {"kernel": (32, 32), "bias": (32,)},
        "Dense_2": {"kernel": (32, 2), "bias": (2,)},
        "Dense_3": {"kernel": (32, 1), "bias": (1,)},
        "log_std": (2,)}}
    p = params["params"]
    np.testing.assert_array_equal(p["log_std"], [-0.5, -0.5])
    assert not np.asarray(p["Dense_0"]["bias"]).any()
    mean, log_std, value = pol.apply(params, scan, vel)
    assert mean.shape == (5, 2) and log_std.shape == (2,)
    assert value.shape == (5,)
    # featurized input path is the same network
    feat = ppolib.featurize_scan(scan, 8)
    np.testing.assert_allclose(
        pol.apply(params, feat, vel, featurized=True)[0], mean, rtol=1e-6)


def test_lecun_normal_init_scale():
    """Kernels follow lecun-normal (std = 1/sqrt(fan_in), truncated)."""
    x = jnp.zeros((1, 400))
    params = ppolib.ScanPolicy(hidden=512, scan_stride=1).init(
        jax.random.PRNGKey(1), x, jnp.zeros((1,)))
    k = np.asarray(params["params"]["Dense_1"]["kernel"])
    assert abs(k.std() * np.sqrt(512) - 1.0) < 0.05
    assert abs(k.mean()) < 0.01


def test_scan_policy_gradient():
    pol = ppolib.ScanPolicy(hidden=16)
    scan = jnp.asarray(np.random.default_rng(0).uniform(0, 10, (4, 1080)),
                       jnp.float32)
    vel = jnp.ones((4,), jnp.float32)
    params = pol.init(jax.random.PRNGKey(2), scan, vel)

    def loss(p):
        m, ls, v = pol.apply(p, scan, vel)
        return jnp.sum(m ** 2) + jnp.sum(v) + jnp.sum(ls)

    g = jax.grad(loss)(params)
    leaves = jax.tree.leaves(g)
    assert all(np.isfinite(np.asarray(x)).all() for x in leaves)
    assert all(np.abs(np.asarray(x)).sum() > 0 for x in leaves)


@pytest.mark.parametrize("module,args,want", [
    (saclib.Actor(action_dim=8, compute_dtype=jnp.float32),
     (jnp.zeros((2, 64, 64), jnp.uint8),),
     {"ConvTrunk_0": {"Conv_0": {"kernel": (8, 8, 1, 16), "bias": (16,)},
                      "Conv_1": {"kernel": (4, 4, 16, 32), "bias": (32,)},
                      "Conv_2": {"kernel": (3, 3, 32, 32), "bias": (32,)}},
      "Dense_0": {"kernel": (512, 512), "bias": (512,)},
      "Dense_1": {"kernel": (512, 8), "bias": (8,)},
      "Dense_2": {"kernel": (512, 8), "bias": (8,)}}),
    (saclib.ScanCritic(hidden=32),
     (jnp.ones((3, 1080)), jnp.ones((3, 2))),
     {"ScanTrunk_0": {"Dense_0": {"kernel": (135, 32), "bias": (32,)},
                      "Dense_1": {"kernel": (32, 32), "bias": (32,)}},
      "Dense_0": {"kernel": (34, 32), "bias": (32,)},
      "Dense_1": {"kernel": (32, 1), "bias": (1,)}}),
], ids=["conv_actor", "scan_critic"])
def test_sac_module_param_shapes(module, args, want):
    params = module.init(jax.random.PRNGKey(0), *args)
    assert _shapes(params) == {"params": want}
    out = module.apply(params, *args)
    assert all(np.isfinite(np.asarray(o)).all() for o in jax.tree.leaves(out))


def test_sac_update_step_changes_params():
    sac = saclib.SAC(obs_shape=(1080,), action_dim=2,
                     actor=saclib.ScanActor(hidden=32),
                     critic=saclib.ScanCritic(hidden=32),
                     obs_dtype=jnp.float32)
    state = sac.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = (jnp.asarray(rng.uniform(0, 10, (16, 1080)), jnp.float32),
             jnp.asarray(rng.uniform(-1, 1, (16, 2)), jnp.float32),
             jnp.asarray(rng.normal(size=16), jnp.float32),
             jnp.asarray(rng.uniform(0, 10, (16, 1080)), jnp.float32),
             jnp.zeros((16,), jnp.float32))
    new, met = sac.update(state, batch, jax.random.PRNGKey(1))
    assert all(np.isfinite(float(v)) for v in met.values())
    before = jax.tree.leaves(state.actor_params)
    after = jax.tree.leaves(new.actor_params)
    assert any(bool((a != b).any()) for a, b in zip(before, after))


def test_module_names_are_per_scope():
    ctx = nn.Ctx(key=jax.random.PRNGKey(0))
    assert [ctx.auto("Dense") for _ in range(3)] == \
        ["Dense_0", "Dense_1", "Dense_2"]
    assert ctx.child("X").auto("Dense") == "Dense_0"


def test_checkpoint_roundtrip(tmp_path):
    """Every leaf kind a trainer holds round-trips, bf16 included, into a
    directory (``<dir>/checkpoint.npz``) or an explicit ``.npz`` file."""
    pol = ppolib.ScanPolicy(hidden=8)
    params = pol.init(jax.random.PRNGKey(0), jnp.ones((1, 1080)),
                      jnp.ones((1,)))
    tree = {"pstate": ppolib.PPOState(params, (jnp.zeros(3),),
                                      jax.random.PRNGKey(7)),
            "bf16": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3),
            "flags": np.array([True, False]), "it": 5}
    for path in (tmp_path / "run", tmp_path / "snap.npz"):
        ckpt.save(str(path), tree)
        got = ckpt.restore(str(path), like=tree)
        assert jax.tree.structure(got) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a, np.float64),
                                          np.asarray(b, np.float64))
        assert got["it"] == 5 and isinstance(got["it"], int)
    assert (tmp_path / "run" / "checkpoint.npz").is_file()
    flat = ckpt.restore(str(tmp_path / "run"))
    assert flat["['bf16']"].dtype == jnp.bfloat16
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore(str(tmp_path / "run"), like={"other": jnp.zeros(2)})
    with pytest.raises(FileExistsError):
        ckpt.save(str(tmp_path / "run"), tree, overwrite=False)


def test_main_path_imports_only_the_sure_packages():
    """The simulator, rollout, PPO, map loader and checkpoint import
    nothing beyond jax, numpy, scipy, optax, chex and einops (a fresh
    interpreter: test workers share sys.modules)."""
    code = (
        "import sys\n"
        "import red_gym_tpu.env, red_gym_tpu.rollout\n"
        "import red_gym_tpu.agents.ppo, red_gym_tpu.maps.loader\n"
        "import red_gym_tpu.utils.checkpoint\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
        "             & {'flax', 'orbax', 'PIL', 'yaml'})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
