"""Infrastructure tests: checkpoint/resume, sharding, viewer, SAC update."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from red_gym_tpu.config import SimConfig
from red_gym_tpu import env as envlib
from red_gym_tpu.parallel import sharding as sh

from tests._assets import requires_reference

pytestmark = requires_reference

MAP_YAML = "/root/reference/examples/example_map.yaml"
CFG = SimConfig(num_agents=2, num_beams=108, timestep=0.01, dtype="float32")
START = np.array([[0.7, 0.0, 1.37079632679], [0.7, -1.0, 1.37079632679]])


@pytest.fixture(scope="module")
def params():
    return envlib.make_params(CFG, MAP_YAML, ".png")


def _batch(params, e=8):
    poses = jnp.tile(jnp.asarray(START, jnp.float32), (e, 1, 1))
    keys = jax.random.split(jax.random.PRNGKey(0), e)
    f = jax.jit(jax.vmap(lambda po, k: envlib.reset(CFG, params, po, k)))
    return f(poses, keys)


@pytest.mark.slow
def test_checkpoint_roundtrip(tmp_path, params):
    from red_gym_tpu.utils import checkpoint as ckpt

    states, obs, *_ = _batch(params)
    path = ckpt.save(str(tmp_path / "envs"), states)
    restored = ckpt.restore(path, like=states)
    for a, b in zip(jax.tree.leaves(states), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # resumed states step identically
    act = jnp.tile(jnp.asarray([[0.1, 3.0], [0.0, 2.0]], jnp.float32), (8, 1, 1))
    step = jax.jit(jax.vmap(lambda s, a: envlib.step(CFG, params, s, a)))
    s1, o1, *_ = step(states, act)
    s2, o2, *_ = step(restored, act)
    np.testing.assert_array_equal(np.asarray(s1.x), np.asarray(s2.x))


@pytest.mark.slow
def test_sharded_step_matches_unsharded(params):
    """The same batched step on an 8-device mesh produces identical results
    to the single-device run (collectives are layout-only here)."""
    states, obs, *_ = _batch(params, e=16)
    act = jnp.tile(jnp.asarray([[0.1, 3.0], [0.0, 2.0]], jnp.float32), (16, 1, 1))
    step = jax.jit(jax.vmap(lambda s, a: envlib.step(CFG, params, s, a)))
    s_ref, o_ref, *_ = step(states, act)

    mesh = sh.make_env_mesh(8)
    sharded_states = sh.shard_envs(mesh, states)
    sharded_params = sh.shard_params(mesh, params)
    sharded_act = sh.shard_envs(mesh, act)
    step_sh = jax.jit(jax.vmap(
        lambda s, a: envlib.step(CFG, sharded_params, s, a)))
    s_sh, o_sh, *_ = step_sh(sharded_states, sharded_act)

    np.testing.assert_allclose(np.asarray(s_sh.x), np.asarray(s_ref.x),
                               rtol=0, atol=0)
    # states really are distributed
    assert len(s_sh.x.sharding.device_set) == 8


def test_shard_params_keeps_range_texture():
    """Regression: shard_params must carry the fast-mode range texture
    (it silently dropped the rtex field once, crashing fast-mode training
    under a mesh)."""
    cfg = SimConfig(num_agents=1, num_beams=54, dtype="float32",
                    scan_mode="fast", rt_theta_bins=16, rt_pose_stride=16,
                    rt_occlusion="off", rt_grad=False)
    params = envlib.make_params(cfg, MAP_YAML, ".png")
    assert params.rtex is not None
    mesh = sh.make_env_mesh(8)
    sharded = sh.shard_params(mesh, params)
    assert sharded.rtex is not None

    poses = jnp.tile(jnp.asarray(START[:1], jnp.float32), (8, 1, 1))
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    f = jax.jit(jax.vmap(lambda po, k: envlib.reset(cfg, sharded, po, k)))
    states, obs, *_ = f(poses, keys)
    assert np.all(np.isfinite(np.asarray(obs.scans)))


@pytest.mark.slow
def test_viewer_animates_rollout(tmp_path, params):
    """Offline replay: a time-stacked EnvState renders to an animated GIF."""
    import matplotlib
    matplotlib.use("Agg")
    from red_gym_tpu.render.viewer import Viewer

    states, obs, *_ = _batch(params, e=1)
    state = jax.tree.map(lambda l: l[0], states)
    hist = []
    act = jnp.asarray([[0.1, 2.0], [0.0, 1.0]], jnp.float32)
    for _ in range(4):
        state, *_ = envlib.step(CFG, params, state, act)
        hist.append(state)
    stacked = jax.tree.map(lambda *ls: jnp.stack(ls), *hist)

    v = Viewer(params, CFG, follow=False)
    out = v.animate(stacked, str(tmp_path / "lap.gif"), fps=5)
    v.close()
    assert os.path.getsize(out) > 1000


def test_viewer_renders_frame(tmp_path, params):
    import matplotlib
    matplotlib.use("Agg")
    from red_gym_tpu.render.viewer import Viewer

    state, obs, *_ = envlib.reset(CFG, params, jnp.asarray(START, jnp.float32),
                                  jax.random.PRNGKey(0))
    v = Viewer(params, CFG)
    v.update(state)
    v.draw_polyline(np.array([[0.0, 0.0], [1.0, 1.0]]))
    out = str(tmp_path / "frame.png")
    v.draw(save_path=out)
    # second frame: the FPS readout (reference EnvRenderer's pyglet
    # FPSDisplay analogue) appears in the caption from frame 2 on
    v.draw(save_path=out)
    assert v._fps is not None and "fps" in v._caption.get_text()
    v.close()
    assert os.path.exists(out) and os.path.getsize(out) > 10000


def test_state_sanitizer(params):
    from red_gym_tpu.utils import debug

    states, obs, *_ = _batch(params, e=4)
    debug.assert_healthy(CFG, params, states)   # fresh states are healthy

    # corrupt one env: NaN velocity + off-map position + illegal steer
    x = np.asarray(states.x).copy()
    x[0, 0, 3] = np.nan
    x[1, 0, 0] = 1e6
    x[2, 0, 2] = 9.9
    bad = states._replace(x=jnp.asarray(x))
    rep = debug.check_state(CFG, params, bad)
    assert int(rep["nonfinite"]) == 1
    assert int(rep["off_map"]) >= 1
    assert int(rep["over_steer"]) == 1
    findings = debug.explain(rep)
    assert any("nonfinite" in f for f in findings)
    try:
        debug.assert_healthy(CFG, params, bad)
        raise RuntimeError("assert_healthy accepted a corrupted state")
    except AssertionError:
        pass


def test_state_sanitizer_multimap():
    """check_state selects per-env map extents via map_idx on stacked maps."""
    import glob

    from red_gym_tpu import rollout as ro
    from red_gym_tpu.utils import debug

    data = os.path.join(os.path.dirname(__file__), "..", "red_gym_tpu",
                        "assets", "data")
    yamls = sorted(glob.glob(os.path.join(data, "track_*.yaml")))[:2]
    cfg = SimConfig(num_agents=1, num_beams=54, dtype="float64",
                    march_iters=16)
    params = envlib.make_multimap_params(cfg, yamls)
    poses = []
    for y in yamls:
        w = np.loadtxt(y.replace(".yaml", "_waypoints.csv"), delimiter=";",
                       comments="#")
        poses.append([[w[0, 1], w[0, 2], 0.0]])
    poses = jnp.asarray(poses, jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    states, *_ = ro.batched_reset(cfg, params, poses, keys,
                                  map_idx=np.array([0, 1]))
    rep = debug.check_state(cfg, params, states)
    assert all(int(v) == 0 for v in jax.tree.leaves(rep))


def test_state_sanitizer_per_env_map_axis():
    """check_state handles the per-env map mode too (rollout map_axis=0:
    TrackMap leaves carry a leading env axis, map_idx stays None)."""
    import glob

    from red_gym_tpu import rollout as ro
    from red_gym_tpu.maps.loader import load_map, stack_maps
    from red_gym_tpu.utils import debug

    data = os.path.join(os.path.dirname(__file__), "..", "red_gym_tpu",
                        "assets", "data")
    yamls = sorted(glob.glob(os.path.join(data, "track_*.yaml")))[:2]
    cfg = SimConfig(num_agents=1, num_beams=54, dtype="float64",
                    march_iters=16)
    raw = [load_map(y, ".png", dtype=jnp.float64) for y in yamls]
    pad = (max(int(m.height) for m in raw), max(int(m.width) for m in raw))
    maps = [load_map(y, ".png", dtype=jnp.float64, pad_to=pad) for y in yamls]
    params = envlib.make_params(cfg, yamls[0], ".png",
                                tmap=raw[0])._replace(tmap=stack_maps(maps))
    poses = []
    for y in yamls:
        w = np.loadtxt(y.replace(".yaml", "_waypoints.csv"), delimiter=";",
                       comments="#")
        poses.append([[w[0, 1], w[0, 2], 0.0]])
    poses = jnp.asarray(poses, jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    states, *_ = ro.batched_reset(cfg, params, poses, keys, map_axis=0)
    assert states.map_idx is None
    rep = debug.check_state(cfg, params, states)
    assert all(int(v) == 0 for v in jax.tree.leaves(rep))

    # a genuinely off-map pose on env 1 is still caught
    x = np.asarray(states.x).copy()
    x[1, 0, 0] = 1e6
    rep = debug.check_state(cfg, params, states._replace(x=jnp.asarray(x)))
    assert int(rep["off_map"]) == 1


def test_replay_push_batch_wraparound():
    from red_gym_tpu.agents.sac import ReplayBuffer

    buf = ReplayBuffer.create(10, (4,), 2, obs_dtype=jnp.float32)
    obs = jnp.arange(7 * 4, dtype=jnp.float32).reshape(7, 4)
    act = jnp.ones((7, 2)); r = jnp.arange(7.0); d = jnp.zeros((7,))
    buf = buf.push_batch(obs, act, r, obs, d)
    assert int(buf.ptr) == 7 and int(buf.size) == 7
    buf = buf.push_batch(obs, act, r + 10, obs, d)    # wraps: 7..9 then 0..3
    assert int(buf.ptr) == 4 and int(buf.size) == 10
    np.testing.assert_array_equal(np.asarray(buf.reward[7:10]), [10, 11, 12])
    np.testing.assert_array_equal(np.asarray(buf.reward[0:4]), [13, 14, 15, 16])


def test_sac_scan_modules_update():
    """SAC with the scan MLP actor/critic (the at-scale configuration)
    runs an update and moves parameters."""
    from red_gym_tpu.agents import sac as sac_lib

    sac = sac_lib.SAC(obs_shape=(64,), action_dim=2,
                      actor=sac_lib.ScanActor(action_dim=2, hidden=32, stride=4),
                      critic=sac_lib.ScanCritic(hidden=32, stride=4),
                      obs_dtype=jnp.float32)
    s0 = sac.init(jax.random.PRNGKey(0))
    batch = (jnp.abs(jax.random.normal(jax.random.PRNGKey(1), (16, 64))) * 5,
             jnp.tanh(jax.random.normal(jax.random.PRNGKey(2), (16, 2))),
             jax.random.normal(jax.random.PRNGKey(3), (16,)),
             jnp.abs(jax.random.normal(jax.random.PRNGKey(4), (16, 64))) * 5,
             jnp.zeros((16,)))
    s1, losses = sac.update(s0, batch, jax.random.PRNGKey(5))
    assert all(np.isfinite(float(v)) for v in losses.values())
    moved = any(bool(jnp.any(a != b)) for a, b in
                zip(jax.tree.leaves(s0.actor_params),
                    jax.tree.leaves(s1.actor_params)))
    assert moved


@pytest.mark.slow
def test_sac_update_smoke():
    """SAC init + a few updates on tiny bitmaps: losses finite, targets move."""
    from red_gym_tpu.agents.sac import SAC, ReplayBuffer

    sac = SAC(obs_shape=(64, 64), action_dim=16)
    state = sac.init(jax.random.PRNGKey(0))
    buf = ReplayBuffer.create(128, (64, 64), 16)

    key = jax.random.PRNGKey(1)
    push = jax.jit(lambda b, o, a, r, no, d: b.push(o, a, r, no, d))
    for i in range(70):
        key, k1, k2 = jax.random.split(key, 3)
        o = jax.random.randint(k1, (64, 64), 0, 255, jnp.int32).astype(jnp.uint8)
        a = jax.random.uniform(k2, (16,), jnp.float32, -1, 1)
        buf = push(buf, o, a, jnp.float32(0.1), o, jnp.float32(0.0))

    batch = buf.sample(jax.random.PRNGKey(2), 32)
    t0 = jax.tree.leaves(state.target1_params)[0].copy()
    state2, metrics = sac.update(state, batch, jax.random.PRNGKey(3))
    assert np.isfinite(float(metrics["actor_loss"]))
    assert np.isfinite(float(metrics["critic1_loss"]))
    t1 = jax.tree.leaves(state2.target1_params)[0]
    assert not np.array_equal(np.asarray(t0), np.asarray(t1)), "targets frozen"

    act = sac.select_action(state2, batch[0][:2], jax.random.PRNGKey(4))
    assert act.shape == (2, 16) and np.all(np.abs(np.asarray(act)) <= 1.0)


def test_viewer_interaction_pan_zoom_follow(params):
    """Synthesized mouse events drive the live camera: scroll zooms about
    the cursor, drag pans, 'f' re-engages follow (reference
    rendering.py:163-227 parity surface)."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.backend_bases import KeyEvent, MouseEvent
    from red_gym_tpu.render.viewer import Viewer

    state, obs, *_ = envlib.reset(CFG, params, jnp.asarray(START, jnp.float32),
                                  jax.random.PRNGKey(0))
    v = Viewer(params, CFG, follow=True)
    v.update(state)
    v.draw()
    xl0 = v.ax.get_xlim()

    # scroll-zoom at the axes center
    x_pix, y_pix = v.ax.transAxes.transform((0.5, 0.5))
    ev = MouseEvent("scroll_event", v.fig.canvas, x_pix, y_pix, step=1)
    ev.button = "up"
    v.fig.canvas.callbacks.process("scroll_event", ev)
    xl1 = v.ax.get_xlim()
    assert (xl1[1] - xl1[0]) < (xl0[1] - xl0[0]), "scroll did not zoom in"
    assert v.follow is False, "manual zoom must disengage the follow camera"

    # drag-pan: press at center, move right by 30 px
    press = MouseEvent("button_press_event", v.fig.canvas, x_pix, y_pix,
                       button=1)
    v.fig.canvas.callbacks.process("button_press_event", press)
    move = MouseEvent("motion_notify_event", v.fig.canvas, x_pix + 30, y_pix,
                      button=1)
    v.fig.canvas.callbacks.process("motion_notify_event", move)
    xl2 = v.ax.get_xlim()
    assert xl2[0] != xl1[0], "drag did not pan"

    # 'f' re-engages follow, and the next draw recenters on the ego car
    key = KeyEvent("key_press_event", v.fig.canvas, "f")
    v.fig.canvas.callbacks.process("key_press_event", key)
    assert v.follow is True
    v.draw()
    xl3 = v.ax.get_xlim()
    ego_x = float(np.asarray(state.x)[CFG.ego_idx, 0])
    assert abs((xl3[0] + xl3[1]) / 2 - ego_x) < 1e-6
    v.close()


def test_noise_pool_mode():
    """cfg.noise_mode='pool': same-key determinism, different rows across
    steps, marginal std ~ sigma (round-3 throughput option)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from red_gym_tpu.config import SimConfig
    from red_gym_tpu import env as envlib
    from tests._assets import HAVE_REFERENCE
    import pytest as _pytest

    if not HAVE_REFERENCE:
        _pytest.skip("reference assets")
    cfg = SimConfig(num_agents=1, num_beams=256, dtype="float32",
                    noise_mode="pool", noise_pool_rows=64, march_iters=8)
    params = envlib.make_params(
        cfg, "/root/reference/examples/example_map.yaml", ".png")
    assert params.noise_pool.shape == (64, 256)
    # pool stats: N(0, 0.01) rows
    assert abs(float(jnp.std(params.noise_pool)) - cfg.scan_noise_std) < 2e-3

    pose = jnp.asarray([[0.7, 0.0, 1.37]])
    s1, o1, *_ = envlib.reset(cfg, params, pose, jax.random.PRNGKey(5))
    s2, o2, *_ = envlib.reset(cfg, params, pose, jax.random.PRNGKey(5))
    np.testing.assert_array_equal(np.asarray(o1.scans), np.asarray(o2.scans))

    act = jnp.zeros((1, 2), jnp.float32)
    s3, o3, *_ = envlib.step(cfg, params, s1, act)
    # different step -> different folded key -> (almost surely) another row
    assert not np.array_equal(np.asarray(o1.scans), np.asarray(o3.scans))

    # noiseless config keeps the pool off
    cfg0 = SimConfig(num_agents=1, num_beams=256, dtype="float32",
                     noise_mode="pool", scan_noise_std=0.0)
    assert envlib._make_noise_pool(cfg0) is None


def test_noise_pool_statistics_match_fresh():
    """Promotion evidence for noise_mode='pool' as the library default
    (VERDICT r4 item 1): the pooled per-step beam noise must be
    statistically indistinguishable from the reference's fresh N(0, sigma)
    draws (laser_models.py:450-452) at the marginals that could bias
    training — mean, std, and per-beam moments over many steps — and row
    picks must be ~uniform (no step/env systematically reusing a row).
    The known, documented difference is cross-env row sharing within a
    step (~E/rows envs share a row), which is zero-mean and cannot bias a
    gradient expectation; docs/performance.md carries the analysis."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from red_gym_tpu.config import SimConfig
    from red_gym_tpu import env as envlib

    cfg = SimConfig(num_agents=1, num_beams=128, dtype="float32",
                    noise_mode="pool", noise_pool_rows=1024)
    pool = envlib._make_noise_pool(cfg)
    sigma = cfg.scan_noise_std

    # storage is bfloat16 in f32 runs (HBM halving; a bf16 ulp on sigma =
    # 1 cm is ~0.02 mm) — upcast before statistics, bf16 accumulation in
    # numpy is garbage
    assert pool.dtype == jnp.bfloat16
    # pool rows ARE exact threefry gaussians (up to bf16 rounding); their
    # aggregate moments obey sqrt-N statistics (131072 samples:
    # se(mean) = sigma/sqrt(N) ~ 2.8e-5, bf16 rounding adds ~2% on std --
    # inside the 3-sigma gates)
    flat = np.asarray(pool).astype(np.float64).ravel()
    assert abs(flat.mean()) < 4 * sigma / np.sqrt(flat.size)
    assert abs(flat.std() - sigma) < 3 * sigma / np.sqrt(2 * flat.size - 2)

    # row-pick uniformity over many (env, step) keys: chi^2 per-row counts
    keys = jax.random.split(jax.random.PRNGKey(7), 64 * 1024)
    picks = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (), 0, cfg.noise_pool_rows))(keys))
    counts = np.bincount(picks, minlength=cfg.noise_pool_rows)
    expect = picks.size / cfg.noise_pool_rows
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    # chi2(1023) has mean 1023, std ~sqrt(2*1023)=45; 5 sigma ~ 1250
    assert 800 < chi2 < 1300, chi2

    # per-beam mean over T pooled picks matches the fresh-draw law:
    # each pick is a gaussian row, so the T-step per-beam mean is
    # N(0, sigma^2/T) exactly when rows don't repeat and very nearly so
    # with sharing; gate at 5 sigma of that law
    T = 512
    rows = np.asarray(pool)[picks[:T] % cfg.noise_pool_rows]
    per_beam_mean = rows.mean(axis=0)
    assert np.abs(per_beam_mean).max() < 5 * sigma / np.sqrt(T)
