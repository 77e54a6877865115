"""The F1TENTH environment as a stateless pure function over pytrees.

The reference env is a hierarchy of mutable objects — F110Env -> Simulator ->
RaceCar with process-global scan state (reference: gym/f110_gym/envs/
f110_env.py, base_classes.py).  Here the whole simulation is

    ``step(cfg, params, state, actions) -> (state', obs, reward, done, info)``

over an `EnvState` pytree: one fused XLA program per step covering dynamics,
lidar, collision and lap logic for all agents, trivially `vmap`-able over an
env axis and `lax.scan`-able over time.  A thin stateful `F110Env` wrapper
reproduces the reference's gym API (4-tuple step, obs dict with the same
keys) for drop-in use.

Step ordering matches Simulator.step + F110Env.step exactly
(base_classes.py:546-605, f110_env.py:261-302): pose update -> scans ->
pairwise body collision -> per-agent iTTC (zeroing dynamic state) ->
opponent ray casting -> obs; then time/lap/done accounting.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from red_gym_tpu.config import Integrator, SimConfig, VehicleParams
from red_gym_tpu.maps.loader import TrackMap, load_map
from red_gym_tpu.ops import agent_scan, collision as col, dynamics as dyn, integrate
from red_gym_tpu.ops import scan as scan_ops, scan_fast


class EnvParams(NamedTuple):
    """Everything the step function reads but does not write."""

    vehicle: VehicleParams        # fields scalar or (A,) for per-agent params
    tables: scan_ops.ScanTables
    tmap: TrackMap
    rtex: Optional["scan_fast.RangeTexture"] = None  # fast-mode range texture
    noise_pool: Optional[jnp.ndarray] = None  # (rows, B) pregenerated beam
    # noise for cfg.noise_mode="pool" (one row fetch replaces 17M fresh
    # transcendentals/step at 16k envs)


class EnvState(NamedTuple):
    """Complete simulation state for one env (leading agent axis A)."""

    x: jnp.ndarray            # (A, 7) [x, y, steer, vel, yaw, yaw_rate, slip]
    steer_buf: jnp.ndarray    # (A, D) steering delay line, newest first
    steer_cnt: jnp.ndarray    # (A,) int32 fills of the delay line
    collisions: jnp.ndarray   # (A,) float collision flags from last step
    near_starts: jnp.ndarray  # (A,) bool finish-line proximity latch
    toggle_list: jnp.ndarray  # (A,) int32 finish-line crossing toggles
    lap_times: jnp.ndarray    # (A,)
    lap_counts: jnp.ndarray   # (A,) int32
    current_time: jnp.ndarray  # scalar
    start_pose: jnp.ndarray   # (A, 3) reset poses
    start_rot: jnp.ndarray    # (2, 2) rotation into the ego start frame
    rng: jax.Array            # PRNG key for scan noise
    step_idx: jnp.ndarray     # scalar int32
    map_idx: jnp.ndarray = None  # scalar int32 into a map-STACKED params.tmap
    # (None/unused when params carry a single map or per-env vmapped maps)


class Observation(NamedTuple):
    """Fixed-shape observation struct (reference obs dict fields,
    base_classes.py:587-605 + f110_env.py:277-278)."""

    scans: jnp.ndarray          # (A, B)
    poses_x: jnp.ndarray        # (A,)
    poses_y: jnp.ndarray
    poses_theta: jnp.ndarray
    linear_vels_x: jnp.ndarray
    linear_vels_y: jnp.ndarray  # always zero (reference base_classes.py:602)
    ang_vels_z: jnp.ndarray
    collisions: jnp.ndarray
    lap_times: jnp.ndarray
    lap_counts: jnp.ndarray

    def to_legacy_dict(self, ego_idx: int = 0) -> dict:
        d = {k: np.asarray(getattr(self, k)) for k in self._fields}
        d["ego_idx"] = ego_idx
        return d


def make_params(cfg: SimConfig, map_yaml_path: str, map_ext: str = ".png",
                vehicle: Optional[VehicleParams] = None,
                tmap: Optional[TrackMap] = None) -> EnvParams:
    vehicle = vehicle if vehicle is not None else VehicleParams.default(cfg.jdtype)
    if tmap is None:
        tmap = load_map(map_yaml_path, map_ext, dtype=cfg.jdtype)
    # the car-edge table uses width/2 and (lf+lr)/2 (base_classes.py:127-128)
    tables = scan_ops.build_tables(
        cfg, width=float(np.asarray(vehicle.width).ravel()[0]),
        length=float(np.asarray(vehicle.lf).ravel()[0] + np.asarray(vehicle.lr).ravel()[0]),
        dtype=cfg.jdtype)
    rtex = None
    if cfg.scan_mode == "fast":
        rtex = scan_fast.build_range_texture(tmap, cfg)
    pool = _make_noise_pool(cfg)
    return EnvParams(vehicle=vehicle, tables=tables, tmap=tmap, rtex=rtex,
                     noise_pool=pool)


def _make_noise_pool(cfg: SimConfig):
    """Pregenerated N(0, sigma) beam rows for cfg.noise_mode='pool'.

    Content is keyed by a fixed seed: determinism of a run stays governed
    by the per-env state rng, which selects rows.  STORAGE is bfloat16 in
    float32 runs: the per-step (E, B) noise slab is pure memory traffic
    and a bf16 ulp on a sigma = 1 cm perturbation is ~0.02 mm — far below
    the sensor noise it implements; compute upcasts on read."""
    if cfg.noise_mode != "pool" or cfg.scan_noise_std <= 0:
        return None
    key = jax.random.PRNGKey(0x5EED)
    pool = cfg.scan_noise_std * jax.random.normal(
        key, (cfg.noise_pool_rows, cfg.num_beams), cfg.jdtype)
    if cfg.jdtype == jnp.float32:
        pool = pool.astype(jnp.bfloat16)
    return pool


def make_multimap_params(cfg: SimConfig, map_yaml_paths, map_ext: str = ".png",
                         vehicle: Optional[VehicleParams] = None) -> EnvParams:
    """EnvParams with M maps STACKED along a leading map axis (padded to a
    common texture shape).  Envs pick their track with EnvState.map_idx —
    a flat-index offset into the shared textures, no per-env copies.  This
    is the randomized-track training configuration the reference could not
    express (one global map per process, base_classes.py:62-66)."""
    from red_gym_tpu.maps.loader import load_map, stack_maps

    raw = [load_map(p, map_ext, dtype=cfg.jdtype) for p in map_yaml_paths]
    pad = (max(int(m.height) for m in raw), max(int(m.width) for m in raw))
    maps = [load_map(p, map_ext, dtype=cfg.jdtype, pad_to=pad)
            for p in map_yaml_paths]
    tmap = stack_maps(maps)

    vehicle = vehicle if vehicle is not None else VehicleParams.default(cfg.jdtype)
    tables = scan_ops.build_tables(
        cfg, width=float(np.asarray(vehicle.width).ravel()[0]),
        length=float(np.asarray(vehicle.lf).ravel()[0]
                     + np.asarray(vehicle.lr).ravel()[0]),
        dtype=cfg.jdtype)
    rtex = None
    if cfg.scan_mode == "fast":
        # build each texture on the RAW map (content-hash cache key stays
        # stable across stack compositions — building on the padded maps
        # re-marched every texture whenever the stack's max dims changed),
        # then pad the finished textures to the common grid
        s = cfg.rt_pose_stride
        hc_pad, wc_pad = (pad[0] + s - 1) // s, (pad[1] + s - 1) // s
        rtex = scan_fast.stack_textures(
            [scan_fast.pad_texture(scan_fast.build_range_texture(m, cfg),
                                   hc_pad, wc_pad) for m in raw])
    pool = _make_noise_pool(cfg)
    return EnvParams(vehicle=vehicle, tables=tables, tmap=tmap, rtex=rtex,
                     noise_pool=pool)


def init_state(cfg: SimConfig, poses, key, map_idx=None) -> EnvState:
    """Fresh state at given (A, 3) poses (reference RaceCar.reset +
    F110Env.reset counters, base_classes.py:181-202, f110_env.py:317-329).

    ``map_idx``: optional scalar index into a map-STACKED params.tmap/rtex
    (copy-free multi-track batches; see maps.loader.stack_maps and
    scan_fast.stack_textures)."""
    dt = cfg.jdtype
    poses = jnp.asarray(poses, dtype=dt)
    a = poses.shape[0]
    x = jnp.zeros((a, 7), dtype=dt)
    x = x.at[:, 0:2].set(poses[:, 0:2])
    x = x.at[:, 4].set(poses[:, 2])

    theta_e = poses[cfg.ego_idx, 2]
    c, s = jnp.cos(-theta_e), jnp.sin(-theta_e)
    start_rot = jnp.array([[c, -s], [s, c]], dtype=dt)

    return EnvState(
        x=x,
        steer_buf=jnp.zeros((a, cfg.steer_delay), dtype=dt),
        steer_cnt=jnp.zeros((a,), dtype=jnp.int32),
        collisions=jnp.zeros((a,), dtype=dt),
        near_starts=jnp.ones((a,), dtype=bool),
        toggle_list=jnp.zeros((a,), dtype=jnp.int32),
        lap_times=jnp.zeros((a,), dtype=dt),
        lap_counts=jnp.zeros((a,), dtype=jnp.int32),
        current_time=jnp.zeros((), dtype=dt),
        start_pose=poses,
        start_rot=start_rot,
        rng=key,
        step_idx=jnp.zeros((), dtype=jnp.int32),
        map_idx=None if map_idx is None else jnp.asarray(map_idx, jnp.int32),
    )


def _steer_delay(cfg: SimConfig, state: EnvState, raw_steer):
    """Two-deep steering delay line (base_classes.py:268-276): the first
    `steer_delay` steps see zero steer, afterwards the oldest buffered value."""
    d = cfg.steer_delay
    filled = state.steer_cnt >= d
    steer = jnp.where(filled, state.steer_buf[:, d - 1], 0.0)
    new_buf = jnp.concatenate([raw_steer[:, None], state.steer_buf[:, : d - 1]], axis=1)
    new_cnt = jnp.minimum(state.steer_cnt + 1, d)
    return steer, new_buf, new_cnt


def sim_step(cfg: SimConfig, params: EnvParams, state: EnvState, actions):
    """One Simulator.step (base_classes.py:546-605): physics + sensing for
    all agents.  actions (A, 2) = [desired steer, desired speed]."""
    p = params.vehicle
    actions = jnp.asarray(actions, dtype=cfg.jdtype)
    raw_steer, vel_cmd = actions[:, 0], actions[:, 1]

    steer, steer_buf, steer_cnt = _steer_delay(cfg, state, raw_steer)

    # pluggable low-level controller (fork delta, reference
    # base_classes.py:68,91,280); default = the reference PID
    controller = cfg.speed_controller or dyn.pid
    accl, sv = controller(vel_cmd, steer, state.x[:, 3], state.x[:, 2],
                          p.sv_max, p.a_max, p.v_max, p.v_min)
    # component-tuple (struct-of-arrays) integration: the whole RK4 step
    # fuses into a few XLA kernels instead of ~50 stack/slice fusions
    xt = tuple(state.x[:, i] for i in range(7))
    xt = integrate.integrate_t(cfg.integrator, dyn.vehicle_dynamics_st_t,
                               xt, sv, accl, cfg.timestep, p)
    xt = xt[:4] + (integrate.wrap_yaw(xt[4]),) + xt[5:]
    x = jnp.stack(xt, axis=-1)

    poses = jnp.stack([xt[0], xt[1], xt[4]], axis=-1)

    # lidar: one noise draw per env per step, broadcast to all agents —
    # reproducing the reference's identical-seed-per-car quirk
    # (base_classes.py:117,202).
    rng, sub = jax.random.split(state.rng)

    def _noise_row(dtype=None):
        if cfg.noise_mode == "pool" and params.noise_pool is not None:
            # one row pick per env per step: contiguous fetch, no fresh
            # normals (see SimConfig.noise_mode)
            r = jax.random.randint(sub, (), 0, cfg.noise_pool_rows)
            # randint(0, rows) is in-bounds by construction:
            # promise_in_bounds drops the clamp/select pass
            row = params.noise_pool.at[r].get(mode="promise_in_bounds")
            return row if dtype is None else row.astype(dtype)
        return cfg.scan_noise_std * jax.random.normal(
            sub, (cfg.num_beams,),
            dtype=cfg.jdtype if dtype is None else dtype)

    if cfg.scan_mode == "fast":
        scans = scan_fast.trace_fast_mxu(
            poses, params.tables, params.tmap, params.rtex, cfg,
            midx=state.map_idx)
    else:
        scans = scan_ops.trace(poses, params.tables, params.tmap, cfg,
                               midx=state.map_idx)
    if cfg.scan_noise_std > 0:
        scans = scans + _noise_row(scans.dtype)[None, :]

    # pairwise body collision (base_classes.py:529-543) — rectangle SAT
    # straight from poses; same boolean as collision_multiple, ~30 fused
    # scalar ops instead of tiny padded einsums
    body_hits = col.pairwise_hits_from_poses(
        poses, p.length, p.width).astype(x.dtype)

    # iTTC against walls -> freeze dynamic state (base_classes.py:227-252);
    # single fused elementwise mask, not a scatter-then-select
    ttc_hit = agent_scan.check_ttc(scans, x[:, 3], params.tables,
                                   cfg.ttc_thresh)
    freeze = ttc_hit[:, None] & (jnp.arange(x.shape[-1]) >= 3)
    x = jnp.where(freeze, 0.0, x)

    # opponent ray casting on the fused scans (base_classes.py:204-225)
    verts = col.get_vertices(poses, p.length, p.width)
    scans = agent_scan.ray_cast_all_opponents(poses, scans, verts,
                                              params.tables)

    collisions = jnp.maximum(body_hits, ttc_hit.astype(body_hits.dtype))

    new_state = state._replace(
        x=x, steer_buf=steer_buf, steer_cnt=steer_cnt,
        collisions=collisions, rng=rng, step_idx=state.step_idx + 1)
    return new_state, scans


def _lap_done_update(cfg: SimConfig, state: EnvState):
    """Finish-line toggle / lap counting / done (f110_env.py:202-244)."""
    left_t = right_t = cfg.finish_band_halfwidth
    dxy = state.x[:, 0:2] - state.start_pose[:, 0:2]          # (A, 2)
    delta = state.start_rot @ dxy.T                            # (2, A)
    temp_y = delta[1]
    over = temp_y > left_t
    under = temp_y < -right_t
    temp_y = jnp.where(over, temp_y - left_t,
                       jnp.where(under, -right_t - temp_y, 0.0))
    dist2 = delta[0] ** 2 + temp_y ** 2
    closes = dist2 <= cfg.finish_dist2

    crossed = closes != state.near_starts
    toggle_list = state.toggle_list + crossed.astype(jnp.int32)
    near_starts = jnp.where(crossed, closes, state.near_starts)
    lap_counts = toggle_list // 2
    lap_times = jnp.where(toggle_list < cfg.laps_to_finish_toggles,
                          state.current_time, state.lap_times)

    finished = toggle_list >= cfg.laps_to_finish_toggles
    done = (state.collisions[cfg.ego_idx] > 0) | jnp.all(finished)

    new_state = state._replace(near_starts=near_starts, toggle_list=toggle_list,
                               lap_counts=lap_counts, lap_times=lap_times)
    return new_state, done, finished


def _build_obs(state: EnvState, scans) -> Observation:
    zeros = jnp.zeros_like(state.x[:, 3])
    return Observation(
        scans=scans,
        poses_x=state.x[:, 0],
        poses_y=state.x[:, 1],
        poses_theta=state.x[:, 4],
        linear_vels_x=state.x[:, 3],
        linear_vels_y=zeros,
        ang_vels_z=state.x[:, 5],
        collisions=state.collisions,
        lap_times=state.lap_times,
        lap_counts=state.lap_counts.astype(state.lap_times.dtype),
    )


def step(cfg: SimConfig, params: EnvParams, state: EnvState, actions):
    """Full env step (f110_env.py:261-302).

    Returns (state', obs, reward, done, info) where info carries the
    per-agent checkpoint_done flags.
    """
    state, scans = sim_step(cfg, params, state, actions)
    state = state._replace(current_time=state.current_time + cfg.timestep)
    state, done, finished = _lap_done_update(cfg, state)
    obs = _build_obs(state, scans)
    reward = jnp.asarray(cfg.timestep, dtype=cfg.jdtype)
    info = {"checkpoint_done": finished}
    return state, obs, reward, done, info


def reset(cfg: SimConfig, params: EnvParams, poses, key, map_idx=None):
    """Reset to poses and synthesize the first observation by stepping once
    with zero actions, exactly like the reference (f110_env.py:304-347)."""
    state = init_state(cfg, poses, key, map_idx=map_idx)
    actions = jnp.zeros((poses.shape[0], 2), dtype=cfg.jdtype)
    return step(cfg, params, state, actions)


def staggered_start_poses(num_agents: int,
                          waypoints_csv: Optional[str] = None) -> np.ndarray:
    """Default (A, 3) grid spawn: agents on consecutive ranks of a raceline
    at its first waypoint (the default map's unless ``waypoints_csv`` names
    another; see assets.raceline_poses).  The shared default of the
    gymnasium adapters and the examples."""
    from red_gym_tpu import assets

    return assets.raceline_poses(1, num_agents, waypoints_csv)[0]


# ---------------------------------------------------------------------------
# Stateful wrapper mirroring the reference gym API
# ---------------------------------------------------------------------------


class F110Env:
    """Drop-in stateful wrapper with the reference's gym-style API.

    ``step`` returns the classic 4-tuple with an obs dict using the same
    keys as the reference (f110_env.py:53-99).  All compute stays jitted;
    this class only holds the current EnvState.
    """

    metadata = {"render.modes": ["human", "human_fast"]}

    def __init__(self, map: str = None, map_ext: str = ".png",
                 params: dict | VehicleParams | None = None,
                 num_agents: int = 2, timestep: float = 0.01, ego_idx: int = 0,
                 integrator: Integrator = Integrator.RK4,
                 fov: float = 2.0 * np.pi, seed: int = 12345,
                 num_beams: int = 1080, dtype: str = "float32",
                 tmap: TrackMap | None = None, **kwargs):
        self.cfg = SimConfig(num_agents=num_agents, num_beams=num_beams,
                             fov=fov, timestep=timestep, ego_idx=ego_idx,
                             integrator=integrator, dtype=dtype,
                             **{k: v for k, v in kwargs.items()
                                if k in SimConfig.__dataclass_fields__})
        if isinstance(params, dict):
            vehicle = VehicleParams.from_dict(params, dtype=self.cfg.jdtype)
        elif isinstance(params, VehicleParams):
            vehicle = params
        else:
            vehicle = VehicleParams.default(self.cfg.jdtype)
        map_yaml = f"{map}.yaml" if map and not map.endswith(".yaml") else map
        self.map_yaml = map_yaml
        self.params = make_params(self.cfg, map_yaml, map_ext, vehicle, tmap=tmap)
        self.seed = seed
        self.state: EnvState | None = None
        self.render_callbacks = []
        self._renderer = None

        cfg = self.cfg
        self._jit_step = jax.jit(lambda p, s, a: step(cfg, p, s, a))
        self._jit_reset = jax.jit(lambda p, poses, key: reset(cfg, p, poses, key))

    # -- gym-style API ------------------------------------------------------
    def reset(self, poses):
        key = jax.random.PRNGKey(self.seed)
        self.state, obs, reward, done, info = self._jit_reset(
            self.params, jnp.asarray(poses), key)
        return self._legacy(obs), float(reward), bool(done), self._info(info)

    def step(self, action):
        self.state, obs, reward, done, info = self._jit_step(
            self.params, self.state, jnp.asarray(action))
        return self._legacy(obs), float(reward), bool(done), self._info(info)

    def update_params(self, params: dict, index: int = -1):
        """Functional param update (reference f110_env.py:362-373)."""
        vehicle = self.params.vehicle
        if index < 0:
            vehicle = VehicleParams.from_dict(params, dtype=self.cfg.jdtype)
        else:
            a = self.cfg.num_agents
            fields = {}
            for name in VehicleParams._fields:
                cur = jnp.broadcast_to(getattr(vehicle, name), (a,))
                if name in params:
                    cur = cur.at[index].set(params[name])
                fields[name] = cur
            vehicle = VehicleParams(**fields)
        self.params = self.params._replace(vehicle=vehicle)

    def update_map(self, map_path: str, map_ext: str = ".png"):
        tmap = load_map(map_path, map_ext, dtype=self.cfg.jdtype)
        rtex = self.params.rtex
        if self.cfg.scan_mode == "fast":
            # the range texture is map-derived: rebuild, never keep stale
            rtex = scan_fast.build_range_texture(tmap, self.cfg)
        self.params = self.params._replace(tmap=tmap, rtex=rtex)
        self._renderer = None  # map raster changed

    def add_render_callback(self, fn):
        self.render_callbacks.append(fn)

    def render(self, mode: str = "human"):
        from red_gym_tpu.render.viewer import Viewer

        if self._renderer is None:
            self._renderer = Viewer(self.params, self.cfg)
        self._renderer.update(self.state)
        for cb in self.render_callbacks:
            cb(self._renderer)
        self._renderer.draw(block=False)

    # -- helpers -------------------------------------------------------------
    def _legacy(self, obs: Observation) -> dict:
        return obs.to_legacy_dict(self.cfg.ego_idx)

    @staticmethod
    def _info(info) -> dict:
        return {"checkpoint_done": np.asarray(info["checkpoint_done"])}


def make(map: str, **kwargs) -> F110Env:
    """Construct an env (the reference's gym.make('f110_gym:f110-v0', ...))."""
    return F110Env(map=map, **kwargs)
