"""PPO actor-learner, fully on device, sharded over an env mesh.

This is the scaled training loop the BASELINE configs 4/5 call for (16k-64k
envs feeding a learner with on-device rollouts): the env batch is sharded
along a 1-D ``env`` mesh axis, policy params are replicated, and XLA inserts
the psum for gradient sync between devices.  There is no reference
counterpart — the reference trains SAC one env at a time on host
(reference: src/SAL.py:975-1022); this module is the on-device replacement
for scale.

The policy consumes the lidar scan directly (log-scaled, strided) rather
than a rasterized bitmap — racing policies need ranges, and skipping the
256x256 rasterization keeps the actor step bandwidth-light.  A bitmap-CNN
policy for SAL-compat lives in agents/sac.py.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import dataclasses

import jax
import jax.numpy as jnp
import optax

from red_gym_tpu.agents import nn
from red_gym_tpu.config import SimConfig
from red_gym_tpu.env import EnvParams, Observation, reset, step


def featurize_scan(scan, stride: int, dtype=jnp.float32):
    """The ScanPolicy observation transform: strided + log1p-compressed
    ranges.  Exposed standalone so rollout collection can store the
    compact features instead of raw 1080-beam scans (8x less trajectory
    HBM at scale) — the policy consumes either via ``featurized=True``."""
    return jnp.log1p(scan[..., ::stride].astype(dtype))


@dataclasses.dataclass(frozen=True)
class ScanPolicy(nn.Module):
    """Gaussian actor + value head over strided log-range features (a
    2-layer tanh MLP)."""

    hidden: int = 256
    action_dim: int = 2           # (steer, speed-fraction)
    scan_stride: int = 8
    compute_dtype: Any = jnp.float32

    def forward(self, ctx, scan, vel, featurized: bool = False):
        # scan (..., B) raw, or (..., ceil(B/stride)) pre-featurized
        cd = self.compute_dtype
        x = scan.astype(cd) if featurized else \
            featurize_scan(scan, self.scan_stride, cd)
        x = jnp.concatenate([x, vel[..., None].astype(cd)], axis=-1)
        x = jnp.tanh(nn.dense(ctx, x, self.hidden, cd))
        x = jnp.tanh(nn.dense(ctx, x, self.hidden, cd))
        mean = nn.dense(ctx, x, self.action_dim)
        log_std = ctx.param("log_std", (self.action_dim,),
                            jax.nn.initializers.constant(-0.5))
        value = nn.dense(ctx, x, 1)[..., 0]
        return mean, log_std, value


class PPOConfig(NamedTuple):
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    rollout_len: int = 32
    minibatches: int = 4
    epochs: int = 2
    max_speed: float = 8.0
    max_steer: float = 0.4


class PPOState(NamedTuple):
    params: Any
    opt_state: Any
    key: jax.Array


def action_to_control(act, pcfg: PPOConfig, dtype):
    """Squash the 2-D policy output into (steer, speed) controls."""
    steer = pcfg.max_steer * jnp.tanh(act[..., 0])
    speed = pcfg.max_speed * 0.5 * (jnp.tanh(act[..., 1]) + 1.0)
    return jnp.stack([steer, speed], axis=-1).astype(dtype)


def gaussian_logp(mean, log_std, act):
    return jnp.sum(-0.5 * ((act - mean) / jnp.exp(log_std)) ** 2
                   - log_std - 0.5 * jnp.log(2 * jnp.pi), axis=-1)


def progress_collision_reward(speed_coef: float = 1.0,
                              collision_penalty: float = 10.0):
    """Default PPO shaping: forward progress minus a crash penalty — the
    distilled form of the reference's reward surface (progress + collision
    + centering terms, reference src/SAL.py:219-250; the richer bitmap
    pipeline lives in agents/planning_env.py).  Returns
    fn(cfg, obs, next_obs) -> (E,)."""

    def fn(cfg: SimConfig, obs: Observation, next_obs: Observation):
        ego = cfg.ego_idx
        return (speed_coef * next_obs.linear_vels_x[:, ego] * cfg.timestep
                - collision_penalty * next_obs.collisions[:, ego])

    return fn


def pure_pursuit_opponents(ppp):
    """Opponent-policy hook: every agent tracks the raceline with pure
    pursuit.  Returns fn(obs, map_idx) -> (E, A, 2) [steer, speed] controls
    (map_idx ignored: one shared raceline)."""
    from red_gym_tpu.agents import pure_pursuit as pp

    def plan_all(obs: Observation, map_idx=None):
        def one(x, y, th):
            speed, steer = pp.plan(x, y, th, ppp)
            return jnp.stack([steer, speed])

        return jax.vmap(jax.vmap(one))(obs.poses_x, obs.poses_y,
                                       obs.poses_theta)

    return plan_all


def pure_pursuit_opponents_multi(stacked_ppp):
    """Multi-map opponent hook for map-STACKED envs: each env's opponents
    track the raceline of ITS track (params from pure_pursuit.stack_params,
    selected per env by state.map_idx)."""
    from red_gym_tpu.agents import pure_pursuit as pp

    def plan_all(obs: Observation, map_idx):
        assert map_idx is not None, \
            "pure_pursuit_opponents_multi needs map_idx envs " \
            "(make_multimap_params); use pure_pursuit_opponents otherwise"

        def one_env(xs, ys, ths, mi):
            ppp = jax.tree.map(lambda l: l[mi], stacked_ppp)

            def one(x, y, th):
                speed, steer = pp.plan(x, y, th, ppp)
                return jnp.stack([steer, speed])

            return jax.vmap(one)(xs, ys, ths)

        return jax.vmap(one_env)(obs.poses_x, obs.poses_y, obs.poses_theta,
                                 map_idx)

    return plan_all


class PPO:
    """Ego-agent PPO over batched envs.  Opponents act through the
    ``opponent_plan`` hook — fn(obs, map_idx) -> (E, A, 2) controls for ALL
    agents, of which the non-ego rows are used.  Options: None (hold slow
    straight), pure_pursuit_opponents(...) (raceline-tracking traffic),
    pure_pursuit_opponents_multi(...) (per-track racelines on map-STACKED
    envs), or the string "self" (self-play: the current policy's mean
    action drives opponents)."""

    def __init__(self, cfg: SimConfig, env_params: EnvParams,
                 pcfg: PPOConfig = PPOConfig(), policy: ScanPolicy | None = None,
                 opponent_plan=None, map_axis=None, reward_fn=None):
        self.cfg = cfg
        self.env_params = env_params
        self.pcfg = pcfg
        self.policy = policy or ScanPolicy()
        self.opponent_plan = opponent_plan
        # hook arity, decided here (not by a try/except at trace time,
        # which would swallow genuine TypeErrors raised INSIDE 2-arg
        # hooks): modern hooks take (obs, map_idx), pre-map_idx ones (obs)
        self._opp_takes_map = None
        if callable(opponent_plan):
            import inspect
            try:
                ps = inspect.signature(opponent_plan).parameters.values()
                n_pos = sum(p.kind in (p.POSITIONAL_ONLY,
                                       p.POSITIONAL_OR_KEYWORD)
                            for p in ps)
                var_pos = any(p.kind == p.VAR_POSITIONAL for p in ps)
                self._opp_takes_map = var_pos or n_pos >= 2
            except (TypeError, ValueError):   # C callables etc.
                self._opp_takes_map = True
        self.map_axis = map_axis   # 0 -> per-env maps (stacked tmap/rtex)
        # pluggable shaping: fn(cfg, obs, next_obs) -> (E,) rewards
        self.reward_fn = reward_fn or progress_collision_reward()
        # trajectory compression: when the policy exposes its feature
        # transform (ScanPolicy), rollouts store the compact features
        # instead of raw B-beam scans — 8x less trajectory HBM at 16k envs
        self._feat_stride = getattr(self.policy, "scan_stride", None)
        self.tx = optax.adam(pcfg.lr)

    def _featurize(self, scans):
        if self._feat_stride is None:
            return scans
        return featurize_scan(scans, self._feat_stride,
                              getattr(self.policy, "compute_dtype", jnp.float32))

    def _apply(self, params, scan_or_feat, vel):
        if self._feat_stride is None:
            return self.policy.apply(params, scan_or_feat, vel)
        return self.policy.apply(params, scan_or_feat, vel, featurized=True)

    def init(self, key) -> PPOState:
        k1, k2 = jax.random.split(key)
        dummy_scan = jnp.zeros((1, self.cfg.num_beams), self.cfg.jdtype)
        dummy_vel = jnp.zeros((1,), self.cfg.jdtype)
        params = self.policy.init(k1, dummy_scan, dummy_vel)
        return PPOState(params=params, opt_state=self.tx.init(params), key=k2)

    # -- rollout collection ---------------------------------------------------
    def _policy_step(self, params, obs: Observation, key):
        ego = self.cfg.ego_idx
        feat = self._featurize(obs.scans[:, ego])
        mean, log_std, value = self._apply(params, feat,
                                           obs.linear_vels_x[:, ego])
        act = mean + jnp.exp(log_std) * jax.random.normal(key, mean.shape)
        logp = gaussian_logp(mean, log_std, act)
        return act, logp, value, feat

    def _env_actions(self, act, obs: Observation, pparams=None, map_idx=None):
        """Ego action from the policy; opponents from the opponent_plan hook
        fn(obs, map_idx) (default: cruise slow and straight; "self" =
        self-play, the current policy's mean action drives every opponent
        too).  ``map_idx`` (E,) is threaded for map-STACKED envs so hooks
        like pure_pursuit_opponents_multi can pick per-track racelines."""
        e = act.shape[0]
        a = self.cfg.num_agents
        ctrl = jnp.zeros((e, a, 2), self.cfg.jdtype)
        ctrl = ctrl.at[:, self.cfg.ego_idx, :].set(
            action_to_control(act, self.pcfg, self.cfg.jdtype))
        if a > 1:
            if self.opponent_plan == "self":
                mean, _, _ = self.policy.apply(pparams, obs.scans,
                                               obs.linear_vels_x)  # (E, A, 2)
                others = action_to_control(mean, self.pcfg, self.cfg.jdtype)
            elif self.opponent_plan is not None:
                others = (self.opponent_plan(obs, map_idx)
                          if self._opp_takes_map
                          else self.opponent_plan(obs))
                others = others.astype(self.cfg.jdtype)
            else:
                others = jnp.broadcast_to(
                    jnp.asarray([0.0, 1.5], self.cfg.jdtype), (e, a, 2))
            mask = jnp.arange(a) != self.cfg.ego_idx
            ctrl = jnp.where(mask[None, :, None], others, ctrl)
        return ctrl

    def collect(self, pstate: PPOState, env_states, obs, env_params=None):
        """Roll the sharded env batch pcfg.rollout_len steps, auto-resetting
        crashed envs; returns trajectories + final states.

        Pass ``env_params`` explicitly when jitting so map/range textures are
        traced ARGUMENTS — closing over them (the default) embeds them as HLO
        constants, which bloats executables."""
        cfg = self.cfg
        params = env_params if env_params is not None else self.env_params
        from red_gym_tpu.rollout import _params_axes

        p_axes = _params_axes(self.map_axis, params.rtex is not None)
        step_v = jax.vmap(lambda pr, s, a: step(cfg, pr, s, a),
                          in_axes=(p_axes, 0, 0))
        reset_v = jax.vmap(lambda pr, po, k: reset(cfg, pr, po, k),
                           in_axes=(p_axes, 0, 0))
        reset_vm = jax.vmap(lambda pr, po, k, m: reset(cfg, pr, po, k, map_idx=m),
                            in_axes=(p_axes, 0, 0, 0))

        def body(carry, _):
            env_states, obs, key = carry
            key, ka, kr = jax.random.split(key, 3)
            act, logp, value, feat = self._policy_step(pstate.params, obs, ka)
            env_states2, obs2, reward, done, _ = step_v(
                params, env_states,
                self._env_actions(act, obs, pstate.params,
                                  map_idx=env_states.map_idx))

            ego = cfg.ego_idx
            r = self.reward_fn(cfg, obs, obs2)

            rkeys = jax.random.split(kr, done.shape[0])
            if env_states2.map_idx is None:
                r_states, r_obs, *_ = reset_v(params, env_states2.start_pose,
                                              rkeys)
            else:
                r_states, r_obs, *_ = reset_vm(params, env_states2.start_pose,
                                               rkeys, env_states2.map_idx)
            sel = lambda a_, b_: jnp.where(
                done.reshape((-1,) + (1,) * (a_.ndim - 1)), a_, b_)
            env_states2 = jax.tree.map(sel, r_states, env_states2)
            obs2 = jax.tree.map(sel, r_obs, obs2)

            traj = (feat, obs.linear_vels_x[:, ego], act, logp,
                    value, r.astype(jnp.float32), done.astype(jnp.float32))
            return (env_states2, obs2, key), traj

        (env_states, obs, _), traj = jax.lax.scan(
            body, (env_states, obs, pstate.key), None,
            length=self.pcfg.rollout_len)
        return env_states, obs, traj

    # -- learning -------------------------------------------------------------
    def _gae(self, values, rewards, dones, last_value):
        p = self.pcfg

        def back(carry, inp):
            gae, next_v = carry
            v, r, d = inp
            delta = r + p.gamma * next_v * (1 - d) - v
            gae = delta + p.gamma * p.gae_lambda * (1 - d) * gae
            return (gae, v), gae

        (_, _), adv = jax.lax.scan(
            back, (jnp.zeros_like(last_value), last_value),
            (values, rewards, dones), reverse=True)
        return adv, adv + values

    def _loss(self, params, batch):
        feats, vels, acts, logp_old, adv, returns = batch
        p = self.pcfg
        mean, log_std, value = self._apply(params, feats, vels)
        logp = gaussian_logp(mean, log_std, acts)
        ratio = jnp.exp(logp - logp_old)
        adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
        pg = -jnp.minimum(ratio * adv_n,
                          jnp.clip(ratio, 1 - p.clip_eps, 1 + p.clip_eps) * adv_n)
        vf = 0.5 * (value - returns) ** 2
        ent = jnp.sum(log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e))
        loss = pg.mean() + p.vf_coef * vf.mean() - p.ent_coef * ent
        return loss, {"pg": pg.mean(), "vf": vf.mean(), "ratio": ratio.mean()}

    def train_step(self, pstate: PPOState, env_states, obs, env_params=None):
        """One full PPO iteration: collect sharded rollouts, GAE, minibatch
        epochs.  Designed to be wrapped in jax.jit with sharded env inputs —
        XLA inserts the cross-device reductions for the replicated params.
        Pass ``env_params`` as a jit argument (see collect)."""
        env_states, obs, traj = self.collect(pstate, env_states, obs, env_params)
        feats, vels, acts, logps, values, rewards, dones = traj

        _, _, last_value = self._apply(
            pstate.params, self._featurize(obs.scans[:, self.cfg.ego_idx]),
            obs.linear_vels_x[:, self.cfg.ego_idx])
        adv, returns = self._gae(values, rewards, dones, last_value)

        t, e = rewards.shape
        flat = lambda x: x.reshape((t * e,) + x.shape[2:])
        data = tuple(map(flat, (feats, vels, acts, logps, adv, returns)))

        key = pstate.key
        params, opt_state = pstate.params, pstate.opt_state
        n = t * e
        mb = n // self.pcfg.minibatches

        def epoch(carry, _):
            params, opt_state, key = carry
            key, kp = jax.random.split(key)
            perm = jax.random.permutation(kp, n)

            def mb_step(carry, i):
                params, opt_state = carry
                idx = jax.lax.dynamic_slice_in_dim(perm, i * mb, mb)
                batch = tuple(x[idx] for x in data)
                (loss, aux), grads = jax.value_and_grad(
                    self._loss, has_aux=True)(params, batch)
                updates, opt_state = self.tx.update(grads, opt_state)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), loss

            (params, opt_state), losses = jax.lax.scan(
                mb_step, (params, opt_state), jnp.arange(self.pcfg.minibatches))
            return (params, opt_state, key), losses.mean()

        (params, opt_state, key), losses = jax.lax.scan(
            epoch, (params, opt_state, key), None, length=self.pcfg.epochs)

        metrics = {"loss": losses.mean(), "reward_mean": rewards.mean(),
                   "done_rate": dones.mean(), "speed_mean": vels.mean()}
        return PPOState(params, opt_state, key), env_states, obs, metrics
