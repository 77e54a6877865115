"""Soft Actor-Critic over lidar bitmaps, in plain JAX + optax.

Re-design of the reference training stack (reference: src/SAL.py:390-580):
same CNN actor (3 conv -> fc -> tanh-squashed diagonal Gaussian), twin CNN
critics, soft target updates — but the replay buffer lives on device as a
fixed-size ring of arrays, and the entire update step is one jitted program,
so training runs with zero host<->device traffic per step.  The conv trunks
run in bfloat16 with float32 parameters.

Hyperparameters match SAL.py:478-497: gamma 0.99, tau 0.005, alpha 0.2,
lr 3e-4 for actor and critics, batch 64, log_std clamped to [-20, 2].
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from red_gym_tpu.agents import nn


relu = jax.nn.relu


@dataclasses.dataclass(frozen=True)
class ConvTrunk(nn.Module):
    """The SAL CNN feature stack (SAL.py:397-400): 8x8/4, 4x4/2, 3x3/1."""

    compute_dtype: Any = jnp.bfloat16

    def forward(self, ctx, x):
        # x: (B, H, W) uint8 or float -> (B, H, W, 1) in [0, 1]
        cd = self.compute_dtype
        x = x.astype(cd) / 255.0
        x = x[..., None]
        x = relu(nn.conv(ctx, x, 16, (8, 8), (4, 4), cd))
        x = relu(nn.conv(ctx, x, 32, (4, 4), (2, 2), cd))
        x = relu(nn.conv(ctx, x, 32, (3, 3), (1, 1), cd))
        return x.reshape((x.shape[0], -1))


@dataclasses.dataclass(frozen=True)
class Actor(nn.Module):
    """Tanh-squashed Gaussian policy (SAL.py:390-421)."""

    action_dim: int = 32
    compute_dtype: Any = jnp.bfloat16

    def forward(self, ctx, x):
        h = nn.submodule(ctx, ConvTrunk(self.compute_dtype), x)
        h = relu(nn.dense(ctx, h, 512, self.compute_dtype))
        h = h.astype(jnp.float32)
        mean = nn.dense(ctx, h, self.action_dim)
        log_std = nn.dense(ctx, h, self.action_dim)
        return mean, jnp.clip(log_std, -20.0, 2.0)


def sample_action(actor_params, actor: Actor, obs, key):
    """rsample + tanh squash with the log-prob correction (SAL.py:414-421)."""
    mean, log_std = actor.apply(actor_params, obs)
    std = jnp.exp(log_std)
    eps = jax.random.normal(key, mean.shape, mean.dtype)
    x_t = mean + std * eps
    y_t = jnp.tanh(x_t)
    normal_logp = (-0.5 * ((x_t - mean) / std) ** 2 - log_std
                   - 0.5 * jnp.log(2 * jnp.pi))
    log_prob = jnp.sum(normal_logp - jnp.log(1 - y_t**2 + 1e-6),
                       axis=-1, keepdims=True)
    return y_t, log_prob


@dataclasses.dataclass(frozen=True)
class Critic(nn.Module):
    """Q(s, a) with the shared trunk shape (SAL.py:423-442)."""

    compute_dtype: Any = jnp.bfloat16

    def forward(self, ctx, x, action):
        h = nn.submodule(ctx, ConvTrunk(self.compute_dtype), x)
        h = jnp.concatenate([h.astype(jnp.float32), action], axis=-1)
        h = relu(nn.dense(ctx, h, 512, self.compute_dtype))
        return nn.dense(ctx, h.astype(jnp.float32), 1)


class ReplayBuffer(NamedTuple):
    """On-device ring buffer (functional replacement for the host deque at
    SAL.py:447-463).  Obs dtype follows what ``create`` was given (uint8 for
    bitmaps, float for scans)."""

    obs: jnp.ndarray        # (C, *obs_shape)
    action: jnp.ndarray     # (C, A)
    reward: jnp.ndarray     # (C,)
    next_obs: jnp.ndarray   # (C, *obs_shape)
    done: jnp.ndarray       # (C,)
    ptr: jnp.ndarray        # scalar int32
    size: jnp.ndarray       # scalar int32

    @classmethod
    def create(cls, capacity: int, obs_shape, action_dim: int,
               obs_dtype=jnp.uint8):
        return cls(
            obs=jnp.zeros((capacity, *obs_shape), obs_dtype),
            action=jnp.zeros((capacity, action_dim), jnp.float32),
            reward=jnp.zeros((capacity,), jnp.float32),
            next_obs=jnp.zeros((capacity, *obs_shape), obs_dtype),
            done=jnp.zeros((capacity,), jnp.float32),
            ptr=jnp.zeros((), jnp.int32),
            size=jnp.zeros((), jnp.int32),
        )

    def push(self, obs, action, reward, next_obs, done):
        c = self.obs.shape[0]
        i = self.ptr
        return self._replace(
            obs=self.obs.at[i].set(obs.astype(self.obs.dtype)),
            action=self.action.at[i].set(action.astype(self.action.dtype)),
            reward=self.reward.at[i].set(reward),
            next_obs=self.next_obs.at[i].set(next_obs.astype(self.obs.dtype)),
            done=self.done.at[i].set(done.astype(jnp.float32)),
            ptr=(i + 1) % c,
            size=jnp.minimum(self.size + 1, c),
        )

    def push_batch(self, obs, action, reward, next_obs, done):
        """Insert a whole env-batch of transitions at once (ring wraparound
        by scatter at (ptr + arange(B)) % C)."""
        c = self.obs.shape[0]
        b = obs.shape[0]
        idx = (self.ptr + jnp.arange(b)) % c
        return self._replace(
            obs=self.obs.at[idx].set(obs.astype(self.obs.dtype)),
            action=self.action.at[idx].set(action.astype(self.action.dtype)),
            reward=self.reward.at[idx].set(reward.astype(jnp.float32)),
            next_obs=self.next_obs.at[idx].set(next_obs.astype(self.obs.dtype)),
            done=self.done.at[idx].set(done.astype(jnp.float32)),
            ptr=(self.ptr + b) % c,
            size=jnp.minimum(self.size + b, c),
        )

    def sample(self, key, batch_size: int):
        idx = jax.random.randint(key, (batch_size,), 0, jnp.maximum(self.size, 1))
        return (self.obs[idx], self.action[idx], self.reward[idx],
                self.next_obs[idx], self.done[idx])


@dataclasses.dataclass(frozen=True)
class ScanTrunk(nn.Module):
    """MLP features over strided log-compressed lidar ranges — the
    bandwidth-light observation for SAC at scale (the bitmap CNN stays for
    SAL-parity training)."""

    hidden: int = 256
    stride: int = 8
    compute_dtype: Any = jnp.float32

    def forward(self, ctx, scan):
        cd = self.compute_dtype
        x = jnp.log1p(scan[..., :: self.stride].astype(cd))
        x = relu(nn.dense(ctx, x, self.hidden, cd))
        return relu(nn.dense(ctx, x, self.hidden, cd))


@dataclasses.dataclass(frozen=True)
class ScanActor(nn.Module):
    """Tanh-squashed Gaussian policy over raw scans (drop-in for Actor)."""

    action_dim: int = 2
    hidden: int = 256
    stride: int = 8
    compute_dtype: Any = jnp.float32

    def forward(self, ctx, scan):
        h = nn.submodule(
            ctx, ScanTrunk(self.hidden, self.stride, self.compute_dtype), scan)
        h = h.astype(jnp.float32)
        mean = nn.dense(ctx, h, self.action_dim)
        log_std = nn.dense(ctx, h, self.action_dim)
        return mean, jnp.clip(log_std, -20.0, 2.0)


@dataclasses.dataclass(frozen=True)
class ScanCritic(nn.Module):
    """Q(scan, a) (drop-in for Critic)."""

    hidden: int = 256
    stride: int = 8
    compute_dtype: Any = jnp.float32

    def forward(self, ctx, scan, action):
        h = nn.submodule(
            ctx, ScanTrunk(self.hidden, self.stride, self.compute_dtype), scan)
        h = jnp.concatenate([h.astype(jnp.float32), action], axis=-1)
        h = relu(nn.dense(ctx, h, self.hidden, self.compute_dtype))
        return nn.dense(ctx, h.astype(jnp.float32), 1)


class SACState(NamedTuple):
    actor_params: Any
    critic1_params: Any
    critic2_params: Any
    target1_params: Any
    target2_params: Any
    actor_opt: Any
    critic1_opt: Any
    critic2_opt: Any


class SAC:
    """Functional SAC trainer with the SAL.py hyperparameters."""

    def __init__(self, obs_shape=(256, 256), action_dim: int = 32,
                 gamma: float = 0.99, tau: float = 0.005, alpha: float = 0.2,
                 actor_lr: float = 3e-4, critic_lr: float = 3e-4,
                 compute_dtype=jnp.bfloat16, actor: nn.Module | None = None,
                 critic: nn.Module | None = None, obs_dtype=jnp.uint8,
                 grad_clip: float | None = None):
        """``grad_clip``: optional global-norm gradient clip.  The reference
        runs plain Adam (SAL.py:495-497) — None preserves that; scaled
        many-env training benefits from clipping (the 64-env bitmap run
        diverged to NaN without it)."""
        self.actor = actor if actor is not None else Actor(action_dim, compute_dtype)
        self.critic = critic if critic is not None else Critic(compute_dtype)
        self.gamma, self.tau, self.alpha = gamma, tau, alpha

        def tx(lr):
            if grad_clip is None:
                return optax.adam(lr)
            return optax.chain(optax.clip_by_global_norm(grad_clip),
                               optax.adam(lr))

        self.actor_tx = tx(actor_lr)
        self.critic_tx = tx(critic_lr)
        self.obs_shape = obs_shape
        self.action_dim = action_dim
        self.obs_dtype = obs_dtype

    def init(self, key) -> SACState:
        k1, k2, k3 = jax.random.split(key, 3)
        dummy_obs = jnp.zeros((1, *self.obs_shape), self.obs_dtype)
        dummy_act = jnp.zeros((1, self.action_dim), jnp.float32)
        ap = self.actor.init(k1, dummy_obs)
        c1 = self.critic.init(k2, dummy_obs, dummy_act)
        c2 = self.critic.init(k3, dummy_obs, dummy_act)
        return SACState(
            actor_params=ap, critic1_params=c1, critic2_params=c2,
            target1_params=c1, target2_params=c2,
            actor_opt=self.actor_tx.init(ap),
            critic1_opt=self.critic_tx.init(c1),
            critic2_opt=self.critic_tx.init(c2),
        )

    def select_action(self, state: SACState, obs, key, evaluate: bool = False):
        obs = obs[None] if obs.ndim == len(self.obs_shape) else obs
        if evaluate:
            mean, _ = self.actor.apply(state.actor_params, obs)
            return jnp.tanh(mean)
        act, _ = sample_action(state.actor_params, self.actor, obs, key)
        return act

    @partial(jax.jit, static_argnums=0)
    def update(self, state: SACState, batch, key):
        """One SAC update (SAL.py:521-580): twin-critic TD, actor, soft
        target polyak."""
        obs, action, reward, next_obs, done = batch
        k_next, k_new = jax.random.split(key)

        next_a, next_logp = sample_action(state.actor_params, self.actor,
                                          next_obs, k_next)
        tq1 = self.critic.apply(state.target1_params, next_obs, next_a)
        tq2 = self.critic.apply(state.target2_params, next_obs, next_a)
        tq = jnp.minimum(tq1, tq2) - self.alpha * next_logp
        tv = reward[:, None] + (1 - done[:, None]) * self.gamma * tq
        tv = jax.lax.stop_gradient(tv)

        def critic_loss(p):
            q = self.critic.apply(p, obs, action)
            return jnp.mean((q - tv) ** 2)

        c1_loss, g1 = jax.value_and_grad(critic_loss)(state.critic1_params)
        c2_loss, g2 = jax.value_and_grad(critic_loss)(state.critic2_params)
        u1, c1_opt = self.critic_tx.update(g1, state.critic1_opt)
        u2, c2_opt = self.critic_tx.update(g2, state.critic2_opt)
        c1p = optax.apply_updates(state.critic1_params, u1)
        c2p = optax.apply_updates(state.critic2_params, u2)

        def actor_loss(p):
            new_a, logp = sample_action(p, self.actor, obs, k_new)
            q1 = self.critic.apply(c1p, obs, new_a)
            q2 = self.critic.apply(c2p, obs, new_a)
            return jnp.mean(self.alpha * logp - jnp.minimum(q1, q2))

        a_loss, ga = jax.value_and_grad(actor_loss)(state.actor_params)
        ua, a_opt = self.actor_tx.update(ga, state.actor_opt)
        ap = optax.apply_updates(state.actor_params, ua)

        polyak = lambda t, p: jax.tree.map(
            lambda a, b: self.tau * b + (1 - self.tau) * a, t, p)

        new_state = SACState(
            actor_params=ap, critic1_params=c1p, critic2_params=c2p,
            target1_params=polyak(state.target1_params, c1p),
            target2_params=polyak(state.target2_params, c2p),
            actor_opt=a_opt, critic1_opt=c1_opt, critic2_opt=c2_opt,
        )
        return new_state, {"actor_loss": a_loss, "critic1_loss": c1_loss,
                           "critic2_loss": c2_loss}
