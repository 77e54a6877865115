"""Population-based vehicle/controller parameter search (CMA-ES).

The reference's experiment config reserves bounds for [mass, lf, tlad,
vgain] and a CMA optimizer with popsize/budget (reference:
examples/config_example_map.yaml:24-43, optim_method 'CMA') — the search
script itself ran out-of-tree, one sequential rollout per candidate.  The
design here evaluates the ENTIRE population in one jitted batched
rollout: candidates are rows of a vmapped env batch, each carrying its own
`VehicleParams` leaves and pure-pursuit (tlad, vgain), so a 100-candidate
generation costs one device dispatch.  CMA-ES itself is a few-KB host-side
numpy update (dimension ~4) — the right split of work between host and
device.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from red_gym_tpu.config import SimConfig, VehicleParams
from red_gym_tpu import env as envlib
from red_gym_tpu.agents import pure_pursuit as pp


class CMAES:
    """Minimal (mu/mu_w, lambda) CMA-ES with box constraints by clipping.

    Standard rank-one + rank-mu covariance adaptation and cumulative
    step-size control; host-side numpy (the search dimension is tiny, the
    expensive part — fitness — runs on device via the batched evaluator).
    """

    def __init__(self, x0, sigma0: float, popsize: int, seed: int = 0,
                 bounds=None):
        self.n = len(x0)
        self.m = np.asarray(x0, dtype=np.float64).copy()
        self.sigma = float(sigma0)
        self.lam = int(popsize)
        self.rng = np.random.default_rng(seed)
        self.bounds = None if bounds is None else np.asarray(bounds, np.float64)

        n, lam = self.n, self.lam
        self.mu = lam // 2
        w = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.w = w / w.sum()
        self.mu_eff = 1.0 / np.sum(self.w ** 2)

        self.c_sigma = (self.mu_eff + 2) / (n + self.mu_eff + 5)
        self.d_sigma = (1 + 2 * max(0.0, np.sqrt((self.mu_eff - 1) / (n + 1)) - 1)
                        + self.c_sigma)
        self.cc = (4 + self.mu_eff / n) / (n + 4 + 2 * self.mu_eff / n)
        self.c1 = 2 / ((n + 1.3) ** 2 + self.mu_eff)
        self.cmu = min(1 - self.c1,
                       2 * (self.mu_eff - 2 + 1 / self.mu_eff)
                       / ((n + 2) ** 2 + self.mu_eff))
        self.chi_n = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))

        self.pc = np.zeros(n)
        self.ps = np.zeros(n)
        self.C = np.eye(n)
        self.gen = 0
        self.best_x = self.m.copy()
        self.best_f = np.inf
        self._z = None

    def ask(self) -> np.ndarray:
        """Sample a (popsize, n) candidate matrix."""
        vals, vecs = np.linalg.eigh(self.C)
        vals = np.maximum(vals, 1e-20)
        self._bd = vecs * np.sqrt(vals)                  # B @ diag(D)
        self._inv_sqrt = (vecs / np.sqrt(vals)) @ vecs.T  # C^{-1/2}
        self._z = self.rng.standard_normal((self.lam, self.n))
        x = self.m + self.sigma * self._z @ self._bd.T
        if self.bounds is not None:
            x = np.clip(x, self.bounds[:, 0], self.bounds[:, 1])
        return x

    def tell(self, xs: np.ndarray, fs: np.ndarray) -> None:
        order = np.argsort(fs)
        if fs[order[0]] < self.best_f:
            self.best_f = float(fs[order[0]])
            self.best_x = xs[order[0]].copy()

        xs_sel = xs[order[: self.mu]]
        m_old = self.m
        self.m = self.w @ xs_sel
        y = (self.m - m_old) / self.sigma

        self.ps = ((1 - self.c_sigma) * self.ps
                   + np.sqrt(self.c_sigma * (2 - self.c_sigma) * self.mu_eff)
                   * (self._inv_sqrt @ y))
        self.gen += 1
        denom = np.sqrt(1 - (1 - self.c_sigma) ** (2 * self.gen))
        h_sigma = (np.linalg.norm(self.ps) / denom
                   < (1.4 + 2 / (self.n + 1)) * self.chi_n)
        self.pc = ((1 - self.cc) * self.pc
                   + h_sigma * np.sqrt(self.cc * (2 - self.cc) * self.mu_eff) * y)

        ys = (xs_sel - m_old) / self.sigma
        rank_mu = (self.w[:, None, None] * (ys[:, :, None] * ys[:, None, :])).sum(0)
        self.C = ((1 - self.c1 - self.cmu) * self.C
                  + self.c1 * (np.outer(self.pc, self.pc)
                               + (1 - h_sigma) * self.cc * (2 - self.cc) * self.C)
                  + self.cmu * rank_mu)
        self.C = (self.C + self.C.T) / 2
        self.sigma *= np.exp((self.c_sigma / self.d_sigma)
                             * (np.linalg.norm(self.ps) / self.chi_n - 1))


# field order of a candidate vector (reference config's varied params)
SEARCH_FIELDS = ("m", "lf", "tlad", "vgain")
DEFAULT_BOUNDS = {  # reference config_example_map.yaml:24-35
    "m": (3.0, 4.0),
    "lf": (0.147, 0.170),
    "tlad": (0.2, 5.0),
    "vgain": (0.5, 1.5),
}


def make_laptime_evaluator(cfg: SimConfig, map_yaml: str, waypoints,
                           steps: int, start_pose,
                           fields: Sequence[str] = SEARCH_FIELDS,
                           map_ext: str = ".png") -> Callable:
    """Build a jitted fitness fn: (popsize, n_fields) -> lap fitness (P,).

    Every candidate drives the raceline with pure pursuit on its own env row
    (own VehicleParams / tlad / vgain); fitness is the two-lap time, with
    budget + collision penalties for candidates that crash or time out —
    one device dispatch per CMA generation.
    """
    params0 = envlib.make_params(cfg, map_yaml, map_ext)
    dt = cfg.jdtype
    budget_time = steps * cfg.timestep
    start = jnp.asarray(start_pose, dt).reshape(1, 3)

    veh_fields = [f for f in fields if f in VehicleParams._fields]
    pp_fields = [f for f in fields if f in ("tlad", "vgain")]
    assert set(veh_fields) | set(pp_fields) == set(fields)

    def evaluate(pop: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        p_n = pop[fields[0]].shape[0]
        vehicle = VehicleParams(*[
            jnp.broadcast_to(jnp.asarray(pop.get(f, getattr(params0.vehicle, f)),
                                         dt), (p_n,))
            for f in VehicleParams._fields])
        env_params = params0._replace(vehicle=vehicle)
        ppp = pp.make_params(waypoints)
        ppp = ppp._replace(
            tlad=jnp.broadcast_to(jnp.asarray(pop.get("tlad", ppp.tlad), dt), (p_n,)),
            vgain=jnp.broadcast_to(jnp.asarray(pop.get("vgain", ppp.vgain), dt), (p_n,)),
            wheelbase=jnp.broadcast_to(
                vehicle.lf + vehicle.lr, (p_n,)).astype(dt))

        veh_ax = VehicleParams(*([0] * len(VehicleParams._fields)))
        par_ax = envlib.EnvParams(vehicle=veh_ax, tables=None, tmap=None,
                                  rtex=None)
        ppp_ax = ppp.__class__(waypoints=None, tlad=0, vgain=0, wheelbase=0,
                               max_reacquire=None)

        poses = jnp.broadcast_to(start, (p_n, 1, 3))
        keys = jax.random.split(jax.random.PRNGKey(0), p_n)
        reset_v = jax.vmap(lambda pr, po, k: envlib.reset(cfg, pr, po, k),
                           in_axes=(par_ax, 0, 0))
        step_v = jax.vmap(lambda pr, s, a: envlib.step(cfg, pr, s, a),
                          in_axes=(par_ax, 0, 0))
        plan_v = jax.vmap(pp.plan, in_axes=(0, 0, 0, ppp_ax))

        def body(carry, _):
            state, obs, crashed = carry
            speed, steer = plan_v(obs.poses_x[:, 0], obs.poses_y[:, 0],
                                  obs.poses_theta[:, 0], ppp)
            act = jnp.stack([steer, speed], axis=-1)[:, None, :]
            state, obs, _, done, _ = step_v(env_params, state, act)
            crashed = crashed | (obs.collisions[:, 0] > 0)
            return (state, obs, crashed), None

        state, obs, *_ = reset_v(env_params, poses, keys)
        crashed0 = obs.collisions[:, 0] > 0

        @jax.jit
        def run(state, obs, crashed):
            (state, obs, crashed), _ = jax.lax.scan(
                body, (state, obs, crashed), None, length=steps)
            return state, crashed

        state, crashed = run(state, obs, crashed0)
        finished = state.toggle_list[:, 0] >= cfg.laps_to_finish_toggles
        lap_time = state.lap_times[:, 0]
        # crashed: budget + stiff penalty; unfinished: budget + distance-to-go
        fitness = jnp.where(
            finished & ~crashed, lap_time,
            budget_time + jnp.where(crashed, 100.0,
                                    10.0 * (cfg.laps_to_finish_toggles
                                            - state.toggle_list[:, 0])))
        return fitness

    return evaluate


def search(cfg: SimConfig, map_yaml: str, waypoints, start_pose,
           popsize: int = 20, generations: int = 10, steps: int = 4500,
           seed: int = 12345, fields: Sequence[str] = SEARCH_FIELDS,
           bounds: Dict[str, tuple] | None = None, log=print):
    """Run the CMA lap-time search; returns (best_params_dict, best_fitness)."""
    bounds = {**DEFAULT_BOUNDS, **(bounds or {})}
    bmat = np.asarray([bounds[f] for f in fields])
    x0 = bmat.mean(axis=1)
    sigma0 = 0.3 * float(np.mean(bmat[:, 1] - bmat[:, 0]))
    es = CMAES(x0, sigma0, popsize, seed=seed, bounds=bmat)
    evaluate = make_laptime_evaluator(cfg, map_yaml, waypoints, steps,
                                      start_pose, fields=fields)
    for g in range(generations):
        xs = es.ask()
        pop = {f: jnp.asarray(xs[:, i]) for i, f in enumerate(fields)}
        fs = np.asarray(evaluate(pop))
        es.tell(xs, fs)
        if log:
            log(f"gen {g}: best {fs.min():.3f}s  mean {fs.mean():.3f}s  "
                f"sigma {es.sigma:.4f}")
    return dict(zip(fields, es.best_x)), es.best_f
