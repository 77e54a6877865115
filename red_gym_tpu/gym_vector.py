"""Gymnasium ``VectorEnv`` adapter over the on-device env batch.

The reference's "massively parallel applications" story is one process per
env (reference docs/index.rst:12); here the batch lives on one chip as a
single jitted program (:class:`red_gym_tpu.vec_env.VecF110Env`), and this
module exposes it through the standard ``gymnasium.vector.VectorEnv``
interface so vector-API tooling (CleanRL-style loops, vector wrappers)
drives thousands of on-device cars unchanged:

    import gymnasium
    import red_gym_tpu                        # registers f110-v0
    envs = gymnasium.make_vec("f110-v0", num_envs=1024,
                              map="...", map_ext=".png")
    obs, info = envs.reset()
    obs, rew, term, trunc, info = envs.step(actions)   # (E, A, 2) numpy

Autoreset follows the SAME_STEP convention: a terminated env returns its
fresh reset observation in the same step, with the terminal observation in
``info["final_obs"]`` (stacked arrays) masked by ``info["_final_obs"]``.

Like every stateful wrapper here, the numpy boundary syncs device->host per
step (docs/performance.md "wrapper perf trap"); throughput training should
use :mod:`red_gym_tpu.rollout` or :class:`~red_gym_tpu.vec_env.VecF110Env`
directly, which keep observations on device.
"""

from __future__ import annotations

import numpy as np

import gymnasium
from gymnasium.vector import AutoresetMode, VectorEnv
from gymnasium.vector.utils import batch_space

from red_gym_tpu.env import staggered_start_poses
from red_gym_tpu.gym_adapter import action_space_box, single_obs_space
from red_gym_tpu.vec_env import VecF110Env


class F110VectorEnv(VectorEnv):
    """``gymnasium.vector.VectorEnv`` facade over :class:`VecF110Env`.

    Constructor kwargs are :class:`VecF110Env`'s (map/map_ext/num_agents/
    timestep/params/multi-map ``map`` lists/``randomize_starts``/every
    SimConfig field).  ``reset`` takes start poses via
    ``options={"poses": ...}`` ((A, 3) broadcast to all envs, or (E, A, 3));
    without them agents spawn on consecutive ranks of the (first) map's
    raceline (``env.staggered_start_poses``).
    """

    metadata = {"autoreset_mode": AutoresetMode.SAME_STEP}

    def __init__(self, num_envs: int, **kwargs):
        self.render_mode = None
        self.num_envs = int(num_envs)
        self.vec = VecF110Env(num_envs=self.num_envs,
                              return_final_obs=True, **kwargs)
        first = kwargs.get("map")
        first = first[0] if isinstance(first, (list, tuple)) else first
        self._map_yaml = (first if not first or first.endswith(".yaml")
                          else f"{first}.yaml")
        cfg = self.vec.cfg
        self.single_action_space = action_space_box(self.vec.params.vehicle,
                                                    cfg.num_agents)
        self.single_observation_space = single_obs_space(cfg.num_agents,
                                                         cfg.num_beams)
        self.action_space = batch_space(self.single_action_space,
                                        self.num_envs)
        self.observation_space = batch_space(self.single_observation_space,
                                             self.num_envs)

    @staticmethod
    def _np_obs(obs: dict) -> dict:
        return {k: np.asarray(v, np.float32) for k, v in obs.items()
                if k != "ego_idx"}

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            import jax
            self.vec._key = jax.random.PRNGKey(seed)
        poses = None if options is None else options.get("poses")
        if poses is None:
            from red_gym_tpu.assets import waypoints_csv_for

            poses = staggered_start_poses(self.vec.cfg.num_agents,
                                          waypoints_csv_for(self._map_yaml))
        obs, _reward, _done, _info = self.vec.reset(np.asarray(poses))
        return self._np_obs(obs), {}

    def step(self, actions):
        obs, reward, done, info = self.vec.step(np.asarray(actions))
        term = np.asarray(done, bool)
        infos = {"checkpoint_done": np.asarray(info["checkpoint_done"])}
        if "final_obs" in info:
            # same-step autoreset: terminal observations as stacked arrays
            # + the standard presence mask
            infos["final_obs"] = self._np_obs(info["final_obs"])
            infos["_final_obs"] = term.copy()
        return (self._np_obs(obs), np.asarray(reward, np.float32), term,
                np.zeros_like(term), infos)

    def render(self):
        return None

    def close_extras(self, **kwargs):
        pass
