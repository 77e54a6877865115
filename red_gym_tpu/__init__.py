"""red_gym_tpu — an F1TENTH racing environment + RL stack in JAX.

A from-scratch re-design of WE-Autopilot/red_gym (the F1TENTH gym fork plus
the club's SAC/MPC training stack) where the entire simulator is a pure,
jit-compiled function over pytrees: vehicle dynamics, lidar raycasting,
collision checks, lap logic and resets all vmapped over thousands of parallel
envs on one GPU and sharded across several with jax collectives.
"""

__version__ = "0.1.0"

from red_gym_tpu.config import Integrator, SimConfig, VehicleParams  # noqa: F401


def make(map, **kwargs):
    """Single stateful env with the reference gym API (see env.F110Env)."""
    from red_gym_tpu import env as _env

    return _env.make(map, **kwargs)


def make_vec(map, num_envs, **kwargs):
    """Batched stateful env (see vec_env.VecF110Env)."""
    from red_gym_tpu.vec_env import VecF110Env

    return VecF110Env(map, num_envs, **kwargs)


# register 'f110-v0' with gymnasium when it is installed (the reference
# registers 'f110_gym:f110-v0' on import, gym/f110_gym/__init__.py:1-5);
# reference scripts on classic gym use red_gym_tpu.gym_compat instead.
# _registration imports only gymnasium — the adapter (and jax) load at
# first make(), and a genuine ImportError inside the adapter surfaces
# there instead of being swallowed here.
try:
    from red_gym_tpu import _registration as _reg

    _reg.register()
except ImportError:  # gymnasium not installed — adapter is optional
    pass
