"""Policy deployment: AOT-serialized StableHLO inference artifacts.

The reference's deployment story ends at
``torch.save(actor.state_dict(), "sac_actor.pth")`` (reference
src/SAL.py:1017) — loading that file requires the exact Python model class,
matching framework versions, and a pickle-compatible environment on the
robot.  Here the policy FUNCTION itself is exported:
trained weights are baked into a jit-compiled program as constants and the
whole program is serialized as *versioned StableHLO* via ``jax.export``, so
the artifact

- loads and runs with NO model code (no module class, no pickle),
- is lowered ahead-of-time for every platform named at export (cpu + cuda
  by default: the same file serves the on-car CPU and a GPU eval farm),
- carries a symbolic batch dimension, so one artifact drives a single car
  or a vmapped fleet without re-export,
- is protected by StableHLO's forward-compatibility guarantees rather than
  Python-pickle fragility.

Typical flow::

    fn = deterministic_ppo_control(policy, pcfg, state.params)   # weights baked
    save_policy("racer.stablehlo", fn, (scan[None], vel[None]))
    ...on the robot / server...
    racer = load_policy("racer.stablehlo")
    controls = racer.call(scans, vels)          # any batch size
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import export as _jexport


def deterministic_ppo_control(policy, pcfg, params):
    """Greedy inference head for a trained ScanPolicy: (scan, vel) ->
    (steer, speed) controls — the mean action squashed exactly as training
    squashed it (agents/ppo.py::action_to_control), weights closed over."""
    from red_gym_tpu.agents import ppo as _ppo

    def fn(scan, vel):
        mean, _, _ = policy.apply(params, scan, vel)
        return _ppo.action_to_control(mean, pcfg, jnp.float32)

    return fn


def deterministic_sac_action(actor, params):
    """Greedy inference head for a trained SAC actor: obs -> tanh(mean)
    in [-1, 1]^A (the evaluation-time action of the tanh-Gaussian policy,
    reference src/SAL.py:414-421 with the noise dropped)."""

    def fn(obs):
        mean, _ = actor.apply(params, obs)
        return jnp.tanh(mean)

    return fn


def export_policy(fn, example_args, *, platforms=("cpu", "cuda"),
                  batch: str | None = "b"):
    """Lower ``fn`` (weights already closed over) to a multi-platform
    StableHLO Exported.

    ``example_args`` fixes every trailing dimension and dtype; with
    ``batch`` set, each argument's LEADING dimension is replaced by one
    shared symbolic size so the artifact accepts any batch.  Scalars-per-
    item (e.g. vel ``(N,)``) therefore stay rank-1 in the example.
    """
    args = tuple(jax.tree.map(jnp.asarray, a) for a in example_args)
    if batch:
        scope = _jexport.SymbolicScope()
        (bdim,) = _jexport.symbolic_shape(batch, scope=scope)
        spec = lambda a: jax.ShapeDtypeStruct((bdim,) + a.shape[1:], a.dtype)
    else:
        spec = lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype)
    specs = jax.tree.map(spec, args)
    return _jexport.export(jax.jit(fn), platforms=list(platforms))(*specs)


def save_policy(path, fn, example_args, **kwargs):
    """Export ``fn`` and write the serialized artifact to ``path``.
    Returns the in-memory Exported (``.call`` runs it immediately)."""
    exp = export_policy(fn, example_args, **kwargs)
    data = exp.serialize()
    with open(path, "wb") as f:
        f.write(data)
    return exp


def load_policy(path):
    """Deserialize a saved artifact.  ``.call(*args)`` executes it on the
    current default platform (must be one it was exported for);
    ``.in_avals`` / ``.platforms`` describe the expected inputs."""
    with open(path, "rb") as f:
        return _jexport.deserialize(f.read())
