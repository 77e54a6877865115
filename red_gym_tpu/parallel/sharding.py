"""Device-mesh sharding of batched envs and learners.

The reference's only distribution story was one process per env over ZMQ to a
C++ sim (retired; reference: gym/f110_gym/envs/f110_env_backup.py:33-62).
Here envs are rows of sharded arrays.  A 1-D ``env`` mesh axis shards
every leading env axis of `EnvState`/`Observation`; the policy / learner
parameters are replicated; XLA inserts the collectives (psum for gradient
sync, over NVLink between the GPUs of a host).  The same code runs on one
GPU, on several, on 8 virtual CPU devices, or across hosts after
`jax.distributed.initialize`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from red_gym_tpu.env import EnvParams
from red_gym_tpu.maps.loader import TrackMap


def make_env_mesh(n_devices: Optional[int] = None, axis: str = "env") -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.array(devs), (axis,))


def shard_envs(mesh: Mesh, tree, axis: str = "env"):
    """Shard every leaf of a batched env pytree along its leading env axis."""
    sharding = NamedSharding(mesh, P(axis))

    def put(x):
        if x.ndim == 0:
            return jax.device_put(x, NamedSharding(mesh, P()))
        return jax.device_put(x, sharding)

    return jax.tree.map(put, tree)


def replicate(mesh: Mesh, tree):
    return jax.device_put(tree, NamedSharding(mesh, P()))


def shard_params(mesh: Mesh, params: EnvParams, map_axis: Optional[int] = None,
                 axis: str = "env") -> EnvParams:
    """Replicate vehicle/tables; shard per-env maps along the mesh if the
    TrackMap carries an env axis."""
    vehicle = replicate(mesh, params.vehicle)
    tables = replicate(mesh, params.tables)
    rtex = None if params.rtex is None else replicate(mesh, params.rtex)
    pool = None if params.noise_pool is None \
        else replicate(mesh, params.noise_pool)
    if map_axis is None:
        tmap = replicate(mesh, params.tmap)
    else:
        tmap = TrackMap(*[jax.device_put(getattr(params.tmap, f),
                                         NamedSharding(mesh, P(axis)))
                          for f in TrackMap._fields])
    return EnvParams(vehicle=vehicle, tables=tables, tmap=tmap, rtex=rtex,
                     noise_pool=pool)
