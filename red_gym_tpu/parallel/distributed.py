"""Multi-host (multi-process) execution: jax.distributed wiring + helpers.

The reference's only distribution story was one OS process per env over ZMQ
to a C++ simulator (retired; reference: gym/f110_gym/envs/
f110_env_backup.py:33-62).  Here (BASELINE config 5): every process owns
the accelerators physically attached to it, `jax.distributed` assembles
them into one global device set, envs shard along a global 1-D ``env``
mesh (host-local rows live on host-local devices, so the rollout loop
touches only local data), and the learner's gradient psum is the single
cross-host collective.

The same code paths run on several GPU hosts and on N CPU processes with
virtual devices
(tests/test_distributed.py launches 2 processes x 4 virtual devices and
checks the training step matches the single-process result exactly).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import jax

from red_gym_tpu.parallel.sharding import make_env_mesh  # re-export mesh builder


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[list[int]] = None) -> None:
    """Join the global JAX process group.

    Pass the coordinator explicitly (nothing on a plain GPU host tells JAX
    of a cluster) or set the standard environment variables::

        JAX_COORDINATOR_ADDRESS   host:port of process 0
        JAX_NUM_PROCESSES         total process count
        JAX_PROCESS_ID            this process's rank

    Idempotent: calling again after successful initialization is a no-op.
    Must run before any computation touches a backend (device queries
    included).
    """
    try:                                   # public API where available
        already = jax.distributed.is_initialized()
    except AttributeError:                 # older jax: private fallback
        already = jax._src.distributed.global_state.client is not None
    if already:
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def is_distributed() -> bool:
    return jax.process_count() > 1


def process_env_slice(n_global_envs: int) -> slice:
    """The half-open env-index range this process materializes locally.

    Envs shard along the global ``env`` mesh axis in device order; with the
    mesh built from `jax.devices()` (sorted so each process's devices are
    contiguous), process p owns rows [p*E/P, (p+1)*E/P).
    """
    p = jax.process_count()
    if n_global_envs % p:
        raise ValueError(f"{n_global_envs} envs not divisible by "
                         f"{p} processes")
    per = n_global_envs // p
    r = jax.process_index()
    return slice(r * per, (r + 1) * per)


def global_env_array(mesh, local_np, axis: str = "env"):
    """Assemble a GLOBAL env-sharded array from this process's local rows.

    ``local_np``: this process's shard (env axis first), shaped
    (E/P, ...).  Every process calls this with its own rows; the result is
    one logical (E, ...) array sharded over the global mesh that jitted
    code consumes like any other input.  Scalars (ndim 0) are replicated.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    local_np = np.asarray(local_np)
    if local_np.ndim == 0:
        return jax.device_put(local_np, NamedSharding(mesh, P()))
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(axis)), local_np)


def global_env_tree(mesh, local_tree, axis: str = "env"):
    """`global_env_array` over every leaf of a host-local env pytree."""
    return jax.tree.map(lambda x: global_env_array(mesh, x, axis), local_tree)
