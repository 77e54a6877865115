"""Profiling and on-device metrics.

The reference's observability is ad-hoc time.time() prints (reference:
laser_models.py:543-549, SAL.py:1011).  Here: a jax.profiler trace context,
a wall-clock step timer that forces execution (a tiny device->host
transfer, so the timer waits for the device), and
an on-device metrics accumulator pytree for host-callback-free logging.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context: view with tensorboard/xprof."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def force(tree: Any) -> None:
    """Force execution of a pytree's computations (tiny host transfer)."""
    leaves = [x for x in jax.tree.leaves(tree) if hasattr(x, "dtype")]
    if leaves:
        float(jnp.sum(leaves[0].astype(jnp.float32)))


class StepTimer:
    """Wall-clock rate meter for jitted step functions."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.time()
        self._count = 0

    def tick(self, n: int = 1):
        self._count += n

    def rate(self, out: Any = None) -> float:
        if out is not None:
            force(out)
        dt = time.time() - self._t0
        return self._count / dt if dt > 0 else float("inf")


class Metrics:
    """Functional on-device metric accumulators: sums + counts."""

    @staticmethod
    def init(names, dtype=jnp.float32) -> Dict[str, jnp.ndarray]:
        d = {n: jnp.zeros((), dtype) for n in names}
        d["_count"] = jnp.zeros((), dtype)
        return d

    @staticmethod
    def update(acc, **values):
        out = dict(acc)
        for k, v in values.items():
            # cast to the accumulator dtype: a weak-f64 value must not
            # change the carry structure mid-lax.scan
            out[k] = acc[k] + jnp.asarray(v, acc[k].dtype)
        out["_count"] = acc["_count"] + 1.0
        return out

    @staticmethod
    def means(acc) -> Dict[str, float]:
        n = max(float(acc["_count"]), 1.0)
        return {k: float(v) / n for k, v in acc.items() if k != "_count"}
