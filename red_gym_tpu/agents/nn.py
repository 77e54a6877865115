"""Minimal plain-JAX neural-network modules.

A module is a frozen dataclass of hyperparameters with a ``forward(ctx,
*args)`` method written once for both uses: ``init(key, *example)`` runs it
with a context that CREATES each parameter on first use (and returns the
params pytree), ``apply(params, *args)`` runs it with a context that READS
them.  Params are a plain dict pytree ``{"params": {"Dense_0": {"kernel",
"bias"}, ...}}``; layers are auto-named per scope in call order.  Kernels
use lecun-normal initialisation and biases zeros; convolutions are NHWC.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

lecun_normal = jax.nn.initializers.lecun_normal()
zeros = jax.nn.initializers.zeros


class Ctx:
    """Parameter scope: creates (``key`` given) or reads (``params`` given)
    the parameters of one module level."""

    def __init__(self, key=None, params=None):
        self.key = key
        self.params = {} if params is None else params
        self._counts = {}

    def auto(self, prefix: str) -> str:
        """Next flax-style layer name in this scope (``Dense_0``, ...)."""
        n = self._counts.get(prefix, 0)
        self._counts[prefix] = n + 1
        return f"{prefix}_{n}"

    def child(self, name: str) -> "Ctx":
        if self.key is None:
            return Ctx(params=self.params[name])
        self.key, sub = jax.random.split(self.key)
        c = Ctx(key=sub)
        self.params[name] = c.params
        return c

    def param(self, name, shape, init, dtype=jnp.float32):
        if self.key is None:
            return self.params[name]
        self.key, sub = jax.random.split(self.key)
        self.params[name] = init(sub, shape, dtype)
        return self.params[name]


@dataclasses.dataclass(frozen=True)
class Module:
    """Base class: subclasses define ``forward(self, ctx, *args, **kw)``."""

    def init(self, key, *args, **kw):
        ctx = Ctx(key=key)
        self.forward(ctx, *args, **kw)
        return {"params": ctx.params}

    def apply(self, params, *args, **kw):
        return self.forward(Ctx(params=params["params"]), *args, **kw)

    def forward(self, ctx: Ctx, *args, **kw):
        raise NotImplementedError


def dense(ctx: Ctx, x, features: int, dtype=jnp.float32):
    """y = x @ kernel + bias, computed in ``dtype`` (params stay f32)."""
    c = ctx.child(ctx.auto("Dense"))
    k = c.param("kernel", (x.shape[-1], features), lecun_normal)
    b = c.param("bias", (features,), zeros)
    return jnp.dot(x.astype(dtype), k.astype(dtype)) + b.astype(dtype)


def conv(ctx: Ctx, x, features: int, kernel, strides, dtype=jnp.float32):
    """VALID-padded NHWC convolution with bias."""
    c = ctx.child(ctx.auto("Conv"))
    k = c.param("kernel", (*kernel, x.shape[-1], features), lecun_normal)
    b = c.param("bias", (features,), zeros)
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), k.astype(dtype), window_strides=strides,
        padding="VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y + b.astype(dtype)


def submodule(ctx: Ctx, module: Module, *args, **kw):
    """Run ``module`` in its own auto-named child scope."""
    return module.forward(ctx.child(ctx.auto(type(module).__name__)),
                          *args, **kw)
