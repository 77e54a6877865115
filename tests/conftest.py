"""Test session setup.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``) on a virtual 8-device
mesh with float64 enabled, so parity checks against the (float64, CPU)
reference implementation are meaningful and multi-device sharding is
exercised without several accelerators
(``--xla_force_host_platform_device_count=8``).  Tests marked ``gpu`` need
a GPU and skip elsewhere: ``JAX_PLATFORMS=cuda python -m pytest tests -m
gpu`` runs them on one.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# persistent XLA compilation cache: the fast lane is compile-dominated
# (~100 jitted programs); repeat runs skip recompilation
from red_gym_tpu.utils import runtime  # noqa: E402

runtime.enable_compile_cache()

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise (the
    check runs here, never at import or collection)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform})")
    return dev


@pytest.fixture(scope="session")
def reference():
    """The reference gym's kernel modules, or None if unavailable.

    The reference tree is mounted read-only at /root/reference; we import its
    pure-numpy kernel modules (with a numba no-op shim) to use as golden
    oracles. Tests that need it should skip when it is absent.
    """
    from tests import _reference

    try:
        return _reference.load()
    except Exception as e:  # pragma: no cover
        pytest.skip(f"reference tree unavailable: {e}")
