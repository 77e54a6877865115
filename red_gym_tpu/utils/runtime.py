"""Process set-up shared by the entry points (bench.py, chip_smoke.py,
examples, the test suite): the persistent compile cache and the GPU checks
a measurement needs.

Compile cache: ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
itself and nothing else is configured), otherwise ``.jax_cache/`` at the
checkout root — a fixed path, since the path is part of what the cache
keys on.
"""

from __future__ import annotations

import os
import subprocess

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


def card() -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` reports it
    (first line), e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``.  Runs
    nvidia-smi as a child process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def require_gpu():
    """The first JAX device, which must be a GPU: a measurement never falls
    back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform!r} "
                         f"({dev.device_kind}); this measures the GPU only")
    return dev


def device_record(n: int | None = None) -> dict:
    """{"platform", "kind", "count"} as JAX reports the devices in use."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs) if n is None else n}
