"""The GPU entry points off the GPU: bench modes, the compile-cache
location, and chip_smoke.py refusing to report without a GPU."""

import os
import stat
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def test_bench_modes_are_valid_configs():
    import bench

    for mode in bench.MODE_LABELS:
        cfg = bench.make_cfg(mode)
        assert cfg.scan_mode == "fast" and cfg.num_beams == 1080
    d = bench.make_cfg("default")
    assert (d.rt_spatial, d.scan_interp, d.rt_occlusion, d.rt_grad) == \
        ("nearest1", "linear", "edge", True)


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_location(tmp_path, env_dir):
    """$JAX_COMPILATION_CACHE_DIR wins; otherwise .jax_cache/ at the
    checkout root."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import jax\n"
            "from red_gym_tpu.utils import runtime\n"
            "print(runtime.enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    path, configured = out.stdout.split()
    want = (str(tmp_path / env_dir) if env_dir
            else os.path.join(REPO, ".jax_cache"))
    assert path == want and configured == want


def test_chip_smoke_fails_without_gpu(tmp_path):
    """With a card reported but JAX on the CPU, chip_smoke exits non-zero
    and prints no result line."""
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'Fake GPU, 1.00 W'\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PATH=f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr
