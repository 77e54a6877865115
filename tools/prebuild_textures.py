"""Prebuild (and disk-cache) the range textures bench.py needs.

The fast-scan texture is a one-time per-map precompute memoized to
$RED_GYM_TPU_TEXTURE_CACHE (default ~/.cache/red_gym_tpu).  The default
build marches ~13 rays per edge theta-bin pair (edge localization + width
probes + base row); on the CPU a large map takes minutes — run this once
per machine (or CI cache restore) and later launches start instantly.

Usage:
    python tools/prebuild_textures.py [map.yaml ...]   # default: track_0007
    JAX_PLATFORMS=cpu python tools/prebuild_textures.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))



def main():
    import dataclasses

    import jax.numpy as jnp

    from red_gym_tpu.config import SimConfig
    from red_gym_tpu.maps.loader import load_map
    from red_gym_tpu.ops import scan_fast
    from red_gym_tpu.assets import example_map_yaml

    maps = sys.argv[1:] or [example_map_yaml()]
    base = SimConfig(num_agents=2, num_beams=1080, dtype="float32",
                     scan_mode="fast")
    cfgs = {
        "default (nearest1/linear/edge+grad)": base,
        "ultra (spectral/grad)": dataclasses.replace(base,
                                                     scan_interp="spectral"),
    }
    for y in maps:
        tmap = load_map(y, ".png", dtype=jnp.float32)
        for name, cfg in cfgs.items():
            t0 = time.time()
            rtex = scan_fast.build_range_texture(tmap, cfg)
            print(f"{os.path.basename(y)} [{name}]: rt {rtex.rt.shape} "
                  f"{rtex.rt.dtype} in {time.time() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
