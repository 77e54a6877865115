"""Classic map import: berlin / skirk / vegas / stata_basement (+ levine).

The reference ships its classic ROS-style maps inside the gym package
(reference: gym/f110_gym/envs/maps/*.yaml, f110_env.py default map), but
this repo does not vendor those binaries (they are upstream f1tenth_gym
assets; levine.pgm is even stripped from the reference checkout, see its
.MISSING_LARGE_BLOBS).  This module makes parity workflows self-sufficient
without copying assets into the package:

* ``import_classic_maps(source, dest)`` converts a reference/f1tenth_gym
  checkout's maps into the normalized package layout (grayscale PNG +
  rewritten minimal yaml, waypoint CSVs when present).
* ``classic_map_path(name)`` resolves a classic map for tests/examples:
  an already-converted copy ($RED_GYM_TPU_CLASSIC_MAPS, then the user
  cache), else converts on the fly from a mounted source (the /root/
  reference checkout or $F1TENTH_GYM_SOURCE).

Fetch step for machines without a mounted checkout::

    git clone https://github.com/f1tenth/f1tenth_gym
    python -m red_gym_tpu.maps.classic --source f1tenth_gym/gym/f110_gym/envs/maps
"""

from __future__ import annotations

import argparse
import os

import numpy as np

CLASSIC_MAPS = ("berlin", "skirk", "vegas", "levine", "stata_basement")

_DEFAULT_SOURCES = (
    os.environ.get("F1TENTH_GYM_SOURCE", ""),
    "/root/reference/gym/f110_gym/envs/maps",
)


def _default_dest() -> str:
    return os.environ.get(
        "RED_GYM_TPU_CLASSIC_MAPS",
        os.path.join(os.path.expanduser("~"), ".cache", "red_gym_tpu",
                     "classic_maps"))


def import_classic_map(name: str, source_dir: str, dest_dir: str) -> str:
    """Convert one classic map to the package layout; returns the yaml path.

    The conversion re-encodes the occupancy image as 8-bit grayscale PNG
    (the reference mixes png/pgm and palette images) and rewrites the yaml
    to the minimal field set our loader consumes (resolution, origin,
    image, negate/thresholds), preserving the values the reference reads
    (laser_models.py:398-427: resolution + origin + >128 binarization).
    """
    src_yaml = os.path.join(source_dir, f"{name}.yaml")
    if not os.path.isfile(src_yaml):
        raise FileNotFoundError(src_yaml)
    import yaml                 # offline converter: PIL/yaml stay optional
    from PIL import Image
    with open(src_yaml) as f:
        meta = yaml.safe_load(f)

    img_name = meta.get("image", f"{name}.png")
    src_img = os.path.join(source_dir, img_name)
    if not os.path.isfile(src_img):
        # the reference strips some large blobs (levine.pgm) — surface a
        # clear error naming the missing binary
        raise FileNotFoundError(
            f"{src_img} (the source checkout does not carry this image; "
            f"the reference strips some, see .MISSING_LARGE_BLOBS)")

    os.makedirs(dest_dir, exist_ok=True)
    img = Image.open(src_img).convert("L")   # normalize to 8-bit grayscale
    out_png = os.path.join(dest_dir, f"{name}.png")
    img.save(out_png)

    out_yaml = os.path.join(dest_dir, f"{name}.yaml")
    with open(out_yaml, "w") as f:
        yaml.safe_dump({
            "image": f"{name}.png",
            "resolution": float(meta["resolution"]),
            "origin": [float(v) for v in meta["origin"]],
            "negate": int(meta.get("negate", 0)),
            "occupied_thresh": float(meta.get("occupied_thresh", 0.45)),
            "free_thresh": float(meta.get("free_thresh", 0.196)),
        }, f, default_flow_style=None)

    # waypoint csv rides along when the source has one
    for suffix in (".csv", "_waypoints.csv"):
        src_csv = os.path.join(source_dir, f"{name}{suffix}")
        if os.path.isfile(src_csv):
            with open(src_csv) as fin, open(
                    os.path.join(dest_dir, f"{name}{suffix}"), "w") as fout:
                fout.write(fin.read())
    return out_yaml


def import_classic_maps(source_dir: str, dest_dir: str | None = None,
                        names=CLASSIC_MAPS) -> dict:
    """Convert every available classic map; returns {name: yaml_path}.
    Maps whose binaries are missing in the source are skipped with a
    notice (levine in the reference checkout)."""
    dest_dir = dest_dir or _default_dest()
    out = {}
    for name in names:
        try:
            out[name] = import_classic_map(name, source_dir, dest_dir)
        except FileNotFoundError as exc:
            print(f"skipping {name}: {exc}")
    return out


def classic_map_path(name: str) -> str:
    """Resolve (converting if needed) the yaml path of a classic map.

    Raises FileNotFoundError when neither a converted copy nor a source
    checkout is available — callers (tests) turn that into a skip.
    """
    if name not in CLASSIC_MAPS:
        raise KeyError(f"unknown classic map {name!r}; have {CLASSIC_MAPS}")
    # the two parity-critical maps (the golden-scan gates' berlin/skirk,
    # reference unittest/scan_sim.py:322-366) ship converted IN the package
    # (tiny MIT-licensed upstream f1tenth_gym assets, see PROVENANCE.md
    # there) so the parity suite is self-sufficient on a bare machine
    packaged = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets", "data", "classic",
        f"{name}.yaml")
    if os.path.isfile(packaged):
        return packaged
    dest = _default_dest()
    ready = os.path.join(dest, f"{name}.yaml")
    if os.path.isfile(ready):
        return ready
    for source in _DEFAULT_SOURCES:
        if source and os.path.isfile(os.path.join(source, f"{name}.yaml")):
            return import_classic_map(name, source, dest)
    raise FileNotFoundError(
        f"classic map {name!r}: no converted copy under {dest} and no "
        f"source checkout found — clone f1tenth_gym and run "
        f"python -m red_gym_tpu.maps.classic --source <maps dir>")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--source", required=True,
                    help="maps dir of a f1tenth_gym/reference checkout")
    ap.add_argument("--dest", default=None,
                    help=f"output dir (default {_default_dest()})")
    args = ap.parse_args()
    done = import_classic_maps(args.source, args.dest)
    for name, path in done.items():
        print(f"{name}: {path}")


if __name__ == "__main__":
    main()
