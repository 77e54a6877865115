"""Asset resolution for maps and racelines.

The framework ships procedurally generated tracks (see
red_gym_tpu/maps/trackgen.py) under ``red_gym_tpu/assets/data/``, each a
ROS map (yaml + png) with a ``<name>_waypoints.csv`` raceline.  The default
map everywhere a track is implied is the packaged ``track_0007``; nothing
here reaches outside the checkout except ``named_map_yaml``, which falls
back to a mounted reference checkout for parity demos.
"""

from __future__ import annotations

import os

import numpy as np

_PKG_DATA = os.path.join(os.path.dirname(__file__), "data")
_REFERENCE_MAPS = "/root/reference/gym/f110_gym/envs/maps"

DEFAULT_TRACK = "track_0007"


def _resolve(candidates):
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(f"none of {candidates} exist; generate assets with "
                            "`python -m red_gym_tpu.maps.trackgen`")


def example_map_yaml() -> str:
    """The default map: the packaged ``track_0007``."""
    return os.path.join(_PKG_DATA, f"{DEFAULT_TRACK}.yaml")


def example_waypoints_csv() -> str:
    """Raceline of the default map."""
    return os.path.join(_PKG_DATA, f"{DEFAULT_TRACK}_waypoints.csv")


def waypoints_csv_for(map_yaml: str | None) -> str:
    """The ``<stem>_waypoints.csv`` beside a map yaml, or the default map's
    raceline when that map ships none."""
    if map_yaml:
        csv = os.path.splitext(map_yaml)[0] + "_waypoints.csv"
        if os.path.exists(csv):
            return csv
    return example_waypoints_csv()


def raceline_poses(n_envs: int, num_agents: int,
                   waypoints_csv: str | None = None,
                   spacing: int = 8) -> np.ndarray:
    """(E, A, 3) starts spread evenly around a lap: env e's grid begins at
    raceline position e/E of the lap (linearly interpolated between
    waypoints) and its agents follow ``spacing`` waypoints apart (about
    1.8 m on the packaged tracks), heading along the raceline.  Defaults
    to the default map's raceline."""
    w = np.loadtxt(waypoints_csv or example_waypoints_csv(), delimiter=";",
                   comments="#")
    n = len(w)
    u = (np.arange(n_envs)[:, None] * (n / n_envs)
         + np.arange(num_agents)[None, :] * spacing) % n      # (E, A)
    i0 = np.floor(u).astype(int)
    i1 = (i0 + 1) % n
    f = u - i0
    x = w[i0, 1] + f * (w[i1, 1] - w[i0, 1])
    y = w[i0, 2] + f * (w[i1, 2] - w[i0, 2])
    th = np.arctan2(w[i1, 2] - w[i0, 2], w[i1, 1] - w[i0, 1])
    return np.stack([x, y, th], axis=-1)


def named_map_yaml(name: str) -> str:
    return _resolve([os.path.join(_PKG_DATA, f"{name}.yaml"),
                     os.path.join(_REFERENCE_MAPS, f"{name}.yaml")])
