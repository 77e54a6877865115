"""Procedural race-track generator (host-side tooling).

Counterpart of the reference's CarRacing-derived generator (reference:
gym/f110_gym/unittest/random_trackgen.py:56-234), re-implemented without
shapely: random radial checkpoints -> periodic smoothing -> resampled
centerline -> wall polygons rasterized with numpy -> ROS-style map
yaml + png + centerline/raceline CSV (the waypoint schema of
examples/config_example_map.yaml: columns [s; x; y; theta; kappa; v; a]).

Usage:
    python -m red_gym_tpu.maps.trackgen --seed 123 --n 3 --outdir <dir>
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _periodic_smooth(xy: np.ndarray, harmonics: int = 8) -> np.ndarray:
    """Low-pass the closed checkpoint loop with a truncated Fourier series."""
    n = xy.shape[0]
    fx = np.fft.rfft(xy[:, 0])
    fy = np.fft.rfft(xy[:, 1])
    fx[harmonics + 1:] = 0
    fy[harmonics + 1:] = 0
    return np.stack([np.fft.irfft(fx, n), np.fft.irfft(fy, n)], axis=1)


def generate_centerline(seed: int, n_checkpoints: int = 14,
                        radius: float = 18.0, rad_jitter: float = 0.32,
                        n_points: int = 600) -> np.ndarray:
    """Closed smooth centerline (n_points, 2), roughly `radius`-sized."""
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n_checkpoints))
    rad = radius * (1 + rng.uniform(-rad_jitter, rad_jitter, n_checkpoints))
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)
    pts = np.repeat(pts, max(1, n_points // n_checkpoints), axis=0)
    smooth = _periodic_smooth(pts, harmonics=max(4, n_checkpoints // 2))

    # arc-length resample to uniform spacing
    d = np.linalg.norm(np.diff(smooth, axis=0, append=smooth[:1]), axis=1)
    s = np.concatenate([[0], np.cumsum(d)])[:-1]
    s_new = np.linspace(0, s[-1] + d[-1], n_points, endpoint=False)
    x = np.interp(s_new, np.concatenate([s, [s[-1] + d[-1]]]),
                  np.concatenate([smooth[:, 0], smooth[:1, 0]]))
    y = np.interp(s_new, np.concatenate([s, [s[-1] + d[-1]]]),
                  np.concatenate([smooth[:, 1], smooth[:1, 1]]))
    return np.stack([x, y], axis=1)


def _normals(center: np.ndarray) -> np.ndarray:
    t = np.roll(center, -1, axis=0) - np.roll(center, 1, axis=0)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    return np.stack([-t[:, 1], t[:, 0]], axis=1)


def rasterize_track(center: np.ndarray, half_width: float = 2.6,
                    resolution: float = 0.0625, margin: float = 5.0):
    """Occupancy image (255 = drivable corridor) + origin, reference map
    conventions (white free space, row 0 at the map bottom).  The corridor
    is the centerline drawn as a closed thick polyline (cv2), i.e. every
    pixel within half_width of the centerline."""
    import cv2

    lo = center.min(axis=0) - (half_width + margin)
    hi = center.max(axis=0) + (half_width + margin)
    w = int(np.ceil((hi[0] - lo[0]) / resolution))
    h = int(np.ceil((hi[1] - lo[1]) / resolution))

    img = np.zeros((h, w), np.uint8)
    pts = np.rint((center - lo) / resolution).astype(np.int32)
    thickness = max(1, int(round(2 * half_width / resolution)))
    cv2.polylines(img, [pts.reshape(-1, 1, 2)], isClosed=True, color=255,
                  thickness=thickness, lineType=cv2.LINE_8)
    origin = (float(lo[0]), float(lo[1]), 0.0)
    return img, origin


def speed_profile(center: np.ndarray, v_max: float = 7.0, v_min: float = 2.5,
                  a_lat: float = 6.0) -> np.ndarray:
    """Curvature-limited target speeds along the centerline."""
    d1 = (np.roll(center, -1, axis=0) - np.roll(center, 1, axis=0)) / 2.0
    d2 = np.roll(center, -1, axis=0) - 2 * center + np.roll(center, 1, axis=0)
    cross = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    denom = np.maximum(np.linalg.norm(d1, axis=1) ** 3, 1e-9)
    kappa = np.abs(cross) / denom
    v = np.sqrt(a_lat / np.maximum(kappa, 1e-6))
    # smooth the profile a little so it is trackable
    for _ in range(10):
        v = np.minimum(v, 0.5 * (np.roll(v, 1) + np.roll(v, -1)) + 0.3)
    return np.clip(v, v_min, v_max)


def save_track(outdir: str, name: str, center: np.ndarray, img: np.ndarray,
               origin, resolution: float = 0.0625):
    os.makedirs(outdir, exist_ok=True)
    from PIL import Image       # offline tool: PIL stays optional

    Image.fromarray(np.flipud(img)).save(os.path.join(outdir, f"{name}.png"))
    with open(os.path.join(outdir, f"{name}.yaml"), "w") as f:
        f.write(f"image: {name}.png\n"
                f"resolution: {resolution:.6f}\n"
                f"origin: [{origin[0]:.8f},{origin[1]:.8f}, 0.000000]\n"
                "negate: 0\noccupied_thresh: 0.45\nfree_thresh: 0.196\n")

    # raceline CSV in the reference waypoint schema (s; x; y; theta; kappa; v; a)
    d = np.linalg.norm(np.diff(center, axis=0, prepend=center[:1]), axis=1)
    s = np.cumsum(d)
    theta = np.arctan2(*np.flip((np.roll(center, -1, axis=0) - center).T, 0))
    v = speed_profile(center)
    rows = np.stack([s, center[:, 0], center[:, 1], theta,
                     np.zeros_like(s), v, np.zeros_like(s)], axis=1)
    hdr = "# s_m; x_m; y_m; psi_rad; kappa_radpm; vx_mps; ax_mps2\n# \n# generated by red_gym_tpu.maps.trackgen\n"
    with open(os.path.join(outdir, f"{name}_waypoints.csv"), "w") as f:
        f.write(hdr)
        for row in rows:
            f.write(";".join(f"{x:.7f}" for x in row) + "\n")
    return os.path.join(outdir, f"{name}.yaml")


def generate(outdir: str, seed: int = 0, name: str | None = None,
             half_width: float = 2.6, **kw) -> str:
    center = generate_centerline(seed, **{k: v for k, v in kw.items()
                                          if k in ("n_checkpoints", "radius",
                                                   "rad_jitter", "n_points")})
    img, origin = rasterize_track(center, half_width=half_width)
    return save_track(outdir, name or f"track_{seed:04d}", center, img, origin)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1)
    ap.add_argument("--outdir", type=str,
                    default=os.path.join(os.path.dirname(__file__), "..",
                                         "assets", "data"))
    ap.add_argument("--half-width", type=float, default=2.6,
                    help="track corridor half width [m]")
    ap.add_argument("--checkpoints", type=int, default=14,
                    help="number of layout checkpoints (more = twistier)")
    ap.add_argument("--name", type=str, default=None)
    args = ap.parse_args()
    for i in range(args.n):
        path = generate(args.outdir, seed=args.seed + i, name=args.name,
                        half_width=args.half_width,
                        n_checkpoints=args.checkpoints)
        print("wrote", path)


if __name__ == "__main__":
    main()
