"""Track map loading and the on-device map pytree.

The reference loads a ROS-style map (yaml metadata + grayscale image) inside
the scan simulator and keeps it as process-global mutable state shared by
every car and env (reference: gym/f110_gym/envs/laser_models.py:383-427,
base_classes.py:62-66).  Here a map is an explicit immutable `TrackMap`
pytree: the Euclidean distance transform is precomputed once on the host
(float64, identical to the reference pipeline) and device_put alongside the
env params, so each lidar ray march is just gathers from a device-resident
texture and different envs can carry different maps.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import NamedTuple, Sequence

import numpy as np
import jax.numpy as jnp

from red_gym_tpu.native import edt


class TrackMap(NamedTuple):
    """Device-resident occupancy map data.

    All fields are arrays (pytree leaves).  ``height``/``width`` are carried
    as scalars (not Python ints) so maps of identical padded shape can be
    stacked along an env axis with differing true extents.
    """

    dt: jnp.ndarray          # (H, W) distance-to-nearest-obstacle [m]
    occupancy: jnp.ndarray   # (H, W) binarized map (0 obstacle, 255 free)
    orig_x: jnp.ndarray      # map origin x [m]
    orig_y: jnp.ndarray      # map origin y [m]
    orig_c: jnp.ndarray      # cos(origin yaw)
    orig_s: jnp.ndarray      # sin(origin yaw)
    resolution: jnp.ndarray  # [m / cell]
    height: jnp.ndarray      # true rows (<= dt.shape[0])
    width: jnp.ndarray       # true cols (<= dt.shape[1])


def parse_map_yaml(text: str) -> dict:
    """The ROS map-server yaml keys the loader reads (``image``,
    ``resolution``, ``origin``, ``negate``, ``occupied_thresh``,
    ``free_thresh``) from a flat ``key: value`` document.  Values are
    numbers, a ``[x, y, yaw]`` list, or bare/quoted strings; ``#`` starts a
    comment.  Unknown keys are kept as strings."""
    meta = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        key, sep, val = line.partition(":")
        if not sep:
            raise ValueError(f"map yaml: expected 'key: value', got {line!r}")
        key, val = key.strip(), val.strip()
        if val.startswith("[") and val.endswith("]"):
            meta[key] = [float(v) for v in val[1:-1].split(",") if v.strip()]
            continue
        try:
            meta[key] = float(val)
        except ValueError:
            meta[key] = val.strip("'\"")
    for req in ("resolution", "origin"):
        if req not in meta:
            raise ValueError(f"map yaml lacks {req!r}")
    return meta


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}     # grey, RGB, RGBA (8-bit each)


def _unfilter_row(ftype: int, row: np.ndarray, prev: np.ndarray, bpp: int):
    """Undo one scanline's PNG filter (RFC 2083 sec. 6) in place."""
    if ftype == 0:
        return row
    if ftype == 1:      # Sub: running sum along each channel, mod 256
        return np.cumsum(row.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if ftype == 2:      # Up
        return row + prev
    if ftype not in (3, 4):
        raise ValueError(f"PNG: unknown filter type {ftype}")
    out = row.astype(np.int32)
    up = prev.astype(np.int32)
    for i in range(out.size):
        a = int(out[i - bpp]) if i >= bpp else 0
        b = int(up[i])
        if ftype == 3:  # Average
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = int(up[i - bpp]) if i >= bpp else 0   # Paeth
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out.astype(np.uint8)


def decode_png(path: str) -> np.ndarray:
    """Decode an 8-bit greyscale, RGB or RGBA non-interlaced PNG with zlib
    alone.  Returns (H, W) uint8 for greyscale, (H, W, C) otherwise; any
    other format (palette, 16-bit, grey+alpha, interlaced) is refused."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _comp, _filt, interlace = hdr
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, color type "
            f"{color}, interlace {interlace}); only 8-bit non-interlaced "
            f"greyscale, RGB or RGBA is decoded")
    bpp = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * bpp + 1
    if raw.size != h * stride:
        raise ValueError(f"{path}: truncated PNG image data")
    raw = raw.reshape(h, stride)
    img = np.empty((h, w * bpp), np.uint8)
    prev = np.zeros(w * bpp, np.uint8)
    for r in range(h):
        prev = img[r] = _unfilter_row(int(raw[r, 0]), raw[r, 1:], prev, bpp)
    return img.reshape(h, w) if bpp == 1 else img.reshape(h, w, bpp)


def load_map_image(image_path: str) -> np.ndarray:
    """Image -> binarized float64 occupancy grid, reference pipeline
    (laser_models.py:398-404): flip top-bottom, threshold at 128."""
    img = decode_png(image_path)[::-1].astype(np.float64)
    if img.ndim == 3:  # RGB(A) maps: reference relies on grayscale; take ch 0
        img = img[..., 0]
    img = np.where(img <= 128.0, 0.0, 255.0)
    return img


def load_map(map_yaml_path: str, map_ext: str = ".png", dtype=jnp.float32,
             pad_to: tuple[int, int] | None = None,
             edt_backend: str = "host") -> TrackMap:
    """Load yaml + image, compute the EDT, return a TrackMap.

    ``pad_to`` pads the dt/occupancy textures (with zeros = "at obstacle", so
    padded cells terminate rays immediately) to a common shape for multi-map
    batching; the true height/width scalars keep the bounds check exact.

    ``edt_backend``: "host" (default — native C++ Felzenszwalb with scipy
    fallback, exact f64) or "device" (ops/edt.py min-plus passes on the
    accelerator, exact f32 — lets procedurally generated occupancy grids
    stay on device; see tests/test_edt.py for parity).
    """
    with open(map_yaml_path) as f:
        meta = parse_map_yaml(f.read())
    resolution = float(meta["resolution"])
    origin = meta["origin"]

    image_path = os.path.splitext(map_yaml_path)[0] + map_ext
    occ = load_map_image(image_path)
    h, w = occ.shape

    if edt_backend == "device":
        from red_gym_tpu.ops import edt as edt_dev

        dt = np.asarray(edt_dev.edt(jnp.asarray(occ), resolution))
    else:
        dt = edt(occ, resolution)

    if pad_to is not None:
        ph, pw = pad_to
        if ph < h or pw < w:
            raise ValueError(f"pad_to {pad_to} smaller than map {(h, w)}")
        dt = np.pad(dt, ((0, ph - h), (0, pw - w)))
        occ = np.pad(occ, ((0, ph - h), (0, pw - w)))

    return TrackMap(
        dt=jnp.asarray(dt, dtype=dtype),
        occupancy=jnp.asarray(occ, dtype=dtype),
        orig_x=jnp.asarray(origin[0], dtype=dtype),
        orig_y=jnp.asarray(origin[1], dtype=dtype),
        orig_c=jnp.asarray(np.cos(origin[2]), dtype=dtype),
        orig_s=jnp.asarray(np.sin(origin[2]), dtype=dtype),
        resolution=jnp.asarray(resolution, dtype=dtype),
        height=jnp.asarray(h, dtype=jnp.int32),
        width=jnp.asarray(w, dtype=jnp.int32),
    )


def stack_maps(maps: Sequence[TrackMap]) -> TrackMap:
    """Stack equal-shaped TrackMaps along a leading (env-sharded) map axis."""
    return TrackMap(*[jnp.stack([getattr(m, f) for m in maps]) for f in TrackMap._fields])
