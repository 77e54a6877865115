"""Map loading with the standard library alone: the zlib PNG decoder and
the ROS map-yaml parser against PIL / PyYAML on every packaged map, and the
default map's raceline start poses."""

import glob
import os
import struct
import zlib

import numpy as np
import pytest

from red_gym_tpu import assets
from red_gym_tpu.maps.loader import decode_png, load_map, parse_map_yaml

DATA = os.path.join(os.path.dirname(assets.__file__), "data")
PNGS = sorted(glob.glob(os.path.join(DATA, "**", "*.png"), recursive=True))
YAMLS = sorted(glob.glob(os.path.join(DATA, "**", "*.yaml"), recursive=True))


def test_every_packaged_map_is_covered():
    assert len(PNGS) == 13 and len(YAMLS) == 13


@pytest.mark.parametrize("path", PNGS, ids=os.path.basename)
def test_png_decoder_matches_pil(path):
    Image = pytest.importorskip("PIL.Image")
    np.testing.assert_array_equal(decode_png(path),
                                  np.asarray(Image.open(path)))


def _png_bytes(img: np.ndarray, color: int, filters, depth=8, interlace=0):
    """Encode ``img`` (H, W*C uint8) with the given per-row filter types."""
    h, row_bytes = img.shape
    bpp = {0: 1, 2: 3, 6: 4}.get(color, 1)
    raw = bytearray()
    prev = np.zeros(row_bytes, np.int32)
    for r in range(h):
        x = img[r].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        f = filters[r % len(filters)]
        if f == 0:
            pred = np.zeros_like(x)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        raw.append(f)
        raw += ((x - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = x

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    width = row_bytes // bpp
    ihdr = struct.pack(">IIBBBBB", width, h, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("color,channels", [(0, 1), (2, 3), (6, 4)])
def test_png_decoder_all_filter_types(tmp_path, color, channels):
    """Every scanline filter (None, Sub, Up, Average, Paeth) round-trips,
    for greyscale, RGB and RGBA."""
    rng = np.random.default_rng(color)
    img = rng.integers(0, 256, (10, 7 * channels)).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_bytes(img, color, filters=[0, 1, 2, 3, 4]))
    out = decode_png(str(path))
    want = img if channels == 1 else img.reshape(10, 7, channels)
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("depth,color,interlace", [
    (16, 0, 0),     # 16-bit
    (8, 3, 0),      # palette
    (8, 4, 0),      # grey + alpha
    (8, 0, 1),      # Adam7 interlaced
])
def test_png_decoder_refuses_other_formats(tmp_path, depth, color,
                                           interlace):
    path = tmp_path / "x.png"
    img = np.zeros((2, 4), np.uint8)
    path.write_bytes(_png_bytes(img, color, [0], depth, interlace))
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png(str(path))


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_map_yaml_parser_matches_pyyaml(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        text = f.read()
    want = yaml.safe_load(text)
    got = parse_map_yaml(text)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, list):
            np.testing.assert_allclose(got[k], v)
        elif isinstance(v, (int, float)):
            assert got[k] == float(v)
        else:
            assert got[k] == v


def test_map_yaml_parser_syntax():
    meta = parse_map_yaml(
        "# a ROS map\n"
        "image: 'my map.png'   # quoted\n"
        "resolution: 0.05\n"
        "origin: [-1.5, 2, 0.0]\n"
        "negate: 0\n\n")
    assert meta == {"image": "my map.png", "resolution": 0.05,
                    "origin": [-1.5, 2.0, 0.0], "negate": 0.0}
    with pytest.raises(ValueError, match="lacks 'origin'"):
        parse_map_yaml("resolution: 0.05\n")
    with pytest.raises(ValueError, match="key: value"):
        parse_map_yaml("resolution 0.05\norigin: [0, 0, 0]\n")


def test_default_map_is_packaged():
    for p in (assets.example_map_yaml(), assets.example_waypoints_csv()):
        assert os.path.isfile(p) and p.startswith(DATA)
    assert os.path.basename(assets.example_map_yaml()) == "track_0007.yaml"
    assert assets.waypoints_csv_for(os.path.join(DATA, "track_wide.yaml")) \
        .endswith("track_wide_waypoints.csv")
    assert assets.waypoints_csv_for(None) == assets.example_waypoints_csv()


def test_start_poses_lie_on_free_track():
    """Raceline starts (every agent rank, envs spread around the lap) sit
    clear of the walls, headed along the raceline."""
    import jax.numpy as jnp

    from red_gym_tpu.env import staggered_start_poses

    tmap = load_map(assets.example_map_yaml(), ".png", dtype=jnp.float64)
    poses = assets.raceline_poses(64, 4).reshape(-1, 3)
    res = float(tmap.resolution)
    c = ((poses[:, 0] - float(tmap.orig_x)) / res).astype(int)
    r = ((poses[:, 1] - float(tmap.orig_y)) / res).astype(int)
    assert (np.asarray(tmap.dt)[r, c] > 0.3).all()
    np.testing.assert_allclose(staggered_start_poses(2),
                               assets.raceline_poses(1, 2)[0])
    d = np.diff(staggered_start_poses(2)[:, :2], axis=0)[0]
    assert 1.0 < np.hypot(*d) < 3.0     # one rank apart
