"""The port's headless viewer and PNG codec against the JAX reference's
viewer (viorb_tpu/viz) and against PIL and matplotlib:
  * `FrameDrawer.draw` equals the reference's bit for bit: uint8 and f32
    frames, tracked / untracked / invalid keypoints (some off the image),
    no keypoints, and every state's strip and border;
  * a PNG written by io/png.py (8-bit gray, RGB, 16-bit gray; each of the
    five filter types on every row, and the adaptive per-row choice) reads
    back equal through PIL and through matplotlib (v / 255, v / 65535), and
    through io/png.py; an interlaced or a palette PNG, or a row of filter
    type 5, raises naming the file;
  * `MapDrawer` and `Viewer` on a stub SLAM object write the files the
    reference's viewer writes (the same names), each a PNG that io/png.py
    decodes to the expected shape: the overlays (H + 12, W, 3), the map
    panels (450, 990, 3) with the points', path's and camera's colors
    drawn and the title in a tEXt chunk; the map is drawn under the SLAM
    object's map lock;
  * `eval.plot_init.load_series` equals the reference's on the same series
    files, None for a missing one.

One test per file: see tests/test_torch_fast.py."""

import os
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Optional

import matplotlib.image as mpimg
import numpy as np
import pytest
from PIL import Image

from viorb_tpu.eval import plot_init as ref_plot_init
from viorb_tpu.viz import FrameDrawer as RefFrameDrawer
from viorb_tpu.viz import Viewer as RefViewer
from viorb_tpu_torch.eval import plot_init
from viorb_tpu_torch.io.png import read_png, read_text, write_png
from viorb_tpu_torch.mapping.map import KeyFrameData, MapStore
from viorb_tpu_torch.viz import FrameDrawer, MapDrawer, Viewer
from viorb_tpu_torch.viz.drawers import _CAMERA, _PATH, _POINT


def _frame_drawer_equal():
    rng = np.random.default_rng(0)
    port, ref = FrameDrawer(), RefFrameDrawer()
    img8 = rng.integers(0, 256, (96, 128)).astype(np.uint8)
    img32 = rng.uniform(-20, 280, (96, 128)).astype(np.float32)
    xy = np.concatenate([rng.uniform(-5, 133, (40, 2)), [[0, 0], [127, 95], [1, 1], [126, 94]]]).astype(np.float32)
    matched = rng.random(len(xy)) < 0.5
    valid = rng.random(len(xy)) < 0.8
    cases = [(img8, xy, matched, valid, "OK", 42), (img32, xy, None, None, "LOST", 0),
             (img8, xy, matched, None, "IMU_ONLY", 400), (img32, None, None, None, "NOT_INITIALIZED", 7),
             (img8, xy[:0], matched[:0], valid[:0], "OK", 0)]
    for image, *rest, state, n in cases:
        got = port.draw(image, *rest, state, n, 3, 10)
        want = ref.draw(image, *rest, state, n, 3, 10)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=state)


def _png_round_trips(tmp_path):
    rng = np.random.default_rng(1)
    for name, arr, scale in (("gray", rng.integers(0, 256, (37, 53)).astype(np.uint8), 255.0),
                             ("rgb", rng.integers(0, 256, (37, 53, 3)).astype(np.uint8), 255.0),
                             ("16-bit", rng.integers(0, 65536, (37, 53)).astype(np.uint16), 65535.0)):
        for filter_type in (0, 1, 2, 3, 4, "adaptive"):
            path = str(tmp_path / f"{name}-{filter_type}.png")
            write_png(path, arr, filter_type=filter_type)
            what = f"{name}, filter {filter_type}"
            np.testing.assert_array_equal(np.asarray(Image.open(path)).astype(arr.dtype), arr, err_msg=what)
            np.testing.assert_array_equal(np.round(mpimg.imread(path) * scale).astype(arr.dtype), arr, err_msg=what)
            got = read_png(path)
            assert got.dtype == arr.dtype
            np.testing.assert_array_equal(got, arr, err_msg=what)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.uint8), filter_type=5)

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))

    bad = tmp_path / "interlaced.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 1))
                    + chunk(b"IDAT", zlib.compress(bytes(20))) + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="interlaced.png"):
        read_png(str(bad))
    bad = tmp_path / "filter5.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 2, 8, 0, 0, 0, 0))
                    + chunk(b"IDAT", zlib.compress(bytes(5) + b"\x05" + bytes(4))) + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="filter5.png: PNG row 1 has filter type 5"):
        read_png(str(bad))
    Image.fromarray(rng.integers(0, 256, (8, 8)).astype(np.uint8)).convert("P").save(tmp_path / "palette.png")
    with pytest.raises(ValueError, match="palette.png"):
        read_png(str(tmp_path / "palette.png"))


def _tiny_map():
    """tests/test_viz.py's map, in the port's MapStore."""
    m = MapStore(max_points=64)
    rng = np.random.default_rng(0)
    for i in range(3):
        m.add_keyframe(KeyFrameData(
            kf_id=-1, timestamp=0.1 * i, r_cw=np.eye(3, dtype=np.float32),
            t_cw=np.array([0.1 * i, 0, 0], np.float32), xy=rng.uniform(0, 100, (8, 2)).astype(np.float32),
            level=np.zeros(8, np.int32), angle=np.zeros(8, np.float32), desc01=np.zeros((8, 256), np.uint8),
            valid=np.ones(8, bool), point_idx=np.full(8, -1, np.int32)))
    for _ in range(10):
        m.add_point(rng.uniform(-2, 2, 3).astype(np.float32), np.zeros(256, np.uint8), kf_id=0, feat_idx=0)
    return m


@dataclass
class _Frame:
    xy: np.ndarray
    valid: np.ndarray
    point_idx: Optional[np.ndarray]
    r_cw: np.ndarray
    t_cw: np.ndarray


class _Slam:
    """What the viewer reads of a SLAM object, with a map lock that records
    whether it was held."""

    def __init__(self):
        self.map = _tiny_map()
        rng = np.random.default_rng(1)
        self.last_frame = _Frame(
            xy=rng.uniform(5, 90, (20, 2)).astype(np.float32), valid=np.ones(20, bool),
            point_idx=np.where(np.arange(20) % 2 == 0, 1, -1).astype(np.int32),
            r_cw=np.eye(3, dtype=np.float32), t_cw=np.zeros(3, np.float32))
        self.map_lock = threading.RLock()


def _viewer_writes_pngs(tmp_path):
    img = np.full((96, 128), 100, np.uint8)
    dirs = {}
    for name, viewer_cls in (("port", Viewer), ("ref", RefViewer)):
        d = tmp_path / name
        viewer = viewer_cls(str(d), every=2, map_every=4)
        slam = _Slam()
        for i in range(6):
            viewer.on_frame(slam, img, {"state": "OK", "n_tracked": 10, "ts": 0.1 * i})
        viewer.finalize(slam)
        dirs[name] = d
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["ref"])) and names == [
        "frame_00000.png", "frame_00002.png", "frame_00004.png", "map_00000.png", "map_00004.png", "map_final.png"]
    for name in names:
        got = read_png(str(dirs["port"] / name))
        if name.startswith("frame_"):
            assert got.shape == (96 + 12, 128, 3)
            np.testing.assert_array_equal(got, np.asarray(Image.open(dirs["ref"] / name)))
        else:
            assert got.shape == (MapDrawer.height, MapDrawer.width, 3)
            for color in (_POINT, _PATH, _CAMERA):
                assert (got == color).all(-1).sum() >= 2, (name, color)
    assert read_text(str(dirs["port"] / "map_final.png")) == {"Title": "final map"}
    assert read_text(str(dirs["port"] / "map_00004.png"))["Title"] == "t=0.40s  state=OK"

    # the map is drawn under the SLAM object's lock
    slam, held = _Slam(), []
    draw = MapDrawer.draw

    def spy(self, *a, **kw):
        held.append(slam.map_lock._is_owned())
        return draw(self, *a, **kw)

    MapDrawer.draw = spy
    try:
        Viewer(str(tmp_path / "locked")).finalize(slam)
    finally:
        MapDrawer.draw = draw
    assert held == [True]


def _series_equal(tmp_path):
    rng = np.random.default_rng(2)
    np.savetxt(tmp_path / "scale.txt", np.column_stack([np.arange(5.0), rng.normal(size=5)]))
    np.savetxt(tmp_path / "gw.txt", np.column_stack([np.arange(5.0), rng.normal(size=(5, 3))]))
    (tmp_path / "condnum.txt").write_text("0.5 12.0\n\n1.0 3e4\n")
    for name in ("scale.txt", "gw.txt", "condnum.txt", "biasa.txt"):
        got, want = plot_init.load_series(str(tmp_path), name), ref_plot_init.load_series(str(tmp_path), name)
        assert (got is None) == (want is None) and (got is None) == (name == "biasa.txt")
        if got is not None:
            np.testing.assert_array_equal(got, want)


def test_viz_matches_reference(tmp_path):
    _frame_drawer_equal()
    _png_round_trips(tmp_path)
    _viewer_writes_pngs(tmp_path)
    _series_equal(tmp_path)
