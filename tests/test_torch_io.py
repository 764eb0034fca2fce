"""The port's settings parser, dataset loaders and trajectory writers
(viorb_tpu_torch/io/{config,datasets,trajectory}.py) against the JAX
reference's (viorb_tpu/io), on the same files:
  * `parse_opencv_yaml` and `SlamConfig.from_yaml` of both packages on an
    inline copy of the reference's EuRoC settings fields (Camera.Tbc's
    multi-line opencv-matrix block included): the same keys and values,
    `r_bc` within 1e-6 (each package re-orthonormalizes in f32 through its
    own quaternion round trip); `depth_map_factor` None in the port where
    the file has no DepthMapFactor (the reference's 1.0), equal where it
    has one;
  * every loader of both packages on a `tmp_path` dump of each layout (TUM
    mono and RGB-D, EuRoC mono, stereo, IMU and ground truth, KITTI mono
    and stereo): timestamps and paths equal, images within 1e-4 absolute
    on 0..255 and depth within 1e-4 relative. The reference reads PNG
    through matplotlib, which hands back v / 255 (or v / 65535) in f32 and
    multiplies back; the port reads the integers exactly. The dump holds
    PGM 8- and 16-bit files and PNG 8-bit gray, RGB, RGBA and 16-bit files
    written by both io/png.py and PIL, and a PNG whose rows use each of
    the five filter types;
  * the TUM RGB-D depth factor: the port's runner reads depth with TUM's
    5000 when the settings give no DepthMapFactor and when there is no
    --config (the reference's runner then divides by 1.0, ROADMAP
    "Deliberate differences"), and with the file's factor otherwise;
  * the four trajectory writers of both packages on the same stub SLAM
    state: the same lines, the same number of digits in every field, the
    values within 1e-6.

One test per file: see tests/test_torch_fast.py."""

import os
import re
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch
from PIL import Image

from viorb_tpu.io import config as ref_config
from viorb_tpu.io import datasets as ref_datasets
from viorb_tpu.io import trajectory as ref_trajectory
from viorb_tpu_torch import run
from viorb_tpu_torch.io import config, datasets, trajectory
from viorb_tpu_torch.io.png import write_png
from viorb_tpu_torch.slam.rgbd import RgbdSlam

torch.set_num_threads(1)

# the fields of the reference's Examples/ROS/ORB_VIO/launch/euroc.yaml
EUROC_YAML = """%YAML:1.0

# Camera calibration and distortion parameters (OpenCV)
Camera.fx: 458.654
Camera.fy: 457.296
Camera.cx: 367.215
Camera.cy: 248.375

Camera.k1: -0.28340811
Camera.k2: 0.07395907
Camera.p1: 0.00019359
Camera.p2: 1.76187114e-05

Camera.width: 752
Camera.height: 480

# Camera frames per second
Camera.fps: 20.0

# Color order of the images (0: BGR, 1: RGB)
Camera.RGB: 1

# Transformation from camera to body-frame (imu)
Camera.Tbc: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

# Local Window size
LocalMapping.LocalWindowSize: 10

test.InitVIOTmpPath: "/tmp/"
test.DiscardTime: 0
test.VINSInitTime: 15.0
IMU.multiplyG: 0
Camera.delaytoimu: 0

ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

Viewer.KeyFrameSize: 0.05
Viewer.ViewpointF: 500
"""
IMG_TOL = 1e-4  # absolute, on 0..255
DEPTH_TOL = 1e-4  # relative


def _config_agrees(tmp_path):
    path = tmp_path / "euroc.yaml"
    path.write_text(EUROC_YAML)
    got, want = config.parse_opencv_yaml(str(path)), ref_config.parse_opencv_yaml(str(path))
    assert sorted(got) == sorted(want) and "Camera.Tbc" in got
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert type(got[k]) is type(want[k]) and got[k] == want[k], k
    c, r = config.SlamConfig.from_yaml(str(path)), ref_config.SlamConfig.from_yaml(str(path))
    assert tuple(c.camera) == tuple(r.camera)
    for f in ("fps", "n_features", "n_levels", "scale_factor", "fast_threshold", "fast_min_threshold",
              "local_window", "vins_init_time", "image_delay_to_imu", "multiply_g", "bf", "depth_th_factor"):
        assert getattr(c, f) == getattr(r, f), f
    np.testing.assert_allclose(c.r_bc, r.r_bc, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(c.p_bc, r.p_bc)
    assert c.r_bc.dtype == r.r_bc.dtype == np.float32
    np.testing.assert_allclose(c.r_bc @ c.r_bc.T, np.eye(3), atol=1e-5)
    assert c.depth_map_factor is None and r.depth_map_factor == 1.0
    path.write_text(EUROC_YAML + "DepthMapFactor: 5000.0\n")
    assert config.SlamConfig.from_yaml(str(path)).depth_map_factor == 5000.0
    assert ref_config.SlamConfig.from_yaml(str(path)).depth_map_factor == 5000.0


def _write_pgm(path, arr):
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(b"P5\n# a comment\n%d %d\n%d\n" % (w, h, 255 if arr.dtype == np.uint8 else 65535))
        f.write(arr.astype(np.uint8 if arr.dtype == np.uint8 else ">u2").tobytes())


def _write_filtered_png(path, img):
    """An 8-bit gray PNG whose row y uses filter type y % 5 (PNG spec 9.2),
    encoded here so the reader's Average and Paeth paths run."""
    import struct
    import zlib

    h, w = img.shape
    x = img.astype(np.int64)
    rows = []
    for y in range(h):
        a = np.concatenate([[0], x[y, :-1]])
        b = x[y - 1] if y else np.zeros(w, np.int64)
        c = np.concatenate([[0], b[:-1]])
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) // 2, paeth][y % 5]
        rows.append(np.concatenate([[y % 5], (x[y] - pred) % 256]).astype(np.uint8))

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(np.concatenate(rows).tobytes())) + chunk(b"IEND", b""))


def _image_files(d, rng, name=lambda i, ext: f"{i:06d}{ext}", png_only=False, h=24, w=32):
    """Frames of every kind a loader meets written into d, frame i as
    name(i, extension); returns the file names."""
    gray = rng.integers(0, 256, (h, w)).astype(np.uint8)
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    rgba = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    g16 = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    writers = [
        ("a.pgm", lambda p: _write_pgm(p, gray)),
        ("b.pgm", lambda p: _write_pgm(p, g16)),
        ("c.png", lambda p: write_png(p, gray)),
        ("d.png", lambda p: write_png(p, rgb)),
        ("e.png", lambda p: write_png(p, g16)),
        ("f.png", lambda p: Image.fromarray(gray).save(p)),
        ("g.png", lambda p: Image.fromarray(rgb).save(p)),
        ("h.png", lambda p: Image.fromarray(rgba).save(p)),
        ("i.png", lambda p: Image.fromarray(g16).save(p)),
        ("j.png", lambda p: _write_filtered_png(p, gray)),
    ]
    names = []
    for suffix, write in writers:
        if png_only and not suffix.endswith(".png"):
            continue
        names.append(name(len(names), suffix[1:]))
        write(os.path.join(d, names[-1]))
    return names


def _same_stream(got, want):
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    assert got.image_paths == want.image_paths
    assert len(got) == len(want)
    for (tg, ig), (tw, iw) in zip(got, want):
        assert tg == tw and ig.dtype == np.float32 and ig.shape == iw.shape
        np.testing.assert_allclose(ig, iw, rtol=0, atol=IMG_TOL)


def _loaders_agree(tmp_path):
    rng = np.random.default_rng(0)
    # TUM mono and RGB-D
    tum = tmp_path / "tum"
    (tum / "rgb").mkdir(parents=True)
    (tum / "depth").mkdir()
    names = _image_files(str(tum / "rgb"), rng)
    ts = 1305031102.175304 + 0.033 * np.arange(len(names))
    (tum / "rgb.txt").write_text("# color images\n# timestamp filename\n"
                                 + "".join(f"{t:.6f} rgb/{n}\n" for t, n in zip(ts, names)))
    _same_stream(datasets.load_tum_mono(str(tum)), ref_datasets.load_tum_mono(str(tum)))
    d16 = rng.integers(0, 65536, (24, 32)).astype(np.uint16)
    d8 = rng.integers(0, 256, (24, 32)).astype(np.uint8)
    depth_writers = [("a.png", lambda p: write_png(p, d16)), ("b.png", lambda p: Image.fromarray(d16).save(p)),
                     ("c.pgm", lambda p: _write_pgm(p, d16)), ("d.npy", lambda p: np.save(p, d16 / 5000.0)),
                     ("e.png", lambda p: write_png(p, d8))]
    lines = []
    for i, (name, write) in enumerate(depth_writers):
        write(str(tum / "depth" / name))
        lines.append(f"{ts[i]:.6f} rgb/{names[i]} {ts[i] + 0.002:.6f} depth/{name}")
    (tum / "associations.txt").write_text("\n".join(lines) + "\n")
    got, got_d = datasets.load_tum_rgbd(str(tum), str(tum / "associations.txt"))
    want, want_d = ref_datasets.load_tum_rgbd(str(tum), str(tum / "associations.txt"))
    _same_stream(got, want)
    assert got_d == want_d
    for p in got_d:
        for factor in (5000.0, 1000.0):
            a, b = datasets.load_depth(p, factor), ref_datasets.load_depth(p, factor)
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=DEPTH_TOL, atol=0)
    np.testing.assert_array_equal(datasets.load_depth(got_d[0], 5000.0), d16.astype(np.float32) / 5000.0)

    # EuRoC: cam0, cam1, imu0, ground truth
    mav = tmp_path / "euroc" / "mav0"
    t_ns = 1403636579758555392 + 50_000_000 * np.arange(len(names), dtype=np.int64)
    for cam in ("cam0", "cam1"):
        (mav / cam / "data").mkdir(parents=True)
        files = _image_files(str(mav / cam / "data"), rng, name=lambda i, ext: f"{t_ns[i]}{ext}")
        (mav / cam / "data.csv").write_text("#timestamp [ns],filename\n" + "".join(
            f"{t},{f}\n" for f, t in zip(files, t_ns)))
    (mav / "imu0").mkdir()
    imu = rng.normal(size=(40, 6))
    (mav / "imu0" / "data.csv").write_text("#timestamp [ns],w_RS_S_x [rad s^-1],...\n" + "".join(
        f"{1403636579758555392 + 5_000_000 * i}," + ",".join(f"{v:.17g}" for v in row) + "\n"
        for i, row in enumerate(imu)))
    (mav / "state_groundtruth_estimate0").mkdir()
    (mav / "state_groundtruth_estimate0" / "data.csv").write_text("#timestamp,p,q\n" + "".join(
        f"{t}," + ",".join(f"{v:.9f}" for v in rng.normal(size=7)) + "\n" for t in t_ns))
    seq = str(tmp_path / "euroc")
    _same_stream(datasets.load_euroc_mono(seq), ref_datasets.load_euroc_mono(seq))
    (gl, gr), (wl, wr) = datasets.load_euroc_stereo(seq), ref_datasets.load_euroc_stereo(seq)
    _same_stream(gl, wl)
    assert gr == wr
    for a, b in zip(gr, wr):
        np.testing.assert_allclose(datasets._load_gray(a), ref_datasets._load_gray(b), rtol=0, atol=IMG_TOL)
    for a, b in zip(datasets.load_euroc_imu(seq), ref_datasets.load_euroc_imu(seq)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(datasets.load_euroc_groundtruth(seq), ref_datasets.load_euroc_groundtruth(seq)):
        np.testing.assert_array_equal(a, b)

    # KITTI: image_0, image_1, times.txt
    kitti = tmp_path / "kitti"
    for cam in ("image_0", "image_1"):
        (kitti / cam).mkdir(parents=True)
        n_png = len(_image_files(str(kitti / cam), rng, png_only=True))
    (kitti / "times.txt").write_text("".join(f"{0.103634 * i:.6e}\n" for i in range(n_png)))
    _same_stream(datasets.load_kitti_mono(str(kitti)), ref_datasets.load_kitti_mono(str(kitti)))
    (gl, gr), (wl, wr) = datasets.load_kitti_stereo(str(kitti)), ref_datasets.load_kitti_stereo(str(kitti))
    _same_stream(gl, wl)
    assert gr == wr


def _depth_factor_falls_back(tmp_path):
    """The runner's depth factor: the file's, else TUM's 5000 (also with no
    --config); the SLAM step is stubbed to record the depth it is given."""
    d = tmp_path / "rgbd"
    (d / "rgb").mkdir(parents=True)
    (d / "depth").mkdir()
    rng = np.random.default_rng(1)
    dep = rng.integers(1000, 20000, (24, 32)).astype(np.uint16)
    write_png(str(d / "rgb" / "0.png"), rng.integers(0, 256, (24, 32)).astype(np.uint8))
    write_png(str(d / "depth" / "0.png"), dep)
    (d / "associations.txt").write_text("0.000000 rgb/0.png 0.000000 depth/0.png\n")
    settings = "%YAML:1.0\nCamera.fx: 20.0\nCamera.fy: 20.0\nCamera.cx: 16.0\nCamera.cy: 12.0\n" \
               "Camera.width: 32\nCamera.height: 24\nORBextractor.nFeatures: 50\n"
    seen = []

    def step(self, image, depth, ts):
        seen.append(np.asarray(depth))
        return {"state": "NOT_INITIALIZED", "n_tracked": 0, "n_kfs": 0, "n_points": 0}

    cases = {"no DepthMapFactor": (settings, 5000.0), "DepthMapFactor 1000": (settings + "DepthMapFactor: 1000.0\n",
                                                                             1000.0), "no --config": (None, 5000.0)}
    with mock.patch.object(RgbdSlam, "process_frame_rgbd", step):
        for name, (text, factor) in cases.items():
            argv = ["--dataset", "tum", "--rgbd", "--path", str(d), "--out", str(tmp_path / "t.txt"),
                    "--device", "cpu"]
            if text is not None:
                (d / "settings.yaml").write_text(text)
                argv += ["--config", str(d / "settings.yaml")]
            run.main(argv)
            np.testing.assert_array_equal(seen[-1], dep.astype(np.float32) / np.float32(factor), err_msg=name)
    assert len(seen) == len(cases)


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


class _Kf:
    def __init__(self, rng, ts, nav):
        self.timestamp, self.r_cw, self.t_cw = ts, _rot(rng), rng.normal(size=3).astype(np.float32)
        self.nav = nav

    def center(self):
        return -self.r_cw.T @ self.t_cw


def _stub_slam(rng):
    """What the writers read of a SLAM object: trajectory_tum, the map's
    keyframes (with NavStates on all but one) and traj_entries."""
    kfs = {}
    for k in range(5):
        ns = SimpleNamespace(p=rng.normal(size=3).astype(np.float32), v=rng.normal(size=3).astype(np.float32),
                             r=_rot(rng), **{f: rng.normal(0, 0.01, 3).astype(np.float32)
                                             for f in ("bg", "ba", "dbg", "dba")})
        kfs[k * 2] = _Kf(rng, 0.1 * k + 1e-7, None if k == 3 else {"state": ns})
    rows = np.concatenate([0.1 * np.arange(7)[:, None], rng.normal(size=(7, 3)),
                           rng.normal(size=(7, 4))], 1)
    rows[:, 4:] /= np.linalg.norm(rows[:, 4:], axis=1, keepdims=True)
    entries = [(0.1 * i, [0, 2, 4, 6, 8, 5][i % 6], _rot(rng), rng.normal(size=3).astype(np.float32))
               for i in range(9)]
    return SimpleNamespace(trajectory_tum=lambda: rows, traj_entries=entries,
                           map=SimpleNamespace(keyframes=kfs, kf_ids=lambda: list(kfs)))


def _writers_agree(tmp_path):
    slam = _stub_slam(np.random.default_rng(2))
    for name in ("save_trajectory_tum", "save_keyframe_trajectory_tum", "save_trajectory_kitti",
                 "save_keyframe_trajectory_navstate"):
        a, b = tmp_path / f"port_{name}.txt", tmp_path / f"ref_{name}.txt"
        getattr(trajectory, name)(slam, str(a))
        getattr(ref_trajectory, name)(slam, str(b))
        la, lb = a.read_text().splitlines(), b.read_text().splitlines()
        assert len(la) == len(lb) > 0, name
        for x, y in zip(la, lb):
            # the same fields, each printed with the same digits
            assert [re.sub(r"\d", "0", f).lstrip("-") for f in x.split()] == \
                   [re.sub(r"\d", "0", f).lstrip("-") for f in y.split()], (name, x, y)
            np.testing.assert_allclose(np.array(x.split(), float), np.array(y.split(), float), rtol=0, atol=1e-6,
                                       err_msg=name)


def test_io_matches_reference(tmp_path):
    _config_agrees(tmp_path)
    _loaders_agree(tmp_path)
    _depth_factor_falls_back(tmp_path)
    _writers_agree(tmp_path)
