"""Dataset loaders: TUM RGB-D, EuRoC MAV, KITTI odometry (port of
viorb_tpu/io/datasets.py: the same files, order, timestamps and values).

Counterparts of the reference's example mains' loaders (reference:
Examples/Monocular/mono_tum.cc LoadImages, mono_euroc.cc:33-130 with
EuRoC_TimeStamps, mono_kitti.cc; RGB-D associations files). Images load
lazily as float32 grayscale on the host through a minimal PGM reader and
`io/png.py` (no matplotlib or PIL). The JAX package reads PNG through
matplotlib, which hands back v / 255 (or v / 65535) in f32 that the loader
multiplies back; here the integers come out exactly, so the two agree
within an ulp of the f32 product (<= 1e-4 on 0..255).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from viorb_tpu_torch.io.png import read_png


def _read_pgm(path: str) -> Tuple[np.ndarray, int]:
    """(the image's integers (H,W), its maxval) of a binary PGM."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"P5", b"P2"):
            raise ValueError(f"{path}: not a PGM file (magic {magic!r})")
        ln = f.readline()
        while ln.startswith(b"#"):
            ln = f.readline()
        w, h = map(int, ln.split())
        maxv = int(f.readline())
        data = np.frombuffer(f.read(), np.uint8 if maxv < 256 else ">u2")
    return data.reshape(h, w), maxv


def _load_gray(path: str) -> np.ndarray:
    """Grayscale f32 image on 0..255: PGM (8- or 16-bit, scaled by
    255 / maxval) or PNG (gray, the mean of R, G and B, 16-bit gray scaled
    by 255 / 65535), as the JAX package's loader reads them."""
    if path.endswith((".pgm", ".PGM")):
        data, maxv = _read_pgm(path)
        return data.astype(np.float32) * (255.0 / maxv)
    img = read_png(path)
    scale = np.float32(255.0 / 65535.0) if img.dtype == np.uint16 else np.float32(1.0)
    img = img.astype(np.float32)
    if img.ndim == 3:
        img = img[..., :3].mean(-1)
    return (img * scale).astype(np.float32)


@dataclass
class MonoFrameStream:
    timestamps: np.ndarray
    image_paths: List[str]

    def __len__(self):
        return len(self.image_paths)

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray]]:
        for t, p in zip(self.timestamps, self.image_paths):
            yield float(t), _load_gray(p)


def load_tum_mono(seq_dir: str) -> MonoFrameStream:
    """TUM RGB-D rgb.txt format: '# comments' then 'timestamp filename'."""
    ts, paths = [], []
    with open(os.path.join(seq_dir, "rgb.txt")) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            t, rel = ln.split()[:2]
            ts.append(float(t))
            paths.append(os.path.join(seq_dir, rel))
    return MonoFrameStream(np.array(ts), paths)


def load_tum_rgbd(seq_dir: str, associations: str):
    """TUM RGB-D with an associations file: 't_rgb rgb t_depth depth'."""
    ts, rgb, depth = [], [], []
    with open(associations) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split()
            ts.append(float(parts[0]))
            rgb.append(os.path.join(seq_dir, parts[1]))
            depth.append(os.path.join(seq_dir, parts[3]))
    return MonoFrameStream(np.array(ts), rgb), depth


def load_depth(path: str, depth_map_factor: float = 5000.0) -> np.ndarray:
    """Depth image -> meters (reference Examples/RGB-D/rgbd_tum.cc reads
    16-bit PNGs scaled by DepthMapFactor=5000). Supports .npy (synthetic
    dumps), 16-bit PGM, and PNG (the first channel; an 8-bit file's values
    are scaled by 65535 / 255, as the JAX package's matplotlib read does)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith((".pgm", ".PGM")):
        data, _ = _read_pgm(path)
        return data.astype(np.float32) / depth_map_factor
    img = read_png(path)
    if img.ndim == 3:
        img = img[..., 0]
    scale = 1.0 if img.dtype == np.uint16 else 65535.0 / 255.0
    return (img.astype(np.float32) * np.float32(scale)) / depth_map_factor


def load_euroc_mono(seq_dir: str, timestamp_file: Optional[str] = None) -> MonoFrameStream:
    """EuRoC mav0/cam0/data + data.csv (ns timestamps)."""
    cam_dir = os.path.join(seq_dir, "mav0", "cam0")
    ts, paths = [], []
    with open(os.path.join(cam_dir, "data.csv")) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            t_ns, name = ln.split(",")[:2]
            ts.append(int(t_ns) * 1e-9)
            paths.append(os.path.join(cam_dir, "data", name.strip()))
    return MonoFrameStream(np.array(ts), paths)


def load_euroc_imu(seq_dir: str):
    """EuRoC mav0/imu0/data.csv: t_ns, wx, wy, wz, ax, ay, az.
    Returns (t (S,), gyro (S,3), acc (S,3))."""
    rows = []
    with open(os.path.join(seq_dir, "mav0", "imu0", "data.csv")) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            rows.append([float(x) for x in ln.split(",")])
    arr = np.array(rows)
    return arr[:, 0] * 1e-9, arr[:, 1:4], arr[:, 4:7]


def load_kitti_mono(seq_dir: str, cam: int = 0) -> MonoFrameStream:
    """KITTI odometry: image_0/ + times.txt."""
    with open(os.path.join(seq_dir, "times.txt")) as f:
        ts = np.array([float(x) for x in f.read().split()])
    img_dir = os.path.join(seq_dir, f"image_{cam}")
    paths = [os.path.join(img_dir, f"{i:06d}.png") for i in range(len(ts))]
    return MonoFrameStream(ts, paths)


def load_euroc_stereo(seq_dir: str):
    """EuRoC cam0 (left) + cam1 (right). Returns (left MonoFrameStream,
    right image paths aligned to left timestamps)."""
    left = load_euroc_mono(seq_dir)
    cam1 = os.path.join(seq_dir, "mav0", "cam1", "data")
    right = [os.path.join(cam1, os.path.basename(p)) for p in left.image_paths]
    return left, right


def load_kitti_stereo(seq_dir: str):
    """KITTI odometry gray stereo: image_0 (left) + image_1 (right)."""
    left = load_kitti_mono(seq_dir, cam=0)
    img1 = os.path.join(seq_dir, "image_1")
    right = [os.path.join(img1, os.path.basename(p)) for p in left.image_paths]
    return left, right


def load_euroc_groundtruth(seq_dir: str):
    """EuRoC state_groundtruth_estimate0/data.csv -> (t, xyz, quat wxyz)
    (the format evaluate_viorb/euroc_to_tum.py converts)."""
    path = os.path.join(seq_dir, "mav0", "state_groundtruth_estimate0", "data.csv")
    rows = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            rows.append([float(x) for x in ln.split(",")])
    arr = np.array(rows)
    return arr[:, 0] * 1e-9, arr[:, 1:4], arr[:, 4:8]
