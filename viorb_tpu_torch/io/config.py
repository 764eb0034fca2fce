"""Configuration loading: the reference's YAML settings schema (port of
viorb_tpu/io/config.py).

Reads the same keys the reference reads from OpenCV FileStorage YAML
(reference: src/Tracking.cc:647-763 camera/ORB params;
src/IMU/configparam.cpp:16-75 VI params — Tbc re-orthonormalized, local
window size, VINS init time, image delay, acc multiplied by 9.8 flag).
Plain-YAML parser included (no external deps; the reference's files use
the '%YAML:1.0' OpenCV dialect which pyyaml rejects anyway).

One difference: `depth_map_factor` is None when the file has no
`DepthMapFactor` (the JAX package's default, 1.0, hid a missing key from
the runner, which then read TUM depth 5000x too large); the runner falls
back to TUM's 5000 (`run.py::TUM_DEPTH_FACTOR`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.geometry.so3 import normalize_rotation


def parse_opencv_yaml(path: str) -> Dict[str, object]:
    """Minimal parser for the reference's flat OpenCV-YAML settings files:
    'Key.Name: value' scalars and '!!opencv-matrix' blocks."""
    out: Dict[str, object] = {}
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        ln = lines[i].split("#")[0].rstrip()
        i += 1
        if not ln or ln.startswith("%") or ln.startswith("---"):
            continue
        if ":" not in ln:
            continue
        key, _, val = ln.partition(":")
        key = key.strip()
        val = val.strip()
        if val.startswith("!!opencv-matrix") or val == "":
            # matrix block: rows/cols/dt/data
            rows = cols = None
            data: List[float] = []
            while i < len(lines):
                ln2 = lines[i].split("#")[0].strip()
                if ln2.startswith("rows:"):
                    rows = int(ln2.split(":")[1])
                elif ln2.startswith("cols:"):
                    cols = int(ln2.split(":")[1])
                elif ln2.startswith("data:"):
                    buf = ln2.split(":", 1)[1]
                    while "]" not in buf and i + 1 < len(lines):
                        i += 1
                        buf += lines[i]
                    nums = buf.replace("[", " ").replace("]", " ").replace(",", " ")
                    data = [float(x) for x in nums.split()]
                    i += 1
                    break
                elif ln2 and ":" in ln2 and not ln2.startswith(("rows", "cols", "dt", "data")):
                    break
                i += 1
            if rows and cols and data:
                out[key] = np.array(data, np.float64).reshape(rows, cols)
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val.strip('"')
    return out


@dataclass
class SlamConfig:
    camera: PinholeCamera
    fps: float = 20.0
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0
    fast_min_threshold: float = 7.0
    # VI (reference ConfigParam)
    r_bc: np.ndarray = field(default_factory=lambda: np.eye(3, dtype=np.float32))
    p_bc: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    local_window: int = 10
    vins_init_time: float = 15.0
    image_delay_to_imu: float = 0.0
    multiply_g: bool = False
    # depth (RGB-D) scaling; None: the file does not say (module docstring)
    depth_map_factor: Optional[float] = None
    # stereo: fx * baseline (reference Camera.bf) and close-point bound
    bf: float = 0.0
    depth_th_factor: float = 35.0

    @staticmethod
    def from_yaml(path: str) -> "SlamConfig":
        d = parse_opencv_yaml(path)
        cam = PinholeCamera(
            fx=float(d.get("Camera.fx", 450.0)),
            fy=float(d.get("Camera.fy", 450.0)),
            cx=float(d.get("Camera.cx", 376.0)),
            cy=float(d.get("Camera.cy", 240.0)),
            k1=float(d.get("Camera.k1", 0.0)),
            k2=float(d.get("Camera.k2", 0.0)),
            p1=float(d.get("Camera.p1", 0.0)),
            p2=float(d.get("Camera.p2", 0.0)),
            k3=float(d.get("Camera.k3", 0.0)),
            width=int(d.get("Camera.width", 752)),
            height=int(d.get("Camera.height", 480)),
        )
        cfg = SlamConfig(camera=cam)
        cfg.fps = float(d.get("Camera.fps", 20.0))
        cfg.n_features = int(d.get("ORBextractor.nFeatures", 1000))
        cfg.n_levels = int(d.get("ORBextractor.nLevels", 8))
        cfg.scale_factor = float(d.get("ORBextractor.scaleFactor", 1.2))
        cfg.fast_threshold = float(d.get("ORBextractor.iniThFAST", 20))
        cfg.fast_min_threshold = float(d.get("ORBextractor.minThFAST", 7))
        cfg.local_window = int(d.get("LocalMapping.LocalWindowSize", 10))
        cfg.vins_init_time = float(d.get("test.VINSInitTime", 15.0))
        cfg.image_delay_to_imu = float(d.get("Camera.delaytoimu", 0.0))
        cfg.multiply_g = bool(int(d.get("IMU.multiplyG", 0)))
        if "DepthMapFactor" in d:
            cfg.depth_map_factor = float(d["DepthMapFactor"])
        cfg.bf = float(d.get("Camera.bf", 0.0))
        cfg.depth_th_factor = float(d.get("ThDepth", 35.0))
        tbc = d.get("Camera.Tbc")
        if tbc is not None:
            tbc = np.asarray(tbc, np.float64)
            # re-orthonormalize like the reference (configparam.cpp:40-68)
            r = normalize_rotation(torch.from_numpy(tbc[:3, :3].astype(np.float32)))
            cfg.r_bc = r.numpy().astype(np.float32)
            cfg.p_bc = tbc[:3, 3].astype(np.float32)
        return cfg
