"""The map store's host helpers in C++ (port of viorb_tpu/native): the
covisibility count, the union of keyframes' points, the BA observation
grid and the per-point statistics refresh; and `png_unfilter.cpp`, the PNG
row reconstruction of `io/png.py` (the port's own, no counterpart there).

Each source is built with g++ at first use into
`<repo>/build/viorb_tpu_torch/lib<name>.so` (git-ignored), again whenever
the source is newer, and bound with ctypes. A failed build raises: there is
no numpy fallback here. The numpy loop that specifies `update_point_stats`
lives in `mapping/map.py::update_point_stats_numpy`, as the tests' oracle.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from viorb_tpu_torch.cuda_build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "map_index.cpp")
LIB_PATH = os.path.join(BUILD_DIR, "libmap_index.so")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = {
    "covis_count": [_P, _I64, _P, _I64, ctypes.c_int32, _P, _I64],
    "union_points": [_P, _I64, _P, _I64, _P],
    "build_ba_grid": [_P, _I64, _P, _P, _I64, _P, _I64, _P, _P, _I64, _P, _P, _P, _P, _P],
    "update_point_stats": [_P, _I64, _P, _P, _I64, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P],
}

_PNG_ARGTYPES = {"png_unfilter": [_P, _I64, _I64, _I64, _P]}
PNG_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "png_unfilter.cpp")
PNG_LIB_PATH = os.path.join(BUILD_DIR, "libpng_unfilter.so")

_libs: dict = {}  # library path -> ctypes.CDLL
_lock = threading.Lock()


def build(src: str = SRC, lib_path: str = LIB_PATH) -> None:
    """g++ `src` into `lib_path`; raises RuntimeError with g++'s output on
    failure."""
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, src, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file


def _load(src: str, lib_path: str, argtypes: dict, restype=None) -> ctypes.CDLL:
    """The library built from `src`, built first if missing or stale."""
    lib = _libs.get(lib_path)
    if lib is not None:
        return lib
    with _lock:
        if lib_path not in _libs:
            if not os.path.exists(lib_path) or os.path.getmtime(lib_path) < os.path.getmtime(src):
                build(src, lib_path)
            lib = ctypes.CDLL(lib_path)
            for name, types in argtypes.items():
                fn = getattr(lib, name)
                fn.argtypes = types
                fn.restype = restype
            _libs[lib_path] = lib
    return _libs[lib_path]


def get_lib() -> ctypes.CDLL:
    """The map helpers' library, built first if missing or stale."""
    return _load(SRC, LIB_PATH, _ARGTYPES)


def get_png_lib() -> ctypes.CDLL:
    """The PNG row reconstruction's library, built first if missing or
    stale."""
    return _load(PNG_SRC, PNG_LIB_PATH, _PNG_ARGTYPES, restype=_I64)


def _c(a: np.ndarray, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype)


def covis_count(pt_ids, obs_kf, exclude_kf: int, max_kf: int) -> np.ndarray:
    """(max_kf,) int32 counts of co-observation per keyframe id over the
    points `pt_ids`, keyframe `exclude_kf` left out."""
    lib = get_lib()
    pt_ids = _c(pt_ids, np.int64)
    obs_kf = _c(obs_kf, np.int32)
    out = np.zeros(max_kf, np.int32)
    lib.covis_count(
        pt_ids.ctypes.data, len(pt_ids), obs_kf.ctypes.data, obs_kf.shape[1],
        int(exclude_kf), out.ctypes.data, max_kf,
    )
    return out


def union_points(point_idx_concat, active) -> np.ndarray:
    """(len(active),) uint8 mask of the active points named in
    `point_idx_concat` (-1 entries ignored)."""
    lib = get_lib()
    point_idx_concat = _c(point_idx_concat, np.int32)
    active_u8 = _c(active, np.uint8)
    out = np.zeros(len(active), np.uint8)
    lib.union_points(
        point_idx_concat.ctypes.data, len(point_idx_concat), active_u8.ctypes.data,
        len(active), out.ctypes.data,
    )
    return out


def build_ba_grid(pt_ids, obs_kf, obs_feat, slot_of_kf, xy_all, level_all, inv_sigma2_of_level):
    """Returns (kf_idx (m,R) int32, uv (m,R,2) f32, inv_sigma2 (m,R) f32,
    valid (m,R) bool) for the m points `pt_ids`."""
    lib = get_lib()
    m = len(pt_ids)
    slots = obs_kf.shape[1]
    kf_idx = np.zeros((m, slots), np.int32)
    uv = np.zeros((m, slots, 2), np.float32)
    inv_s2 = np.ones((m, slots), np.float32)
    valid = np.zeros((m, slots), np.uint8)
    if m == 0:
        return kf_idx, uv, inv_s2, valid.astype(bool)
    pt_ids = _c(pt_ids, np.int64)
    obs_kf = _c(obs_kf, np.int32)
    obs_feat = _c(obs_feat, np.int32)
    slot_of_kf = _c(slot_of_kf, np.int32)
    xy_all = _c(xy_all, np.float32)
    level_all = _c(level_all, np.int32)
    inv_sigma2_of_level = _c(inv_sigma2_of_level, np.float32)
    lib.build_ba_grid(
        pt_ids.ctypes.data, m, obs_kf.ctypes.data, obs_feat.ctypes.data, slots,
        slot_of_kf.ctypes.data, len(slot_of_kf), xy_all.ctypes.data, level_all.ctypes.data,
        xy_all.shape[1], inv_sigma2_of_level.ctypes.data,
        kf_idx.ctypes.data, uv.ctypes.data, inv_s2.ctypes.data, valid.ctypes.data,
    )
    return kf_idx, uv, inv_s2, valid.astype(bool)


def update_point_stats(
    pt_ids, obs_kf, obs_feat, desc_ptrs, level_ptrs, centers, kf_alive,
    pt_xyz, pt_desc01, pt_normal, pt_min_dist, pt_max_dist,
) -> None:
    """In place: the distinctive descriptor, mean viewing normal and
    distance range of the points `pt_ids`. desc_ptrs / level_ptrs are
    (max_kf,) uint64 addresses of each keyframe's (N,4) uint64 packed
    descriptors and (N,) int32 levels; the caller keeps those arrays alive
    during the call. Every output array must be C-contiguous, as MapStore's
    are: the kernel writes through their pointers."""
    lib = get_lib()
    if len(pt_ids) == 0:
        return
    for a, dtype in (
        (obs_kf, np.int32), (obs_feat, np.int32), (desc_ptrs, np.uint64), (level_ptrs, np.uint64),
        (centers, np.float32), (kf_alive, np.uint8), (pt_xyz, np.float32), (pt_desc01, np.uint8),
        (pt_normal, np.float32), (pt_min_dist, np.float32), (pt_max_dist, np.float32),
    ):
        if a.dtype != dtype or not a.flags.c_contiguous:
            raise ValueError(f"update_point_stats: expected a C-contiguous {np.dtype(dtype)} array, got {a.dtype}")
    pt_ids = _c(pt_ids, np.int64)
    lib.update_point_stats(
        pt_ids.ctypes.data, len(pt_ids), obs_kf.ctypes.data, obs_feat.ctypes.data, obs_kf.shape[1],
        desc_ptrs.ctypes.data, level_ptrs.ctypes.data, centers.ctypes.data, kf_alive.ctypes.data,
        len(kf_alive), pt_xyz.ctypes.data, pt_desc01.ctypes.data, pt_normal.ctypes.data,
        pt_min_dist.ctypes.data, pt_max_dist.ctypes.data,
    )
