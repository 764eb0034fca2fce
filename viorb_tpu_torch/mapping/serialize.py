"""Map checkpoint/resume: save/load a full MapStore as one .npz (port of
viorb_tpu/mapping/serialize.py).

The layout is the reference's, key for key: the point arrays under their
MapStore names, `_next_pt` / `_free_pts` / `_next_kf` / `max_points`, each
keyframe's arrays under a `kf{id}_` prefix, a 7-column `kf_meta` table
(id, timestamp, prev, next, active, imu_t0, parent) and pipeline extras
under `x_`. A map saved by either package loads in the other.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from viorb_tpu_torch.imu.navstate import NavState
from viorb_tpu_torch.mapping.map import KeyFrameData, MapStore

_PT_FIELDS = (
    "pt_xyz", "pt_desc01", "pt_normal", "pt_min_dist", "pt_max_dist",
    "pt_found", "pt_visible", "pt_first_kf", "pt_active", "obs_kf",
    "obs_feat",
)
_KF_ARRAYS = ("xy", "level", "angle", "desc01", "valid", "point_idx")
_NAV_KEYS = ("state_p", "state_v", "state_r", "state_bg", "state_ba",
             "state_dbg", "state_dba")
_IMU_KEYS = ("imu_t", "imu_g", "imu_a")


def map_arrays(m: MapStore, extra: dict | None = None) -> dict:
    """The checkpoint's arrays of `m`, by .npz key. A keyframe's VI state,
    `nav["state"]` (a NavState), is stored field by field under `_NAV_KEYS`
    (p, v, r, bg, ba, dbg, dba in that order), its IMU segment under
    `_IMU_KEYS`."""
    data = {}
    if extra:
        for k, v in extra.items():
            data["x_" + k] = np.asarray(v)
    for f in _PT_FIELDS:
        data[f] = getattr(m, f)
    data["_next_pt"] = np.int64(m._next_pt)
    data["_free_pts"] = np.asarray(m._free_pts, np.int64)
    data["_next_kf"] = np.int64(m._next_kf)
    data["max_points"] = np.int64(m.max_points)
    ids = sorted(m.keyframes)
    # id, ts, prev, next, active, imu_t0, parent
    meta = np.zeros((len(ids), 7), np.float64)
    for row, i in enumerate(ids):
        kf = m.keyframes[i]
        meta[row] = [i, kf.timestamp, kf.prev_kf, kf.next_kf,
                     float(kf.active), kf.imu_t0, kf.parent_kf]
        p = f"kf{i}_"
        data[p + "r_cw"] = kf.r_cw
        data[p + "t_cw"] = kf.t_cw
        kf.ensure_desc01()  # fulfill a deferred descriptor pull
        for f in _KF_ARRAYS:
            data[p + f] = getattr(kf, f)
        if kf.ur is not None:
            data[p + "ur"] = kf.ur
        if kf.bow is not None:
            # bow is a {word_id: weight} dict — pack to an (W,2) array
            data[p + "bow"] = np.array(
                sorted(kf.bow.items()), np.float64
            ).reshape(-1, 2)
        if kf.nav:
            if "state" in kf.nav:
                for name, val in zip(_NAV_KEYS, kf.nav["state"]):
                    data[p + "nav_" + name] = np.asarray(val)
            for key in _IMU_KEYS:
                if key in kf.nav:
                    data[p + "nav_" + key] = kf.nav[key]
    data["kf_meta"] = meta
    return data


def map_store_from_arrays(z: Mapping[str, np.ndarray]) -> MapStore:
    """A MapStore from a checkpoint's arrays: an opened .npz, or a dict with
    the same keys (`map_arrays`' output, or the JAX package's arrays). The
    arrays are copied."""
    m = MapStore(max_points=int(z["max_points"]))
    for f in _PT_FIELDS:
        getattr(m, f)[...] = z[f]
    m._next_pt = int(z["_next_pt"])
    m._free_pts = [int(i) for i in z["_free_pts"]]
    m._next_kf = int(z["_next_kf"])
    for row in z["kf_meta"]:
        i = int(row[0])
        p = f"kf{i}_"
        nav = None
        if p + "nav_state_p" in z:
            nav = {"state": NavState(*(np.array(z[p + "nav_" + k]) for k in _NAV_KEYS))}
        for key in _IMU_KEYS:
            if p + "nav_" + key in z:
                nav = nav or {}
                nav[key] = np.array(z[p + "nav_" + key])
        kf = KeyFrameData(
            kf_id=i, timestamp=float(row[1]),
            r_cw=np.array(z[p + "r_cw"]), t_cw=np.array(z[p + "t_cw"]),
            xy=np.array(z[p + "xy"]), level=np.array(z[p + "level"]),
            angle=np.array(z[p + "angle"]), desc01=np.array(z[p + "desc01"]),
            valid=np.array(z[p + "valid"]), point_idx=np.array(z[p + "point_idx"]),
            ur=np.array(z[p + "ur"]) if p + "ur" in z else None,
            nav=nav, imu_t0=float(row[5]),
            prev_kf=int(row[2]), next_kf=int(row[3]),
            # column 6 came with the spanning tree; older checkpoints
            # predate it
            parent_kf=int(row[6]) if len(row) > 6 else -1,
            bow=(
                {int(w): float(v) for w, v in z[p + "bow"]}
                if p + "bow" in z
                else None
            ),
            active=bool(row[4]),
        )
        m.keyframes[i] = kf
    m.version += 1
    return m


def save_map(m: MapStore, path: str, extra: dict | None = None):
    """extra: pipeline-level state stored under an ``x_`` prefix;
    load_map_extra retrieves it."""
    np.savez_compressed(path, **map_arrays(m, extra))


def load_map_extra(path: str) -> dict:
    """The ``extra`` dict passed to save_map (pipeline-level state)."""
    with np.load(path, allow_pickle=False) as z:
        return {k[2:]: z[k] for k in z.files if k.startswith("x_")}


def load_map(path: str) -> MapStore:
    with np.load(path, allow_pickle=False) as z:
        return map_store_from_arrays(z)
