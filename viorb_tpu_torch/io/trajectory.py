"""Trajectory export: TUM, KITTI, and full NavState formats (port of
viorb_tpu/io/trajectory.py, the same formats digit for digit).

Counterparts of the reference's savers (reference: src/System.cc:72-119
SaveKeyFrameTrajectoryNavState — P, q, V, bg+dbg, ba+dba per keyframe;
SaveTrajectoryTUM / SaveKeyFrameTrajectoryTUM / SaveTrajectoryKITTI at
include/System.h:114-130).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from viorb_tpu_torch.geometry.so3 import matrix_to_quat

if TYPE_CHECKING:
    from viorb_tpu_torch.slam.mono import MonoSlam


def _quat(r) -> np.ndarray:
    """(w, x, y, z) of a 3x3 rotation, in f32 as the JAX package computes it."""
    return matrix_to_quat(torch.from_numpy(np.asarray(r, np.float32))).numpy()


def save_trajectory_tum(slam: "MonoSlam", path: str):
    """t tx ty tz qx qy qz qw per tracked frame."""
    rows = slam.trajectory_tum()
    with open(path, "w") as f:
        for r in rows:
            f.write(
                f"{r[0]:.6f} {r[1]:.7f} {r[2]:.7f} {r[3]:.7f} "
                f"{r[4]:.7f} {r[5]:.7f} {r[6]:.7f} {r[7]:.7f}\n"
            )


def save_keyframe_trajectory_tum(slam: "MonoSlam", path: str):
    with open(path, "w") as f:
        for kf_id in sorted(slam.map.kf_ids()):
            kf = slam.map.keyframes[kf_id]
            c = kf.center()
            q = _quat(kf.r_cw.T)
            f.write(
                f"{kf.timestamp:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
            )


def save_trajectory_kitti(slam: "MonoSlam", path: str):
    """3x4 row-major camera-to-world matrix per frame (KITTI format)."""
    with open(path, "w") as f:
        for ts, kf_id, r_rel, t_rel in slam.traj_entries:
            kf = slam.map.keyframes.get(kf_id)
            if kf is None:
                continue
            r_cw = r_rel @ kf.r_cw
            t_cw = r_rel @ kf.t_cw + t_rel
            r_wc = r_cw.T
            c = -r_wc @ t_cw
            m = np.concatenate([r_wc, c[:, None]], axis=1)
            f.write(" ".join(f"{x:.7e}" for x in m.reshape(-1)) + "\n")


def save_keyframe_trajectory_navstate(slam, path: str):
    """Full NavState per keyframe: t P q V bg+dbg ba+dba (reference:
    SaveKeyFrameTrajectoryNavState, src/System.cc:72-119)."""
    with open(path, "w") as f:
        for kf_id in sorted(slam.map.kf_ids()):
            kf = slam.map.keyframes[kf_id]
            if not kf.nav or "state" not in kf.nav:
                continue
            ns = kf.nav["state"]
            p = np.asarray(ns.p)
            v = np.asarray(ns.v)
            q = _quat(ns.r)
            bg = np.asarray(ns.bg) + np.asarray(ns.dbg)
            ba = np.asarray(ns.ba) + np.asarray(ns.dba)
            vals = [kf.timestamp, *p, q[1], q[2], q[3], q[0], *v, *bg, *ba]
            f.write(" ".join(f"{x:.7f}" for x in vals) + "\n")
