"""Trajectory evaluation: ATE RMSE with SE3/Sim3 (Umeyama) alignment (port
of viorb_tpu/eval/ate.py without its command line, numpy as there).

Counterpart of the reference's evaluate_viorb/ Python-2 scripts
(associate.py + TUM evaluate_ate; reference evaluate_viorb/), as a library:
associate by timestamp, align (mono needs Sim3 — scale is unobservable),
report RMSE.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def associate(
    t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.02
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association (reference
    evaluate_viorb/associate.py). Returns index pairs into a and b."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(t_a):
        while j + 1 < len(t_b) and abs(t_b[j + 1] - t) <= abs(t_b[j] - t):
            j += 1
        if abs(t_b[j] - t) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.array(ia, np.int64), np.array(ib, np.int64)


def umeyama_alignment(
    x: np.ndarray, y: np.ndarray, with_scale: bool = True
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Find (s, R, t) minimizing ||y - (s R x + t)||^2. x,y: (N,3)."""
    mx = x.mean(0)
    my = y.mean(0)
    xc = x - mx
    yc = y - my
    cov = yc.T @ xc / len(x)
    u, d, vt = np.linalg.svd(cov)
    s_fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[2, 2] = -1
    R = u @ s_fix @ vt
    if with_scale:
        var_x = (xc**2).sum() / len(x)
        s = float(np.trace(np.diag(d) @ s_fix) / max(var_x, 1e-12))
    else:
        s = 1.0
    t = my - s * R @ mx
    return s, R, t


def ate_rmse(
    est_t: np.ndarray,  # (N,) timestamps
    est_xyz: np.ndarray,  # (N,3) positions
    gt_t: np.ndarray,
    gt_xyz: np.ndarray,
    with_scale: bool = True,
    max_dt: float = 0.02,
) -> float:
    ia, ib = associate(est_t, gt_t, max_dt)
    if len(ia) < 3:
        return float("inf")
    x = est_xyz[ia]
    y = gt_xyz[ib]
    s, R, t = umeyama_alignment(x, y, with_scale)
    err = y - (s * (x @ R.T) + t)
    return float(np.sqrt((err**2).sum(1).mean()))
