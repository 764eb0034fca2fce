"""Trajectory evaluation: ATE RMSE with SE3/Sim3 (Umeyama) alignment (port
of viorb_tpu/eval/ate.py, numpy as there).

Counterpart of the reference's evaluate_viorb/ Python-2 scripts
(associate.py + TUM evaluate_ate; reference evaluate_viorb/), as a library:
associate by timestamp, align (mono needs Sim3 — scale is unobservable),
report RMSE.

Usage:
  python -m viorb_tpu_torch.eval.ate est.txt gt.txt [--scale] [--max-dt S]
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


def _load_tum(path: str):
    rows = np.loadtxt(path, comments="#", ndmin=2)
    return rows[:, 0], rows[:, 1:4]


def main(argv=None):
    """CLI: absolute trajectory error between two TUM files (reference
    evaluate_viorb/evaluate_ate_scale.py — associate by timestamp,
    Umeyama-align, report RMSE; --scale also reports the recovered
    alignment scale, the reference's mono-scale diagnostic)."""
    import argparse

    ap = argparse.ArgumentParser(
        description="ATE between an estimated and ground-truth TUM trajectory"
    )
    ap.add_argument("est", help="estimated trajectory (TUM: t x y z qx qy qz qw)")
    ap.add_argument("gt", help="ground-truth trajectory (TUM)")
    ap.add_argument("--scale", action="store_true",
                    help="Sim3 alignment (mono): also print recovered scale")
    ap.add_argument("--max-dt", type=float, default=0.02,
                    help="association timestamp window (s)")
    args = ap.parse_args(argv)
    t_e, xyz_e = _load_tum(args.est)
    t_g, xyz_g = _load_tum(args.gt)
    ia, ib = associate(t_e, t_g, max_dt=args.max_dt)
    if len(ia) < 3:
        raise SystemExit(f"only {len(ia)} associations (max_dt={args.max_dt})")
    x, y = xyz_e[ia], xyz_g[ib]
    s, R, t = umeyama_alignment(x, y, with_scale=args.scale)
    err = np.sqrt(((y - (s * (x @ R.T) + t)) ** 2).sum(1))
    print(f"compared_pose_pairs {len(ia)} pairs")
    print(f"absolute_translational_error.rmse {np.sqrt((err**2).mean()):.6f} m")
    print(f"absolute_translational_error.mean {err.mean():.6f} m")
    print(f"absolute_translational_error.median {np.median(err):.6f} m")
    print(f"absolute_translational_error.std {err.std():.6f} m")
    print(f"absolute_translational_error.min {err.min():.6f} m")
    print(f"absolute_translational_error.max {err.max():.6f} m")
    if args.scale:
        print(f"alignment_scale {s:.6f}")


if __name__ == "__main__":
    main()
