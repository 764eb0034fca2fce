"""Gravity-direction evaluation (port of viorb_tpu/eval/gravity.py;
counterpart of the reference's evaluate_viorb/evaluate_gravity.py:1-40).

Reads the VI-init convergence dump `gw.txt` written by `run.py
--init-log-dir` (rows: t gx gy gz, world frame) and prints the angular
error of every estimate against the true gravity direction; an optional
ground-truth body pose + extrinsics rotates camera-frame estimates first,
like the reference script.

Usage:
  python -m viorb_tpu_torch.eval.gravity tmp/gw.txt [--gt 0,0,-9.81]
  python -m viorb_tpu_torch.eval.gravity g_cam.txt --q-wb w,x,y,z --r-bc <9 vals>
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(w,x,y,z) -> rotation matrix."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def gravity_angle_deg(g_est: np.ndarray, g_true: np.ndarray) -> float:
    """Angle in degrees between two gravity vectors (direction only)."""
    c = float(g_est @ g_true / max(np.linalg.norm(g_est) * np.linalg.norm(g_true), 1e-12))
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def main(argv=None):
    ap = argparse.ArgumentParser(description="gravity-direction error")
    ap.add_argument("gw", help="gw dump: rows `t gx gy gz` (or `gx gy gz`)")
    ap.add_argument("--gt", default="0,0,-9.81", help="true gravity in world, comma-separated")
    ap.add_argument("--q-wb", default=None,
                    help="ground-truth body-to-world quaternion w,x,y,z — rotates camera-frame estimates to "
                         "world like the reference script")
    ap.add_argument("--r-bc", default=None, help="9 comma-separated row-major entries of R_bc")
    args = ap.parse_args(argv)

    rows = np.loadtxt(args.gw, ndmin=2)
    g_cols = rows[:, 1:4] if rows.shape[1] >= 4 else rows[:, 0:3]
    ts = rows[:, 0] if rows.shape[1] >= 4 else np.arange(len(rows))
    g_true = np.array([float(v) for v in args.gt.split(",")])

    rot = np.eye(3)
    if args.q_wb:
        rot = quat_to_rot(np.array([float(v) for v in args.q_wb.split(",")]))
        if args.r_bc:
            rot = rot @ np.array([float(v) for v in args.r_bc.split(",")]).reshape(3, 3)

    errs = []
    for t, g in zip(ts, g_cols):
        g_w = rot @ g
        errs.append(gravity_angle_deg(g_w, g_true))
        print(f"{t:.6f} {errs[-1]:.4f} deg  |g|={np.linalg.norm(g_w):.4f}")
    errs = np.array(errs)
    print(f"final {errs[-1]:.4f} deg  mean {errs.mean():.4f}  min {errs.min():.4f}", file=sys.stderr)
    return errs[-1]


if __name__ == "__main__":
    main()
