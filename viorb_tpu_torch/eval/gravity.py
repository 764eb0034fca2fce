"""Gravity-direction evaluation (port of viorb_tpu/eval/gravity.py's
`quat_to_rot` and `gravity_angle_deg`; its command line waits for the
apps, ROADMAP Slice G)."""

from __future__ import annotations

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
