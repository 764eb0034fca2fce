"""Batched SO(3) operations (port of viorb_tpu/geometry/so3.py: the subset
the tracking step uses).

Rotations are (...,3,3) f32 matrices; every function takes arbitrary
leading batch dimensions. `exp_so3` keeps the reference's small-angle
series so it is exact at the LM's zero increment.
"""

from __future__ import annotations

import torch

# Below this angle (rad) the Taylor series replace sin(t)/t and
# (1-cos t)/t^2; theta^2 < eps makes the quadratic terms vanish in f32.
_SMALL_ANGLE = 1e-5


def hat(w: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def _theta(w: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(w * w, dim=-1) + 1e-30)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, (...,3) -> (...,3,3):
    R = I + sin(t)/t * W + (1-cos t)/t^2 * W^2, with series fallbacks."""
    t = _theta(w)
    t2 = t * t
    small = t < _SMALL_ANGLE
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2)
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,4) quaternion (w,x,y,z), w >= 0. Shepperd's
    method, branch-free via selecting the max-trace variant."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidate quaternions (unnormalized)
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    scores = torch.stack([tr, m00, m11, m22], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (...,4cand,4)
    q = torch.take_along_dim(cands, idx[..., None, None], dim=-2)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    sgn = torch.where(q[..., :1] < 0.0, -1.0, 1.0)
    return q * sgn


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(...,4) (w,x,y,z) -> (...,3,3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize via a quaternion round trip."""
    return quat_to_matrix(matrix_to_quat(R))
