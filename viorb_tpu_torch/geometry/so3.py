"""Batched SO(3) operations (port of viorb_tpu/geometry/so3.py).

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


def vee(W: torch.Tensor) -> torch.Tensor:
    """(...,3,3) skew -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,3), stable near 0 and near pi.

    The generic branch takes the angle from atan2(|anti|/2, (tr-1)/2) and
    the axis from the anti-symmetric part; near pi, where that part
    vanishes, the axis comes from the largest diagonal entry of
    (S - cos t I)/(1 - cos t) = a a^T, S the symmetric part."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = ((tr - 1.0) * 0.5).clamp(-1.0, 1.0)
    anti = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    anti_norm = torch.sqrt(torch.sum(anti * anti, dim=-1) + 1e-30)
    t = torch.atan2(0.5 * anti_norm, cos_t)
    small = t < _SMALL_ANGLE
    # w = t * anti/|anti|; for small t, anti/|anti| -> anti/(2t)
    scale = torch.where(
        small,
        0.5 + t * t / 12.0,
        t / torch.where(anti_norm < 1e-10, torch.ones_like(anti_norm), anti_norm),
    )
    w_generic = scale[..., None] * anti

    one_m_cos = (1.0 - cos_t).clamp(min=1e-7)
    S = (R + R.transpose(-1, -2)) * 0.5
    diag = torch.diagonal(S, dim1=-2, dim2=-1)
    axis_abs = torch.sqrt(((diag - cos_t[..., None]) / one_m_cos[..., None]).clamp(0.0, 1.0))
    # the largest component k is taken positive; a_j = (S[k,j]/(1-cos)) / a_k
    k = torch.argmax(axis_abs, dim=-1, keepdim=True)  # (...,1)
    ak = torch.gather(axis_abs, -1, k).clamp(min=1e-7)
    row_k = torch.gather(S / one_m_cos[..., None, None], -2, k[..., None].expand(*k.shape, 3))[..., 0, :]
    axis = torch.scatter(row_k / ak, -1, k, ak)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True).clamp(min=1e-12)
    # overall sign from the anti-symmetric part (a . anti has the sign of sin t >= 0)
    sgn = torch.where(torch.sum(axis * anti, dim=-1) < 0.0, -1.0, 1.0)
    w_pi = t[..., None] * axis * sgn[..., None]
    return torch.where((t > 2.9)[..., None], w_pi, w_generic)


def right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Jr(w): Exp(w + dw) ~= Exp(w) Exp(Jr dw)."""
    t = _theta(w)
    t2 = t * t
    small = t < _SMALL_ANGLE
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - torch.sin(t)) / (t2 * t))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye - b[..., None, None] * W + c[..., None, None] * (W @ W)


def right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    t = _theta(w)
    t2 = t * t
    small = t < _SMALL_ANGLE
    # 1/t^2 - (1+cos t)/(2 t sin t); series: 1/12 + t^2/720
    sin_t = torch.sin(t)
    safe = torch.where(sin_t.abs() < 1e-10, torch.ones_like(sin_t), sin_t)
    c = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0, 1.0 / t2 - (1.0 + torch.cos(t)) / (2.0 * t * safe)
    )
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + 0.5 * W + c[..., None, None] * (W @ W)


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Jl(w) = Jr(-w)."""
    return right_jacobian(-w)


def left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    return right_jacobian_inv(-w)


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
