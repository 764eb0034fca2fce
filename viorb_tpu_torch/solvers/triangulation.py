"""Batched linear triangulation (port of
viorb_tpu/solvers/triangulation.py): one batched solve over all candidate
pairs.
"""

from __future__ import annotations

import torch


def triangulate_two_view(
    P1: torch.Tensor,  # (...,3,4) projection matrix K[R|t] or normalized [R|t]
    P2: torch.Tensor,
    x1: torch.Tensor,  # (...,2) pixel (or normalized) coords in view 1
    x2: torch.Tensor,
) -> torch.Tensor:
    """DLT triangulation; the leading dimensions broadcast. Returns (...,3)
    world points: the right singular
    vector of the smallest singular value of the 4x4 homogeneous system,
    dehomogenized (its sign cancels there). The batched SVD is a library
    call, as in the reference."""
    rows = torch.stack(
        torch.broadcast_tensors(
            x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ),
        dim=-2,
    )  # (...,4,4)
    _, _, vt = torch.linalg.svd(rows)
    X = vt[..., 3, :]
    w = X[..., 3]
    w = torch.where(w.abs() < 1e-10, torch.full_like(w, 1e-10), w)
    return X[..., :3] / w[..., None]


def projection_matrix(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """K (3,3), R (...,3,3), t (...,3) -> (...,3,4)."""
    return K @ torch.cat([R, t[..., None]], dim=-1)


def parallax_cos(c1: torch.Tensor, c2: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """cos of the ray angle at X between camera centers c1, c2 (...,3)."""
    r1 = X - c1
    r2 = X - c2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    return torch.sum(r1 * r2, dim=-1) / (n1 * n2).clamp(min=1e-12)
