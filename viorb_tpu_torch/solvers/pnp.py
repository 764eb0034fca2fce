"""Batched PnP RANSAC for relocalization (port of viorb_tpu/solvers/pnp.py).

Each hypothesis solves the 12-parameter projection matrix from 6
correspondences by SVD (DLT-P6P), extracts (R,t) by orthonormalization, and
all hypotheses are scored against all points in one batch; the caller
refines the winner with the pose-only LM.

The reference draws its minimal sets from `jax.random`, a stream PyTorch
cannot replay. Here `sample_pnp_sets` draws them from a `torch.Generator`
and `pnp_from_samples` takes given index sets, so a test can hold the fit
and the scoring to another implementation on the same sets. The batched
12x12 SVD is a library call (`torch.linalg.svd`), as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from viorb_tpu_torch.geometry.camera import PinholeCamera, camera_matrix, project
from viorb_tpu_torch.geometry.so3 import normalize_rotation

MIN_SET = 6


class PnPResult(NamedTuple):
    success: torch.Tensor  # () bool
    r_cw: torch.Tensor  # (3,3)
    t_cw: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (N,) bool


def _dlt_p6p(xw: torch.Tensor, xn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xw (...,6,3) world points, xn (...,6,2) normalized image coords ->
    (R (...,3,3), t (...,3))."""
    ones = torch.ones_like(xw[..., :1])
    zeros = torch.zeros_like(xw[..., :1]).expand(*xw.shape[:-1], 4)
    Xh = torch.cat([xw, ones], dim=-1)  # (...,6,4)
    r1 = torch.cat([Xh, zeros, -xn[..., 0:1] * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (...,12,12)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    P = vt[..., 11, :].reshape(*A.shape[:-2], 3, 4)
    M = P[..., :3]
    # fix scale/sign: det(M) > 0 and ||rows|| ~ 1 (the real cube root)
    det = torch.linalg.det(M)
    s = torch.sign(det) * det.abs().pow(1.0 / 3.0)
    s = torch.where(s.abs() < 1e-12, torch.full_like(s, 1e-12), s)
    M = M / s[..., None, None]
    t = P[..., 3] / s[..., None]
    return normalize_rotation(M), t


def sample_pnp_sets(valid: torch.Tensor, n_hypotheses: int, generator: torch.Generator) -> torch.Tensor:
    """(n_hypotheses, 6) int64 row indices drawn without replacement from
    the valid rows, on `valid`'s device; the draw runs on the generator's
    device. Invalid rows keep a vanishing weight (the reference gives them
    none), so with fewer than 6 valid rows the draw still returns."""
    p = (valid.to(torch.float32) + 1e-9).to(generator.device).expand(n_hypotheses, -1)
    return torch.multinomial(p, MIN_SET, replacement=False, generator=generator).to(valid.device)


def pnp_hypotheses(points, uv, valid, cam: PinholeCamera, idx, inlier_th_px: float = 4.0):
    """Every hypothesis of the minimal sets `idx` (H,6), fitted and scored:
    (scores (H,) int64, R (H,3,3), t (H,3), inliers (H,N) bool)."""
    Kinv = torch.linalg.inv(camera_matrix(cam, points.device, points.dtype))
    xn = (torch.cat([uv, torch.ones_like(uv[:, :1])], 1) @ Kinv.T)[:, :2]
    R, t = _dlt_p6p(points[idx], xn[idx])  # (H,3,3), (H,3)
    pc = points @ R.transpose(-1, -2) + t[:, None, :]  # (H,N,3)
    err = torch.sum((project(cam, pc) - uv) ** 2, dim=-1)
    inl = valid & (pc[..., 2] > 0) & (err < inlier_th_px**2)
    return inl.sum(dim=1), R, t, inl


def pnp_from_samples(points, uv, valid, cam: PinholeCamera, idx, inlier_th_px: float = 4.0) -> PnPResult:
    """`pnp_ransac` on given minimal sets: the best-scoring hypothesis
    (ties to the lowest index, as `jnp.argmax`)."""
    scores, R, t, inl = pnp_hypotheses(points, uv, valid, cam, idx, inlier_th_px)
    best = torch.argmax(scores)
    return PnPResult(success=scores[best] >= 10, r_cw=R[best], t_cw=t[best], inliers=inl[best])


def pnp_ransac(
    points: torch.Tensor,  # (N,3) world
    uv: torch.Tensor,  # (N,2) undistorted pixels
    valid: torch.Tensor,  # (N,) bool
    cam: PinholeCamera,
    generator: torch.Generator,
    n_hypotheses: int = 256,
    inlier_th_px: float = 4.0,
) -> PnPResult:
    idx = sample_pnp_sets(valid, n_hypotheses, generator)
    return pnp_from_samples(points, uv, valid, cam, idx, inlier_th_px)
