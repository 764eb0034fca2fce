"""Batched Sim3 RANSAC with Horn's closed form, for loop-closure
verification (port of viorb_tpu/solvers/sim3_solver.py; the reference
ORB-SLAM's Sim3Solver: Horn's absolute orientation from 3
correspondences inside RANSAC).

All hypotheses are solved at once. `sim3_ransac` draws each hypothesis's 3
indices from a `torch.Generator`; `sim3_from_samples` takes given index
triples (the reference's draw, replayed by the tests and the goldens).
With `fix_scale` (stereo and RGB-D, whose maps are metric: the reference
Sim3Solver's bFixScale) every fit is an SE3, s = 1 exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from viorb_tpu_torch.geometry.so3 import quat_to_matrix


class Sim3Result(NamedTuple):
    success: torch.Tensor  # () bool
    s: torch.Tensor  # ()
    r: torch.Tensor  # (3,3) maps frame-2 coordinates into frame 1
    t: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (N,) bool


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool = False):
    """Closed-form Sim3 aligning p2 onto p1, both (...,M,3), M >= 3 (Horn
    1987, the quaternion method): (s (...), R (...,3,3), t (...,3)); s = 1
    exactly with `fix_scale`."""
    c1 = p1.mean(dim=-2)
    c2 = p2.mean(dim=-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    M = q2.transpose(-1, -2) @ q1  # correlation, aligning 2 into 1
    S = [[M[..., i, j] for j in range(3)] for i in range(3)]
    (sxx, sxy, sxz), (syx, syy, syz), (szx, szy, szz) = S
    N = torch.stack(
        [
            torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], dim=-1),
            torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], dim=-1),
            torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], dim=-1),
            torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], dim=-1),
        ],
        dim=-2,
    )
    _, v = torch.linalg.eigh(N)
    R = quat_to_matrix(v[..., :, 3])  # the eigenvector of the largest eigenvalue
    if fix_scale:
        s = torch.ones_like(c1[..., 0])
    else:
        num = torch.sum(q1 * (q2 @ R.transpose(-1, -2)), dim=(-1, -2))
        den = torch.sum(q2 * q2, dim=(-1, -2))
        s = num / den.clamp(min=1e-12)
    t = c1 - s[..., None] * (R @ c2[..., None])[..., 0]
    return s, R, t


def sample_sim3_sets(valid: torch.Tensor, n_hypotheses: int, generator: torch.Generator) -> torch.Tensor:
    """(n_hypotheses,3) int64 row indices, each row drawn without replacement
    from the valid correspondences, on `valid`'s device (the draw runs on
    the generator's). Invalid rows keep a vanishing weight, so too few valid
    rows give degenerate sets instead of an error."""
    p = (valid.to(torch.float32) + 1e-9).to(generator.device).expand(n_hypotheses, -1)
    return torch.multinomial(p, 3, replacement=False, generator=generator).to(valid.device)


def sim3_from_samples(
    p1: torch.Tensor,  # (N,3) points in frame-1 camera coordinates
    p2: torch.Tensor,  # (N,3) the corresponding points in frame 2
    valid: torch.Tensor,  # (N,) bool
    idx: torch.Tensor,  # (H,3) int64 minimal sets
    inlier_th: float = 0.05,
    min_inliers: int = 20,
    fix_scale: bool = False,
) -> Sim3Result:
    """Score every hypothesis by 3D distance relative to depth (the
    reference gates by reprojection chi2; in 3D the distance relative to
    depth), take the first with the most inliers, refit Horn on its inliers
    (outliers replaced by the inlier centroid)."""
    s, R, t = horn_sim3(p1[idx], p2[idx], fix_scale)  # (H,), (H,3,3), (H,3)
    pred = s[:, None, None] * (p2 @ R.transpose(-1, -2)) + t[:, None, :]
    err = torch.linalg.norm(pred - p1, dim=-1)
    scale_ref = torch.linalg.norm(p1, dim=-1).clamp(min=1e-6)
    inls = valid & (err < inlier_th * scale_ref)
    counts = inls.sum(dim=1)
    best = torch.argmax(counts)  # ties: the first hypothesis
    inl = inls[best]
    w = inl.to(p1.dtype)[:, None]
    cnt = inl.sum().clamp(min=3)
    c1 = (p1 * w).sum(dim=0) / cnt
    c2 = (p2 * w).sum(dim=0) / cnt
    s_r, R_r, t_r = horn_sim3(
        torch.where(inl[:, None], p1, c1), torch.where(inl[:, None], p2, c2), fix_scale
    )
    return Sim3Result(success=counts[best] >= min_inliers, s=s_r, r=R_r, t=t_r, inliers=inl)


def sim3_ransac(
    p1: torch.Tensor,
    p2: torch.Tensor,
    valid: torch.Tensor,
    generator: torch.Generator,
    n_hypotheses: int = 128,
    inlier_th: float = 0.05,
    min_inliers: int = 20,
    fix_scale: bool = False,
) -> Sim3Result:
    """Sim3 RANSAC over `n_hypotheses` minimal sets drawn from `generator`."""
    idx = sample_sim3_sets(valid, n_hypotheses, generator)
    return sim3_from_samples(p1, p2, valid, idx, inlier_th, min_inliers, fix_scale)
