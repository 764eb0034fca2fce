"""Sim3 refinement by two-way reprojection (port of
viorb_tpu/optim/sim3_refine.py; the reference ORB-SLAM's
Optimizer::OptimizeSim3: a Sim3 vertex with forward and inverse projection
edges, Huber, inlier re-gating).

Given matched map points seen in two keyframes, each in its own camera
frame, refine S12 (candidate camera -> current camera) so that S12 x2
projects onto the current keyframe's keypoint and S12^-1 x1 onto the
candidate's. LM on the 7-DoF left increment; the Jacobian is
`torch.func.jacfwd` of the batched residuals at a zero increment of shape
(1, 7) broadcast over the points (each point's residual depends on its
own copy of the increment only, so the derivative by the shared one is
its own). Each iteration accepts or rejects on the card: no host sync.
With `fix_scale` the sigma row and column of the normal equations are
pinned (a unit diagonal, a zero gradient), so s stays 1 exactly.
"""

from __future__ import annotations

from typing import Tuple

import torch

from viorb_tpu_torch.geometry.camera import PinholeCamera, project
from viorb_tpu_torch.geometry.so3 import exp_so3
from viorb_tpu_torch.optim.forward_ad import jacfwd
from viorb_tpu_torch.optim.robust import huber_weight

TH2 = 9.21  # chi2 gate of a 2-dof edge pair (the reference uses 10)


def _increment(delta: torch.Tensor, s, r, t):
    """Left increment (..,7) = (rho, phi, sigma) applied to S = (s, r, t)."""
    ds = torch.exp(delta[..., 6])
    dr = exp_so3(delta[..., 3:6])
    return ds * s, dr @ r, ds[..., None] * (dr @ t[..., None])[..., 0] + delta[..., :3]


def _residuals(delta, s, r, t, x1, uv1, x2, uv2, cam: PinholeCamera):
    """delta (1,7) -> forward (N,2) and inverse (N,2) residuals."""
    s_n, r_n, t_n = _increment(delta, s, r, t)  # (1,), (1,3,3), (1,3)
    xf = s_n[:, None] * (x2 @ r_n[0].T) + t_n
    rf = project(cam, xf) - uv1
    s_inv = 1.0 / s_n
    r_inv = r_n[0].T
    t_inv = -s_inv[:, None] * (t_n @ r_n[0])
    xi = s_inv[:, None] * (x1 @ r_inv.T) + t_inv
    ri = project(cam, xi) - uv2
    return rf, ri


def optimize_sim3_reproj(
    s12: torch.Tensor,  # ()
    r12: torch.Tensor,  # (3,3)
    t12: torch.Tensor,  # (3,)
    x1: torch.Tensor,  # (N,3) points in the current camera's frame
    uv1: torch.Tensor,  # (N,2) current keyframe keypoints matched to x2
    x2: torch.Tensor,  # (N,3) points in the candidate camera's frame
    uv2: torch.Tensor,  # (N,2) candidate keypoints matched to x1
    valid: torch.Tensor,  # (N,) bool
    cam: PinholeCamera,
    iters: int = 10,
    fix_scale: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s, r, t, inlier mask) after `iters` LM steps; inliers gated at chi2
    9.21. `fix_scale` keeps s as given (1 for stereo and RGB-D loops)."""
    dev = x1.device
    s = s12.reshape(1).to(torch.float32)
    r = r12[None].to(torch.float32)
    t = t12[None].to(torch.float32)
    w = valid.to(torch.float32)[:, None]
    z7 = torch.zeros(1, 7, dtype=torch.float32, device=dev)
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)
    free = torch.ones(7, dtype=torch.float32, device=dev)
    if fix_scale:
        free[6] = 0.0
    pin = torch.diag(1.0 - free)

    def cost_and_chi2(s, r, t):
        rf, ri = _residuals(z7, s, r, t, x1, uv1, x2, uv2, cam)
        chi2 = (rf * rf).sum(-1) + (ri * ri).sum(-1)
        hw = huber_weight(chi2, TH2)
        return torch.where(valid, chi2 * hw.clamp(max=1.0), torch.zeros_like(chi2)).sum(), chi2

    lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
    for _ in range(iters):
        def res_flat(delta):
            rf, ri = _residuals(delta, s, r, t, x1, uv1, x2, uv2, cam)
            return torch.cat([(rf * w).reshape(-1), (ri * w).reshape(-1)])

        rv = res_flat(z7)
        J = jacfwd(res_flat)(z7).reshape(-1, 7)  # (4N,7)
        H = J.T @ J
        g = -(J.T @ rv)
        H = H + lam * torch.diag(H.diagonal().clamp(min=1e-6))
        if fix_scale:
            H = H * free[:, None] * free[None, :] + pin
            g = g * free
        dx = torch.linalg.solve_ex(H + 1e-8 * eye7, g[:, None])[0][:, 0]
        s_n, r_n, t_n = _increment(dx[None], s, r, t)
        c0, _ = cost_and_chi2(s, r, t)
        c1, _ = cost_and_chi2(s_n, r_n, t_n)
        acc = c1 < c0
        s = torch.where(acc, s_n, s)
        r = torch.where(acc, r_n, r)
        t = torch.where(acc, t_n, t)
        lam = torch.where(acc, (lam * 0.5).clamp(min=1e-8), (lam * 4).clamp(max=1e4))
    _, chi2 = cost_and_chi2(s, r, t)
    return s[0], r[0], t[0], valid & (chi2 <= TH2)
