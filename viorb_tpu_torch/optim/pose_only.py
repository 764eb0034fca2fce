"""Vision-only 6-DoF pose optimization for tracking (port of
viorb_tpu/optim/pose_only.py::pose_optimization_tcw).

Levenberg-Marquardt over the observations' Huber-weighted reprojection
errors: per iteration a 6x6 normal system, a damped solve, an SO(3)-exp
update kept only if it lowers the cost; chi2 5.991 re-gating between
rounds. Everything stays on the tensors' device with no host sync: the
accept/reject branch is a `torch.where`, and the 6x6 solve does not read
its status back.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from viorb_tpu_torch.geometry.camera import PinholeCamera, project
from viorb_tpu_torch.geometry.so3 import exp_so3
from viorb_tpu_torch.optim.reprojection import reproj_residual_jacobian_tcw
from viorb_tpu_torch.optim.robust import CHI2_MONO_2DOF, huber_weight


class PoseObs(NamedTuple):
    """Per-frame pose-only observations: matched map points + keypoints.

    points: (N,3) world; uv: (N,2) undistorted pixels; inv_sigma2: (N,);
    valid: (N,) bool."""

    points: torch.Tensor
    uv: torch.Tensor
    inv_sigma2: torch.Tensor
    valid: torch.Tensor


def _chi2(r: torch.Tensor, obs: PoseObs) -> torch.Tensor:
    return torch.sum(r * r, dim=-1) * obs.inv_sigma2


def _cost(r: torch.Tensor, obs: PoseObs, active: torch.Tensor) -> torch.Tensor:
    c2 = _chi2(r, obs)
    h = huber_weight(c2, CHI2_MONO_2DOF)
    return torch.sum(torch.where(active, c2 * h.clamp(max=1.0), torch.zeros_like(c2)))


def _residual(r_cw, t_cw, obs: PoseObs, cam: PinholeCamera) -> torch.Tensor:
    return project(cam, obs.points @ r_cw.T + t_cw) - obs.uv


def _damped_step(H: torch.Tensor, g: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """dx of the LM's damped 6x6 normal system (H + lam diag(H)) dx = g.
    `solve_ex` leaves its error flag on the device; `torch.linalg.solve`
    would read it back, a host sync on every iteration (and a refusal
    inside a CUDA graph capture)."""
    H = H + lam * torch.diag(torch.diagonal(H).clamp(min=1e-6))
    H.diagonal().add_(1e-8)  # in place on the damped copy: H + 1e-8 I
    return torch.linalg.solve_ex(H, g)[0]


def pose_optimization_tcw(
    r_cw: torch.Tensor,
    t_cw: torch.Tensor,
    obs: PoseObs,
    cam: PinholeCamera,
    rounds: int = 4,
    iters_per_round: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (r_cw, t_cw, inlier_mask): `rounds` x `iters_per_round` LM
    iterations with chi2 5.991 re-gating between rounds."""
    dev, dt = r_cw.device, r_cw.dtype
    inlier = torch.ones(obs.points.shape[0], dtype=torch.bool, device=dev)
    for _ in range(rounds):
        lam = torch.full((), 1e-4, dtype=dt, device=dev)
        active = obs.valid & inlier
        for _ in range(iters_per_round):
            r, J = reproj_residual_jacobian_tcw(r_cw, t_cw, obs.points, obs.uv, cam)
            chi2 = _chi2(r, obs)
            w = obs.inv_sigma2 * huber_weight(chi2, CHI2_MONO_2DOF) * active.to(dt)
            Jw = J * w[:, None, None]
            H = torch.einsum("nci,ncj->ij", Jw, J)
            g = -torch.einsum("nci,nc->i", Jw, r)
            dx = _damped_step(H, g, lam)
            dR = exp_so3(dx[3:6])
            r_new = dR @ r_cw
            t_new = dR @ t_cw + dx[:3]
            # accept if the cost decreases
            c0 = _cost(r, obs, active)
            c1 = _cost(_residual(r_new, t_new, obs, cam), obs, active)
            acc = c1 < c0
            r_cw = torch.where(acc, r_new, r_cw)
            t_cw = torch.where(acc, t_new, t_cw)
            lam = torch.where(acc, (lam * 0.5).clamp(min=1e-8), (lam * 4).clamp(max=1e4))
        inlier = _chi2(_residual(r_cw, t_cw, obs, cam), obs) <= CHI2_MONO_2DOF
    return r_cw, t_cw, inlier & obs.valid
