"""Reprojection residual of the vision Tcw 6-DoF pose (port of
viorb_tpu/optim/reprojection.py::reproj_residual_tcw), with its analytic
Jacobian.

The reference differentiates the residual with `jax.jacfwd` at delta=0.
The port writes that derivative out: with pc = R p + t and
T <- Exp(delta) T, d pc / d rho = I and d pc / d phi = -[pc]x, chained
through d project / d pc. tests/test_torch_pose.py holds it to jacfwd.
"""

from __future__ import annotations

import torch

from viorb_tpu_torch.geometry.camera import PinholeCamera, project, project_jacobian
from viorb_tpu_torch.geometry.so3 import exp_so3, hat


def reproj_residual_tcw(
    delta: torch.Tensor,  # (6,) local increment (rho, phi), T <- Exp(delta) T
    r_cw: torch.Tensor,
    t_cw: torch.Tensor,
    p_w: torch.Tensor,  # (...,3) landmarks
    uv: torch.Tensor,  # (...,2) observations (undistorted pixels)
    cam: PinholeCamera,
) -> torch.Tensor:
    """(...,2) residual project(Exp(delta) T p) - uv."""
    rho, phi = delta[:3], delta[3:]
    dR = exp_so3(phi)
    R = dR @ r_cw
    t = (dR @ t_cw) + rho
    pc = p_w @ R.T + t
    return project(cam, pc) - uv


def reproj_residual_jacobian_tcw(
    r_cw: torch.Tensor,
    t_cw: torch.Tensor,
    p_w: torch.Tensor,  # (N,3)
    uv: torch.Tensor,  # (N,2)
    cam: PinholeCamera,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual (N,2) and its Jacobian (N,2,6) w.r.t. (rho, phi) at
    delta = 0."""
    pc = p_w @ r_cw.T + t_cw
    return project(cam, pc) - uv, _pose_jacobian(cam, pc)[1]


def _pose_jacobian(cam: PinholeCamera, pc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """At camera-frame points pc (...,3): d project / d pc (...,2,3) and its
    chain through d pc / d (rho, phi) = [I, -[pc]x] (...,2,6)."""
    d_pc = torch.cat(
        [torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*pc.shape[:-1], 3, 3), -hat(pc)],
        dim=-1,
    )  # (...,3,6)
    J_proj = project_jacobian(cam, pc)
    return J_proj, J_proj @ d_pc


def reproj_residual_jacobians_ba(
    r_cw: torch.Tensor,  # (...,3,3) pose of each observation's keyframe
    t_cw: torch.Tensor,  # (...,3)
    p_w: torch.Tensor,  # (...,3) landmark of each observation
    uv: torch.Tensor,  # (...,2)
    cam: PinholeCamera,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bundle adjustment's form of `reproj_residual_tcw`, one pose and
    one landmark per observation: the residual (...,2) and its Jacobians at
    zero increment, w.r.t. the pose's (rho, phi) (...,2,6) and w.r.t. the
    landmark (...,2,3) (d pc / d p_w = R)."""
    pc = (r_cw @ p_w[..., None])[..., 0] + t_cw
    J_proj, J_pose = _pose_jacobian(cam, pc)
    return project(cam, pc) - uv, J_pose, J_proj @ r_cw
