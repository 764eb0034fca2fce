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
    r = project(cam, pc) - uv
    d_pc = torch.cat(
        [torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3), -hat(pc)],
        dim=-1,
    )  # (N,3,6)
    return r, project_jacobian(cam, pc) @ d_pc
