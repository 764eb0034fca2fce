"""Reprojection residuals of the two pose parameterizations (port of
viorb_tpu/optim/reprojection.py), with their analytic Jacobians.

  * vision Tcw 6-DoF: with pc = R p + t and T <- Exp(delta) T,
    d pc / d rho = I and d pc / d phi = -[pc]x;
  * VI NavState (body pose p, R; body-camera extrinsics Tbc): with
    pb = R^T (p_w - p), pc = Rbc^T (pb - p_bc), p <- p + dp and
    R <- R Exp(dphi), d pc / d dp = -Rbc^T R^T, d pc / d dphi = Rbc^T [pb]x,
    d pc / d p_w = Rbc^T R^T; the velocity columns are zero, as in the
    reference's PVR edge.

Each is chained through d project / d pc. The stereo Tcw residual adds a
third row u_l - bf / z - u_r (the reference's EdgeStereoSE3ProjectXYZ,
with z clamped at 1e-6), d / d pc = d u_l / d pc + (0, 0, bf / z^2). The
reference differentiates the residuals with `jax.jacfwd` at delta = 0;
tests/test_torch_pose.py, tests/test_torch_vi_optim.py and
tests/test_torch_stereo_ba.py hold the analytic forms to it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from viorb_tpu_torch.geometry.camera import PinholeCamera, project, project_jacobian
from viorb_tpu_torch.geometry.so3 import exp_so3, hat


class Extrinsics(NamedTuple):
    """Tbc: the camera pose in the body (IMU) frame, x_b = r_bc @ x_c + p_bc."""

    r_bc: torch.Tensor  # (3,3)
    p_bc: torch.Tensor  # (3,)


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


def reproj_residual_jacobians_ba_stereo(
    r_cw: torch.Tensor,  # (...,3,3) pose of each observation's keyframe
    t_cw: torch.Tensor,  # (...,3)
    p_w: torch.Tensor,  # (...,3) landmark of each observation
    uv: torch.Tensor,  # (...,2) left observation
    ur: torch.Tensor,  # (...) right u
    ur_valid: torch.Tensor,  # (...) bool: the observation has a stereo match
    cam: PinholeCamera,
    bf: float,  # fx * baseline
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`reproj_residual_jacobians_ba` with the stereo row: the residual
    (...,3) (u_l, v_l, u_l - bf / max(z, 1e-6) - u_r) and its Jacobians
    (...,3,6) and (...,3,3) at zero increment; the third row is zero, with
    its Jacobian, where `ur_valid` is False."""
    pc = (r_cw @ p_w[..., None])[..., 0] + t_cw
    J_proj = project_jacobian(cam, pc)
    uv_hat = project(cam, pc)
    z = pc[..., 2]
    zc = z.clamp(min=1e-6)
    mask = ur_valid.to(pc.dtype)
    r3 = (uv_hat[..., 0] - bf / zc - ur) * mask
    dz = torch.where(z > 1e-6, bf / (zc * zc), torch.zeros_like(z))  # d(-bf / z) / dz
    J3 = J_proj[..., 0, :] + torch.stack([torch.zeros_like(z), torch.zeros_like(z), dz], dim=-1)
    J_pc = torch.cat([J_proj, (J3 * mask[..., None])[..., None, :]], dim=-2)  # (...,3,3)
    d_pc = torch.cat(
        [torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*pc.shape[:-1], 3, 3), -hat(pc)], dim=-1
    )
    r = torch.cat([uv_hat - uv, r3[..., None]], dim=-1)
    return r, J_pc @ d_pc, J_pc @ r_cw


def reproj_residual_navstate(
    delta_pose: torch.Tensor,  # (...,9) (dP, dV, dPhi) increment on the NavState's P, V, R
    delta_lm: torch.Tensor,  # (...,3) landmark increment
    p_wb: torch.Tensor,
    r_wb: torch.Tensor,
    p_w: torch.Tensor,  # (...,3)
    uv: torch.Tensor,  # (...,2)
    cam: PinholeCamera,
    ext: Extrinsics,
) -> torch.Tensor:
    """Body-frame projection residual (...,2); the velocity part of the
    increment is unused. With a leading dim on the increments, everything
    broadcasts against it (imu_factors.py says why forward-mode AD wants
    one)."""
    p = p_wb + delta_pose[..., 0:3]
    R = r_wb @ exp_so3(delta_pose[..., 6:9])
    pb = (p_w + delta_lm - p) @ R
    pc = (pb - ext.p_bc) @ ext.r_bc
    return project(cam, pc) - uv


def reproj_residual_jacobians_navstate(
    p_wb: torch.Tensor,  # (...,3) body position of each observation's state
    r_wb: torch.Tensor,  # (...,3,3)
    p_w: torch.Tensor,  # (...,3) landmark of each observation
    uv: torch.Tensor,  # (...,2)
    cam: PinholeCamera,
    ext: Extrinsics,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`reproj_residual_navstate` at zero increment (...,2), its Jacobian
    w.r.t. the state's (dP, dV, dPhi) (...,2,9) and w.r.t. the landmark
    (...,2,3)."""
    r_wb_t = r_wb.transpose(-1, -2)
    pb = (r_wb_t @ (p_w - p_wb)[..., None])[..., 0]
    r_cb = ext.r_bc.T
    pc = (r_cb @ (pb - ext.p_bc)[..., None])[..., 0]
    J_proj = project_jacobian(cam, pc)  # (...,2,3)
    J_cb = J_proj @ r_cb  # d res / d pb
    J_lm = J_cb @ r_wb_t
    J_phi = J_cb @ hat(pb)
    J_pose = torch.cat([-J_lm, torch.zeros_like(J_lm), J_phi], dim=-1)
    return project(cam, pc) - uv, J_pose, J_lm
