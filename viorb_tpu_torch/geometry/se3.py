"""Batched SE(3) operations (port of viorb_tpu/geometry/se3.py). Pose
convention: world->camera T = (R, t) with x_cam = R @ x_world + t, kept as
a pair of tensors rather than a 4x4.
"""

from __future__ import annotations

from typing import Tuple

import torch

from viorb_tpu_torch.geometry.so3 import exp_so3, left_jacobian, left_jacobian_inv, log_so3


def make_se3(R: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return R, t


def se3_compose(
    Ra: torch.Tensor, ta: torch.Tensor, Rb: torch.Tensor, tb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Ta * Tb): apply Tb first, then Ta."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_inverse(R: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    Rinv = R.transpose(-1, -2)
    return Rinv, -(Rinv @ t[..., None])[..., 0]


def se3_apply(R: torch.Tensor, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x: (...,3) points."""
    return (R @ x[..., None])[..., 0] + t


def exp_se3(xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xi = (rho, phi): (...,6) -> (R, t) with t = Jl(phi) rho."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return exp_so3(phi), (left_jacobian(phi) @ rho[..., None])[..., 0]


def log_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    phi = log_so3(R)
    rho = (left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R,t) -> (...,4,4) homogeneous matrix (IO only)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)
