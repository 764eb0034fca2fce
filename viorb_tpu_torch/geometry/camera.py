"""Pinhole camera with radial-tangential distortion (port of
viorb_tpu/geometry/camera.py). Batched over leading dims.

The camera stays a NamedTuple of Python numbers, as in the reference, so
the same fields build both (interop.camera_from_fields).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PinholeCamera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 752
    height: int = 480


def camera_matrix(cam: PinholeCamera, device, dtype=torch.float32) -> torch.Tensor:
    """The 3x3 intrinsic matrix K as a tensor on `device` (the reference's
    `cam.K`). Built from Python numbers: a host-to-device copy, so not for
    a per-frame path."""
    return torch.tensor(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]], dtype=dtype, device=device
    )


def has_distortion(cam: PinholeCamera) -> bool:
    """False for an ideal pinhole. Its distortion is then the identity,
    exactly (x * 1 + 0 in f32), so the maps below skip the arithmetic:
    each op is a kernel launch on the device."""
    return any((cam.k1, cam.k2, cam.p1, cam.p2, cam.k3))


def distort(cam: PinholeCamera, xn: torch.Tensor) -> torch.Tensor:
    """Normalized coords (...,2) -> distorted normalized coords (...,2)."""
    if not has_distortion(cam):
        return xn
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xy = x * y
    xd = x * radial + 2.0 * cam.p1 * xy + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * xy
    return torch.stack([xd, yd], dim=-1)


def distort_jacobian(cam: PinholeCamera, xn: torch.Tensor) -> torch.Tensor:
    """d distort / d xn at xn (...,2) -> (...,2,2)."""
    if not has_distortion(cam):
        return torch.eye(2, dtype=xn.dtype, device=xn.device).expand(*xn.shape[:-1], 2, 2)
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    d_radial = cam.k1 + r2 * (2.0 * cam.k2 + 3.0 * cam.k3 * r2)  # d radial / d r2
    dxx = radial + 2.0 * x * x * d_radial + 2.0 * cam.p1 * y + 6.0 * cam.p2 * x
    dxy = 2.0 * x * y * d_radial + 2.0 * cam.p1 * x + 2.0 * cam.p2 * y
    dyy = radial + 2.0 * y * y * d_radial + 6.0 * cam.p1 * y + 2.0 * cam.p2 * x
    return torch.stack(
        [torch.stack([dxx, dxy], dim=-1), torch.stack([dxy, dyy], dim=-1)], dim=-2
    )


def _safe_depth(z: torch.Tensor) -> torch.Tensor:
    # the reference's zsafe rule: |z| < 1e-6 projects as if z were 1e-6
    return torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)


def project(cam: PinholeCamera, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (...,3) -> pixel coords (...,2). No validity
    check; the caller gates on depth."""
    zsafe = _safe_depth(pc[..., 2])
    xn = pc[..., :2] / zsafe[..., None]
    xd = distort(cam, xn)
    return torch.stack(
        [cam.fx * xd[..., 0] + cam.cx, cam.fy * xd[..., 1] + cam.cy], dim=-1
    )


def project_jacobian(cam: PinholeCamera, pc: torch.Tensor) -> torch.Tensor:
    """d project / d pc at pc (...,3) -> (...,2,3), the derivative of
    `project` including its zsafe branch (no depth derivative there)."""
    z = pc[..., 2]
    clamped = z.abs() < 1e-6
    zsafe = _safe_depth(z)
    inv_z = 1.0 / zsafe
    xn = pc[..., :2] * inv_z[..., None]
    zero = torch.zeros_like(z)
    dz = torch.where(clamped[..., None], zero[..., None], -xn * inv_z[..., None])
    dxn = torch.stack(
        [
            torch.stack([inv_z, zero, dz[..., 0]], dim=-1),
            torch.stack([zero, inv_z, dz[..., 1]], dim=-1),
        ],
        dim=-2,
    )  # (...,2,3)
    J = distort_jacobian(cam, xn) @ dxn
    # scale by Python floats: a tensor built from them would be a
    # host-to-device copy, which synchronises on every call
    return torch.stack([cam.fx * J[..., 0, :], cam.fy * J[..., 1, :]], dim=-2)


def depth_mask(pc: torch.Tensor, min_depth: float = 0.05) -> torch.Tensor:
    """Camera-frame points (...,3) in front of the camera: z > min_depth."""
    return pc[..., 2] > min_depth


def pixel_to_normalized(cam: PinholeCamera, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (...,2) -> distorted normalized coords."""
    return torch.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1
    )


def undistort_points(cam: PinholeCamera, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Undistort pixel keypoints (...,2) -> undistorted pixel coords, by
    fixed-point inversion of the distortion."""
    xd = pixel_to_normalized(cam, uv)
    x = xd
    for _ in range(iters if has_distortion(cam) else 0):
        # x_{k+1} = xd - (distort(x_k) - x_k)
        x = xd - (distort(cam, x) - x)
    return torch.stack(
        [cam.fx * x[..., 0] + cam.cx, cam.fy * x[..., 1] + cam.cy], dim=-1
    )


def in_image_mask(cam: PinholeCamera, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < cam.width - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < cam.height - margin)
    )
