"""Batched Sim(3) ops (port of viorb_tpu/geometry/sim3.py), for the loop
closer's geometric verification and the essential-graph optimization
(reference: g2o's sim3.h, used by ORB-SLAM's LoopClosing and
Optimizer::OptimizeEssentialGraph).

A Sim3 is (s, R, t): x' = s * R @ x + t. Every function takes arbitrary
leading batch dimensions: s (...,), R (...,3,3), t (...,3).
"""

from __future__ import annotations

from typing import Tuple

import torch

from viorb_tpu_torch.geometry.so3 import exp_so3, hat, log_so3

Sim3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (s (...), R (...,3,3), t (...,3))


def sim3_compose(sa, ra, ta, sb, rb, tb) -> Sim3:
    """Sa * Sb (Sb applied first)."""
    return sa * sb, ra @ rb, sa[..., None] * (ra @ tb[..., None])[..., 0] + ta


def sim3_inverse(s, r, t) -> Sim3:
    r_inv = r.transpose(-1, -2)
    s_inv = 1.0 / s
    return s_inv, r_inv, -s_inv[..., None] * (r_inv @ t[..., None])[..., 0]


def sim3_apply(s, r, t, x) -> torch.Tensor:
    return s[..., None] * (r @ x[..., None])[..., 0] + t


def _sim3_v(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim3 left-Jacobian block V(phi, sigma) (...,3,3), with
    t_out = V @ rho: V = A I + B W + C W^2 (Strasdat's closed form). The
    general coefficients cancel catastrophically in f32 below theta ~ 1e-3
    and sigma ~ 1e-4, where the series take over. Every branch divides by a
    guarded denominator, so the branch NOT selected stays finite (its
    forward-mode tangent too)."""
    es = torch.exp(sigma)
    t_norm = torch.sqrt(torch.sum(phi * phi, dim=-1) + 1e-30)
    W = hat(phi)
    W2 = W @ W
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    small_theta = t_norm < 1e-3
    small_sigma = sigma.abs() < 1e-4
    one = torch.ones_like(sigma)
    t2 = t_norm * t_norm
    sig = sigma

    A = torch.where(small_sigma, 1.0 + 0.5 * sig, (es - 1.0) / torch.where(small_sigma, one, sig))
    cos_t, sin_t = torch.cos(t_norm), torch.sin(t_norm)
    denom = sig * sig + t2
    # general case (sigma != 0, theta != 0)
    a_gen = es * sin_t
    b_gen = es * cos_t
    safe_denom = torch.where(small_theta, one, denom)
    B_gen = (a_gen * sig + (1.0 - b_gen) * t_norm) / torch.where(small_theta, one, t_norm * safe_denom)
    C_gen = (A - ((b_gen - 1.0) * sig + a_gen * t_norm) / safe_denom) / torch.where(small_theta, one, t2)
    # sigma ~ 0, theta != 0: the SE3 left-Jacobian coefficients
    B_se3 = (1.0 - cos_t) / torch.where(small_theta, one, t2)
    C_se3 = (t_norm - sin_t) / torch.where(small_theta, one, t2 * t_norm)
    # theta ~ 0, any sigma
    B_small = torch.where(
        small_sigma, 0.5 + sig / 6.0, ((sig - 1.0) * es + 1.0) / torch.where(small_sigma, one, sig * sig)
    )
    C_small = torch.where(
        small_sigma,
        1.0 / 6.0 + sig / 24.0,
        (es * 0.5 * sig * sig + es - 1.0 - sig * es) / torch.where(small_sigma, one, sig * sig * sig),
    )
    B = torch.where(small_theta, B_small, torch.where(small_sigma, B_se3, B_gen))
    C = torch.where(small_theta, C_small, torch.where(small_sigma, C_se3, C_gen))
    return A[..., None, None] * eye + B[..., None, None] * W + C[..., None, None] * W2


def exp_sim3(xi: torch.Tensor) -> Sim3:
    """xi = (rho, phi, sigma) (...,7) -> (s, R, t), s = exp(sigma)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    V = _sim3_v(phi, sigma)
    return torch.exp(sigma), exp_so3(phi), (V @ rho[..., None])[..., 0]


def _solve3(V: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """V^-1 b for (...,3,3) V and (...,3) b by Cramer's rule: products and
    sums only (no factorization call, nothing to sync, cheap to
    differentiate forward); V here is well conditioned (close to I)."""
    c0 = torch.linalg.cross(V[..., :, 1], V[..., :, 2], dim=-1)
    c1 = torch.linalg.cross(V[..., :, 2], V[..., :, 0], dim=-1)
    c2 = torch.linalg.cross(V[..., :, 0], V[..., :, 1], dim=-1)
    det = (V[..., :, 0] * c0).sum(-1)
    return torch.stack([(c0 * b).sum(-1), (c1 * b).sum(-1), (c2 * b).sum(-1)], dim=-1) / det[..., None]


def log_sim3(s, r, t) -> torch.Tensor:
    """Inverse of exp_sim3: (...,7), rho from the tiny solve V rho = t."""
    phi = log_so3(r)
    sigma = torch.log(s)
    rho = _solve3(_sim3_v(phi, sigma), t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
