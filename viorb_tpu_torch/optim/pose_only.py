"""Pose-only optimizers for tracking (port of viorb_tpu/optim/pose_only.py).

  * vision-only 6-DoF (`pose_optimization_tcw`): Levenberg-Marquardt over
    the observations' Huber-weighted reprojection errors: per iteration a
    6x6 normal system, a damped solve, an SO(3)-exp update kept only if it
    lowers the cost; chi2 5.991 re-gating between rounds;
  * VI 15-DoF (`pose_optimization_vi`): frame j against anchor i with the
    preintegration and bias random-walk edges, an optional marginalized
    prior on i, and the 15x15 marginal information of j for the next
    frame's prior.

Everything stays on the tensors' device with no host sync: the
accept/reject branch is a `torch.where`, the solves and inverses are the
`_ex` variants, which do not read their status back, and the LM loop is
unrolled. The VI LM's vision rows use the analytic navstate Jacobian; its
few IMU, bias and prior rows are differentiated with `torch.func.jacfwd`
at the zero increment, as the reference does with `jax.jacfwd`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from viorb_tpu_torch.geometry.camera import PinholeCamera, project
from viorb_tpu_torch.geometry.so3 import exp_so3
from viorb_tpu_torch.imu.navstate import NavState, select_nav
from viorb_tpu_torch.imu.preintegration import PreintegratedImu
from viorb_tpu_torch.optim.forward_ad import jacfwd
from viorb_tpu_torch.optim.imu_factors import (
    bias_walk_residual,
    preint_residual,
    prior_residual,
    whitener_from_cov,
)
from viorb_tpu_torch.optim.reprojection import (
    Extrinsics,
    reproj_residual_jacobian_tcw,
    reproj_residual_jacobians_navstate,
)
from viorb_tpu_torch.optim.robust import CHI2_MONO_2DOF, CHI2_VI_9DOF, huber_weight


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


# ---------------------------------------------------------------------------
# VI pose optimization (frame j against anchor i)
# ---------------------------------------------------------------------------


class ViPosePrior(NamedTuple):
    """Marginalized prior on the anchor state."""

    state: NavState
    info: torch.Tensor  # (15,15)
    valid: torch.Tensor  # () bool


def _imu_rows(ns_i, ns_j, pre, Lt, gravity, prior, optimize_i: bool):
    """The whitened preintegration residual (9,), the bias-walk residual
    (6,), with their Jacobians w.r.t. delta_i (only when i is optimized)
    and delta_j, and the prior's residual and Jacobian on i, all at zero
    increments by forward-mode differentiation."""
    z15 = torch.zeros(15, dtype=Lt.dtype, device=Lt.device)

    # increments with a leading dim of 1 (imu_factors.py's docstring)
    def ires(di, dj):
        r = Lt @ preint_residual(di[None], dj[None, :9], ns_i, ns_j, pre, gravity)[0]
        return r, r

    def bres(di, dj):
        r = bias_walk_residual(di[None], dj[None], ns_i, ns_j)[0]
        return r, r

    argnums = (0, 1) if optimize_i else (1,)
    J9, r9 = jacfwd(ires, argnums=argnums, has_aux=True)(z15, z15)
    Jb, rb = jacfwd(bres, argnums=argnums, has_aux=True)(z15, z15)
    Jp = rp = None
    if prior is not None and optimize_i:
        def pres(di):
            r = prior_residual(di[None], ns_i, prior.state)[0]
            return r, r

        Jp, rp = jacfwd(pres, has_aux=True)(z15)
    return r9, J9, rb, Jb, rp, Jp


def _vi_frame_system(ns_j, ns_i, obs, cam, ext, pre, Lt, gravity, bias_info_diag, prior, inlier, optimize_i):
    """The normal equations over (delta_i, delta_j): (H_ii, H_ij, H_jj, g_i,
    g_j), the i-blocks None unless i is optimized, and the vision chi2."""
    r_v, J9, _ = reproj_residual_jacobians_navstate(ns_j.p, ns_j.r, obs.points, obs.uv, cam, ext)
    chi2_v = _chi2(r_v, obs)
    w_v = obs.inv_sigma2 * huber_weight(chi2_v, CHI2_MONO_2DOF) * (obs.valid & inlier).to(r_v.dtype)
    J_v = torch.cat([J9, torch.zeros_like(J9[..., :6])], dim=-1)  # (N,2,15): no V / bias columns
    Jw = J_v * w_v[:, None, None]
    H_jj = torch.einsum("nci,ncj->ij", Jw, J_v)
    g_j = -torch.einsum("nci,nc->i", Jw, r_v)

    r9, J9i, rb, Jb, rp, Jp = _imu_rows(ns_i, ns_j, pre, Lt, gravity, prior, optimize_i)
    ihw = huber_weight(r9 @ r9, CHI2_VI_9DOF)
    Wb = bias_info_diag
    Jj, Bj = J9i[-1], Jb[-1]
    H_jj = H_jj + ihw * Jj.T @ Jj + Bj.T @ (Wb[:, None] * Bj)
    g_j = g_j - ihw * Jj.T @ r9 - Bj.T @ (Wb * rb)
    H_ii = H_ij = g_i = None
    if optimize_i:
        Ji, Bi = J9i[0], Jb[0]
        H_ii = ihw * Ji.T @ Ji + Bi.T @ (Wb[:, None] * Bi)
        H_ij = ihw * Ji.T @ Jj + Bi.T @ (Wb[:, None] * Bj)
        g_i = -ihw * Ji.T @ r9 - Bi.T @ (Wb * rb)
        if prior is not None:
            pw = prior.valid.to(r9.dtype)
            H_ii = H_ii + pw * Jp.T @ prior.info @ Jp
            g_i = g_i - pw * Jp.T @ prior.info @ rp
    return H_ii, H_ij, H_jj, g_i, g_j, chi2_v


def _vi_frame_cost(ns_j, ns_i, obs, cam, ext, pre, Lt, gravity, bias_info_diag, prior, inlier):
    """The LM's robust cost at (ns_j, ns_i): vision, preintegration, bias
    walk and prior terms."""
    r_v = reproj_residual_jacobians_navstate(ns_j.p, ns_j.r, obs.points, obs.uv, cam, ext)[0]
    z15 = torch.zeros(15, dtype=r_v.dtype, device=r_v.device)
    r9 = Lt @ preint_residual(z15, z15[:9], ns_i, ns_j, pre, gravity)
    ichi2 = r9 @ r9
    rb = bias_walk_residual(z15, z15, ns_i, ns_j)
    cost = (
        _cost(r_v, obs, obs.valid & inlier)
        + ichi2 * huber_weight(ichi2, CHI2_VI_9DOF).clamp(max=1.0)
        + rb @ (bias_info_diag * rb)
    )
    if prior is not None:
        rp = prior_residual(z15, ns_i, prior.state)
        cost = cost + torch.where(prior.valid, rp @ prior.info @ rp, torch.zeros_like(cost))
    return cost


def _damped_solve(H: torch.Tensor, g: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """(H + lam diag(max(diag H, 1e-6)) + 1e-6 I)^-1 g, no host sync."""
    H = H + lam * torch.diag(torch.diagonal(H).clamp(min=1e-6))
    H.diagonal().add_(1e-6)
    return torch.linalg.solve_ex(H, g)[0]


def pose_optimization_vi(
    ns_j: NavState,
    ns_i: NavState,
    obs: PoseObs,
    cam: PinholeCamera,
    ext: Extrinsics,
    pre: PreintegratedImu,
    gravity: torch.Tensor,
    bias_info_diag: torch.Tensor,
    prior: Optional[ViPosePrior] = None,
    rounds: int = 4,
    iters_per_round: int = 5,
    optimize_i: bool = False,
) -> Tuple[NavState, NavState, torch.Tensor, torch.Tensor]:
    """VI tracking pose optimization of frame j (15-DoF) against anchor i,
    which is optimized too (a 30x30 system) when `optimize_i`.

    Returns (ns_j, ns_i, inlier_mask, marg_info_j): marg_info_j is the 15x15
    information of j after marginalizing i (H_jj - H_ji H_ii^-1 H_ij; H_jj
    when i is fixed), the prior carried to the next frame, undiscounted as
    in the reference."""
    dev, dt = obs.points.device, obs.points.dtype
    Lt = whitener_from_cov(pre.cov)
    inlier = torch.ones(obs.points.shape[0], dtype=torch.bool, device=dev)
    common = (obs, cam, ext, pre, Lt, gravity, bias_info_diag, prior)
    for _ in range(rounds):
        lam = torch.full((), 1e-3, dtype=dt, device=dev)
        # the cost of the current state: after the first iteration of a round,
        # the accepted candidate's (the same state, so the same value)
        cost0 = _vi_frame_cost(ns_j, ns_i, *common, inlier)
        for _ in range(iters_per_round):
            H_ii, H_ij, H_jj, g_i, g_j, _ = _vi_frame_system(ns_j, ns_i, *common, inlier, optimize_i)
            if optimize_i:
                H = torch.cat([torch.cat([H_ii, H_ij], 1), torch.cat([H_ij.T, H_jj], 1)], 0)
                dx = _damped_solve(H, torch.cat([g_i, g_j]), lam)
                cand_i = ns_i.inc_small(dx[:15])
                dj = dx[15:]
            else:
                dj = _damped_solve(H_jj, g_j, lam)
                cand_i = ns_i
            cand_j = ns_j.inc_small(dj)
            cost1 = _vi_frame_cost(cand_j, cand_i, *common, inlier)
            acc = cost1 < cost0
            cost0 = torch.where(acc, cost1, cost0)
            ns_j = select_nav(acc, cand_j, ns_j)
            ns_i = select_nav(acc, cand_i, ns_i)
            lam = torch.where(acc, (lam * 0.5).clamp(min=1e-8), (lam * 4).clamp(max=1e4))
        r_v = reproj_residual_jacobians_navstate(ns_j.p, ns_j.r, obs.points, obs.uv, cam, ext)[0]
        inlier = _chi2(r_v, obs) <= CHI2_MONO_2DOF

    # marginal information of j: H_jj - H_ji H_ii^-1 H_ij
    H_ii, H_ij, H_jj, _, _, _ = _vi_frame_system(ns_j, ns_i, *common, inlier, optimize_i)
    if optimize_i:
        H_ii_inv = torch.linalg.inv_ex(H_ii + 1e-6 * torch.eye(15, dtype=dt, device=dev))[0]
        marg_info = H_jj - H_ij.T @ H_ii_inv @ H_ij
    else:
        marg_info = H_jj
    return ns_j, ns_i, inlier & obs.valid, marg_info
