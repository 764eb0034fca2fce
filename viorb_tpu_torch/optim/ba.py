"""Batched Levenberg-Marquardt vision bundle adjustment with an explicit
Schur complement over the landmarks (port of viorb_tpu/optim/ba.py's
vision BA; its visual-inertial BAs and the stereo residual are not ported
yet).

  * observations live in a LANDMARK-MAJOR grid (M landmarks x R observation
    slots, validity-masked): every per-landmark quantity (Hll, its inverse,
    the Schur products) is one batched einsum;
  * the pose-pose fill-in is accumulated into a dense (K*6, K*6) reduced
    camera matrix; windows are small (10-20 keyframes), so the reduced
    solve is a tiny Cholesky;
  * Jacobians are analytic (optim/reprojection.py), where the reference
    differentiates the residual with `jax.jacfwd`;
  * Huber weights and chi2 outlier gating between two optimization phases.

The reference buckets per-observation blocks by keyframe with one-hot
matmuls, because scatters serialize on a TPU. Here the same sums are
`index_add_` segment sums; the results (S, b, the update) are the
reference's, the layout is not. On the card `index_add_` adds with atomics,
so sums over a keyframe's observations come in a run-dependent order.

Nothing in `vision_ba` syncs with the host: accept/reject is a
`torch.where`, the Cholesky is `cholesky_ex`. Keyframe indices must lie in
[0, K): `vision_ba` clamps them once (an invalid slot has weight 0, so the
keyframe it names receives zeros).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.geometry.so3 import exp_so3
from viorb_tpu_torch.optim.reprojection import reproj_residual_jacobians_ba
from viorb_tpu_torch.optim.robust import CHI2_MONO_2DOF, huber_weight

_STEREO = "stereo observations (obs.ur) are not ported yet: the vision BA is monocular"


class BAObservations(NamedTuple):
    """Landmark-major observation grid.

    kf_idx: (M,R) int64 observing keyframe slot; uv: (M,R,2) undistorted
    pixels; inv_sigma2: (M,R) per-observation information scale (1/sigma^2
    of the pyramid level); valid: (M,R) bool. ur / ur_valid are the
    reference's stereo fields: anything but None raises."""

    kf_idx: torch.Tensor
    uv: torch.Tensor
    inv_sigma2: torch.Tensor
    valid: torch.Tensor
    ur: Optional[torch.Tensor] = None
    ur_valid: Optional[torch.Tensor] = None

    def chi2_delta2(self) -> float:
        """Per-observation outlier threshold: 5.991 (mono, 2 dof)."""
        if self.ur is not None or self.ur_valid is not None:
            raise NotImplementedError(_STEREO)
        return CHI2_MONO_2DOF

    @property
    def m(self) -> int:
        return self.kf_idx.shape[0]

    @property
    def r(self) -> int:
        return self.kf_idx.shape[1]


class VisionBAState(NamedTuple):
    r_cw: torch.Tensor  # (K,3,3)
    t_cw: torch.Tensor  # (K,3)
    points: torch.Tensor  # (M,3)


def _vision_blocks(state: VisionBAState, obs: BAObservations, cam: PinholeCamera):
    """Residuals and Jacobians on the (M,R) grid for Tcw poses: r (M,R,2),
    Jp (M,R,2,6), Jl (M,R,2,3)."""
    if obs.ur is not None:
        raise NotImplementedError(_STEREO)
    return reproj_residual_jacobians_ba(
        state.r_cw[obs.kf_idx], state.t_cw[obs.kf_idx], state.points[:, None, :], obs.uv, cam
    )


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant): the damped
    SPD landmark blocks are well-conditioned, and the formula is a handful
    of elementwise ops where a batched LU is a library call per block."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    return adj * (1.0 / det)[..., None, None]


def _schur_system(r, Jp, Jl, w, obs: BAObservations, k: int, d: int, lm_lambda):
    """Build the reduced camera system.

    r: (M,R,2), Jp: (M,R,2,D), Jl: (M,R,2,3), w: (M,R) combined weights
    (inv_sigma2 * huber * valid). Returns S (K*D,K*D), b (K*D,), and the
    landmark back-substitution operators Hll_inv (M,3,3), b_l (M,3),
    U (M,R,D,3).

    The Schur fill-in is factorized per landmark: the all-pairs sum
    sum_{r,s} Y_r U_s^T equals (sum_r Y_r)(sum_s U_s)^T with the sums
    bucketed by observing keyframe, so the fill-in is one
    (K*D, M*3) x (M*3, K*D) matmul."""
    m, R = obs.kf_idx.shape
    dev = r.device
    wJp = Jp * w[..., None, None]
    wJl = Jl * w[..., None, None]

    # landmark blocks, multiplicatively damped like the poses
    Hll = torch.einsum("mrci,mrcj->mij", wJl, Jl)
    dmp = lm_lambda * torch.diagonal(Hll, dim1=-2, dim2=-1).clamp(min=1e-6)  # (M,3)
    Hll = Hll + torch.diag_embed(dmp)
    b_l = -torch.einsum("mrci,mrc->mi", wJl, r)
    Hll_inv = _inv3x3(Hll + 1e-8 * torch.eye(3, dtype=r.dtype, device=dev))

    kf = obs.kf_idx.reshape(-1)  # (M*R,)

    def by_keyframe(blocks):  # (M,R,...) -> (K,...), summed per observing keyframe
        out = torch.zeros((k, *blocks.shape[2:]), dtype=r.dtype, device=dev)
        return out.index_add_(0, kf, blocks.reshape(m * R, *blocks.shape[2:]))

    # keyframe of each observation within its landmark's row of K buckets
    slot = (torch.arange(m, device=dev)[:, None] * k + obs.kf_idx).reshape(-1)

    def by_landmark_keyframe(blocks):  # (M,R,D,3) -> (K*D, M*3)
        out = torch.zeros((m * k, d, 3), dtype=r.dtype, device=dev)
        out.index_add_(0, slot, blocks.reshape(m * R, d, 3))
        return out.reshape(m, k, d, 3).permute(1, 2, 0, 3).reshape(k * d, m * 3)

    # pose diagonal blocks and rhs
    s_diag = by_keyframe(torch.einsum("mrci,mrcj->mrij", wJp, Jp))  # (K,D,D)
    b = by_keyframe(-torch.einsum("mrci,mrc->mri", wJp, r))  # (K,D)

    # pose-landmark coupling
    U = torch.einsum("mrci,mrcj->mrij", wJp, Jl)  # (M,R,D,3)
    Y = torch.einsum("mrij,mjk->mrik", U, Hll_inv)  # (M,R,D,3)

    S = -(by_landmark_keyframe(Y) @ by_landmark_keyframe(U).T)
    S = S + torch.block_diag(*s_diag)
    # b_red[a] -= sum_{obs of a} Y b_l
    b = b - by_keyframe(torch.einsum("mrik,mk->mri", Y, b_l))
    return S, b.reshape(k * d), Hll_inv, b_l, U


def _solve_reduced(S, b, fixed_mask_kd, pose_lambda):
    """Damped solve with fixed poses masked out (unit rows/cols).

    Jacobi-preconditioned Cholesky plus one iterative-refinement step: in
    f32 an unscaled factorization of a reduced camera system that mixes
    huge vision information (fx^2-scaled) with tiny curvature along
    near-null directions loses those directions."""
    n = S.shape[0]
    S = S + torch.diag(pose_lambda * torch.diagonal(S).clamp(min=1e-6))
    free = ~fixed_mask_kd
    zero = torch.zeros((), dtype=S.dtype, device=S.device)
    Sm = torch.where(free[:, None] & free[None, :], S, zero)
    Sm = Sm + torch.diag(fixed_mask_kd.to(S.dtype))
    bm = torch.where(free, b, zero)
    # Jacobi scaling: unit diagonal
    dg = torch.sqrt(torch.diagonal(Sm).clamp(min=1e-12))
    Sn = Sm / dg[:, None] / dg[None, :]
    bn = bm / dg
    # cholesky_ex keeps its status on the device (no host sync); a failed
    # factorization yields non-finite steps, which the LM rejects
    L = torch.linalg.cholesky_ex(Sn + 1e-7 * torch.eye(n, dtype=S.dtype, device=S.device))[0]
    y = torch.cholesky_solve(bn[:, None], L)[:, 0]
    # one refinement step on the scaled system
    y = y + torch.cholesky_solve((bn - Sn @ y)[:, None], L)[:, 0]
    return torch.where(free, y / dg, zero)


def _back_substitute(Hll_inv, b_l, U, dx_pose, obs: BAObservations, d: int):
    """delta_lm = Hll^{-1} (b_l - sum_r U_r^T dx[kf_r])."""
    dxp = dx_pose.reshape(-1, d)[obs.kf_idx]  # (M,R,D)
    rhs = b_l - torch.einsum("mrij,mri->mj", U, dxp)
    return torch.einsum("mij,mj->mi", Hll_inv, rhs)


def _vision_cost_and_chi2(state, obs: BAObservations, cam, delta2):
    r, _, _ = _vision_blocks(state, obs, cam)
    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    w = huber_weight(chi2, delta2)
    cost = torch.sum(torch.where(obs.valid, chi2 * w, torch.zeros_like(chi2)))
    return cost, chi2


def _apply_vision_update(state: VisionBAState, dx, dl, k, fixed_lm=None) -> VisionBAState:
    dx = dx.reshape(k, 6)
    dR = exp_so3(dx[:, 3:6])
    r_new = dR @ state.r_cw
    t_new = (dR @ state.t_cw[..., None])[..., 0] + dx[:, :3]
    pts = state.points + dl
    if fixed_lm is not None:
        pts = torch.where(fixed_lm[:, None], state.points, pts)
    return VisionBAState(r_new, t_new, pts)


def vision_ba(
    state: VisionBAState,
    obs: BAObservations,
    cam: PinholeCamera,
    fixed_kf: torch.Tensor,  # (K,) bool
    iters: int = 10,
    fixed_lm: Optional[torch.Tensor] = None,  # (M,) bool
) -> Tuple[VisionBAState, torch.Tensor]:
    """Levenberg-Marquardt vision bundle adjustment over K keyframe poses
    and M landmarks. Returns (state, final per-observation chi2 (M,R))."""
    k = state.r_cw.shape[0]
    d = 6
    delta2 = obs.chi2_delta2()
    obs = obs._replace(kf_idx=obs.kf_idx.clamp(0, k - 1))
    fixed_kd = torch.repeat_interleave(fixed_kf, d)
    lam = torch.full((), 1e-4, dtype=state.points.dtype, device=state.points.device)
    for _ in range(iters):
        r, Jp, Jl = _vision_blocks(state, obs, cam)
        chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        hw = huber_weight(chi2, delta2)
        w = obs.inv_sigma2 * hw * obs.valid.to(r.dtype)
        cost0 = torch.sum(torch.where(obs.valid, chi2 * hw.clamp(max=1.0), torch.zeros_like(chi2)))
        S, b, Hll_inv, b_l, U = _schur_system(r, Jp, Jl, w, obs, k, d, lam)
        dx = _solve_reduced(S, b, fixed_kd, lam)
        dl = _back_substitute(Hll_inv, b_l, U, dx, obs, d)
        cand = _apply_vision_update(state, dx, dl, k, fixed_lm)
        cost1, _ = _vision_cost_and_chi2(cand, obs, cam, delta2)
        accept = cost1 < cost0
        state = VisionBAState(*[torch.where(accept, a, b_) for a, b_ in zip(cand, state)])
        lam = torch.where(accept, (lam * 0.5).clamp(min=1e-6), (lam * 4.0).clamp(max=1e4))
    _, chi2 = _vision_cost_and_chi2(state, obs, cam, delta2)
    return state, chi2


def vision_ba_two_phase(
    state: VisionBAState,
    obs: BAObservations,
    cam: PinholeCamera,
    fixed_kf: torch.Tensor,
    iters1: int = 5,
    iters2: int = 5,
    fixed_lm: Optional[torch.Tensor] = None,
) -> Tuple[VisionBAState, BAObservations]:
    """The two-round scheme: optimize, drop chi2 outliers at 1.5 x 5.991,
    optimize again, gate at 5.991. Returns the state and the observations
    with the surviving `valid` mask."""
    delta2 = obs.chi2_delta2()
    state, chi2 = vision_ba(state, obs, cam, fixed_kf, iters1, fixed_lm)
    obs = obs._replace(valid=obs.valid & (chi2 <= delta2 * 1.5))
    state, chi2 = vision_ba(state, obs, cam, fixed_kf, iters2, fixed_lm)
    obs = obs._replace(valid=obs.valid & (chi2 <= delta2))
    return state, obs
