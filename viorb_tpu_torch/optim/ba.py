"""Batched Levenberg-Marquardt bundle adjustment with an explicit Schur
complement over the landmarks (port of viorb_tpu/optim/ba.py: the vision
BA, monocular or stereo, the visual-inertial BA and the VI BA with a free
gravity direction).

  * observations live in a LANDMARK-MAJOR grid (M landmarks x R observation
    slots, validity-masked): every per-landmark quantity (Hll, its inverse,
    the Schur products) is one batched einsum;
  * the pose-pose fill-in is accumulated into a dense (K*6, K*6) reduced
    camera matrix; windows are small (10-20 keyframes), so the reduced
    solve is a tiny Cholesky;
  * Jacobians of the reprojection rows are analytic (optim/reprojection.py),
    where the reference differentiates the residual with `jax.jacfwd`: 2
    rows an observation, or 3 in a stereo problem (the right u; zero where
    an observation has no stereo match), with chi2 gates of 5.991 / 7.815
    by observation; the
    few IMU rows (one per keyframe edge) are differentiated with
    `torch.func.jacfwd`, vmapped over the edges, as the reference does;
  * the VI BAs add the preintegration and bias random-walk edges of an
    `ImuChain` to the same reduced system at block size 15, and the
    gravity-vertex BA appends a 2-DoF gravity-direction block;
  * Huber weights and chi2 outlier gating between two optimization phases.

The per-keyframe sums over the observations are one-hot matmuls, as the
reference buckets them: a GEMM adds in an order fixed by its shapes, where
`index_add_`'s float atomics on the card add a keyframe's thousands of
blocks in a run-dependent order, and a whole SLAM run would then differ
from run to run. The IMU chain's edges go into their keyframes' slots by
one-hot GEMMs too (the global BAs' multi-stride edges give a keyframe many
edges). The one sum that stays `index_add_` is order-free: each (landmark,
keyframe) slot receives one nonzero block. So a BA on the card gives the
same bits every run.

Nothing in the BAs syncs with the host: accept/reject is a
`torch.where`, the Cholesky is `cholesky_ex`. Keyframe indices must lie in
[0, K): each BA clamps them once (an invalid slot has weight 0, so the
keyframe it names receives zeros).

The local BAs run as CUDA graphs, the port's counterpart of the reference's
one compiled program a shape: `make_local_vision_ba` / `make_local_vi_ba`
wrap the two-phase solves in a `cuda_graph.GraphedFunction`, and a caller
pads the pose block to `pose_bucket(K)` (4, then 20, then multiples of 8),
as the reference pads it, so a window plus its anchors (at most 20
keyframes) replays one of two graphs (a stereo pipeline has its own graphs, keyed by `bf`). A padded slot is a fixed identity
pose that no observation names (and, in the VI BA, no valid edge): the
reduced system gives it a unit row, and the solve of the other slots is the
same as without it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from torch.func import vmap

from viorb_tpu_torch.cuda_graph import GraphedFunction
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.geometry.so3 import exp_so3
from viorb_tpu_torch.imu.navstate import NavState, select_nav
from viorb_tpu_torch.imu.preintegration import PreintegratedImu
from viorb_tpu_torch.optim.forward_ad import jacfwd
from viorb_tpu_torch.optim.imu_factors import bias_walk_residual, preint_residual, whitener_from_cov
from viorb_tpu_torch.optim.reprojection import (
    Extrinsics,
    reproj_residual_jacobians_ba,
    reproj_residual_jacobians_ba_stereo,
    reproj_residual_jacobians_navstate,
)
from viorb_tpu_torch.optim.robust import CHI2_MONO_2DOF, CHI2_STEREO_3DOF, CHI2_VI_9DOF, huber_weight

GRAPHED_MAX_POSES = 20  # the largest pose bucket of a local BA: windows and anchors replay a graph up to it
_GRAPHS: dict = {}  # the process-wide local-BA graphs, by kind and camera


def pose_bucket(n: int) -> int:
    """The BA pose count a problem of n poses is padded to (the reference's
    `viorb_tpu/slam/mono.py::_pose_bucket`): 4 (two-view init), 20 (any
    local window: 10 keyframes + up to 8 anchors), then multiples of 8 (the
    global BA, which grows with the map). One graph a bucket."""
    if n <= 4:
        return 4
    if n <= 20:
        return 20
    return (n + 7) & ~7


class BAObservations(NamedTuple):
    """Landmark-major observation grid.

    kf_idx: (M,R) int64 observing keyframe slot; uv: (M,R,2) undistorted
    pixels; inv_sigma2: (M,R) per-observation information scale (1/sigma^2
    of the pyramid level); valid: (M,R) bool. Stereo (both set together):
    ur (M,R) f32 right-image u and ur_valid (M,R) bool; an observation with
    ur_valid gets the 3-row stereo residual (the vision BA's `bf`)."""

    kf_idx: torch.Tensor
    uv: torch.Tensor
    inv_sigma2: torch.Tensor
    valid: torch.Tensor
    ur: Optional[torch.Tensor] = None
    ur_valid: Optional[torch.Tensor] = None

    def chi2_delta2(self):
        """Per-observation outlier threshold: 5.991 (mono, 2 dof), or an
        (M,R) tensor of 7.815 (stereo, 3 dof) where ur_valid, else 5.991."""
        if self.ur_valid is None:
            return CHI2_MONO_2DOF
        return torch.where(self.ur_valid, torch.full_like(self.ur, CHI2_STEREO_3DOF),
                           torch.full_like(self.ur, CHI2_MONO_2DOF))

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


def _vision_blocks(state: VisionBAState, obs: BAObservations, cam: PinholeCamera, bf: Optional[float] = None):
    """Residuals and Jacobians on the (M,R) grid for Tcw poses: r (M,R,C),
    Jp (M,R,C,6), Jl (M,R,C,3), C = 2, or 3 with stereo observations (bf =
    fx * baseline; None reads 0, as in the reference)."""
    r_cw, t_cw, pts = state.r_cw[obs.kf_idx], state.t_cw[obs.kf_idx], state.points[:, None, :]
    if obs.ur is None:
        return reproj_residual_jacobians_ba(r_cw, t_cw, pts, obs.uv, cam)
    return reproj_residual_jacobians_ba_stereo(r_cw, t_cw, pts, obs.uv, obs.ur, obs.ur_valid, cam, bf or 0.0)


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

    # the observing keyframe of each observation, one-hot (K, M*R)
    onehot = (obs.kf_idx.reshape(1, -1) == torch.arange(k, device=dev)[:, None]).to(r.dtype)

    def by_keyframe(blocks):  # (M,R,...) -> (K,...), summed per observing keyframe
        return (onehot @ blocks.reshape(m * R, -1)).reshape(k, *blocks.shape[2:])

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


def _vision_cost_and_chi2(state, obs: BAObservations, cam, delta2, bf: Optional[float] = None):
    r, _, _ = _vision_blocks(state, obs, cam, bf)
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


Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _summed(reduce: Reduce, *parts):
    """`parts` summed over the ranks of a landmark-sharded solve by ONE call
    of `reduce` (the sum of a flat tensor over the ranks) on their packed
    concatenation; as they are when `reduce` is None (one process)."""
    if reduce is None:
        return parts
    flat = reduce(torch.cat([p.reshape(-1) for p in parts]))
    out, at = [], 0
    for p in parts:
        out.append(flat[at: at + p.numel()].reshape(p.shape))
        at += p.numel()
    return out


def vision_ba(
    state: VisionBAState,
    obs: BAObservations,
    cam: PinholeCamera,
    fixed_kf: torch.Tensor,  # (K,) bool
    iters: int = 10,
    fixed_lm: Optional[torch.Tensor] = None,  # (M,) bool
    bf: Optional[float] = None,  # fx * baseline, for stereo observations
    reduce: Reduce = None,
) -> Tuple[VisionBAState, torch.Tensor]:
    """Levenberg-Marquardt vision bundle adjustment over K keyframe poses
    and M landmarks. Returns (state, final per-observation chi2 (M,R)).
    With stereo observations (obs.ur set), pass bf = fx * baseline.

    `reduce` sums a flat tensor over the ranks of a landmark-sharded solve
    (`parallel.distributed_ba`): `state.points` and `obs` are then this
    rank's landmark rows, the reduced system and the current cost are summed
    by one call an iteration and the candidate's cost by one more, and every
    rank solves, accepts and damps alike; the chi2 returned is this rank's
    rows'."""
    k = state.r_cw.shape[0]
    d = 6
    delta2 = obs.chi2_delta2()
    obs = obs._replace(kf_idx=obs.kf_idx.clamp(0, k - 1))
    fixed_kd = torch.repeat_interleave(fixed_kf, d)
    lam = torch.full((), 1e-4, dtype=state.points.dtype, device=state.points.device)
    for _ in range(iters):
        r, Jp, Jl = _vision_blocks(state, obs, cam, bf)
        chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        hw = huber_weight(chi2, delta2)
        w = obs.inv_sigma2 * hw * obs.valid.to(r.dtype)
        cost0 = torch.sum(torch.where(obs.valid, chi2 * hw.clamp(max=1.0), torch.zeros_like(chi2)))
        S, b, Hll_inv, b_l, U = _schur_system(r, Jp, Jl, w, obs, k, d, lam)
        S, b, cost0 = _summed(reduce, S, b, cost0)
        dx = _solve_reduced(S, b, fixed_kd, lam)
        dl = _back_substitute(Hll_inv, b_l, U, dx, obs, d)
        cand = _apply_vision_update(state, dx, dl, k, fixed_lm)
        cost1, _ = _vision_cost_and_chi2(cand, obs, cam, delta2, bf)
        (cost1,) = _summed(reduce, cost1)
        accept = cost1 < cost0
        state = VisionBAState(*[torch.where(accept, a, b_) for a, b_ in zip(cand, state)])
        lam = torch.where(accept, (lam * 0.5).clamp(min=1e-6), (lam * 4.0).clamp(max=1e4))
    _, chi2 = _vision_cost_and_chi2(state, obs, cam, delta2, bf)
    return state, chi2


def vision_ba_two_phase(
    state: VisionBAState,
    obs: BAObservations,
    cam: PinholeCamera,
    fixed_kf: torch.Tensor,
    iters1: int = 5,
    iters2: int = 5,
    fixed_lm: Optional[torch.Tensor] = None,
    bf: Optional[float] = None,
) -> Tuple[VisionBAState, BAObservations]:
    """The two-round scheme: optimize, drop chi2 outliers at 1.5 x the gate
    (5.991 mono / 7.815 stereo), optimize again, gate at 1 x. Returns the
    state and the observations with the surviving `valid` mask."""
    delta2 = obs.chi2_delta2()
    state, chi2 = vision_ba(state, obs, cam, fixed_kf, iters1, fixed_lm, bf)
    obs = obs._replace(valid=obs.valid & (chi2 <= delta2 * 1.5))
    state, chi2 = vision_ba(state, obs, cam, fixed_kf, iters2, fixed_lm, bf)
    obs = obs._replace(valid=obs.valid & (chi2 <= delta2))
    return state, obs


def make_local_vision_ba(cam: PinholeCamera, bf: Optional[float] = None) -> GraphedFunction:
    """The local vision BA (`vision_ba_two_phase` at its 5 + 5 iterations) as
    a `GraphedFunction` of (state, kf_idx, uv, inv_sigma2, valid, fixed_kf)
    -> (state, the surviving `valid`): one graph per (K, M, R) on the card,
    the eager solve on the CPU. Process-wide, one per camera. With `bf`
    (fx * baseline) the stereo flavour, of (state, kf_idx, uv, inv_sigma2,
    valid, ur, ur_valid, fixed_kf): one per camera and bf."""
    if bf is None:
        def local_vision_ba(state, kf_idx, uv, inv_sigma2, valid, fixed_kf):
            out, obs = vision_ba_two_phase(state, BAObservations(kf_idx, uv, inv_sigma2, valid), cam, fixed_kf)
            return out, obs.valid

        return _GRAPHS.setdefault(("vision", cam), GraphedFunction(local_vision_ba))

    def local_stereo_ba(state, kf_idx, uv, inv_sigma2, valid, ur, ur_valid, fixed_kf):
        obs = BAObservations(kf_idx, uv, inv_sigma2, valid, ur, ur_valid)
        out, obs = vision_ba_two_phase(state, obs, cam, fixed_kf, bf=bf)
        return out, obs.valid

    return _GRAPHS.setdefault(("stereo", cam, float(bf)), GraphedFunction(local_stereo_ba))


# ---------------------------------------------------------------------------
# visual-inertial BA
# ---------------------------------------------------------------------------


class ViBAState(NamedTuple):
    nav: NavState  # leading dim K
    points: torch.Tensor  # (M,3)


class ImuChain(NamedTuple):
    """Preintegrated IMU edges between keyframe slots.

    Default (idx_i / idx_j None): the K-1 consecutive segments i -> i+1.
    With explicit idx_i / idx_j (E,): arbitrary edges, e.g. multi-stride
    composed preintegrations i -> i+s, whose long spans carry the scale
    signal; bias random-walk edges apply only to stride-1 pairs."""

    pre: PreintegratedImu  # leading dim E (or K-1)
    valid: torch.Tensor  # (E,) bool
    bias_cov_inv_diag: torch.Tensor  # (6,) information diagonal of the bias walk
    idx_i: Optional[torch.Tensor] = None  # (E,) int64
    idx_j: Optional[torch.Tensor] = None  # (E,) int64

    def edges(self, k: int):
        if self.idx_i is None:
            i = torch.arange(k - 1, device=self.valid.device)
            return i, i + 1
        return self.idx_i, self.idx_j


def _vi_blocks(state: ViBAState, obs: BAObservations, cam: PinholeCamera, ext: Extrinsics):
    """Residuals and Jacobians on the (M,R) grid for NavState poses: r
    (M,R,2), Jp (M,R,2,15) with zero V and bias columns, Jl (M,R,2,3)."""
    r, J9, Jl = reproj_residual_jacobians_navstate(
        state.nav.p[obs.kf_idx], state.nav.r[obs.kf_idx], state.points[:, None, :], obs.uv, cam, ext
    )
    return r, torch.cat([J9, torch.zeros_like(J9[..., :6])], dim=-1), Jl


def _take(nav: NavState, idx: torch.Tensor) -> NavState:
    return NavState(*[x[idx] for x in nav])


def _edge_whiteners(chain: ImuChain) -> torch.Tensor:
    """Whitening of each edge's 9-dim residual; padded (invalid) edges carry
    zero covariance, replaced by I so the whitener stays finite (their
    contributions are masked)."""
    eye = torch.eye(9, dtype=chain.pre.cov.dtype, device=chain.pre.cov.device)
    return whitener_from_cov(torch.where(chain.valid[:, None, None], chain.pre.cov, eye))


def _edge_rows(ns_i: NavState, ns_j: NavState, pre: PreintegratedImu, Lt, gravity, basis=None):
    """Per edge (leading dim E): the whitened preintegration residual (E,9)
    and its Jacobians w.r.t. delta_i (E,9,15), delta_j (E,9,15; zero bias
    columns) and, with a gravity basis (3,2), the 2-DoF gravity-direction
    increment dg (E,9,2), with g(dg) = Exp(basis dg) g; then the bias-walk
    residual (E,6) and its Jacobians (E,6,15) twice."""
    dev = Lt.device

    def one(ns_i, ns_j, pre, Lt):
        z15 = torch.zeros(15, dtype=Lt.dtype, device=dev)
        z9 = torch.zeros(9, dtype=Lt.dtype, device=dev)

        # increments with a leading dim of 1 (imu_factors.py's docstring)
        def wres(di, dj9, dg):
            g = gravity if basis is None else exp_so3((basis @ dg)[None])[0] @ gravity
            r = Lt @ preint_residual(di[None], dj9[None], ns_i, ns_j, pre, g)[0]
            return r, r

        def bres(di, dj):
            r = bias_walk_residual(di[None], dj[None], ns_i, ns_j)[0]
            return r, r

        z2 = torch.zeros(2, dtype=Lt.dtype, device=dev)
        argnums = (0, 1) if basis is None else (0, 1, 2)
        J, r = jacfwd(wres, argnums=argnums, has_aux=True)(z15, z9, z2)
        (Bi, Bj), rb = jacfwd(bres, argnums=(0, 1), has_aux=True)(z15, z15)
        Jj = torch.cat([J[1], torch.zeros_like(J[1][:, :6])], dim=-1)
        Jg = J[2] if basis is not None else torch.zeros_like(J[0][:, :2])
        return r, J[0], Jj, Jg, rb, Bi, Bj

    return vmap(one)(ns_i, ns_j, pre, Lt)


def _vi_imu_system(nav: NavState, chain: ImuChain, gravity, k: int, basis=None):
    """The preintegration and bias-walk edges' contributions to the reduced
    system, as (K*15, K*15) and (K*15,) in its layout; with a gravity basis
    also the pose-gravity coupling C (K*15, 2), Hgg (2,2) and g_g (2,)."""
    d = 15
    idx_i, idx_j = chain.edges(k)
    ns_i, ns_j = _take(nav, idx_i), _take(nav, idx_j)
    edge = _edge_rows(ns_i, ns_j, chain.pre, _edge_whiteners(chain), gravity, basis)
    # an invalid edge's rows are zeroed, so nothing it holds reaches another
    # keyframe's slot through a one-hot's zeros below
    r, Ji, Jj, Jg, rb, Bi, Bj = (torch.where(chain.valid.reshape(-1, *[1] * (x.dim() - 1)), x, 0.0) for x in edge)
    dt = r.dtype
    chi2 = torch.sum(r * r, dim=-1)
    w = (huber_weight(chi2, CHI2_VI_9DOF) * chain.valid.to(dt))[:, None, None]
    wJi, wJj = Ji * w, Jj * w
    # the bias random walk couples consecutive keyframes only
    consec = ((idx_j - idx_i) == 1).to(dt)
    binfo = chain.bias_cov_inv_diag[None, :] * (chain.valid.to(dt) * consec)[:, None]  # (E,6)
    bBi, bBj = Bi * binfo[..., None], Bj * binfo[..., None]

    def outer(a, b):  # (E,c,i), (E,c,j) -> (E,i,j)
        return torch.einsum("eci,ecj->eij", a, b)

    # an edge's blocks are summed into its keyframes' slots by one-hot GEMMs
    # (a keyframe ends up to 2 edges a stride, and atomics would add them in
    # a run-dependent order)
    def by_slot(slots, rows, n):  # (N,), (N,...) -> (n,...)
        onehot = (slots[None, :] == torch.arange(n, device=slots.device)[:, None]).to(dt)
        return (onehot @ rows.reshape(len(slots), -1)).reshape(n, *rows.shape[1:])

    blocks = torch.cat([
        outer(wJi, Ji) + outer(bBi, Bi),
        outer(wJi, Jj) + outer(bBi, Bj),
        outer(wJj, Ji) + outer(bBj, Bi),
        outer(wJj, Jj) + outer(bBj, Bj),
    ])
    slots = torch.cat([idx_i * k + idx_i, idx_i * k + idx_j, idx_j * k + idx_i, idx_j * k + idx_j])
    H = by_slot(slots, blocks, k * k)
    rhs_i = torch.einsum("eci,ec->ei", wJi, r) + torch.einsum("eci,ec->ei", bBi, rb)
    rhs_j = torch.einsum("eci,ec->ei", wJj, r) + torch.einsum("eci,ec->ei", bBj, rb)
    ends = torch.cat([idx_i, idx_j])
    g = by_slot(ends, -torch.cat([rhs_i, rhs_j]), k)
    H = H.reshape(k, k, d, d).permute(0, 2, 1, 3).reshape(k * d, k * d)
    if basis is None:
        return H, g.reshape(k * d)
    C = by_slot(ends, torch.cat([outer(wJi, Jg), outer(wJj, Jg)]), k)
    Hgg = torch.einsum("ecg,ech->gh", Jg * w, Jg)
    g_g = -torch.einsum("ecg,ec->g", Jg * w, r)
    return H, g.reshape(k * d), C.reshape(k * d, 2), Hgg, g_g


def _vi_cost(state: ViBAState, obs: BAObservations, cam, ext, chain: ImuChain, gravity, delta2,
             reduce: Reduce = None):
    """Robust cost (vision + preintegration + bias walk) and the per-
    observation chi2 (M,R). With `reduce` (`vi_ba`), the vision part is
    summed over the ranks and the replicated IMU part added once."""
    r, _, _ = _vi_blocks(state, obs, cam, ext)
    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    hw = huber_weight(chi2, delta2)
    vis_cost = torch.sum(torch.where(obs.valid, chi2 * hw.clamp(max=1.0), torch.zeros_like(chi2)))
    (vis_cost,) = _summed(reduce, vis_cost)
    return vis_cost + _vi_imu_cost(state.nav, chain, gravity), chi2


def _vi_imu_cost(nav: NavState, chain: ImuChain, gravity):
    """The robust cost of the preintegration and bias-walk edges."""
    k = nav.p.shape[0]
    idx_i, idx_j = chain.edges(k)
    ns_i, ns_j = _take(nav, idx_i), _take(nav, idx_j)
    e = idx_i.shape[0]
    z15 = torch.zeros((e, 15), dtype=nav.p.dtype, device=nav.p.device)
    ri = (_edge_whiteners(chain) @ preint_residual(z15, z15[:, :9], ns_i, ns_j, chain.pre, gravity)[..., None])[..., 0]
    ichi2 = torch.sum(ri * ri, dim=-1)
    ihw = huber_weight(ichi2, CHI2_VI_9DOF)
    rb = bias_walk_residual(z15, z15, ns_i, ns_j)
    consec = ((idx_j - idx_i) == 1).to(ri.dtype)
    binfo = chain.bias_cov_inv_diag[None, :] * (chain.valid.to(ri.dtype) * consec)[:, None]
    return torch.sum(torch.where(chain.valid, ichi2 * ihw.clamp(max=1.0), torch.zeros_like(ichi2))) + torch.sum(
        binfo * rb * rb
    )


def _apply_vi_update(state: ViBAState, dx, dl, k, fixed_lm=None) -> ViBAState:
    nav = state.nav.inc_small(dx.reshape(k, 15))
    pts = state.points + dl
    if fixed_lm is not None:
        pts = torch.where(fixed_lm[:, None], state.points, pts)
    return ViBAState(nav, pts)


def _select_vi(accept, a: ViBAState, b: ViBAState) -> ViBAState:
    return ViBAState(select_nav(accept, a.nav, b.nav), torch.where(accept, a.points, b.points))


def vi_ba(
    state: ViBAState,
    obs: BAObservations,
    cam: PinholeCamera,
    ext: Extrinsics,
    chain: ImuChain,
    gravity: torch.Tensor,
    fixed_kf: torch.Tensor,
    iters: int = 10,
    fixed_lm: Optional[torch.Tensor] = None,
    reduce: Reduce = None,
) -> Tuple[ViBAState, torch.Tensor]:
    """Visual-inertial windowed / global BA over K NavStates and M
    landmarks. Returns (state, final per-observation chi2 (M,R)).

    `reduce` as in `vision_ba`: the landmark rows' reduced system is summed
    over the ranks by one call an iteration, the candidate's vision cost by
    one more, and the IMU chain, which couples only the replicated
    NavStates, adds its system and cost once, after the sum, on every rank."""
    k = state.nav.p.shape[0]
    d = 15
    delta2 = CHI2_MONO_2DOF
    obs = obs._replace(kf_idx=obs.kf_idx.clamp(0, k - 1))
    fixed_kd = torch.repeat_interleave(fixed_kf, d)
    lam = torch.full((), 1e-4, dtype=state.points.dtype, device=state.points.device)
    # the cost of the current state: after the first iteration, the accepted
    # candidate's (the same state, so the same value)
    cost0, _ = _vi_cost(state, obs, cam, ext, chain, gravity, delta2, reduce)
    for _ in range(iters):
        r, Jp, Jl = _vi_blocks(state, obs, cam, ext)
        chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        w = obs.inv_sigma2 * huber_weight(chi2, delta2) * obs.valid.to(r.dtype)
        S, b, Hll_inv, b_l, U = _schur_system(r, Jp, Jl, w, obs, k, d, lam)
        S, b = _summed(reduce, S, b)
        Himu, gimu = _vi_imu_system(state.nav, chain, gravity, k)
        dx = _solve_reduced(S + Himu, b + gimu, fixed_kd, lam)
        dl = _back_substitute(Hll_inv, b_l, U, dx, obs, d)
        cand = _apply_vi_update(state, dx, dl, k, fixed_lm)
        cost1, _ = _vi_cost(cand, obs, cam, ext, chain, gravity, delta2, reduce)
        accept = cost1 < cost0
        cost0 = torch.where(accept, cost1, cost0)
        state = _select_vi(accept, cand, state)
        lam = torch.where(accept, (lam * 0.5).clamp(min=1e-6), (lam * 4.0).clamp(max=1e4))
    _, chi2 = _vi_cost(state, obs, cam, ext, chain, gravity, delta2)
    return state, chi2


def vi_ba_two_phase(
    state: ViBAState,
    obs: BAObservations,
    cam: PinholeCamera,
    ext: Extrinsics,
    chain: ImuChain,
    gravity: torch.Tensor,
    fixed_kf: torch.Tensor,
    iters1: int = 5,
    iters2: int = 5,
    fixed_lm: Optional[torch.Tensor] = None,
) -> Tuple[ViBAState, BAObservations]:
    """`vi_ba`, chi2 gating at 1.5 x 5.991, `vi_ba` again, gating at 5.991."""
    state, chi2 = vi_ba(state, obs, cam, ext, chain, gravity, fixed_kf, iters1, fixed_lm)
    obs = obs._replace(valid=obs.valid & (chi2 <= CHI2_MONO_2DOF * 1.5))
    state, chi2 = vi_ba(state, obs, cam, ext, chain, gravity, fixed_kf, iters2, fixed_lm)
    obs = obs._replace(valid=obs.valid & (chi2 <= CHI2_MONO_2DOF))
    return state, obs


def make_local_vi_ba(cam: PinholeCamera, iters: Tuple[int, int] = (5, 5)) -> GraphedFunction:
    """The local VI BA (`vi_ba_two_phase` over the window's consecutive IMU
    edges) as a `GraphedFunction` of (state, kf_idx, uv, inv_sigma2, valid,
    ext, pre, edge_valid, bias_cov_inv_diag, gravity, fixed_kf) -> (state,
    the surviving `valid`): one graph per shape on the card, the eager solve
    on the CPU. Process-wide, one per camera and iteration counts."""

    def local_vi_ba(state, kf_idx, uv, inv_sigma2, valid, ext, pre, edge_valid, bias_info, gravity, fixed_kf):
        obs = BAObservations(kf_idx, uv, inv_sigma2, valid)
        chain = ImuChain(pre, edge_valid, bias_info)
        out, obs = vi_ba_two_phase(state, obs, cam, ext, chain, gravity, fixed_kf, iters[0], iters[1])
        return out, obs.valid

    return _GRAPHS.setdefault(("vi", cam, tuple(iters)), GraphedFunction(local_vi_ba))


# ---------------------------------------------------------------------------
# visual-inertial BA with a free gravity direction (the post-init global BA)
# ---------------------------------------------------------------------------


def _gravity_basis(g: torch.Tensor) -> torch.Tensor:
    """(3,2) orthonormal basis perpendicular to g: rotating g about these
    axes spans the 2-DoF direction manifold while |g| stays fixed."""
    gn = g / torch.linalg.norm(g).clamp(min=1e-12)
    # the coordinate axis least aligned with g seeds the basis
    # (index_select: indexing with a 0-dim tensor would read it on the host)
    seed = torch.eye(3, dtype=g.dtype, device=g.device).index_select(0, torch.argmin(gn.abs()).reshape(1))[0]
    b1 = torch.linalg.cross(gn, seed)
    b1 = b1 / torch.linalg.norm(b1).clamp(min=1e-12)
    b2 = torch.linalg.cross(gn, b1)
    return torch.stack([b1, b2], dim=-1)


def vi_ba_gw(
    state: ViBAState,
    obs: BAObservations,
    cam: PinholeCamera,
    ext: Extrinsics,
    chain: ImuChain,
    gravity: torch.Tensor,
    fixed_kf: torch.Tensor,
    iters: int = 15,
    fixed_lm: Optional[torch.Tensor] = None,
) -> Tuple[ViBAState, torch.Tensor, torch.Tensor]:
    """Visual-inertial global BA with a free 2-DoF gravity-direction vertex:
    the post-init GBA, which repairs the residual scale and gravity error of
    the closed-form init together. Only P and R of the fixed keyframes are
    held (their V and biases stay free). Returns (state, refined gravity
    (3,), final per-observation chi2)."""
    k = state.nav.p.shape[0]
    d = 15
    delta2 = CHI2_MONO_2DOF
    dev = state.points.device
    obs = obs._replace(kf_idx=obs.kf_idx.clamp(0, k - 1))
    pose_dofs = torch.zeros(d, dtype=torch.bool, device=dev)
    pose_dofs[0:3] = True
    pose_dofs[6:9] = True
    fixed_ext = torch.cat([
        torch.repeat_interleave(fixed_kf, d) & pose_dofs.repeat(k),
        torch.zeros(2, dtype=torch.bool, device=dev),
    ])
    lam = torch.full((), 1e-4, dtype=state.points.dtype, device=dev)
    cost0, _ = _vi_cost(state, obs, cam, ext, chain, gravity, delta2)  # then the accepted candidate's
    for _ in range(iters):
        basis = _gravity_basis(gravity)
        r, Jp, Jl = _vi_blocks(state, obs, cam, ext)
        chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        w = obs.inv_sigma2 * huber_weight(chi2, delta2) * obs.valid.to(r.dtype)
        S, b, Hll_inv, b_l, U = _schur_system(r, Jp, Jl, w, obs, k, d, lam)
        Himu, gimu, C, Hgg, gg = _vi_imu_system(state.nav, chain, gravity, k, basis)
        # the augmented system [[S, C], [C^T, Hgg]]
        A = torch.cat([torch.cat([S + Himu, C], 1), torch.cat([C.T, Hgg], 1)], 0)
        dx = _solve_reduced(A, torch.cat([b + gimu, gg]), fixed_ext, lam)
        dx_pose, dg = dx[: k * d], dx[k * d:]
        dl = _back_substitute(Hll_inv, b_l, U, dx_pose, obs, d)
        cand = _apply_vi_update(state, dx_pose, dl, k, fixed_lm)
        g_cand = exp_so3(basis @ dg) @ gravity
        cost1, _ = _vi_cost(cand, obs, cam, ext, chain, g_cand, delta2)
        accept = cost1 < cost0
        cost0 = torch.where(accept, cost1, cost0)
        state = _select_vi(accept, cand, state)
        gravity = torch.where(accept, g_cand, gravity)
        lam = torch.where(accept, (lam * 0.5).clamp(min=1e-6), (lam * 4.0).clamp(max=1e4))
    _, chi2 = _vi_cost(state, obs, cam, ext, chain, gravity, delta2)
    return state, gravity, chi2


def vi_ba_gw_two_phase(
    state: ViBAState,
    obs: BAObservations,
    cam: PinholeCamera,
    ext: Extrinsics,
    chain: ImuChain,
    gravity: torch.Tensor,
    fixed_kf: torch.Tensor,
    iters1: int = 12,
    iters2: int = 8,
    fixed_lm: Optional[torch.Tensor] = None,
) -> Tuple[ViBAState, torch.Tensor, BAObservations]:
    """`vi_ba_gw` twice with the two-phase chi2 gating of `vi_ba_two_phase`."""
    state, gravity, chi2 = vi_ba_gw(state, obs, cam, ext, chain, gravity, fixed_kf, iters1, fixed_lm)
    obs = obs._replace(valid=obs.valid & (chi2 <= CHI2_MONO_2DOF * 1.5))
    state, gravity, chi2 = vi_ba_gw(state, obs, cam, ext, chain, gravity, fixed_kf, iters2, fixed_lm)
    obs = obs._replace(valid=obs.valid & (chi2 <= CHI2_MONO_2DOF))
    return state, gravity, obs
