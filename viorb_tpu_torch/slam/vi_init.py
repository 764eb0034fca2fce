"""Visual-inertial initialization: gyro bias, scale, gravity, accel bias
(port of viorb_tpu/slam/vi_init.py).

  Step 1  gyro bias from relative rotations: Gauss-Newton on
          r = Log(dR(bg)^T Rbi^T Rbj);
  Step 2  linear scale + gravity: for each keyframe triplet, eliminate the
          velocities from the preintegrated kinematics to get
          lam*s - beta*gw = gamma (errors-in-variables corrected scale);
  Step 3  refine with |g| fixed at 9.81: a 2-DoF gravity-direction
          correction + accel bias;
  Step 4  per-keyframe velocities from the position equations.

Triplets are built at several strides by composing preintegrations: the
scale coefficient is a double difference of camera centers, whose signal
grows ~dt^2 while vision noise stays constant.

The preintegrations and the gyro-bias residual (differentiated with
`torch.func.jacfwd`) run on the IMU batches' device; the tiny least-squares
systems run on the host in float64, as in the reference. The reference
pads the segment count to a multiple of 8 so that its compiled
preintegration sees few shapes; eager PyTorch compiles nothing, so the port
does not pad (the padded segments never enter a result).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from viorb_tpu_torch.geometry.so3 import exp_so3, log_so3
from viorb_tpu_torch.imu.preintegration import PreintegratedImu, compose_preint, preintegrate_batch
from viorb_tpu_torch.imu.types import ImuBatch, ImuNoise
from viorb_tpu_torch.optim.forward_ad import jacfwd

GRAVITY_MAG = 9.810


def estimate_gyro_bias(
    r_wb: np.ndarray,  # (N,3,3) body rotations from vision (Rwc @ Rcb)
    preints: PreintegratedImu,  # stacked, leading dim N-1 (i -> i+1)
    iters: int = 4,
) -> np.ndarray:
    """Gauss-Newton for bg minimizing sum ||Log((dR Exp(J dbg))^T R_i^T R_j)||^2;
    each step solves the (3(N-1), 3) system on the host in float64."""
    dev = preints.delta_r.device
    r_wb = torch.as_tensor(np.asarray(r_wb, np.float32), device=dev)
    rel_vision = r_wb[:-1].transpose(-1, -2) @ r_wb[1:]

    def residuals(bg):
        dR_corr = preints.delta_r @ exp_so3((preints.j_r_bg @ bg[None, :, None])[..., 0])
        r = log_so3(dR_corr.transpose(-1, -2) @ rel_vision).reshape(-1)
        return r, r

    bg = torch.zeros(3, dtype=torch.float32, device=dev)
    for _ in range(iters):
        J, r = jacfwd(residuals, has_aux=True)(bg)
        Jn = J.double().cpu().numpy()
        rn = r.double().cpu().numpy()
        delta = np.linalg.lstsq(Jn, -rn, rcond=None)[0]
        bg = bg + torch.from_numpy(delta.astype(np.float32)).to(dev)
    return bg.cpu().numpy()


class ViInitResult(NamedTuple):
    success: bool
    scale: float
    gravity_w: np.ndarray  # (3,)
    bias_g: np.ndarray
    bias_a: np.ndarray
    velocities: np.ndarray  # (N,3) body velocities in world (scaled frame)
    condition_number: float


class Triplet(NamedTuple):
    """One velocity-eliminated equation over keyframes (i, j, k) with the
    preintegrated segments i->j and j->k (numpy fields, on the host)."""

    i: int
    j: int
    k: int
    pre_ij: PreintegratedImu
    pre_jk: PreintegratedImu


def _host(pre: PreintegratedImu) -> PreintegratedImu:
    return PreintegratedImu(*(x.cpu().numpy() for x in pre))


def _row(pre: PreintegratedImu, i: int) -> PreintegratedImu:
    return PreintegratedImu(*(x[i] for x in pre))


def build_triplets(
    pre1: PreintegratedImu,  # stacked consecutive segments (N-1)
    strides: Sequence[int] = (1, 2, 3),
) -> List[Triplet]:
    """Compose consecutive preintegrations into multi-stride triplets:
    seg[s][i], the preintegration i -> i+s, is seg[s-1][i] o seg[1][i+s-1],
    each stride one batched composition."""
    n_seg = pre1.dt.shape[0]
    n = n_seg + 1
    seg = {1: pre1}
    for s in range(2, max(strides) + 1):
        if n - s <= 0:
            break
        prev = PreintegratedImu(*(x[: n - s] for x in seg[s - 1]))
        nxt = PreintegratedImu(*(x[s - 1:] for x in pre1))
        seg[s] = compose_preint(prev, nxt)
    host = {s: _host(p) for s, p in seg.items()}
    out = []
    for s in strides:
        if s not in host:
            continue
        for i in range(0, n - 2 * s):
            out.append(Triplet(i, i + s, i + 2 * s, _row(host[s], i), _row(host[s], i + s)))
    return out


def _row_parts(tr: Triplet, p_c, r_wb, p_bc_w, ts):
    i, j, k = tr.i, tr.j, tr.k
    dt12 = float(ts[j] - ts[i])
    dt23 = float(ts[k] - ts[j])
    lam = (p_c[k] - p_c[j]) * dt12 - (p_c[j] - p_c[i]) * dt23
    # eliminating V_i gives: lam*s - 1/2(dt12^2 dt23 + dt23^2 dt12) g = gamma
    # (verified numerically against analytic trajectories)
    half = 0.5 * (dt12 * dt12 * dt23 + dt23 * dt23 * dt12)
    dp_ij = np.asarray(tr.pre_ij.delta_p, np.float64)
    dv_ij = np.asarray(tr.pre_ij.delta_v, np.float64)
    dp_jk = np.asarray(tr.pre_jk.delta_p, np.float64)
    gamma0 = (
        r_wb[i] @ dv_ij * dt12 * dt23
        + r_wb[j] @ dp_jk * dt12
        - r_wb[i] @ dp_ij * dt23
        - ((p_bc_w[k] - p_bc_w[j]) * dt12 - (p_bc_w[j] - p_bc_w[i]) * dt23)
    )
    return lam, half, gamma0, dt12, dt23


def _triplet_noise_rows(triplets: List[Triplet]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-ROW (3 per triplet) noise accounting for the velocity-eliminated
    equation  lam*s - half*g = gamma:

      * sigma_b2: variance of the IMU-side rhs gamma from the composed
        preintegration covariances (cov is 9x9 in P-V-phi order);
      * c_rows: coefficient of the vision noise variance sigma_p^2 in the
        lam regressor — lam = p_k*dt12 - p_j*(dt12+dt23) + p_i*dt23, so
        Var(lam) = sigma_p^2 * (dt12^2 + (dt12+dt23)^2 + dt23^2).
    """
    sb, cr = [], []
    for tr in triplets:
        dt12 = float(np.asarray(tr.pre_ij.dt))
        dt23 = float(np.asarray(tr.pre_jk.dt))
        cov_ij = np.asarray(tr.pre_ij.cov)
        cov_jk = np.asarray(tr.pre_jk.cov)
        vp_ij = float(np.trace(cov_ij[:3, :3])) / 3.0
        vv_ij = float(np.trace(cov_ij[3:6, 3:6])) / 3.0
        vp_jk = float(np.trace(cov_jk[:3, :3])) / 3.0
        var_b = (
            (dt12 * dt23) ** 2 * vv_ij
            + dt12**2 * vp_jk
            + dt23**2 * vp_ij
        )
        c = dt12**2 + (dt12 + dt23) ** 2 + dt23**2
        sb += [var_b] * 3
        cr += [c] * 3
    return np.array(sb), np.array(cr)


def _eiv_scale_solve(
    a: np.ndarray,  # (n,) noisy regressor column (multiplies s)
    B: np.ndarray,  # (n,d) exact columns
    b: np.ndarray,  # (n,) rhs
    sigma_b2: np.ndarray,  # (n,) per-row rhs noise variance (IMU)
    c_rows: np.ndarray,  # (n,) Var(a_i) = sigma_p^2 * c_rows[i]
) -> Tuple[float, np.ndarray]:
    """Mixed LS-TLS scale solve: ONLY the `a` column carries vision noise
    (the camera centers), the other columns are exact, and the rhs noise
    (IMU preintegration) is known. Ordinary least squares is then an
    errors-in-variables regression whose scale estimate is attenuated by
    the noise-to-signal ratio of `a` — re-solving on a refined map
    COMPOUNDS the shrinkage (the round-2/3 ±12% scale gate). The fix is
    Fuller's method-of-moments correction: estimate sigma_p^2 from the
    residual power left after subtracting the known IMU noise, then
    subtract the noise-induced inflation from the Gram entry of `a`.

    No reference counterpart (the reference accepts the OLS estimate
    after 15 s of data, src/LocalMapping.cc:554-563)."""
    Q, _ = np.linalg.qr(B)
    at = a - Q @ (Q.T @ a)
    bt = b - Q @ (Q.T @ b)
    gram = float(at @ at)
    cross = float(at @ bt)
    if gram <= 1e-12:
        return 0.0, np.zeros(B.shape[1])
    s_ols = cross / gram
    # vision noise sigma_p^2 by residual moment matching, iterated to its
    # fixed point: at the true s, E[RSS] = sum(sigma_b^2) + s^2 sigma_p^2
    # sum(c) and E[gram] = gram_true + sigma_p^2 sum(c) — evaluating the
    # moments at the attenuated OLS s instead overcorrects by
    # (s-s_ols)^2/s_ols^2, so a few substitutions are needed
    lev = (Q**2).sum(axis=1)
    c_eff = float(((1.0 - lev) * c_rows).sum())
    sb_eff = float(((1.0 - lev) * sigma_b2).sum())
    s_hat = s_ols
    for _ in range(6):
        rss = float(((bt - at * s_hat) ** 2).sum())
        sp2 = max(0.0, (rss - sb_eff) / max(s_hat**2 * c_eff, 1e-12))
        gram_corr = max(gram - c_eff * sp2, 0.25 * gram)  # safeguard
        s_hat = cross / gram_corr
    # Safeguards: the residual-moment sp2 soaks up ANY unmodeled rhs noise
    # (e.g. vision-rotation terms in gamma), so in low-information windows
    # the Gram correction can inflate the scale far beyond the attenuation
    # it is meant to undo (~10-15% on refined maps, measured round 3).
    # With too few triplets the moment estimate is statistically
    # meaningless — keep OLS; otherwise bound the inflation by a margin
    # that tightens as the row count (and thus the sp2 estimate's
    # reliability) grows.
    n_rows = at.shape[0]
    if n_rows < 24:  # < 8 triplets
        theta = np.linalg.lstsq(B, b - a * s_ols, rcond=None)[0]
        return float(s_ols), theta
    max_infl = 1.2 + 2.0 / np.sqrt(n_rows / 3.0)
    if abs(s_hat) > max_infl * abs(s_ols):
        s_hat = float(np.sign(s_hat)) * max_infl * abs(s_ols)
    theta = np.linalg.lstsq(B, b - a * s_hat, rcond=None)[0]
    return float(s_hat), theta


def estimate_scale_gravity(
    triplets: List[Triplet],
    p_c: np.ndarray,
    r_wb: np.ndarray,
    p_bc_w: np.ndarray,
    ts: np.ndarray,
) -> Tuple[float, np.ndarray, float]:
    """Step 2: linear solve for (s, gw) with the EIV-corrected scale.
    Returns (scale, gravity, condition number)
    (reference src/LocalMapping.cc:356-390)."""
    m = len(triplets)
    A = np.zeros((3 * m, 4))
    b = np.zeros(3 * m)
    for r, tr in enumerate(triplets):
        lam, half, gamma0, _, _ = _row_parts(tr, p_c, r_wb, p_bc_w, ts)
        A[3 * r : 3 * r + 3, 0] = lam
        A[3 * r : 3 * r + 3, 1:4] = -half * np.eye(3)
        b[3 * r : 3 * r + 3] = gamma0
    u, s, vt = np.linalg.svd(A, full_matrices=False)
    cond = s[0] / max(s[-1], 1e-12)
    sigma_b2, c_rows = _triplet_noise_rows(triplets)
    s_hat, gw = _eiv_scale_solve(A[:, 0], A[:, 1:4], b, sigma_b2, c_rows)
    return float(s_hat), gw, float(cond)


def refine_scale_gravity_ba(
    triplets: List[Triplet],
    p_c: np.ndarray,
    r_wb: np.ndarray,
    p_bc_w: np.ndarray,
    ts: np.ndarray,
    g_est: np.ndarray,
    ba_prior_weight: float = 0.0,
    outer_iters: int = 3,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Step 3: fix |g| = 9.81, solve for (s, dtheta_xy, ba), iterating the
    gravity-frame linearization (reference src/LocalMapping.cc:396-504 does
    one pass; re-centering R_wi plus a weak zero prior on ba tames the
    g-direction/accel-bias trade-off under vision noise)."""
    g_cur = g_est.copy()
    for _ in range(outer_iters):
        s, g_cur, ba = _refine_once(
            triplets, p_c, r_wb, p_bc_w, ts, g_cur, ba_prior_weight
        )
    return s, g_cur, ba


def _refine_once(triplets, p_c, r_wb, p_bc_w, ts, g_est, ba_prior_weight):
    gI = np.array([0.0, 0.0, -1.0])
    gn = g_est / max(np.linalg.norm(g_est), 1e-12)
    v = np.cross(gI, gn)
    sv = np.linalg.norm(v)
    cv = float(gI @ gn)
    if sv < 1e-8:
        R_wi = np.eye(3)
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R_wi = np.eye(3) + vx + vx @ vx * ((1 - cv) / (sv * sv))
    g0 = R_wi @ gI * GRAVITY_MAG
    gIx = np.array([[0, -gI[2], gI[1]], [gI[2], 0, -gI[0]], [-gI[1], gI[0], 0]])

    m = len(triplets)
    A = np.zeros((3 * m, 6))
    b = np.zeros(3 * m)
    for r, tr in enumerate(triplets):
        lam, half, gamma0, dt12, dt23 = _row_parts(tr, p_c, r_wb, p_bc_w, ts)
        i, j = tr.i, tr.j
        jp_ij = np.asarray(tr.pre_ij.j_p_ba, np.float64)
        jv_ij = np.asarray(tr.pre_ij.j_v_ba, np.float64)
        jp_jk = np.asarray(tr.pre_jk.j_p_ba, np.float64)
        # equation: lam*s - half*g(dtheta) - zeta*ba = gamma0
        # g(dtheta) ~= g0 - G R_wi hat(gI) dtheta
        phi = half * GRAVITY_MAG * (R_wi @ gIx)
        zeta = (
            r_wb[j] @ jp_jk * dt12
            - r_wb[i] @ jp_ij * dt23
            + r_wb[i] @ jv_ij * dt12 * dt23
        )
        A[3 * r : 3 * r + 3, 0] = lam
        A[3 * r : 3 * r + 3, 1:3] = phi[:, :2]
        A[3 * r : 3 * r + 3, 3:6] = -zeta
        b[3 * r : 3 * r + 3] = gamma0 + half * g0
    if ba_prior_weight > 0:
        P = np.zeros((3, 6))
        P[:, 3:6] = np.eye(3) * ba_prior_weight
        A = np.vstack([A, P])
        b = np.concatenate([b, np.zeros(3)])
    # EIV-corrected scale (see _eiv_scale_solve): only the lam column
    # carries vision noise; prior rows are noise-free
    sigma_b2, c_rows = _triplet_noise_rows(triplets)
    if A.shape[0] > 3 * len(triplets):
        pad = A.shape[0] - 3 * len(triplets)
        sigma_b2 = np.concatenate([sigma_b2, np.zeros(pad)])
        c_rows = np.concatenate([c_rows, np.zeros(pad)])
    s_hat, theta = _eiv_scale_solve(A[:, 0], A[:, 1:], b, sigma_b2, c_rows)
    x = np.concatenate([[s_hat], theta])
    s = float(x[0])
    dtheta = np.array([x[1], x[2], 0.0])
    th = np.linalg.norm(dtheta)
    if th > 1e-12:
        k = dtheta / th
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        Rdt = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
    else:
        Rdt = np.eye(3)
    gw = R_wi @ Rdt @ gI * GRAVITY_MAG
    ba = x[3:6]
    return s, gw, ba


def solve_velocities(
    p_wb: np.ndarray,  # (N,3) SCALED body positions
    r_wb: np.ndarray,
    dts: np.ndarray,
    dp: np.ndarray,  # bias-corrected
    dv: np.ndarray,
    gw: np.ndarray,
) -> np.ndarray:
    """Velocities from P_{i+1} = P_i + V_i dt + 1/2 g dt^2 + R_i dP; the
    last from V_j = V_i + g dt + R_i dV (reference src/LocalMapping.cc:620-688)."""
    n = len(p_wb)
    v = np.zeros((n, 3))
    for i in range(n - 1):
        dt = dts[i]
        v[i] = (
            p_wb[i + 1] - p_wb[i] - 0.5 * gw * dt * dt - r_wb[i] @ dp[i]
        ) / dt
    v[n - 1] = v[n - 2] + gw * dts[n - 2] + r_wb[n - 2] @ dv[n - 2]
    return v


def try_vi_init(
    p_c: np.ndarray,  # (N,3) camera centers (unscaled mono map)
    r_wc: np.ndarray,  # (N,3,3) camera-to-world rotations
    timestamps: np.ndarray,  # (N,)
    imu_batches: ImuBatch,  # stacked, leading dim N-1: the samples of each keyframe gap
    r_bc: np.ndarray = np.eye(3),  # extrinsics Tbc
    p_bc: np.ndarray = np.zeros(3),
    noise: Optional[ImuNoise] = None,
    strides: Sequence[int] = (1, 2, 3),
    ba_prior_weight: float = 0.02,
) -> Optional[ViInitResult]:
    """Full VI initialization over a keyframe chain. success=False when the
    estimate fails the plausibility gates; None when the chain is too short
    or the scale comes out non-positive."""
    noise = noise or ImuNoise()
    n = len(p_c)
    if n < 4:
        return None
    # x_b = r_bc x_c + p_bc  =>  Rwb = Rwc @ r_bc^T
    r_wb = np.einsum("nij,kj->nik", r_wc, r_bc)
    p_cb = -(r_bc.T @ p_bc)
    p_bc_w = np.einsum("nij,j->ni", r_wc, p_cb)
    dts = np.diff(timestamps).astype(np.float64)

    dev = imu_batches.gyro.device
    t0 = torch.as_tensor(np.asarray(timestamps[:-1], np.float32), device=dev)
    t1 = torch.as_tensor(np.asarray(timestamps[1:], np.float32), device=dev)
    zero = torch.zeros(3, dtype=torch.float32, device=dev)

    # step 1: gyro bias (preintegrate at zero bias first)
    pre0 = preintegrate_batch(imu_batches, zero, zero, t0, t1, noise)
    bg = estimate_gyro_bias(r_wb, pre0)

    # re-preintegrate with bg (one batched pass)
    pre = preintegrate_batch(imu_batches, torch.from_numpy(bg).to(dev), zero, t0, t1, noise)

    triplets = build_triplets(pre, strides=strides)
    if len(triplets) < 4:
        return None

    # step 2: linear scale + gravity
    s2, gw2, cond = estimate_scale_gravity(triplets, p_c, r_wb, p_bc_w, timestamps)
    if s2 <= 0:
        return None

    # step 3: refine with the |g| constraint + accel bias
    s3, gw3, ba = refine_scale_gravity_ba(
        triplets, p_c, r_wb, p_bc_w, timestamps, gw2, ba_prior_weight=ba_prior_weight,
    )
    if s3 <= 0:
        return None

    # plausibility gates
    ok = abs(np.linalg.norm(gw2) - GRAVITY_MAG) < 1.5 and np.linalg.norm(ba) < 0.6

    # step 4: velocities (with the deltas bias-corrected at ba)
    dp_c, dv_c, _ = pre.corrected_deltas(zero, torch.from_numpy(np.asarray(ba, np.float32)).to(dev))
    p_wb = s3 * p_c + p_bc_w
    vels = solve_velocities(p_wb, r_wb, dts, dp_c.cpu().numpy(), dv_c.cpu().numpy(), gw3)
    return ViInitResult(
        success=bool(ok),
        scale=s3,
        gravity_w=gw3,
        bias_g=bg,
        bias_a=ba,
        velocities=vels,
        condition_number=cond,
    )
