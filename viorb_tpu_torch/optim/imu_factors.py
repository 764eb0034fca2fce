"""IMU factor residuals: preintegration edge, bias random walk, NavState
prior (port of viorb_tpu/optim/imu_factors.py).

Each residual is a function of local increments (delta_i, delta_j) around
the current states, so `torch.func.jacfwd` at zero gives the manifold
Jacobians, as `jax.jacfwd` does in the reference. The residuals take
increments with leading dims (the states broadcast against them). Callers
that differentiate them pass increments of shape (1, n): forward-mode AD in
PyTorch promotes the tangent of a 0-dim tensor combined with a Python
number to float64, and with a leading dim no intermediate is 0-dim.
`whitener_from_cov` is batched and syncs nothing with the host.
"""

from __future__ import annotations

import torch

from viorb_tpu_torch.geometry.so3 import exp_so3, log_so3
from viorb_tpu_torch.imu.navstate import NavState
from viorb_tpu_torch.imu.preintegration import PreintegratedImu


def preint_residual(
    delta_i: torch.Tensor,  # (...,15) increment on state i (P, V, phi, dbg, dba)
    delta_j: torch.Tensor,  # (...,9) increment on state j's P, V, phi
    ns_i: NavState,
    ns_j: NavState,
    pre: PreintegratedImu,
    gravity_w: torch.Tensor,
) -> torch.Tensor:
    """9-dim residual (rP, rV, rPhi):

      rP   = Rwb_i^T (Pj - Pi - Vi dt - 1/2 g dt^2) - dP_corr
      rV   = Rwb_i^T (Vj - Vi - g dt)               - dV_corr
      rPhi = Log(dR_corr^T Rwb_i^T Rwb_j)"""
    p_i = ns_i.p + delta_i[..., 0:3]
    v_i = ns_i.v + delta_i[..., 3:6]
    r_i = ns_i.r @ exp_so3(delta_i[..., 6:9])
    dbg_i = ns_i.dbg + delta_i[..., 9:12]
    dba_i = ns_i.dba + delta_i[..., 12:15]

    p_j = ns_j.p + delta_j[..., 0:3]
    v_j = ns_j.v + delta_j[..., 3:6]
    r_j = ns_j.r @ exp_so3(delta_j[..., 6:9])

    dt = pre.dt[..., None]
    dp_c, dv_c, dr_c = pre.corrected_deltas(dbg_i, dba_i)
    ri_t = r_i.transpose(-1, -2)
    r_p = (ri_t @ (p_j - p_i - v_i * dt - 0.5 * gravity_w * dt * dt)[..., None])[..., 0] - dp_c
    r_v = (ri_t @ (v_j - v_i - gravity_w * dt)[..., None])[..., 0] - dv_c
    r_phi = log_so3(dr_c.transpose(-1, -2) @ ri_t @ r_j)
    return torch.cat([r_p, r_v, r_phi], dim=-1)


def bias_walk_residual(
    delta_i: torch.Tensor,  # (...,15)
    delta_j: torch.Tensor,  # (...,15)
    ns_i: NavState,
    ns_j: NavState,
) -> torch.Tensor:
    """6-dim bias random-walk residual: (bg_j + dbg_j) - (bg_i + dbg_i), and
    the same for the accelerometer. Its information, (random-walk variance x
    dt)^-1, is the caller's."""
    bg_i = ns_i.bg + ns_i.dbg + delta_i[..., 9:12]
    ba_i = ns_i.ba + ns_i.dba + delta_i[..., 12:15]
    bg_j = ns_j.bg + ns_j.dbg + delta_j[..., 9:12]
    ba_j = ns_j.ba + ns_j.dba + delta_j[..., 12:15]
    return torch.cat([bg_j - bg_i, ba_j - ba_i], dim=-1)


def prior_residual(delta: torch.Tensor, ns: NavState, prior: NavState) -> torch.Tensor:
    """15-dim manifold difference state [-] prior; delta (...,15)."""
    p = ns.p + delta[..., 0:3]
    v = ns.v + delta[..., 3:6]
    r = ns.r @ exp_so3(delta[..., 6:9])
    bg = ns.bg + ns.dbg + delta[..., 9:12]
    ba = ns.ba + ns.dba + delta[..., 12:15]
    return torch.cat([
        p - prior.p,
        v - prior.v,
        log_so3(prior.r.transpose(-1, -2) @ r),
        bg - (prior.bg + prior.dbg),
        ba - (prior.ba + prior.dba),
    ], dim=-1)


def whitener_from_cov(cov: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """cov (...,n,n) -> L^T with L L^T = cov^-1, so the whitened residual
    r' = L^T r has r'^T r' = r^T cov^-1 r: the Cholesky factor of the
    symmetrized inverse. `inv_ex` and `cholesky_ex` keep their status on
    the device (the plain calls would sync with the host to check it)."""
    n = cov.shape[-1]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    covs = 0.5 * (cov + cov.transpose(-1, -2)) + eps * eye
    info = torch.linalg.inv_ex(covs)[0]
    info = 0.5 * (info + info.transpose(-1, -2))
    L = torch.linalg.cholesky_ex(info + 1e-10 * eye)[0]  # jitter for PSD safety
    return L.transpose(-1, -2)
