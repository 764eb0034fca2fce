"""IMU preintegration (port of viorb_tpu/imu/preintegration.py).

Per sample (omega, acc, dt), with bias-corrected measurements (the
reference preintegrator's recursion, state order P, V, phi):

  cov <- A cov A^T + Bg Sg Bg^T + Ca Sa Ca^T
  J_P_ba += J_V_ba dt - 1/2 dR dt^2
  J_P_bg += J_V_bg dt - 1/2 dR [a]x J_R_bg dt^2
  J_V_ba += -dR dt
  J_V_bg += -dR [a]x J_R_bg dt
  J_R_bg  = Exp(w dt)^T J_R_bg - Jr(w dt) dt
  dP += dV dt + 1/2 dR a dt^2 ; dV += dR a dt ; dR = norm(dR Exp(w dt))

The reference composes the per-sample steps with `jax.lax.associative_scan`
and keeps the last prefix. The port needs only that total, so it reduces
the steps pairwise: log2(capacity) levels of one batched `compose_preint`
each (8 levels at capacity 256), a few hundred small kernels where a
sample-by-sample loop would be thousands. For a power-of-two capacity the
grouping is the one the reference's scan gives its last element (and a
Hillis-Steele scan's): a balanced binary tree. `preintegrate_sequential`
is the plain recursion the tests hold both to.

Everything takes leading batch dims, so `preintegrate_batch` (many
keyframe gaps at once) is `preintegrate` with broadcasting. No host sync:
a CUDA graph can capture it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from viorb_tpu_torch.device import resolve_device
from viorb_tpu_torch.geometry.so3 import exp_so3, hat, normalize_rotation, right_jacobian
from viorb_tpu_torch.imu.types import ImuBatch, ImuNoise


class PreintegratedImu(NamedTuple):
    """Preintegrated measurements over one segment.

    delta_p / delta_v: (...,3); delta_r: (...,3,3); j_*: (...,3,3) bias
    Jacobians; cov: (...,9,9) over (P, V, phi); dt: (...,) total time."""

    delta_p: torch.Tensor
    delta_v: torch.Tensor
    delta_r: torch.Tensor
    j_p_bg: torch.Tensor
    j_p_ba: torch.Tensor
    j_v_bg: torch.Tensor
    j_v_ba: torch.Tensor
    j_r_bg: torch.Tensor
    cov: torch.Tensor
    dt: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), device=None) -> "PreintegratedImu":
        device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=device)
        eye = torch.eye(3, **f32).expand(*batch_shape, 3, 3).contiguous()
        zero3 = torch.zeros((*batch_shape, 3), **f32)
        zero33 = torch.zeros((*batch_shape, 3, 3), **f32)
        return PreintegratedImu(
            delta_p=zero3, delta_v=zero3.clone(), delta_r=eye,
            j_p_bg=zero33, j_p_ba=zero33.clone(), j_v_bg=zero33.clone(), j_v_ba=zero33.clone(),
            j_r_bg=zero33.clone(), cov=torch.zeros((*batch_shape, 9, 9), **f32),
            dt=torch.zeros(batch_shape, **f32),
        )

    def corrected_deltas(self, dbg: torch.Tensor, dba: torch.Tensor):
        """First-order bias-corrected (dP, dV, dR) for bias increments
        (dbg, dba) relative to the linearization bias."""
        dp = self.delta_p + (self.j_p_bg @ dbg[..., None])[..., 0] + (self.j_p_ba @ dba[..., None])[..., 0]
        dv = self.delta_v + (self.j_v_bg @ dbg[..., None])[..., 0] + (self.j_v_ba @ dba[..., None])[..., 0]
        dr = self.delta_r @ exp_so3((self.j_r_bg @ dbg[..., None])[..., 0])
        return dp, dv, dr


def _select(valid: torch.Tensor, new: PreintegratedImu, old: PreintegratedImu) -> PreintegratedImu:
    """new where valid (leading dims), else old."""
    out = []
    for n, o in zip(new, old):
        v = valid.reshape(valid.shape + (1,) * (n.dim() - valid.dim()))
        out.append(torch.where(v, n, o))
    return PreintegratedImu(*out)


def _blocks(rows) -> torch.Tensor:
    """A block matrix from a list of rows of (...,a,b) tensors."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def _step(state: PreintegratedImu, omega, acc, dt, valid, noise: ImuNoise) -> PreintegratedImu:
    """One sample of the reference's recursion, batched over leading dims;
    rows with `valid` False leave the state as it was."""
    dt = torch.where(valid, dt, torch.zeros_like(dt))
    dt2 = dt * dt
    dtm = dt[..., None, None]
    dt2m = dt2[..., None, None]
    w_dt = omega * dt[..., None]
    dR_inc = exp_so3(w_dt)
    Jr = right_jacobian(w_dt)
    acc_hat = hat(acc)
    dR = state.delta_r
    dR_ah = dR @ acc_hat
    eye = torch.eye(3, dtype=dt.dtype, device=dt.device).expand(dR.shape)
    zero = torch.zeros_like(dR)
    dR_inc_t = dR_inc.transpose(-1, -2)

    # covariance propagation (order P, V, phi)
    A = _blocks([
        [eye, eye * dtm, -0.5 * dR_ah * dt2m],
        [zero, eye, -dR_ah * dtm],
        [zero, zero, dR_inc_t],
    ])
    Bg = torch.cat([zero, zero, Jr * dtm], dim=-2)  # (...,9,3)
    Ca = torch.cat([0.5 * dR * dt2m, dR * dtm, zero], dim=-2)
    cov = (
        A @ state.cov @ A.transpose(-1, -2)
        + noise.gyro_meas_var * (Bg @ Bg.transpose(-1, -2))
        + noise.acc_meas_var * (Ca @ Ca.transpose(-1, -2))
    )

    # bias Jacobians (with the pre-update dR, J_R_bg)
    j_p_ba = state.j_p_ba + state.j_v_ba * dtm - 0.5 * dR * dt2m
    j_p_bg = state.j_p_bg + state.j_v_bg * dtm - 0.5 * dR_ah @ state.j_r_bg * dt2m
    j_v_ba = state.j_v_ba - dR * dtm
    j_v_bg = state.j_v_bg - dR_ah @ state.j_r_bg * dtm
    j_r_bg = dR_inc_t @ state.j_r_bg - Jr * dtm

    # deltas (P with the old V and R; V with the old R)
    dRa = (dR @ acc[..., None])[..., 0]
    delta_p = state.delta_p + state.delta_v * dt[..., None] + 0.5 * dRa * dt2[..., None]
    delta_v = state.delta_v + dRa * dt[..., None]
    delta_r = normalize_rotation(dR @ dR_inc)

    new = PreintegratedImu(
        delta_p, delta_v, delta_r, j_p_bg, j_p_ba, j_v_bg, j_v_ba, j_r_bg, cov, state.dt + dt
    )
    return _select(valid, new, state)


def compose_preint(a: PreintegratedImu, b: PreintegratedImu) -> PreintegratedImu:
    """Compose consecutive segments (i->j) o (j->k) -> (i->k), batched:

      dP_ik = dP_ij + dV_ij dt_jk + dR_ij dP_jk
      dV_ik = dV_ij + dR_ij dV_jk
      dR_ik = dR_ij dR_jk

    with the bias Jacobians (the bg ones through dR_ij's sensitivity) and
    cov_ik = A cov_ij A^T + B cov_jk B^T."""
    dtb = b.dt[..., None]
    dtbm = dtb[..., None]
    dR_a = a.delta_r
    dp = a.delta_p + a.delta_v * dtb + (dR_a @ b.delta_p[..., None])[..., 0]
    dv = a.delta_v + (dR_a @ b.delta_v[..., None])[..., 0]
    dr = dR_a @ b.delta_r

    j_p_ba = a.j_p_ba + a.j_v_ba * dtbm + dR_a @ b.j_p_ba
    j_v_ba = a.j_v_ba + dR_a @ b.j_v_ba
    hp = hat(b.delta_p)
    hv = hat(b.delta_v)
    j_p_bg = a.j_p_bg + a.j_v_bg * dtbm + dR_a @ b.j_p_bg - dR_a @ hp @ a.j_r_bg
    j_v_bg = a.j_v_bg + dR_a @ b.j_v_bg - dR_a @ hv @ a.j_r_bg
    b_rt = b.delta_r.transpose(-1, -2)
    j_r_bg = b_rt @ a.j_r_bg + b.j_r_bg

    eye = torch.eye(3, dtype=dp.dtype, device=dp.device).expand(dR_a.shape)
    zero = torch.zeros_like(dR_a)
    A = _blocks([
        [eye, eye * dtbm, -dR_a @ hp],
        [zero, eye, -dR_a @ hv],
        [zero, zero, b_rt],
    ])
    B = _blocks([[dR_a, zero, zero], [zero, dR_a, zero], [zero, zero, eye]])
    cov = A @ a.cov @ A.transpose(-1, -2) + B @ b.cov @ B.transpose(-1, -2)
    return PreintegratedImu(dp, dv, dr, j_p_bg, j_p_ba, j_v_bg, j_v_ba, j_r_bg, cov, a.dt + b.dt)


def _identity_like(dt: torch.Tensor) -> PreintegratedImu:
    return PreintegratedImu.identity(tuple(dt.shape), device=dt.device)


def _sample_steps(batch: ImuBatch, bias_g, bias_a, t_start, t_end, noise: ImuNoise):
    """The per-sample single-step segments (...,N) and the segment of the
    gap from t_start to the first sample (...).

    Sample i is integrated over dt = t_{i+1} - t_i with measurement i (zero
    order hold on the previous measurement), the last valid sample up to
    t_end, and the gap from t_start with the first measurement."""
    g = batch.gyro - bias_g[..., None, :]
    a = batch.acc - bias_a[..., None, :]
    t, m = batch.t, batch.mask
    next_t = torch.cat([t[..., 1:], torch.zeros_like(t[..., :1])], dim=-1)
    next_valid = torch.cat([m[..., 1:], torch.zeros_like(m[..., :1])], dim=-1)
    is_last = m & ~next_valid
    dt = torch.where(is_last, t_end[..., None] - t, next_t - t).clamp(min=0.0)
    elems = _step(_identity_like(dt), g, a, dt, m & (dt > 0), noise)

    first = torch.argmax(m.to(torch.int32), dim=-1, keepdim=True)  # first True (0 if none)
    any_valid = m.any(dim=-1)
    t_first = torch.gather(t, -1, first)[..., 0]
    gap0 = torch.where(any_valid, (t_first - t_start).clamp(min=0.0), torch.zeros_like(t_start))
    g0 = torch.gather(g, -2, first[..., None].expand(*first.shape, 3))[..., 0, :]
    a0 = torch.gather(a, -2, first[..., None].expand(*first.shape, 3))[..., 0, :]
    gap = _step(_identity_like(gap0), g0, a0, gap0, any_valid & (gap0 > 0), noise)
    return elems, gap


def _reduce(elems: PreintegratedImu) -> PreintegratedImu:
    """Compose the (...,N) segments in order, pairwise, log2(N) levels."""
    while elems.dt.shape[-1] > 1:
        n = elems.dt.shape[-1]
        if n % 2:
            pad = _identity_like(elems.dt[..., :1])
            elems = PreintegratedImu(*(torch.cat([e, p], dim=elems.dt.dim() - 1) for e, p in zip(elems, pad)))
        lead = elems.dt.dim() - 1
        even = PreintegratedImu(*(e.unflatten(lead, (-1, 2)).select(lead + 1, 0) for e in elems))
        odd = PreintegratedImu(*(e.unflatten(lead, (-1, 2)).select(lead + 1, 1) for e in elems))
        elems = compose_preint(even, odd)
    return PreintegratedImu(*(e.select(elems.dt.dim() - 1, 0) for e in elems))


def preintegrate(
    batch: ImuBatch,
    bias_g: torch.Tensor,
    bias_a: torch.Tensor,
    t_start: torch.Tensor,
    t_end: torch.Tensor,
    noise: ImuNoise = ImuNoise(),
) -> PreintegratedImu:
    """Preintegrate the samples of `batch` over [t_start, t_end] (both f32
    tensors, (...,)), at linearization biases bias_g / bias_a (...,3)."""
    elems, gap = _sample_steps(batch, bias_g, bias_a, t_start, t_end, noise)
    out = compose_preint(gap, _reduce(elems))
    return out._replace(delta_r=normalize_rotation(out.delta_r))


def preintegrate_batch(
    batches: ImuBatch,
    bias_g: torch.Tensor,
    bias_a: torch.Tensor,
    t_start: torch.Tensor,
    t_end: torch.Tensor,
    noise: ImuNoise = ImuNoise(),
) -> PreintegratedImu:
    """K segments at once: batches has leading dim K, biases (K,3) or (3,),
    t_start / t_end (K,). Re-preintegrates a keyframe window after a bias
    update in one pass."""
    k = t_start.shape[0]
    return preintegrate(batches, bias_g.expand(k, 3), bias_a.expand(k, 3), t_start, t_end, noise)


def preintegrate_sequential(
    batch: ImuBatch,
    bias_g: torch.Tensor,
    bias_a: torch.Tensor,
    t_start: torch.Tensor,
    t_end: torch.Tensor,
    noise: ImuNoise = ImuNoise(),
) -> PreintegratedImu:
    """The same integral by the plain recursion, one `_step` per sample
    (the reference's own recursion, the oracle of the pairwise reduction)."""
    elems, gap = _sample_steps(batch, bias_g, bias_a, t_start, t_end, noise)
    g = batch.gyro - bias_g[..., None, :]
    a = batch.acc - bias_a[..., None, :]
    m = batch.mask
    state = gap
    for i in range(batch.capacity):
        dt_i = elems.dt[..., i]
        state = _step(state, g[..., i, :], a[..., i, :], dt_i, m[..., i] & (dt_i > 0), noise)
    return state._replace(delta_r=normalize_rotation(state.delta_r))
