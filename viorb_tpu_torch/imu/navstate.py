"""NavState: the 15-DoF VI state {P, V, R, bg, ba, dbg, dba} (port of
viorb_tpu/imu/navstate.py), batched over leading dims.

Kinematic propagation over a preintegrated segment:

  P += V dt + 1/2 g dt^2 + R dP ;  V += g dt + R dV ;  R = R dR

Bias convention: `bg` / `ba` are the linearization-point biases the
preintegration used; `dbg` / `dba` the estimated increments on top.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from viorb_tpu_torch.device import resolve_device
from viorb_tpu_torch.geometry.so3 import exp_so3
from viorb_tpu_torch.imu.preintegration import PreintegratedImu

GRAVITY_W = np.array([0.0, 0.0, -9.810], np.float32)


class NavState(NamedTuple):
    p: torch.Tensor  # (...,3) world position of the body
    v: torch.Tensor  # (...,3) world velocity
    r: torch.Tensor  # (...,3,3) Rwb, body -> world
    bg: torch.Tensor  # (...,3) gyro bias (linearization point)
    ba: torch.Tensor  # (...,3) acc bias (linearization point)
    dbg: torch.Tensor  # (...,3) gyro bias increment
    dba: torch.Tensor  # (...,3) acc bias increment

    @staticmethod
    def identity(batch_shape=(), device=None) -> "NavState":
        device = resolve_device(device)
        z = torch.zeros((*batch_shape, 3), dtype=torch.float32, device=device)
        eye = torch.eye(3, dtype=torch.float32, device=device).expand(*batch_shape, 3, 3).contiguous()
        return NavState(z, z.clone(), eye, z.clone(), z.clone(), z.clone(), z.clone())

    def inc_pvr(self, dpvr: torch.Tensor) -> "NavState":
        """Manifold increment on (P, V, phi), 9-dim."""
        dp, dv, dphi = dpvr[..., 0:3], dpvr[..., 3:6], dpvr[..., 6:9]
        return self._replace(p=self.p + dp, v=self.v + dv, r=self.r @ exp_so3(dphi))

    def inc_bias(self, dbias: torch.Tensor) -> "NavState":
        """6-dim bias increment (dbg, dba)."""
        return self._replace(dbg=self.dbg + dbias[..., 0:3], dba=self.dba + dbias[..., 3:6])

    def inc_small(self, dx: torch.Tensor) -> "NavState":
        """15-dim increment (P, V, phi, dbg, dba)."""
        return self.inc_pvr(dx[..., :9]).inc_bias(dx[..., 9:15])


def select_nav(cond: torch.Tensor, a: NavState, b: NavState) -> NavState:
    """a where `cond` (a () bool tensor), else b, field by field."""
    return NavState(*[torch.where(cond, x, y) for x, y in zip(a, b)])


def propagate_navstate(
    ns: NavState, preint: PreintegratedImu, gravity_w: Optional[torch.Tensor] = None
) -> NavState:
    """Kinematic propagation over a preintegrated segment, with the
    first-order bias correction of the deltas. `gravity_w` defaults to
    GRAVITY_W; pass it as a tensor inside a CUDA graph (building it from
    numbers there would be a host-to-device copy)."""
    if gravity_w is None:
        gravity_w = torch.from_numpy(GRAVITY_W).to(ns.p.device)
    dp, dv, dr = preint.corrected_deltas(ns.dbg, ns.dba)
    dt = preint.dt[..., None]
    p = ns.p + ns.v * dt + 0.5 * gravity_w * dt * dt + (ns.r @ dp[..., None])[..., 0]
    v = ns.v + gravity_w * dt + (ns.r @ dv[..., None])[..., 0]
    r = ns.r @ dr
    return ns._replace(p=p, v=v, r=r)
