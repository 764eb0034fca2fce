"""Sim3 pose-graph (essential graph) optimization (port of
viorb_tpu/optim/pose_graph.py; the reference ORB-SLAM's
Optimizer::OptimizeEssentialGraph: a Sim3 vertex per keyframe, edges from
the spanning tree, strong covisibility and the loop; mono scale free, or
every scale pinned with `fix_scale` for stereo and RGB-D).

The residual of edge i -> j is e = Log(S_ji_meas * S_i * S_j^-1) (7-dim),
and a left increment moves a vertex, S <- Exp(d) S. With R = S_ji_meas
S_i S_j^-1 = Exp(e), the residual at increments (d_i, d_j) is
Log(Exp(Ad_M d_i) R Exp(-d_j)) (M = S_ji_meas), so its Jacobians are
exact in closed form: de/dd_j = -Jr^-1(e) and de/dd_i = Jr^-1(e)
Ad(S_j S_i^-1), with Jr^-1(e) = sum_n B_n (-ad_e)^n / n!, the Bernoulli
series (through ad^8: its next term is below 1e-10 of the first for
|ad_e| < 0.5, and an edge's residual is far smaller). Plain batched
matrix products, a few hundred kernel launches an iteration, where
differentiating the residual forward (`jacfwd`) took ~1900.
Dense damped Gauss-Newton over all 7K states (K up to a few hundred: a
small solve), each iteration accepted or rejected on the device with no
host sync. The normal equations are products of the dense (7E, 7K) edge
Jacobian, placed by one-hot masks: a GEMM sums a keyframe's edges in an
order fixed by the shapes, where float atomics would make the solve differ
from run to run on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from viorb_tpu_torch.geometry.sim3 import exp_sim3, log_sim3, sim3_compose, sim3_inverse
from viorb_tpu_torch.geometry.so3 import hat


class Sim3Graph(NamedTuple):
    """Edges i -> j with measured relative transform S_ji = S_j * S_i^-1.

    edge_i/j: (E,) int64; meas_s: (E,), meas_r: (E,3,3), meas_t: (E,3);
    weight: (E,) f32."""

    edge_i: torch.Tensor
    edge_j: torch.Tensor
    meas_s: torch.Tensor
    meas_r: torch.Tensor
    meas_t: torch.Tensor
    weight: torch.Tensor


def _edge_residual(si, ri, ti, sj, rj, tj, ms, mr, mt):
    """(e = Log(S_ji_meas * S_i * S_j^-1) (E,7), S_i * S_j^-1), batched over
    the edges."""
    rel = sim3_compose(si, ri, ti, *sim3_inverse(sj, rj, tj))
    return log_sim3(*sim3_compose(ms, mr, mt, *rel)), rel


def _adjoint(s, r, t) -> torch.Tensor:
    """Ad of (s, R, t) on (rho, phi, sigma), (E,7,7): S Exp(x) S^-1 =
    Exp(Ad x)."""
    e = s.shape[0]
    z31 = t.new_zeros(e, 3, 1)
    top = torch.cat([s[:, None, None] * r, hat(t) @ r, -t[:, :, None]], dim=-1)
    mid = torch.cat([torch.zeros_like(r), r, z31], dim=-1)
    bot = torch.cat([t.new_zeros(e, 1, 6), t.new_ones(e, 1, 1)], dim=-1)
    return torch.cat([top, mid, bot], dim=-2)


def _jr_inv(x: torch.Tensor) -> torch.Tensor:
    """The inverse right Jacobian of Sim3 at x = (rho, phi, sigma), (E,7,7):
    I + ad/2 + ad^2/12 - ad^4/720 + ad^6/30240 - ad^8/1209600."""
    rho, phi, sigma = x[:, :3], x[:, 3:6], x[:, 6]
    e = x.shape[0]
    eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
    wp = hat(phi)
    top = torch.cat([wp + sigma[:, None, None] * eye3, hat(rho), -rho[:, :, None]], dim=-1)
    mid = torch.cat([torch.zeros_like(wp), wp, x.new_zeros(e, 3, 1)], dim=-1)
    ad = torch.cat([top, mid, x.new_zeros(e, 1, 7)], dim=-2)
    ad2 = ad @ ad
    ad4 = ad2 @ ad2
    ad6 = ad4 @ ad2
    eye7 = torch.eye(7, dtype=x.dtype, device=x.device)
    return eye7 + 0.5 * ad + ad2 / 12.0 - ad4 / 720.0 + ad6 / 30240.0 - (ad4 @ ad4) / 1209600.0


def optimize_sim3_graph(
    s: torch.Tensor,  # (K,) scales (Scw: world -> camera)
    r: torch.Tensor,  # (K,3,3)
    t: torch.Tensor,  # (K,3)
    graph: Sim3Graph,
    fixed: torch.Tensor,  # (K,) bool
    iters: int = 20,
    fix_scale: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`iters` damped Gauss-Newton steps with the `fixed` vertices held.
    `fix_scale` pins every vertex's sigma dof too (an SE3 graph inside the
    Sim3 one: the reference's essential graph for stereo and RGB-D), so the
    scales stay as given."""
    k, d = s.shape[0], 7
    dev = s.device
    ei, ej = graph.edge_i, graph.edge_j
    fixed_kd = fixed.repeat_interleave(d)
    if fix_scale:
        fixed_kd = fixed_kd | (torch.arange(k * d, device=dev) % d == 6)
    free = ~fixed_kd
    free_f = free.to(torch.float32)
    pin = torch.where(fixed_kd, 1.0, 1e-8).diag()
    w = graph.weight
    kk = torch.arange(k, device=dev)
    at_i = (ei[:, None] == kk[None, :]).to(torch.float32)[:, None, :, None]  # (E,1,K,1)
    at_j = (ej[:, None] == kk[None, :]).to(torch.float32)[:, None, :, None]
    meas = (graph.meas_s, graph.meas_r, graph.meas_t)

    def cost(s, r, t):
        res, _ = _edge_residual(s[ei], r[ei], t[ei], s[ej], r[ej], t[ej], *meas)
        return (w * (res * res).sum(-1)).sum()

    def system(s, r, t):
        res, rel = _edge_residual(s[ei], r[ei], t[ei], s[ej], r[ej], t[ej], *meas)
        Jj = -_jr_inv(res)  # (E,7,7)
        Ji = -Jj @ _adjoint(*sim3_inverse(*rel))  # Ad(S_j S_i^-1)
        # the dense edge Jacobian (7E, 7K): each edge's blocks at its two keyframes
        Jd = (at_i * Ji[:, :, None, :] + at_j * Jj[:, :, None, :]).reshape(-1, k * d)
        wJd = Jd * w.repeat_interleave(d)[:, None]
        H = wJd.T @ Jd
        g = -(wJd.T @ res.reshape(-1))
        return H, g, (w * (res * res).sum(-1)).sum()

    lam = torch.full((), 1e-6, dtype=torch.float32, device=dev)
    for _ in range(iters):
        Hd, g, cost0 = system(s, r, t)
        Hd = Hd + lam * torch.diag(Hd.diagonal().clamp(min=1e-6))
        Hm = Hd * free_f[:, None] * free_f[None, :] + pin
        gm = g.reshape(k * d) * free_f
        dx = torch.linalg.solve_ex(Hm, gm[:, None])[0][:, 0].reshape(k, d)
        s_n, r_n, t_n = sim3_compose(*exp_sim3(dx), s, r, t)
        acc = cost(s_n, r_n, t_n) < cost0
        s = torch.where(acc, s_n, s)
        r = torch.where(acc, r_n, r)
        t = torch.where(acc, t_n, t)
        lam = torch.where(acc, (lam * 0.5).clamp(min=1e-8), (lam * 4).clamp(max=1e6))
    return s, r, t
