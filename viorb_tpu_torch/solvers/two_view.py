"""Two-view monocular initialization: batched H/F RANSAC + reconstruction
(port of viorb_tpu/solvers/two_view.py).

All homography and all fundamental hypotheses are fitted and scored in one
batched pass (the reference's `vmap` is a leading batch dimension here),
the model is selected by RH = SH / (SH + SF) > 0.40, and the 4 + 8 motion
candidates are checked together by cheirality voting.

The reference draws its minimal sets from `jax.random`, a stream PyTorch
cannot replay. Here `sample_minimal_sets` draws them from a
`torch.Generator`, and `two_view_from_samples` takes given index sets, so a
test can feed the fitting, scoring and reconstruction the same sets as
another implementation. The small batched SVDs are library calls
(`torch.linalg.svd`), as in the reference; on CUDA they may synchronize,
which is acceptable off the per-frame path.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from viorb_tpu_torch.geometry.camera import PinholeCamera, camera_matrix
from viorb_tpu_torch.solvers.triangulation import parallax_cos, triangulate_two_view

SIGMA = 1.0
TH_F = 3.841 * SIGMA**2  # chi2 0.95 1-dof
TH_H = 5.991 * SIGMA**2  # chi2 0.95 2-dof
TH_SCORE = 5.991 * SIGMA**2


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _normalize_points(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hartley normalization of (N,2) points; returns (xn, T) with
    xn = T(x)."""
    mean = x.mean(dim=0)
    d = (x - mean).abs().mean(dim=0)
    s = 1.0 / d.clamp(min=1e-8)
    T = torch.zeros(3, 3, dtype=x.dtype, device=x.device)
    T[0, 0], T[1, 1], T[2, 2] = s[0], s[1], 1.0
    T[0, 2], T[1, 2] = -mean[0] * s[0], -mean[1] * s[1]
    return (x - mean) * s, T


def _fit_fundamental(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """8-point algorithm on (...,8,2)+(...,8,2) -> F (...,3,3), projected
    to rank 2."""
    a = torch.cat(
        [
            x2[..., 0:1] * x1,
            x2[..., 0:1],
            x2[..., 1:2] * x1,
            x2[..., 1:2],
            x1,
            torch.ones_like(x1[..., :1]),
        ],
        dim=-1,
    )  # (...,8,9): [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1]
    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    F = vt[..., 8, :].reshape(*a.shape[:-2], 3, 3)
    u, s, vt2 = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., :1])], dim=-1)
    return (u * s[..., None, :]) @ vt2


def _fit_homography(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """4-point DLT on (...,4,2)+(...,4,2) -> H (...,3,3) with x2 ~ H x1."""
    p1 = _homogeneous(x1)  # (...,n,3)
    zeros = torch.zeros_like(p1)
    r1 = torch.cat([zeros, -p1, x2[..., 1:2] * p1], dim=-1)
    r2 = torch.cat([p1, zeros, -x2[..., 0:1] * p1], dim=-1)
    a = torch.cat([r1, r2], dim=-2)  # (...,2n,9)
    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    return vt[..., 8, :].reshape(*a.shape[:-2], 3, 3)


def _f_score(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric epipolar chi2 score of F (...,3,3) over (N,2) matches:
    (score (...), ok (...,N))."""
    p1 = _homogeneous(x1)
    p2 = _homogeneous(x2)
    Fx1 = p1 @ F.transpose(-1, -2)  # (...,N,3) = F @ p1
    Ftx2 = p2 @ F  # (...,N,3) = F^T @ p2
    x2tFx1 = torch.sum(p2 * Fx1, dim=-1)
    d1 = x2tFx1**2 / (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2).clamp(min=1e-12)
    d2 = x2tFx1**2 / (Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2).clamp(min=1e-12)
    ok = (d1 < TH_F) & (d2 < TH_F) & valid
    score = torch.sum(torch.where(ok, (TH_SCORE - d1) + (TH_SCORE - d2), torch.zeros_like(d1)), dim=-1)
    return score, ok


def _h_score(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric transfer chi2 score of H (...,3,3): (score (...),
    ok (...,N)). A singular H inverts to non-finite numbers, which fail
    every test, as in the reference."""
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hinv = torch.linalg.inv_ex(H + 1e-12 * eye)[0]

    def transfer(M, xa, xb):
        p = _homogeneous(xa) @ M.transpose(-1, -2)
        w = torch.where(p[..., 2].abs() < 1e-10, torch.full_like(p[..., 2], 1e-10), p[..., 2])
        return torch.sum((p[..., :2] / w[..., None] - xb) ** 2, dim=-1)

    d12 = transfer(H, x1, x2)
    d21 = transfer(Hinv, x2, x1)
    ok = (d12 < TH_H) & (d21 < TH_H) & valid
    score = torch.sum(torch.where(ok, (TH_SCORE - d12) + (TH_SCORE - d21), torch.zeros_like(d12)), dim=-1)
    return score, ok


class TwoViewResult(NamedTuple):
    success: torch.Tensor  # () bool
    r_cw2: torch.Tensor  # (3,3) pose of view 2 (view 1 = identity)
    t_cw2: torch.Tensor  # (3,) unit translation (scale-free)
    points: torch.Tensor  # (N,3) triangulated (garbage where not inlier)
    is_inlier: torch.Tensor  # (N,) bool triangulated inliers
    used_h: torch.Tensor  # () bool


def _det_sign(m: torch.Tensor) -> torch.Tensor:
    return torch.sign(torch.linalg.det(m))


def _motion_candidates_from_e(E: torch.Tensor):
    """E (3,3) -> 4 (R,t) candidates."""
    u, _, vt = torch.linalg.svd(E)
    # enforce det(U), det(V) = +1
    u = u * _det_sign(u)
    vt = vt * _det_sign(vt)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]
    t = t / torch.linalg.norm(t).clamp(min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _motion_candidates_from_h(A: torch.Tensor):
    """Faugeras decomposition of the calibrated homography A = K^-1 H K ->
    8 (R,t) candidates."""
    u, s, vt = torch.linalg.svd(A)
    detUV = torch.linalg.det(u) * torch.linalg.det(vt)
    d1n, d3n = s[0] / s[1], s[2] / s[1]  # normalized by d2
    a2, c2 = d1n**2, d3n**2
    x1 = torch.sqrt(((a2 - 1.0) / (a2 - c2)).clamp(min=0.0))
    x3 = torch.sqrt(((1.0 - c2) / (a2 - c2)).clamp(min=0.0))
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)

    Rs, ts = [], []
    for dprime_pos in (True, False):
        for e1 in (1.0, -1.0):
            for e3 in (1.0, -1.0):
                if dprime_pos:  # d' = +d2: rotation about the x2 axis
                    st = e1 * e3 * (d1n - d3n) * x1 * x3
                    ct = d1n * x3 * x3 + d3n * x1 * x1
                    Rp = torch.stack(
                        [torch.stack([ct, zero, -st]), torch.stack([zero, one, zero]),
                         torch.stack([st, zero, ct])]
                    )
                    tp = torch.stack([e1 * x1, zero, -e3 * x3]) * (d1n - d3n)
                else:  # d' = -d2: rotation by pi about x2 plus a reflection
                    sp = e1 * e3 * (d1n + d3n) * x1 * x3
                    cp = d3n * x1 * x1 - d1n * x3 * x3
                    Rp = torch.stack(
                        [torch.stack([cp, zero, sp]), torch.stack([zero, -one, zero]),
                         torch.stack([sp, zero, -cp])]
                    )
                    tp = torch.stack([e1 * x1, zero, e3 * x3]) * (d1n + d3n)
                t = u @ tp
                Rs.append(detUV * u @ Rp @ vt)
                ts.append(t / torch.linalg.norm(t).clamp(min=1e-12))
    return torch.stack(Rs), torch.stack(ts)


def _check_motion(
    R: torch.Tensor,  # (...,3,3)
    t: torch.Tensor,  # (...,3)
    x1n: torch.Tensor,  # (N,2) normalized (K^-1) coords view 1
    x2n: torch.Tensor,
    inlier: torch.Tensor,  # (N,) bool
    cam_sigma2: float = 1.0,
):
    """Triangulate with (I|0), (R|t) in normalized coords; mark points with
    positive depth in both views, bounded reprojection error and parallax.
    Batched over the candidates: (good (...,N), X (...,N,3), cosp (...,N))."""
    P1 = torch.eye(3, 4, dtype=R.dtype, device=R.device)
    P2 = torch.cat([R, t[..., None]], dim=-1)
    X = triangulate_two_view(P1, P2[..., None, :, :], x1n, x2n)  # (...,N,3)
    z1 = X[..., 2]
    Xc2 = X @ R.transpose(-1, -2) + t[..., None, :]
    z2 = Xc2[..., 2]
    c2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    cosp = parallax_cos(torch.zeros_like(c2)[..., None, :], c2[..., None, :], X)
    # reprojection in normalized coords; threshold ~ (2 px / f)^2
    e1 = torch.sum((X[..., :2] / z1.clamp(min=1e-9)[..., None] - x1n) ** 2, dim=-1)
    e2 = torch.sum((Xc2[..., :2] / z2.clamp(min=1e-9)[..., None] - x2n) ** 2, dim=-1)
    th = 4.0 * cam_sigma2
    good = inlier & (z1 > 0) & (z2 > 0) & (cosp < 0.99998) & (e1 < th) & (e2 < th)
    return good, X, cosp


def sample_minimal_sets(
    valid: torch.Tensor, n_hypotheses: int, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC minimal sets: ((n_hypotheses,4), (n_hypotheses,8)) int64 row
    indices drawn without replacement from the valid matches, on `valid`'s
    device. Each hypothesis draws ONE ordered 8-set and its H set is the
    first 4 of it: the reference draws both sets from one key, and they
    come out nested the same way (the first 4 of an ordered draw without
    replacement are distributed as a 4-draw). The draw runs on the
    generator's device. Invalid rows keep a vanishing weight, so with too
    few valid matches the draw still returns (degenerate sets that score
    poorly) instead of raising."""
    p = (valid.to(torch.float32) + 1e-9).to(generator.device).expand(n_hypotheses, -1)
    idx_f = torch.multinomial(p, 8, replacement=False, generator=generator)
    return idx_f[:, :4].contiguous().to(valid.device), idx_f.to(valid.device)


def two_view_init(
    x1: torch.Tensor,  # (N,2) undistorted pixel matches in frame 1
    x2: torch.Tensor,  # (N,2) matches in frame 2
    valid: torch.Tensor,  # (N,) bool
    cam: PinholeCamera,
    generator: torch.Generator,
    n_hypotheses: int = 256,
) -> TwoViewResult:
    """Full monocular initialization: batched RANSAC of H and F, RH model
    selection, motion reconstruction with cheirality voting."""
    idx_h, idx_f = sample_minimal_sets(valid, n_hypotheses, generator)
    return two_view_from_samples(x1, x2, valid, cam, idx_h, idx_f)


def two_view_from_samples(
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    cam: PinholeCamera,
    idx_h: torch.Tensor,  # (Hh,4) int64 minimal sets of the homographies
    idx_f: torch.Tensor,  # (Hf,8) int64 minimal sets of the fundamentals
) -> TwoViewResult:
    """`two_view_init` on given minimal sets."""
    dtype, dev = x1.dtype, x1.device
    x1n_, T1 = _normalize_points(x1)
    x2n_, T2 = _normalize_points(x2)

    # --- hypotheses, denormalized: x2 = T2^-1 H T1 x1, F' = T2^T F T1 ---
    Hs = torch.linalg.inv(T2) @ _fit_homography(x1n_[idx_h], x2n_[idx_h]) @ T1
    Fs = T2.T @ _fit_fundamental(x1n_[idx_f], x2n_[idx_f]) @ T1
    h_scores, h_oks = _h_score(Hs, x1, x2, valid)
    f_scores, f_oks = _f_score(Fs, x1, x2, valid)
    bh = torch.argmax(h_scores)
    bf = torch.argmax(f_scores)
    SH, H, h_inl = h_scores[bh], Hs[bh], h_oks[bh]
    SF, F, f_inl = f_scores[bf], Fs[bf], f_oks[bf]
    use_h = SH / (SH + SF).clamp(min=1e-9) > 0.40

    # --- reconstruction ---
    K = camera_matrix(cam, dev, dtype)
    Kinv = torch.linalg.inv(K)
    x1n = (_homogeneous(x1) @ Kinv.T)[:, :2]
    x2n = (_homogeneous(x2) @ Kinv.T)[:, :2]
    Rs_f, ts_f = _motion_candidates_from_e(K.T @ F @ K)  # (4,..)
    Rs_h, ts_h = _motion_candidates_from_h(Kinv @ H @ K)  # (8,..)
    # evaluate all 12 candidates; gate by which model was selected
    Rs_all = torch.cat([Rs_f, Rs_h])  # (12,3,3)
    ts_all = torch.cat([ts_f, ts_h])
    from_f = torch.arange(12, device=dev) < 4
    inl = torch.where(use_h, h_inl, f_inl)
    goods, Xs, _ = _check_motion(Rs_all, ts_all, x1n, x2n, inl, (SIGMA / cam.fx) ** 2)
    counts = goods.sum(dim=1)  # (12,)
    counts = torch.where(from_f == use_h, torch.full_like(counts, -1), counts)
    best = torch.argmax(counts)
    n_good = counts[best]
    # acceptance: enough points, most of the inliers, a clear winner
    second = torch.where(torch.arange(12, device=dev) == best, torch.full_like(counts, -1), counts).max()
    ok = (n_good >= 30) & (n_good > 0.8 * inl.sum()) & (second < 0.75 * n_good)
    return TwoViewResult(
        success=ok,
        r_cw2=Rs_all[best],
        t_cw2=ts_all[best],
        points=Xs[best],
        is_inlier=goods[best],
        used_h=use_h,
    )
