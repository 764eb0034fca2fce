"""Device functions of the SLAM front end and of local mapping (port of
viorb_tpu/slam/kernels.py): projection matching for tracking and for
fusion, epipolar matching and triangulation between keyframes, the
local-map unpack, rectified stereo matching and its sub-pixel refinement.

Each is a fixed-shape batched program: project every map point, gate it
(frustum, view angle, scale range), gate every point-feature pair (search
window, epipolar line or scan line), take one Hamming matmul, and keep
mutual best matches. `refine_stereo_subpixel` is the plain version of the
hand-written kernel K9 (`slam/stereo_cuda.py`), which the card runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from viorb_tpu_torch.features.matching import (
    MatchResult,
    hamming_matrix,
    match_with_mask,
    valid_gate,
)
from viorb_tpu_torch.geometry.camera import PinholeCamera, camera_matrix, in_image_mask, project
from viorb_tpu_torch.geometry.so3 import hat
from viorb_tpu_torch.solvers.triangulation import (
    parallax_cos,
    projection_matrix,
    triangulate_two_view,
)


class ProjectionMatches(NamedTuple):
    point_for_feat: torch.Tensor  # (Nf,) best point row per frame feature (-1)
    dist: torch.Tensor  # (Nf,)
    n_matches: torch.Tensor  # ()


class _Candidates(NamedTuple):
    """What projection matching computes before the search radius enters."""

    frustum: torch.Tensor  # (Np,) bool: the point is visible from the pose
    gate: torch.Tensor  # (Np,Nf) bool: visible point x valid feature
    d: torch.Tensor  # (Np,Nf) f32 Hamming distances
    d2: torch.Tensor  # (Np,Nf) f32 squared pixel distances


def _projection_candidates(
    pts_xyz, pts_desc, pts_valid, pts_normal, pts_min_dist, pts_max_dist,
    r_cw, t_cw, feat_xy, feat_desc, feat_valid, cam: PinholeCamera,
) -> _Candidates:
    pc = pts_xyz @ r_cw.T + t_cw
    depth = pc[:, 2]
    uv = project(cam, pc)
    c_w = -r_cw.T @ t_cw
    view_dir = pts_xyz - c_w
    dist = torch.linalg.norm(view_dir, dim=1)
    # viewing angle vs normal < 60 deg
    cos_view = torch.sum(view_dir * pts_normal, dim=1) / dist.clamp(min=1e-9)
    frustum = (
        pts_valid
        & (depth > 0.05)
        & in_image_mask(cam, uv, margin=1.0)
        & (cos_view > 0.5)
        & (dist >= 0.8 * pts_min_dist)
        & (dist <= 1.2 * pts_max_dist)
    )
    # distance matrix points x features
    d = hamming_matrix(pts_desc, feat_desc)
    dx = uv[:, None, 0] - feat_xy[None, :, 0]
    dy = uv[:, None, 1] - feat_xy[None, :, 1]
    return _Candidates(frustum, frustum[:, None] & feat_valid[None, :], d, dx * dx + dy * dy)


def _match_in_radius(cand: _Candidates, radius: float, max_dist: float):
    """(point_for_feat (Nf,) int64, MatchResult over points, n_matches ())."""
    gate = cand.gate & (cand.d2 <= radius * radius)
    res = match_with_mask(cand.d, gate, max_dist=max_dist, ratio=0.9, mutual=True)
    # invert: per-feature point index. Mutual best makes the matched
    # features distinct; unmatched rows write to a dropped slot nf.
    n_pts, nf = cand.d.shape
    dev = cand.d.device
    ok = res.idx >= 0
    rows = torch.arange(n_pts, device=dev)
    point_for_feat = torch.full((nf + 1,), -1, dtype=torch.int64, device=dev)
    point_for_feat[torch.where(ok, res.idx, nf)] = torch.where(ok, rows, -1)
    return point_for_feat[:nf], res, ok.sum()


def match_by_projection(
    pts_xyz: torch.Tensor,  # (Np,3) world
    pts_desc: torch.Tensor,  # (Np,256) {-1,1}
    pts_valid: torch.Tensor,  # (Np,)
    pts_normal: torch.Tensor,  # (Np,3)
    pts_min_dist: torch.Tensor,  # (Np,)
    pts_max_dist: torch.Tensor,  # (Np,)
    r_cw: torch.Tensor,
    t_cw: torch.Tensor,
    feat_xy: torch.Tensor,  # (Nf,2)
    feat_desc: torch.Tensor,  # (Nf,256)
    feat_valid: torch.Tensor,
    cam: PinholeCamera,
    radius: float,  # search window px
    max_dist: float = 50.0,
):
    """Returns (point_for_feat (Nf,) int64, MatchResult over points,
    n_matches (), visible (Np,) bool)."""
    cand = _projection_candidates(
        pts_xyz, pts_desc, pts_valid, pts_normal, pts_min_dist, pts_max_dist,
        r_cw, t_cw, feat_xy, feat_desc, feat_valid, cam,
    )
    pf, res, n = _match_in_radius(cand, radius, max_dist)
    return pf, res, n, cand.frustum


# the tracking cores' search: 15 px, and 30 px when that finds fewer than 20
TRACK_RADIUS = 15.0
TRACK_WIDE_RADIUS = 30.0
TRACK_MIN_MATCHES = 20
TRACK_MAX_HAMMING = 50.0  # `match_by_projection`'s default


def match_by_projection_retry(
    pts_xyz, pts_desc, pts_valid, pts_normal, pts_min_dist, pts_max_dist,
    r_cw, t_cw, feat_xy, feat_desc, feat_valid, cam: PinholeCamera,
):
    """`match_by_projection` at `TRACK_RADIUS`, and at `TRACK_WIDE_RADIUS`
    instead when the first yields fewer than `TRACK_MIN_MATCHES`: the
    tracking cores' retry, with no host sync. The reference branches with
    `lax.cond`; here the projection, the frustum gate, the Hamming matrix
    and the squared distances, none of which depends on the radius, are
    computed once, both radii are matched, and each field is selected with
    `torch.where` on the device. Same outcome as the branch on every input.
    `visible` is the frustum gate, the same for both radii."""
    cand = _projection_candidates(
        pts_xyz, pts_desc, pts_valid, pts_normal, pts_min_dist, pts_max_dist,
        r_cw, t_cw, feat_xy, feat_desc, feat_valid, cam,
    )
    pf_a, res_a, n_a = _match_in_radius(cand, TRACK_RADIUS, TRACK_MAX_HAMMING)
    pf_b, res_b, n_b = _match_in_radius(cand, TRACK_WIDE_RADIUS, TRACK_MAX_HAMMING)
    wide = n_a < TRACK_MIN_MATCHES
    res = MatchResult(torch.where(wide, res_b.idx, res_a.idx), torch.where(wide, res_b.dist, res_a.dist))
    return torch.where(wide, pf_b, pf_a), res, torch.where(wide, n_b, n_a), cand.frustum


def unpack_desc_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N,32) uint8 packed bits (numpy packbits bitorder='little') ->
    (N,256) uint8 {0,1}."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    b = (bits[:, :, None] >> shifts[None, None, :]) & 1
    return b.reshape(bits.shape[0], 256).to(torch.uint8)


def unpack_local_map(
    packed: torch.Tensor,  # (M,8) f32: xyz | normal | dmin | dmax
    desc_bits: torch.Tensor,  # (M,32) uint8 packed descriptor bits
    valid: torch.Tensor,  # (M,)
):
    """Split the packed local-map upload into the argument tuple the
    tracking cores take (xyz, desc_pm1, valid, normal, dmin, dmax);
    desc_pm1 is f32 {-1,+1}, zeroed on invalid rows."""
    return (
        packed[:, 0:3], _desc_pm1(unpack_desc_bits(desc_bits), valid), valid, packed[:, 3:6], packed[:, 6],
        packed[:, 7],
    )


def _desc_pm1(desc01: torch.Tensor, valid: torch.Tensor = None) -> torch.Tensor:
    """(N,256) {0,1} -> f32 {-1,+1}; rows not `valid` become all zero."""
    d = desc01.to(torch.float32) * 2 - 1
    return d if valid is None else d * valid[:, None].to(torch.float32)


def fuse_match_gathered(
    pt_packed: torch.Tensor,  # (U,8) f32 union payload: xyz|normal|dmin|dmax
    pt_desc_bits: torch.Tensor,  # (U,32) uint8 packed bits
    pt_valid: torch.Tensor,  # (U,)
    sel: torch.Tensor,  # (S,) int rows of the union for THIS pair, -1 pad
    r_cw: torch.Tensor,
    t_cw: torch.Tensor,
    kf_xy: torch.Tensor,
    kf_desc_pm1: torch.Tensor,
    kf_valid: torch.Tensor,
    cam: PinholeCamera,
    radius: float,
):
    """Fuse-projection matching where the (mutable) point payload is the
    per-job union, uploaded once, and each keyframe pair selects its subset
    on the device. Returns what `match_by_projection` returns."""
    ok = sel >= 0
    s = sel.clamp(min=0).to(torch.int64)
    packed = pt_packed[s]
    valid = pt_valid[s] & ok
    desc_pm1 = _desc_pm1(unpack_desc_bits(pt_desc_bits[s]), valid)
    return match_by_projection(
        packed[:, 0:3], desc_pm1, valid, packed[:, 3:6], packed[:, 6],
        packed[:, 7], r_cw, t_cw, kf_xy, kf_desc_pm1, kf_valid, cam, radius,
    )


def fundamental_from_poses(
    r1: torch.Tensor, t1: torch.Tensor, r2: torch.Tensor, t2: torch.Tensor, K: torch.Tensor
) -> torch.Tensor:
    """F12 with x1^T F12 x2 = 0 for pixel coords, from the two keyframes'
    world->camera poses."""
    # relative pose: cam1 <- world <- cam2
    R12 = r1 @ r2.T
    t12 = -R12 @ t2 + t1
    Kinv = torch.linalg.inv(K)
    E = hat(t12) @ R12  # x1_c^T E x2_c
    return Kinv.T @ E @ Kinv


def match_for_triangulation(
    xy1: torch.Tensor,  # (N,2) features of KF1 (no map point)
    desc1: torch.Tensor,  # (N,256) {-1,+1}
    free1: torch.Tensor,  # (N,) bool: valid & unmatched
    xy2: torch.Tensor,
    desc2: torch.Tensor,
    free2: torch.Tensor,
    F12: torch.Tensor,  # x1^T F12 x2 = 0
    max_dist: float = 50.0,
    epi_th: float = 3.84,
) -> MatchResult:
    """Epipolar-gated Hamming matching: a pair is a candidate when x1 lies
    within `epi_th` px of the epipolar line of x2 in image 1."""
    p1 = torch.cat([xy1, torch.ones_like(xy1[:, :1])], 1)
    p2 = torch.cat([xy2, torch.ones_like(xy2[:, :1])], 1)
    l1 = p2 @ F12.T  # (N2,3) epipolar line of x2 in image 1
    num = (p1 @ l1.T) ** 2  # (N1,N2)
    den = (l1[:, 0] ** 2 + l1[:, 1] ** 2).clamp(min=1e-12)[None, :]
    gate = valid_gate(free1, free2) & (num / den < epi_th**2)
    d = hamming_matrix(desc1, desc2)
    return match_with_mask(d, gate, max_dist=max_dist, ratio=0.8, mutual=True)


def project_depth(r_cw, t_cw, xyz, cam: PinholeCamera):
    """World points -> (pixels (N,2), camera-frame depth (N,))."""
    pc = xyz @ r_cw.T + t_cw
    return project(cam, pc), pc[:, 2]


def triangulate_between(
    r1: torch.Tensor,  # (3,3) pose of KF1
    t1: torch.Tensor,
    xy1: torch.Tensor,  # (N1,2) undistorted keypoints
    lv1: torch.Tensor,  # (N1,) pyramid level
    desc1_01: torch.Tensor,  # (N1,256) uint8 {0,1}
    free1: torch.Tensor,  # (N1,) valid & unbound
    r2: torch.Tensor,
    t2: torch.Tensor,
    xy2: torch.Tensor,
    lv2: torch.Tensor,
    desc2_01: torch.Tensor,
    free2: torch.Tensor,
    cam: PinholeCamera,
    sigma2: torch.Tensor,  # (L,) per-level variance factors
):
    """New map points for one keyframe pair as one static-shape program:
    epipolar-gated Hamming matching, batched DLT triangulation of EVERY
    feature slot (masked), and the acceptance checks (depth, chi2
    reprojection, parallax). Returns (idx (N1,) match in KF2 or -1,
    X (N1,3), good (N1,) bool): one pull for the caller."""
    K = camera_matrix(cam, xy1.device, xy1.dtype)
    F12 = fundamental_from_poses(r1, t1, r2, t2, K)
    res = match_for_triangulation(xy1, _desc_pm1(desc1_01), free1, xy2, _desc_pm1(desc2_01), free2, F12)
    idx = res.idx
    j = idx.clamp(min=0)
    X = triangulate_two_view(
        projection_matrix(K, r1, t1), projection_matrix(K, r2, t2), xy1, xy2[j]
    )
    pc1 = X @ r1.T + t1
    pc2 = X @ r2.T + t2
    e1 = torch.sum((project(cam, pc1) - xy1) ** 2, dim=-1)
    e2 = torch.sum((project(cam, pc2) - xy2[j]) ** 2, dim=-1)
    cosp = parallax_cos(-r1.T @ t1, -r2.T @ t2, X)
    good = (
        (idx >= 0)
        & (pc1[:, 2] > 0.05)
        & (pc2[:, 2] > 0.05)
        & (e1 < 5.991 * sigma2[lv1])
        & (e2 < 5.991 * sigma2[lv2[j]])
        & (cosp < 0.9998)
    )
    return idx, X, good


def match_stereo(
    xy_l: torch.Tensor,  # (Nl,2) left keypoints (undistorted, rectified)
    desc_l: torch.Tensor,  # (Nl,256) {-1,+1}, 0 on invalid rows
    valid_l: torch.Tensor,
    level_l: torch.Tensor,  # (Nl,)
    xy_r: torch.Tensor,  # (Nr,2) right keypoints
    desc_r: torch.Tensor,
    valid_r: torch.Tensor,
    level_r: torch.Tensor,
    min_disp: float,
    max_disp: float,
    max_dist: float = 50.0,
):
    """Rectified stereo matching: one masked Hamming matmul over all left x
    right pairs, gated to the same scan line (a row tolerance of 2 x 1.2^level
    of the left keypoint), a disparity range and a pyramid-level difference
    of at most 1; ratio 0.9, mutual best. Returns (ur (Nl,) f32, the right
    u of each left feature's match or -1, matched (Nl,) bool)."""
    row_tol = 2.0 * torch.pow(1.2, level_l.to(torch.float32))
    dv = (xy_l[:, None, 1] - xy_r[None, :, 1]).abs()
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    dlev = (level_l[:, None] - level_r[None, :]).abs()
    gate = (
        valid_gate(valid_l, valid_r)
        & (dv <= row_tol[:, None])
        & (disp >= min_disp)
        & (disp <= max_disp)
        & (dlev <= 1)
    )
    res = match_with_mask(hamming_matrix(desc_l, desc_r), gate, max_dist=max_dist, ratio=0.9, mutual=True)
    matched = res.idx >= 0
    ur = torch.where(matched, xy_r[res.idx.clamp(min=0), 0], torch.full_like(xy_l[:, 0], -1.0))
    return ur, matched


SUBPIX_HALF = 5  # an 11x11 SAD window
SUBPIX_SEARCH = 3  # +-3 px around the descriptor match


def subpixel_windows(img_l, img_r, xy_l, ur0):
    """Each keypoint's 11x11 left patch (N,11,11) and 11x17 right strip
    (N,11,17), cut from the images padded by edge replication (pad 9) at
    the starts `jax.lax.dynamic_slice` takes: a negative start counts from
    the end of the padded axis, then the start is clamped so that the window
    stays inside (an unmatched ur0 = -1 lands on the pad). Coordinates round
    half to even."""
    h, s = SUBPIX_HALF, SUBPIX_SEARCH
    win, pad = 2 * h + 1, h + s + 1
    pl = F.pad(img_l[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    pr = F.pad(img_r[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    hp, wp = pl.shape
    dev = img_l.device

    def start(x, lo, size, n):  # x rounded + lo: the window's start on an axis of n
        i = torch.round(x).to(torch.int64) + lo
        return torch.where(i < 0, i + n, i).clamp(0, n - size)

    y0 = start(xy_l[:, 1], pad - h, win, hp)
    xl0 = start(xy_l[:, 0], pad - h, win, wp)
    xr0 = start(ur0, pad - h - s, win + 2 * s, wp)
    rows = (y0[:, None] + torch.arange(win, device=dev))[:, :, None]
    patch_l = pl[rows, (xl0[:, None] + torch.arange(win, device=dev))[:, None, :]]
    strip_r = pr[rows, (xr0[:, None] + torch.arange(win + 2 * s, device=dev))[:, None, :]]
    return patch_l, strip_r


def refine_stereo_subpixel(
    img_l: torch.Tensor,  # (H,W) f32 left image (rectified)
    img_r: torch.Tensor,  # (H,W) f32 right image
    xy_l: torch.Tensor,  # (N,2) left keypoints
    ur0: torch.Tensor,  # (N,) right u of the descriptor match
    matched: torch.Tensor,  # (N,) bool
) -> torch.Tensor:
    """Sub-pixel right u (N,) f32, -1 where unmatched: the SAD of the 11x11
    left patch against the right strip at 7 shifts (+-3 px around the
    rounded match), the first smallest, and a parabola through it and its
    neighbours when it is interior (the fraction gated on |denominator| >
    1e-6, clipped to +-1). The plain version of K9 (`slam/stereo_cuda.py`),
    equal to it bit for bit on the card: each SAD is ONE running f32 sum over
    the window in row-major order, as the kernel adds (the reference lets
    XLA pick the order)."""
    h, s = SUBPIX_HALF, SUBPIX_SEARCH
    win = 2 * h + 1
    patch_l, strip_r = subpixel_windows(img_l, img_r, xy_l, ur0)
    diff = torch.stack([(patch_l - strip_r[:, :, d : d + win]).abs() for d in range(2 * s + 1)], 1)
    diff = diff.reshape(diff.shape[0], 2 * s + 1, win * win)
    sads = torch.zeros_like(diff[:, :, 0])
    for i in range(win * win):
        sads = sads + diff[:, :, i]
    best = torch.argmin(sads, dim=1)  # the first smallest
    interior = (best > 0) & (best < 2 * s)
    bi = best.clamp(1, 2 * s - 1)[:, None]
    s0 = torch.gather(sads, 1, bi)[:, 0]
    sm = torch.gather(sads, 1, bi - 1)[:, 0]
    sp = torch.gather(sads, 1, bi + 1)[:, 0]
    denom = sm - 2.0 * s0 + sp
    frac = torch.where(denom.abs() > 1e-6, 0.5 * (sm - sp) / denom.clamp(min=1e-6), torch.zeros_like(denom))
    frac = frac.clamp(-1.0, 1.0)
    off = torch.where(interior, (bi[:, 0] - s).to(torch.float32) + frac, torch.zeros_like(frac))
    return torch.where(matched, torch.round(ur0) + off, torch.full_like(ur0, -1.0))
