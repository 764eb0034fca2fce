"""Front-end matching for the tracking step (port of
viorb_tpu/slam/kernels.py: match_by_projection and the local-map unpack).

Project every map point, gate it (frustum, view angle, scale range), gate
every point-feature pair by the search window, take one Hamming matmul,
and keep mutual best matches.
"""

from __future__ import annotations

import torch

from viorb_tpu_torch.features.matching import hamming_matrix, match_with_mask
from viorb_tpu_torch.geometry.camera import PinholeCamera, in_image_mask, project


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
    gate = frustum[:, None] & feat_valid[None, :] & (dx * dx + dy * dy <= radius * radius)
    res = match_with_mask(d, gate, max_dist=max_dist, ratio=0.9, mutual=True)
    # invert: per-feature point index. Mutual best makes the matched
    # features distinct; unmatched rows write to a dropped slot nf.
    nf = feat_xy.shape[0]
    ok = res.idx >= 0
    rows = torch.arange(pts_xyz.shape[0], device=pts_xyz.device)
    point_for_feat = torch.full((nf + 1,), -1, dtype=torch.int64, device=pts_xyz.device)
    point_for_feat[torch.where(ok, res.idx, nf)] = torch.where(ok, rows, -1)
    n = ok.sum()
    return point_for_feat[:nf], res, n, frustum


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
    desc01 = unpack_desc_bits(desc_bits)
    desc_pm1 = (desc01.to(torch.float32) * 2 - 1) * valid[:, None].to(torch.float32)
    return (
        packed[:, 0:3], desc_pm1, valid, packed[:, 3:6], packed[:, 6],
        packed[:, 7],
    )
