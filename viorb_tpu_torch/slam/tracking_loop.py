"""Device-resident tracking step (port of viorb_tpu/slam/tracking_loop.py:
DeviceMap, TrackCarry, TrackOut, make_tracking_step, identity_carry).

The whole per-frame tracking path of localization mode — extract ->
predict -> project-match -> pose LM — with the pose and the
constant-velocity state carried on the device. The step syncs with the
host nowhere: it can be called frame after frame, and the caller reads
`TrackOut` when it needs it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from viorb_tpu_torch.device import resolve_device
from viorb_tpu_torch.features.extractor import OrbExtractor
from viorb_tpu_torch.geometry.camera import PinholeCamera, undistort_points
from viorb_tpu_torch.geometry.so3 import normalize_rotation
from viorb_tpu_torch.optim.pose_only import PoseObs, pose_optimization_tcw
from viorb_tpu_torch.slam.kernels import match_by_projection


class DeviceMap(NamedTuple):
    """Frozen localization map resident on the device."""

    xyz: torch.Tensor  # (M,3)
    desc_pm1: torch.Tensor  # (M,256) f32 {-1,+1}, 0 on invalid rows
    valid: torch.Tensor  # (M,)
    normal: torch.Tensor  # (M,3)
    dmin: torch.Tensor  # (M,)
    dmax: torch.Tensor  # (M,)


class TrackCarry(NamedTuple):
    r_cw: torch.Tensor
    t_cw: torch.Tensor
    vel_r: torch.Tensor  # relative motion (constant-velocity model)
    vel_t: torch.Tensor


class TrackOut(NamedTuple):
    r_cw: torch.Tensor
    t_cw: torch.Tensor
    n_inliers: torch.Tensor


def make_tracking_step(cam: PinholeCamera, extractor: OrbExtractor):
    """Returns step(carry, image, dmap) -> (carry, TrackOut): search radius
    15 px, pose LM 2 rounds x 4 iterations."""
    sigma2_np = extractor.level_sigma2()
    sigma2_dev: dict = {}

    def step(carry: TrackCarry, image: torch.Tensor, dmap: DeviceMap):
        dev = carry.r_cw.device
        sigma2 = sigma2_dev.get(str(dev))
        if sigma2 is None:
            sigma2 = sigma2_dev[str(dev)] = torch.from_numpy(sigma2_np).to(dev)
        # constant-velocity prediction
        r_pred = carry.vel_r @ carry.r_cw
        t_pred = (carry.vel_r @ carry.t_cw) + carry.vel_t

        feats = extractor._extract(image)
        xy = undistort_points(cam, feats.xy)
        desc = feats.descriptors_pm1()

        point_for_feat, _res, _n, _ = match_by_projection(
            dmap.xyz, dmap.desc_pm1, dmap.valid, dmap.normal, dmap.dmin,
            dmap.dmax, r_pred, t_pred, xy, desc, feats.valid, cam, 15.0,
        )
        obs = PoseObs(
            points=dmap.xyz[point_for_feat.clamp(min=0)],
            uv=xy,
            inv_sigma2=1.0 / sigma2[feats.level],
            valid=point_for_feat >= 0,
        )
        r_new, t_new, inlier = pose_optimization_tcw(
            r_pred, t_pred, obs, cam, rounds=2, iters_per_round=4
        )
        # Re-orthonormalize the carried rotation, as the reference's
        # streaming core does. The reference's make_tracking_step does not:
        # its carry composes r_new @ r_old^T @ r_new frame after frame, and
        # the f32 departure from orthonormality grows ~2.4x a frame (1e-7
        # at frame 1, 5e-2 at frame 15 of the rendered arc), bending the
        # rotation by degrees within 15 frames.
        r_new = normalize_rotation(r_new)
        # velocity update: T_new * T_old^{-1}
        vel_r = r_new @ carry.r_cw.T
        vel_t = t_new - (vel_r @ carry.t_cw)
        new_carry = TrackCarry(r_new, t_new, vel_r, vel_t)
        return new_carry, TrackOut(r_new, t_new, inlier.sum())

    return step


def identity_carry(device=None) -> TrackCarry:
    """The carry at rest at the origin, on the card unless `device` says
    otherwise."""
    device = resolve_device(device)
    eye = torch.eye(3, dtype=torch.float32, device=device)
    zero = torch.zeros(3, dtype=torch.float32, device=device)
    return TrackCarry(eye, zero, eye.clone(), zero.clone())
