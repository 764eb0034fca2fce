"""Device-resident tracking cores (port of viorb_tpu/slam/tracking_loop.py:
DeviceMap, TrackCarry, TrackOut, make_tracking_step,
make_pipeline_track_core, make_streaming_track_core, tcw_from_nav,
make_vi_pipeline_core, identity_carry).

The whole per-frame tracking path — extract -> predict -> project-match
(with the wide-radius retry) -> pose LM — with no host sync anywhere, so a
core can be called frame after frame and the caller reads its outputs when
it needs them.

Where the reference wraps each core in `jax.jit`, the port wraps it in
`cuda_graph.GraphedFunction`: on the card the callable a maker returns
captures one CUDA graph per set of input shapes at its first call (after a
warm-up that uploads the constant tables and builds the FAST kernel) and
replays it from then on; on CPU tensors it is the eager function, which
stays reachable as `.eager`. Outputs are clones of the graph's static
outputs, made on the same stream after the replay: a caller may keep many
frames' outputs, and a returned carry goes straight back in as the next
call's input, with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from viorb_tpu_torch.cuda_graph import GraphedFunction
from viorb_tpu_torch.device import resolve_device
from viorb_tpu_torch.features.extractor import OrbExtractor
from viorb_tpu_torch.geometry.camera import PinholeCamera, undistort_points
from viorb_tpu_torch.geometry.so3 import normalize_rotation
from viorb_tpu_torch.imu.navstate import NavState, propagate_navstate
from viorb_tpu_torch.imu.preintegration import preintegrate
from viorb_tpu_torch.imu.types import ImuNoise
from viorb_tpu_torch.optim.pose_only import PoseObs, ViPosePrior, pose_optimization_tcw, pose_optimization_vi
from viorb_tpu_torch.optim.reprojection import Extrinsics
from viorb_tpu_torch.slam.kernels import TRACK_RADIUS, match_by_projection, match_by_projection_retry


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


class _FrontEnd:
    """extract -> undistort -> project-match -> PoseObs: the part the three
    cores share."""

    def __init__(self, cam: PinholeCamera, extractor: OrbExtractor):
        self.cam = cam
        self.extractor = extractor
        self._sigma2_np = extractor.level_sigma2()
        # per-device copy of the level variances: uploaded at first use (a
        # graph's warm-up), never inside a capture
        self._sigma2: dict = {}

    def _level_sigma2(self, dev: torch.device) -> torch.Tensor:
        sigma2 = self._sigma2.get(dev)
        if sigma2 is None:
            sigma2 = self._sigma2[dev] = torch.from_numpy(self._sigma2_np).to(dev)
        return sigma2

    def __call__(self, image, r_pred, t_pred, xyz, desc_pm1, valid, normal, dmin, dmax, retry: bool):
        """Returns (feats, xy, fdesc, pf, nmatch, visible, obs). With
        `retry`, a 15 px search that finds fewer than 20 matches gives way
        to a 30 px one, selected on the device."""
        feats = self.extractor._extract(image)
        xy = undistort_points(self.cam, feats.xy)
        fdesc = feats.descriptors_pm1()
        args = (xyz, desc_pm1, valid, normal, dmin, dmax, r_pred, t_pred, xy, fdesc, feats.valid, self.cam)
        if retry:
            pf, _res, nmatch, visible = match_by_projection_retry(*args)
        else:
            pf, _res, nmatch, visible = match_by_projection(*args, TRACK_RADIUS)
        obs = PoseObs(
            points=xyz[pf.clamp(min=0)],
            uv=xy,
            inv_sigma2=1.0 / self._level_sigma2(xy.device)[feats.level],
            valid=pf >= 0,
        )
        return feats, xy, fdesc, pf, nmatch, visible, obs


# Process-wide core cache: a core is a pure function of (camera, extractor
# configuration), so SLAM instances share it, and with it the CUDA graphs it
# has captured.
_CORE_CACHE: dict = {}


def _cached(key, build):
    core = _CORE_CACHE.get(key)
    if core is None:
        core = _CORE_CACHE[key] = build()
    return core


def make_tracking_step(cam: PinholeCamera, extractor: OrbExtractor):
    """Returns step(carry, image, dmap) -> (carry, TrackOut): search radius
    15 px, pose LM 2 rounds x 4 iterations. A CUDA graph on the card."""
    return _cached(
        ("step", cam, extractor.config_key()), lambda: _build_tracking_step(cam, extractor)
    )


def _build_tracking_step(cam: PinholeCamera, extractor: OrbExtractor):
    front = _FrontEnd(cam, extractor)

    def step(carry: TrackCarry, image: torch.Tensor, dmap: DeviceMap):
        # constant-velocity prediction
        r_pred = carry.vel_r @ carry.r_cw
        t_pred = (carry.vel_r @ carry.t_cw) + carry.vel_t
        *_, obs = front(image, r_pred, t_pred, *dmap, retry=False)
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

    return GraphedFunction(step)


def make_pipeline_track_core(cam: PinholeCamera, extractor: OrbExtractor):
    """Tracking core of the full SLAM pipeline (mutable map): extraction,
    undistortion, projection matching with the wide-radius retry, and the
    pose-only LM at 4 rounds x 10 iterations, as one CUDA graph on the card.

    core(image, r_pred, t_pred, xyz, desc_pm1, valid, normal, dmin, dmax)
    -> (feats, xy, fdesc, pf, r_new, t_new, inlier, visible, nmatch).

    The map arrays arrive padded to a static capacity, so one graph serves
    every map size of an (image, capacity) shape."""
    return _cached(
        ("pipeline", cam, extractor.config_key()),
        lambda: _build_pipeline_track_core(cam, extractor),
    )


def _build_pipeline_track_core(cam: PinholeCamera, extractor: OrbExtractor):
    front = _FrontEnd(cam, extractor)

    def core(image, r_pred, t_pred, xyz, desc_pm1, valid, normal, dmin, dmax):
        feats, xy, fdesc, pf, nmatch, visible, obs = front(
            image, r_pred, t_pred, xyz, desc_pm1, valid, normal, dmin, dmax, retry=True
        )
        r_new, t_new, inlier = pose_optimization_tcw(r_pred, t_pred, obs, cam)
        return feats, xy, fdesc, pf, r_new, t_new, inlier, visible, nmatch

    return GraphedFunction(core)


def make_streaming_track_core(cam: PinholeCamera, extractor: OrbExtractor):
    """Carry-based tracking core for streaming: like
    `make_pipeline_track_core`, but the constant-velocity prediction comes
    from a `TrackCarry` on the device and the updated carry is returned as
    device tensors, so the host can queue frame after frame without pulling
    anything; a collector pulls the bookkeeping fields of many frames later.

    core(carry, image, xyz, desc_pm1, valid, normal, dmin, dmax) ->
    (new_carry, (feats, xy, fdesc, pf, r_new, t_new, inlier, visible, ok)).

    The carry freezes on failure frames (fewer than 10 matches or inliers):
    the pose and velocity keep the last good estimate, so one blurred frame
    cannot poison the chain before the collector notices."""
    return _cached(
        ("streaming", cam, extractor.config_key()),
        lambda: _build_streaming_track_core(cam, extractor),
    )


def _build_streaming_track_core(cam: PinholeCamera, extractor: OrbExtractor):
    front = _FrontEnd(cam, extractor)

    def core(carry: TrackCarry, image, xyz, desc_pm1, valid, normal, dmin, dmax):
        r_pred = carry.vel_r @ carry.r_cw
        t_pred = (carry.vel_r @ carry.t_cw) + carry.vel_t
        feats, xy, fdesc, pf, nmatch, visible, obs = front(
            image, r_pred, t_pred, xyz, desc_pm1, valid, normal, dmin, dmax, retry=True
        )
        r_new, t_new, inlier = pose_optimization_tcw(r_pred, t_pred, obs, cam)
        # the synchronous path's acceptance gate
        ok = (nmatch >= 10) & (inlier.sum() >= 10)
        # re-orthonormalize the carried rotation: the LM composes dR
        # products frame after frame with no host resync, and the f32 drift
        # compounds across the carry chain
        r_new = normalize_rotation(r_new)
        # velocity update T_new * T_old^{-1}; freeze the carry on failure
        vel_r = r_new @ carry.r_cw.T
        vel_t = t_new - (vel_r @ carry.t_cw)
        new_carry = TrackCarry(
            torch.where(ok, r_new, carry.r_cw),
            torch.where(ok, t_new, carry.t_cw),
            torch.where(ok, vel_r, carry.vel_r),
            torch.where(ok, vel_t, carry.vel_t),
        )
        return new_carry, (feats, xy, fdesc, pf, r_new, t_new, inlier, visible, ok)

    return GraphedFunction(core)


def tcw_from_nav(nav: NavState, ext: Extrinsics):
    """Camera pose (r_cw, t_cw) of a body NavState, on its device."""
    r_wc = nav.r @ ext.r_bc
    c_w = nav.p + nav.r @ ext.p_bc
    r_cw = r_wc.transpose(-1, -2)
    return r_cw, -(r_cw @ c_w)


class ViPipelineCore:
    """The VI tracking core: two CUDA graphs on the card, one for each value
    of the reference's static `use_prior` (frame-to-frame with the
    marginalized prior and the anchor optimized, or frame-to-keyframe with
    the anchor fixed). `core(*args, use_prior=...)` calls the one the host
    picks; `graphs[use_prior]` is each `GraphedFunction`."""

    def __init__(self, fn):
        self.graphs = {flag: GraphedFunction(lambda *a, _f=flag: fn(*a, use_prior=_f)) for flag in (False, True)}

    def __call__(self, *args, use_prior: bool = False):
        return self.graphs[use_prior](*args)


def make_vi_pipeline_core(cam: PinholeCamera, extractor: OrbExtractor, ext: Extrinsics, noise: ImuNoise):
    """The VI tracking core of the full VI pipeline: IMU preintegration since
    the last frame (and, frame-to-keyframe, since the last keyframe),
    NavState propagation, extraction, projection matching with the
    wide-radius retry and the 15-DoF VI pose LM (2 rounds x 5 iterations)
    with the marginal information of the frame, one CUDA graph a frame on
    the card. `ext` lives on the core's device.

    core(image, nav_cur, ns_i, batch_fr, batch_kf, t_last, t_now, t_kf,
         bias_g, bias_a, gravity, prior_state, prior_info,
         xyz, desc_pm1, valid, normal, dmin, dmax, use_prior=False)
    -> (feats, xy, fdesc, pf, visible, nmatch, nav_pred, ns_j, inlier, marg),
    marg the frame's 15x15 marginal information, symmetrized

    ns_i is the anchor (the last frame with use_prior, else the last
    keyframe); prior_state / prior_info are ignored without use_prior."""
    key = ("vi", cam, extractor.config_key(), ext.r_bc.device,
           tuple(ext.r_bc.cpu().reshape(-1).tolist()), tuple(ext.p_bc.cpu().tolist()), tuple(noise))
    return _cached(key, lambda: _build_vi_pipeline_core(cam, extractor, ext, noise))


def _build_vi_pipeline_core(cam: PinholeCamera, extractor: OrbExtractor, ext: Extrinsics, noise: ImuNoise):
    front = _FrontEnd(cam, extractor)
    bias_rw_np = np.concatenate([
        np.full(3, 1.0 / max(noise.gyro_bias_rw_var, 1e-12)),
        np.full(3, 1.0 / max(noise.acc_bias_rw_var, 1e-12)),
    ]).astype(np.float32)
    bias_rw: dict = {}  # per device, uploaded at first use (a graph's warm-up)

    def core(image, nav_cur, ns_i, batch_fr, batch_kf, t_last, t_now, t_kf, bias_g, bias_a, gravity,
             prior_state, prior_info, xyz, desc_pm1, valid, normal, dmin, dmax, use_prior: bool):
        dev = image.device
        if dev not in bias_rw:
            bias_rw[dev] = torch.from_numpy(bias_rw_np).to(dev)
        pre_fr = preintegrate(batch_fr, bias_g, bias_a, t_last, t_now, noise)
        nav_pred = propagate_navstate(nav_cur, pre_fr, gravity)
        r_pred, t_pred = tcw_from_nav(nav_pred, ext)
        feats, xy, fdesc, pf, nmatch, visible, obs = front(
            image, r_pred, t_pred, xyz, desc_pm1, valid, normal, dmin, dmax, retry=True
        )
        if use_prior:
            bias_info = bias_rw[dev] / pre_fr.dt.clamp(min=1e-3)
            prior = ViPosePrior(prior_state, prior_info, torch.ones((), dtype=torch.bool, device=dev))
            ns_j, _ns_i, inlier, marg = pose_optimization_vi(
                nav_pred, ns_i, obs, cam, ext, pre_fr, gravity, bias_info,
                prior=prior, rounds=2, iters_per_round=5, optimize_i=True,
            )
        else:
            pre_kf = preintegrate(batch_kf, bias_g, bias_a, t_kf, t_now, noise)
            bias_info = bias_rw[dev] / pre_kf.dt.clamp(min=1e-3)
            ns_j, _ns_i, inlier, marg = pose_optimization_vi(
                nav_pred, ns_i, obs, cam, ext, pre_kf, gravity, bias_info,
                rounds=2, iters_per_round=5, optimize_i=False,
            )
        # symmetrized: the next frame's prior information
        return feats, xy, fdesc, pf, visible, nmatch, nav_pred, ns_j, inlier, 0.5 * (marg + marg.T)

    return ViPipelineCore(core)


def identity_carry(device=None) -> TrackCarry:
    """The carry at rest at the origin, on the card unless `device` says
    otherwise."""
    device = resolve_device(device)
    eye = torch.eye(3, dtype=torch.float32, device=device)
    zero = torch.zeros(3, dtype=torch.float32, device=device)
    return TrackCarry(eye, zero, eye.clone(), zero.clone())
