"""Carry state into the port from numpy.

The system has no weights: its state is the map, the local map, the carry,
the camera, the extractor configuration and, for bundle adjustment, the
keyframe poses, landmarks and observation grid, and for the VI path the
NavStates, IMU sample batches and preintegration chains, and for stereo and
RGB-D the right u and depth of a frame's features. These functions take that
state as plain numpy arrays and numbers — for instance the JAX package's
arrays after `np.asarray` — so the port can start from exactly the state
another implementation holds. `device=None` puts the state on the card
(`viorb_tpu_torch.default_device()`); `device="cpu"` on the CPU.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from viorb_tpu_torch.device import resolve_device
from viorb_tpu_torch.features.extractor import FrameFeatures
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.imu.navstate import NavState
from viorb_tpu_torch.imu.preintegration import PreintegratedImu
from viorb_tpu_torch.imu.types import ImuBatch
from viorb_tpu_torch.mapping.map import KeyFrameData
from viorb_tpu_torch.mapping.serialize import map_store_from_arrays  # noqa: F401  (the map's state)
from viorb_tpu_torch.optim.ba import BAObservations, ImuChain, ViBAState, VisionBAState
from viorb_tpu_torch.slam.mono import FrameRecord
from viorb_tpu_torch.slam.tracking_loop import DeviceMap, TrackCarry


def _f32(x, device) -> torch.Tensor:
    # C order whatever the array's: a transposed view (r_wc.T) would
    # otherwise arrive as a column-major tensor
    return torch.tensor(np.ascontiguousarray(x, np.float32), device=device)


def _bool(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, bool), device=device)


def _i64(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.int64), device=device)


def device_map_from_numpy(
    xyz, desc_pm1, valid, normal, dmin, dmax, device=None
) -> DeviceMap:
    """DeviceMap from its fields as arrays. desc_pm1 may be any float type
    holding -1/+1/0 (a bf16 map arrives as float32)."""
    device = resolve_device(device)
    return DeviceMap(
        xyz=_f32(xyz, device),
        desc_pm1=_f32(desc_pm1, device),
        valid=_bool(valid, device),
        normal=_f32(normal, device),
        dmin=_f32(dmin, device),
        dmax=_f32(dmax, device),
    )


def carry_from_numpy(r_cw, t_cw, vel_r, vel_t, device=None) -> TrackCarry:
    device = resolve_device(device)
    return TrackCarry(
        _f32(r_cw, device), _f32(t_cw, device), _f32(vel_r, device), _f32(vel_t, device)
    )


def camera_from_fields(fields: Mapping[str, Any] | Any) -> PinholeCamera:
    """PinholeCamera from a mapping of its field names (fx, fy, cx, cy,
    k1, k2, p1, p2, k3, width, height), or from any NamedTuple that has
    them."""
    if not isinstance(fields, Mapping):
        fields = fields._asdict()
    return PinholeCamera(**{k: fields[k] for k in PinholeCamera._fields if k in fields})


def features_from_numpy(
    xy, response, angle, level, desc01, valid, device=None
) -> FrameFeatures:
    device = resolve_device(device)
    return FrameFeatures(
        xy=_f32(xy, device),
        response=_f32(response, device),
        angle=_f32(angle, device),
        level=_i64(level, device),
        desc01=torch.tensor(np.asarray(desc01, np.uint8), device=device),
        valid=_bool(valid, device),
    )


def local_map_upload_from_numpy(packed, desc_bits, valid, device=None):
    """The packed local-map upload, `slam/kernels.py::unpack_local_map`'s
    arguments: packed (M,8) f32 xyz | normal | dmin | dmax, desc_bits (M,32)
    uint8 packed descriptor bits (numpy packbits, bitorder='little'),
    valid (M,) bool."""
    device = resolve_device(device)
    return (
        _f32(packed, device),
        torch.tensor(np.asarray(desc_bits, np.uint8), device=device),
        _bool(valid, device),
    )


def ba_observations_from_numpy(kf_idx, uv, inv_sigma2, valid, ur=None, ur_valid=None, device=None) -> BAObservations:
    """The landmark-major (M,R) observation grid of a bundle adjustment;
    with `ur` (M,R) and `ur_valid` (M,R) bool, a stereo one (the vision
    BA's `bf` then applies)."""
    device = resolve_device(device)
    return BAObservations(
        kf_idx=_i64(kf_idx, device),
        uv=_f32(uv, device),
        inv_sigma2=_f32(inv_sigma2, device),
        valid=_bool(valid, device),
        ur=None if ur is None else _f32(ur, device),
        ur_valid=None if ur_valid is None else _bool(ur_valid, device),
    )


def frame_from_numpy(timestamp, xy, level, angle, desc01, valid, r_cw=None, t_cw=None, ur=None, depth=None,
                     device=None) -> FrameRecord:
    """A tracked frame of the SLAM pipelines (`slam/mono.py::FrameRecord`)
    from its features as arrays: undistorted xy (N,2), level, angle,
    desc01 (N,256) {0,1}, valid; its pose where it has one; and, for
    stereo or RGB-D, the right u and depth of each feature (-1 where there
    is none). The device payload (descriptors as +-1, xy, level, valid) is
    on `device`."""
    device = resolve_device(device)
    feats = features_from_numpy(xy, np.zeros(len(xy)), angle, level, desc01, valid, device=device)

    def host(x, dtype):
        return None if x is None else np.array(x, dtype)

    return FrameRecord(
        timestamp=float(timestamp), xy=host(xy, np.float32), level=host(level, np.int32),
        angle=host(angle, np.float32), desc01=host(desc01, np.uint8), valid=host(valid, bool),
        desc_pm1=feats.descriptors_pm1(), r_cw=host(r_cw, np.float32), t_cw=host(t_cw, np.float32),
        point_idx=np.full(len(xy), -1, np.int32), desc01_dev=feats.desc01, xy_dev=feats.xy,
        level_dev=feats.level, valid_dev=feats.valid, ur=host(ur, np.float32), depth=host(depth, np.float32),
    )


def keyframe_from_numpy(timestamp, r_cw, t_cw, xy, level, angle, desc01, valid, ur=None) -> KeyFrameData:
    """A keyframe of the host map (`mapping/map.py::KeyFrameData`, id
    unassigned, no point bound) from arrays, with the right u of each
    feature for a stereo map (-1 where there is none)."""
    return KeyFrameData(
        kf_id=-1, timestamp=float(timestamp), r_cw=np.array(r_cw, np.float32), t_cw=np.array(t_cw, np.float32),
        xy=np.array(xy, np.float32), level=np.array(level, np.int32), angle=np.array(angle, np.float32),
        desc01=np.array(desc01, np.uint8), valid=np.array(valid, bool), point_idx=np.full(len(xy), -1, np.int32),
        ur=None if ur is None else np.array(ur, np.float32),
    )


def vision_ba_state_from_numpy(r_cw, t_cw, points, device=None) -> VisionBAState:
    device = resolve_device(device)
    return VisionBAState(_f32(r_cw, device), _f32(t_cw, device), _f32(points, device))


def nav_state_from_numpy(p, v, r, bg, ba, dbg, dba, device=None) -> NavState:
    """A NavState (any leading batch dims) from its fields as arrays."""
    device = resolve_device(device)
    return NavState(*(_f32(x, device) for x in (p, v, r, bg, ba, dbg, dba)))


def imu_batch_from_numpy(gyro, acc, t, mask, device=None) -> ImuBatch:
    """A padded ImuBatch (any leading batch dims) from its arrays; rows with
    mask False are padding."""
    device = resolve_device(device)
    return ImuBatch(_f32(gyro, device), _f32(acc, device), _f32(t, device), _bool(mask, device))


def imu_chain_from_numpy(pre: Mapping[str, Any], valid, bias_cov_inv_diag, idx_i=None, idx_j=None,
                         device=None) -> ImuChain:
    """An ImuChain from its preintegrated edges (`pre`: a mapping of the
    PreintegratedImu field names to arrays with leading dim E), the edge
    mask, the bias-walk information diagonal and, for arbitrary edges,
    their keyframe slots."""
    device = resolve_device(device)
    return ImuChain(
        pre=PreintegratedImu(*(_f32(pre[k], device) for k in PreintegratedImu._fields)),
        valid=_bool(valid, device),
        bias_cov_inv_diag=_f32(bias_cov_inv_diag, device),
        idx_i=None if idx_i is None else _i64(idx_i, device),
        idx_j=None if idx_j is None else _i64(idx_j, device),
    )


def vi_ba_state_from_numpy(nav: Mapping[str, Any], points, device=None) -> ViBAState:
    """A ViBAState from the K keyframes' NavState fields (a mapping of the
    field names to (K,...) arrays) and the (M,3) landmarks."""
    device = resolve_device(device)
    return ViBAState(nav_state_from_numpy(**{k: nav[k] for k in NavState._fields}, device=device),
                     _f32(points, device))
