"""Carry state into the port from numpy.

The tracking step has no weights: its state is the local map, the carry,
the camera and the extractor configuration. These builders take that
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
from viorb_tpu_torch.slam.tracking_loop import DeviceMap, TrackCarry


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


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
