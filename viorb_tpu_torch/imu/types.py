"""IMU sample containers and noise model (port of viorb_tpu/imu/types.py).

Samples live in fixed-capacity struct-of-arrays batches (gyro (N,3), acc
(N,3), t (N,), mask (N,)), so a preintegration has the same shapes for any
number of samples, and a CUDA graph captured at one capacity serves them
all.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from viorb_tpu_torch.device import resolve_device


class ImuNoise(NamedTuple):
    """Discrete-time measurement and bias-random-walk variances (isotropic),
    the reference's convention: measurement variance = sigma^2 * rate, bias
    random-walk variance = sigma_rw^2. Defaults are EuRoC-tuned."""

    gyro_meas_var: float = 2.0e-3 ** 2 * 200.0
    acc_meas_var: float = 8.0e-3 ** 2 * 200.0
    gyro_bias_rw_var: float = 2.0e-5 ** 2
    acc_bias_rw_var: float = 5.0e-3 ** 2


class ImuBatch(NamedTuple):
    """Fixed-capacity batch of IMU samples, with any leading batch dims.

    gyro: (...,N,3) rad/s; acc: (...,N,3) m/s^2; t: (...,N) seconds; mask:
    (...,N) bool, True for valid samples. Padding rows have mask False and
    are ignored by the preintegration."""

    gyro: torch.Tensor
    acc: torch.Tensor
    t: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.gyro.shape[-2]

    @staticmethod
    def empty(capacity: int, device=None) -> "ImuBatch":
        device = resolve_device(device)
        return ImuBatch(
            gyro=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
            acc=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
            t=torch.zeros((capacity,), dtype=torch.float32, device=device),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    @staticmethod
    def from_arrays(gyro, acc, t, capacity: Optional[int] = None, device=None) -> "ImuBatch":
        """Samples from numpy arrays, padded to `capacity` (default: their
        count)."""
        g, a, tt, m = padded_arrays(gyro, acc, t, capacity)
        device = resolve_device(device)
        return ImuBatch(*(torch.from_numpy(x).to(device) for x in (g, a, tt, m)))


def padded_arrays(gyro, acc, t, capacity: Optional[int] = None):
    """(gyro, acc, t, mask) as numpy arrays padded to `capacity`: the host
    half of `ImuBatch.from_arrays`, for callers that upload it themselves."""
    gyro = np.asarray(gyro, np.float32).reshape(-1, 3)
    acc = np.asarray(acc, np.float32).reshape(-1, 3)
    t = np.asarray(t, np.float32).reshape(-1)
    n = gyro.shape[0]
    cap = capacity if capacity is not None else n
    if n > cap:
        raise ValueError(f"{n} samples exceed capacity {cap}")
    g = np.zeros((cap, 3), np.float32)
    a = np.zeros((cap, 3), np.float32)
    tt = np.zeros((cap,), np.float32)
    m = np.zeros((cap,), bool)
    g[:n], a[:n], tt[:n], m[:n] = gyro, acc, t, True
    return g, a, tt, m
