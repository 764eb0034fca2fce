"""IMU subsystem (port of viorb_tpu/imu/): sample batches, noise model,
preintegration, NavState."""

from viorb_tpu_torch.imu.navstate import NavState, propagate_navstate
from viorb_tpu_torch.imu.preintegration import PreintegratedImu, compose_preint, preintegrate, preintegrate_batch
from viorb_tpu_torch.imu.types import ImuBatch, ImuNoise

__all__ = [
    "ImuBatch", "ImuNoise", "NavState", "PreintegratedImu", "compose_preint", "preintegrate",
    "preintegrate_batch", "propagate_navstate",
]
