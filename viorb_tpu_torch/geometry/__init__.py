"""Batched geometry: SO(3) and the pinhole camera (port of
viorb_tpu.geometry, the part the tracking step uses)."""

from viorb_tpu_torch.geometry.so3 import (
    exp_so3,
    hat,
    matrix_to_quat,
    normalize_rotation,
    quat_to_matrix,
)
