"""Pose-only LM optimization (port of viorb_tpu.optim, the part the
tracking step uses)."""

from viorb_tpu_torch.optim.pose_only import PoseObs, pose_optimization_tcw
from viorb_tpu_torch.optim.robust import CHI2_MONO_2DOF, CHI2_VI_9DOF
