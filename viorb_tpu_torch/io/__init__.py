"""IO (port of viorb_tpu/io): dataset loaders (TUM/EuRoC/KITTI), config
YAML, trajectory export, the image/IMU stream and its live TCP source, the
PNG codec, and the synthetic textured-room renderer."""

from viorb_tpu_torch.io.config import SlamConfig, parse_opencv_yaml
