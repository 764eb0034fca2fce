"""Multi-device distribution: landmark-sharded Schur-complement BA over the
ranks of a `torch.distributed` run (port of viorb_tpu/parallel)."""

from viorb_tpu_torch.parallel.distributed_ba import (
    distributed_vi_ba,
    distributed_vision_ba,
    shard_observations,
)
from viorb_tpu_torch.parallel.multihost import (
    host_local_slice,
    initialize,
    landmark_mesh,
)
