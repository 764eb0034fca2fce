"""Multi-process launch helpers for the distributed BA path (port of
viorb_tpu/parallel/multihost.py on `torch.distributed`).

A multi-process run is the same program as the single-process one:
`initialize` joins the processes into one `torch.distributed` group, the
1-D "lm" mesh spans every rank in rank order, each rank holds one device,
and the landmark-sharded BA's all-reduces ride NCCL between cards or gloo
between CPU processes.

Usage (one process a device; torchrun's environment also works):

    from viorb_tpu_torch.parallel import initialize, landmark_mesh, shard_observations
    initialize(coordinator="10.0.0.1:8476", num_processes=2, process_id=i)
    mesh = landmark_mesh()                      # every rank, host-major
    obs_local = shard_observations(obs, mesh)   # this rank's landmark rows
    out, chi2 = distributed_vision_ba(state, obs_local, cam, fixed, mesh)

The environment fallback is torchrun's (MASTER_ADDR and MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK) where the JAX package reads JAX_* names.
Importing this module starts no process group.
"""

from __future__ import annotations

import os
import socket
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from viorb_tpu_torch.device import resolve_device


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join a multi-process run; True when a process group was formed.

    With no arguments this reads torchrun's variables (MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE, RANK) and is a no-op returning False when there
    is no coordinator or a single process. `coordinator` is "host:port" of
    rank 0's TCP store. The rest is `join_process_group`'s."""
    if coordinator is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator is None or num_processes <= 1:
        return False
    join_process_group(coordinator, num_processes, process_id, backend)
    return True


def join_process_group(coordinator: str, num_processes: int, process_id: int,
                       backend: Optional[str] = None) -> None:
    """Form the process group, a world of one process too (`initialize`
    forms none there). The backend is NCCL when a card is present, else
    gloo; `backend` overrides it. With a card, this process's device becomes
    cuda:LOCAL_RANK, or cuda:(process_id modulo the card count) where
    LOCAL_RANK is unset (one host, one card a rank, as the module's usage
    starts it)."""
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if torch.cuda.is_available():
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id)


class LandmarkMesh(NamedTuple):
    """The 1-D "lm" mesh: every rank of the run in rank order, one device a
    rank. `group` is None in a single process with no process group: the
    distributed BA then runs as world size 1 with no collective."""

    group: Optional[dist.ProcessGroup]
    size: int
    position: int  # this process's place along "lm"
    device: torch.device
    backend: Optional[str]


def landmark_mesh(device=None) -> LandmarkMesh:
    """The 1-D "lm" mesh over all ranks of the run (the default process
    group), on this process's device: `device`, else the current card (the
    one `initialize` chose; `device="cpu"` for the CPU). The ranks of one host must
    be contiguous (host-major order, as torchrun numbers them), so that the
    all-reduce's ring crosses hosts once a boundary; asserted over the
    ranks' host names."""
    if device is None:
        resolve_device(None)  # raises without a card
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if not dist.is_initialized():
        return LandmarkMesh(None, 1, 0, device, None)
    size, rank = dist.get_world_size(), dist.get_rank()
    hosts = [None] * size
    dist.all_gather_object(hosts, socket.gethostname())
    _assert_host_major(hosts)
    return LandmarkMesh(dist.group.WORLD, size, rank, device, dist.get_backend())


def _assert_host_major(hosts) -> None:
    seen, prev = set(), None
    for h in hosts:
        assert h == prev or h not in seen, f"landmark_mesh orders ranks host-major; got interleaved hosts {hosts}"
        seen.add(h)
        prev = h


def host_local_slice(n_items: int, mesh: LandmarkMesh) -> slice:
    """The block of an lm-sharded, length-n_items array that this process
    owns: rows divide evenly across the mesh's ranks, one device a rank, so
    rank i owns [i * per, (i + 1) * per)."""
    assert n_items % mesh.size == 0, (n_items, mesh.size)
    per = n_items // mesh.size
    return slice(mesh.position * per, (mesh.position + 1) * per)

