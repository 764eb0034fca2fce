"""Distributed Schur-complement bundle adjustment over the "lm" mesh (port
of viorb_tpu/parallel/distributed_ba.py on `torch.distributed`).

  * landmarks (and their observation rows) are SHARDED over the ranks: each
    rank eliminates its own landmark blocks;
  * the poses are REPLICATED, and so is the reduced camera system S
    (K*D x K*D): each rank builds its part from its rows, and the parts
    are summed by one all-reduce of one flat buffer (S and b, and in the
    vision BA the current cost);
  * the damped Cholesky solve of S runs replicated on every rank, and the
    landmark back-substitution is local;
  * the candidate's cost is one more all-reduced scalar, and accept / the
    damping are decided on the device from the all-reduced costs, so every
    rank takes the same branch with no host sync.

Both solves are the port's single-device `vision_ba` / `vi_ba`
(`optim/ba.py`), given the mesh's all-reduce as their `reduce` hook: the
communication per LM iteration is independent of the landmark count
(`all_reduce_payload`). With no process group (`landmark_mesh()` in a
single process) the hook is None and they run as world size 1 with no
collective.

States and observations are rank-local: `state.points` and `obs_local`
hold this rank's landmark rows (`shard_observations`), the poses the whole
window; the solved state comes back the same way, with each rank's chi2 of
its own rows.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.optim.ba import BAObservations, ImuChain, Reduce, ViBAState, VisionBAState, vi_ba, vision_ba
from viorb_tpu_torch.optim.reprojection import Extrinsics
from viorb_tpu_torch.parallel.multihost import LandmarkMesh, host_local_slice


def shard_observations(obs: BAObservations, mesh: LandmarkMesh) -> BAObservations:
    """This rank's landmark rows of the landmark-major grid `obs` (every
    rank's rows), on this rank's device."""
    sl = host_local_slice(obs.m, mesh)
    return BAObservations(*(None if x is None else x[sl].to(mesh.device) for x in obs))


def all_reduce_payload(k: int, d: int, vi: bool = False) -> int:
    """Bytes all-reduced per LM iteration, f32: the packed [S | b] with the
    current cost ((K*D)^2 + K*D + 1 floats; the VI BA carries the accepted
    candidate's cost instead, so its pack has no cost), then the
    candidate's cost."""
    return ((k * d) ** 2 + k * d + (0 if vi else 1) + 1) * 4


def _mesh_sum(mesh: LandmarkMesh) -> Reduce:
    """The BAs' `reduce` hook: an in-place all-reduce (sum) over the mesh's
    group; None with no group."""
    if mesh.group is None:
        return None

    def reduce(x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=mesh.group)
        return x

    return reduce


def distributed_vision_ba(
    state: VisionBAState,
    obs_local: BAObservations,
    cam: PinholeCamera,
    fixed_kf: torch.Tensor,
    mesh: LandmarkMesh,
    iters: int = 10,
) -> Tuple[VisionBAState, torch.Tensor]:
    """`optim.ba.vision_ba`, landmark-sharded over `mesh`: poses replicated,
    landmarks and observations this rank's rows. Returns (state, this
    rank's final per-observation chi2 (M_local,R))."""
    return vision_ba(state, obs_local, cam, fixed_kf, iters, reduce=_mesh_sum(mesh))


def distributed_vi_ba(
    state: ViBAState,
    obs_local: BAObservations,
    cam: PinholeCamera,
    ext: Extrinsics,
    chain: ImuChain,
    gravity: torch.Tensor,
    fixed_kf: torch.Tensor,
    mesh: LandmarkMesh,
    iters: int = 10,
) -> Tuple[ViBAState, torch.Tensor]:
    """`optim.ba.vi_ba` (15-DoF NavStates, preintegration and bias-walk
    edges), landmark-sharded over `mesh` as the vision variant. The IMU
    chain couples only the replicated NavStates, so its system and cost are
    built on every rank after the all-reduce (K <= 20: recomputing beats
    communicating). Returns (state, this rank's final chi2)."""
    return vi_ba(state, obs_local, cam, ext, chain, gravity, fixed_kf, iters, reduce=_mesh_sum(mesh))
