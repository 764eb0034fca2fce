"""One rank of the port's 2-process distributed BA run (spawned by
tests/test_torch_multihost.py; not collected by pytest), and the two
problems of tests/torch_parallel_golden.npz as port inputs, which the port's
parallel tests share.

    python tests/torch_multihost_worker.py RANK WORLD PORT OUT.npz

Each rank joins a gloo run through `initialize(coordinator=
"127.0.0.1:PORT", ...)`, takes its block of landmark rows
(`landmark_mesh` / `host_local_slice`), runs the distributed vision BA and
the distributed VI BA (whose IMU chain is live, so its system and cost must
be added once, after the all-reduce), and writes its solved poses and
NavStates to OUT.npz."""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from viorb_tpu_torch import interop  # noqa: E402
from viorb_tpu_torch.geometry.camera import PinholeCamera  # noqa: E402
from viorb_tpu_torch.imu.navstate import NavState  # noqa: E402
from viorb_tpu_torch.optim.reprojection import Extrinsics  # noqa: E402

GOLDEN = os.path.join(HERE, "torch_parallel_golden.npz")
CAM = PinholeCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0)  # tests/test_distributed_ba.py's


def load_golden() -> dict:
    with np.load(GOLDEN, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _obs(g, prefix, rows, device):
    return interop.ba_observations_from_numpy(*(g[f"{prefix}_{f}"][rows] for f in (
        "kf_idx", "uv", "inv_sigma2", "valid")), device=device)


def vision_inputs(g, device, rows=slice(None)):
    """(state, obs, fixed) of the vision problem, landmark rows `rows`."""
    state = interop.vision_ba_state_from_numpy(g["vision_r0"], g["vision_t0"], g["vision_p0"][rows], device=device)
    return state, _obs(g, "vision", rows, device), torch.tensor(g["vision_fixed"], device=device)


def vi_inputs(g, device, rows=slice(None)):
    """(state, obs, ext, chain, gravity, fixed) of the VI problem, landmark
    rows `rows`."""
    nav = {f: g[f"vi_nav0_{f}"] for f in NavState._fields}
    state = interop.vi_ba_state_from_numpy(nav, g["vi_points0"][rows], device=device)
    pre = {k[len("vi_pre_"):]: v for k, v in g.items() if k.startswith("vi_pre_")}
    chain = interop.imu_chain_from_numpy(pre, np.ones(len(g["vi_pre_dt"]), bool), g["vi_bias_info"], device=device)
    ext = Extrinsics(torch.eye(3, device=device), torch.zeros(3, device=device))
    return (state, _obs(g, "vi", rows, device), ext, chain, torch.tensor(g["vi_gravity"], device=device),
            torch.tensor(g["vi_fixed"], device=device))


def main(rank: int, world: int, port: str, out: str) -> None:
    import torch.distributed as dist

    from viorb_tpu_torch.parallel import (distributed_vi_ba, distributed_vision_ba, host_local_slice, initialize,
                                          landmark_mesh)

    torch.set_num_threads(1)
    assert initialize(coordinator=f"127.0.0.1:{port}", num_processes=world, process_id=rank)
    mesh = landmark_mesh(device="cpu")
    assert (mesh.size, mesh.position, mesh.backend) == (world, rank, "gloo"), mesh
    g = load_golden()
    state, obs, fixed = vision_inputs(g, "cpu", host_local_slice(len(g["vision_p0"]), mesh))
    out_state, chi2 = distributed_vision_ba(state, obs, CAM, fixed, mesh, iters=10)
    vi_state, obs_vi, ext, chain, gravity, vi_fixed = vi_inputs(g, "cpu", host_local_slice(len(g["vi_points0"]), mesh))
    assert bool(chain.valid.all())
    vi_out, vi_chi2 = distributed_vi_ba(vi_state, obs_vi, CAM, ext, chain, gravity, vi_fixed, mesh, iters=10)
    np.savez(out, r_cw=out_state.r_cw.numpy(), t_cw=out_state.t_cw.numpy(), chi2=chi2.numpy(), rows=obs.m,
             p=vi_out.nav.p.numpy(), v=vi_out.nav.v.numpy(), r=vi_out.nav.r.numpy(), vi_chi2=vi_chi2.numpy(),
             vi_rows=obs_vi.m)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
