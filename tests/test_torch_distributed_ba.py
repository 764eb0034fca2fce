"""The port's distributed BAs (`viorb_tpu_torch/parallel`) at world size 1,
in this process, against the JAX package's on its 8-device virtual CPU mesh.

  * `initialize()` with no coordinator is a no-op returning False, and
    `landmark_mesh` without a process group is world size 1 with no
    collective; `host_local_slice` and `shard_observations` give rank 0 of 1
    every row; with a card (stubbed here) a joining rank binds
    cuda:LOCAL_RANK, or cuda:(rank modulo the card count) without it, and
    the backend is NCCL;
  * `distributed_vision_ba` and `distributed_vi_ba` (10 iterations) at
    tests/test_distributed_ba.py's two problems, with that test's
    tolerances: r_cw within 1e-4, t_cw 1e-3, VI positions 2e-3 m and
    velocities 1e-2 m/s of the reference's distributed solve, the chi2 RMS
    within 0.05;
  * at world size 1 they are the port's single-device `vision_ba` / `vi_ba`
    on the same rows, bit for bit (the same system build, solve and update,
    no collective).
The reference's runs come from tests/torch_parallel_golden.npz
(tests/make_torch_goldens.py, set `parallel`), which holds the problems too.
One test per file: see tests/test_torch_fast.py."""

import numpy as np
import torch

from torch_multihost_worker import CAM, load_golden, vi_inputs, vision_inputs
from viorb_tpu_torch.optim.ba import vi_ba, vision_ba
from viorb_tpu_torch.parallel import (distributed_vi_ba, distributed_vision_ba, host_local_slice, initialize,
                                      landmark_mesh, shard_observations)

torch.set_num_threads(1)


def _rms(chi2) -> float:
    return float(np.sqrt(np.asarray(chi2, np.float64).mean()))


def test_distributed_ba_matches_reference(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() is False
    assert initialize(coordinator="127.0.0.1:1", num_processes=1) is False
    mesh = landmark_mesh(device="cpu")
    assert mesh.group is None and (mesh.size, mesh.position) == (1, 0)
    assert host_local_slice(256, mesh) == slice(0, 256)
    with monkeypatch.context() as stub:  # the card's branch, recorded instead of run
        calls = []
        stub.setattr(torch.cuda, "is_available", lambda: True)
        stub.setattr(torch.cuda, "device_count", lambda: 4)
        stub.setattr(torch.cuda, "set_device", lambda i: calls.append(("device", i)))
        stub.setattr(torch.distributed, "init_process_group",
                     lambda backend, init_method, world_size, rank: calls.append((backend, init_method, world_size,
                                                                                  rank)))
        stub.delenv("LOCAL_RANK", raising=False)
        assert initialize(coordinator="127.0.0.1:1", num_processes=8, process_id=6) is True
        stub.setenv("LOCAL_RANK", "1")
        assert initialize(coordinator="127.0.0.1:1", num_processes=8, process_id=5) is True
        assert calls == [("device", 2), ("nccl", "tcp://127.0.0.1:1", 8, 6), ("device", 1),
                         ("nccl", "tcp://127.0.0.1:1", 8, 5)], calls
    g = load_golden()

    state, obs, fixed = vision_inputs(g, "cpu")
    obs_local = shard_observations(obs, mesh)
    assert all(torch.equal(a, b) for a, b in zip(obs_local[:4], obs[:4]))
    out, chi2 = distributed_vision_ba(state, obs_local, CAM, fixed, mesh, iters=10)
    np.testing.assert_allclose(out.r_cw.numpy(), g["vision_dist_r_cw"], atol=1e-4)
    np.testing.assert_allclose(out.t_cw.numpy(), g["vision_dist_t_cw"], atol=1e-3)
    assert abs(_rms(chi2) - _rms(g["vision_dist_chi2"])) < 0.05 and _rms(chi2) < 1.0
    single, chi2_s = vision_ba(state, obs, CAM, fixed, iters=10)
    assert all(torch.equal(a, b) for a, b in zip(out, single)) and torch.equal(chi2, chi2_s)

    state, obs, ext, chain, gravity, fixed = vi_inputs(g, "cpu")
    out, chi2 = distributed_vi_ba(state, shard_observations(obs, mesh), CAM, ext, chain, gravity, fixed, mesh,
                                  iters=10)
    np.testing.assert_allclose(out.nav.p.numpy(), g["vi_dist_p"], atol=2e-3)
    np.testing.assert_allclose(out.nav.v.numpy(), g["vi_dist_v"], atol=1e-2)
    assert abs(_rms(chi2) - _rms(g["vi_dist_chi2"])) < 0.05 and _rms(chi2) < 1.0
    single, chi2_s = vi_ba(state, obs, CAM, ext, chain, gravity, fixed, iters=10)
    assert all(torch.equal(a, b) for a, b in zip(out.nav, single.nav)) and torch.equal(out.points, single.points)
    assert torch.equal(chi2, chi2_s)
