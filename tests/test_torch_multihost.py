"""A real 2-process `torch.distributed` run of the port on localhost: two
gloo ranks join through `initialize(coordinator="127.0.0.1:<free port>",
...)`, each feeds its block of landmark rows (`landmark_mesh`,
`host_local_slice`) to the distributed vision and VI BAs
(tests/torch_multihost_worker.py; the VI problem's IMU chain is live), and
the solved poses and NavStates must be the same on both ranks, bit for
bit, and meet the JAX package's distributed solve in
tests/torch_parallel_golden.npz with tests/test_distributed_ba.py's
tolerances (cf. tests/test_multihost_spawn.py). Every wait has a timeout
that kills both ranks. One test per file: see tests/test_torch_fast.py."""

import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_gloo_ranks_match_reference(tmp_path):
    import torch

    from torch_multihost_worker import CAM, load_golden, vi_inputs, vision_inputs
    from viorb_tpu_torch.optim.ba import vi_ba, vision_ba

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = os.path.dirname(HERE)
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_multihost_worker.py"), str(r), "2",
                               str(port), outs[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    a, b = (dict(np.load(o)) for o in outs)
    g = load_golden()
    assert int(a["rows"]) == int(b["rows"]) == len(g["vision_p0"]) // 2
    assert int(a["vi_rows"]) == int(b["vi_rows"]) == len(g["vi_points0"]) // 2
    for key in ("r_cw", "t_cw", "p", "v", "r"):
        assert np.array_equal(a[key], b[key]), key
    np.testing.assert_allclose(a["r_cw"], g["vision_dist_r_cw"], atol=1e-4)
    np.testing.assert_allclose(a["t_cw"], g["vision_dist_t_cw"], atol=1e-3)
    # the VI chain is live: an IMU system or cost added before the sum would
    # count twice here and move the NavStates off the reference's
    np.testing.assert_allclose(a["p"], g["vi_dist_p"], atol=2e-3)
    np.testing.assert_allclose(a["v"], g["vi_dist_v"], atol=1e-2)
    # and the port's single-device solves of every row, which differ only in
    # the order of the sums: 1.4e-4 m and 2.4e-4 m/s apart on the VI problem,
    # where an IMU system added on both ranks moves p by 1.5e-3 m and v by
    # 2.7e-3 m/s
    torch.set_num_threads(1)
    state, obs, fixed = vision_inputs(g, "cpu")
    single, _ = vision_ba(state, obs, CAM, fixed, iters=10)
    state, obs, ext, chain, gravity, fixed = vi_inputs(g, "cpu")
    single_vi, _ = vi_ba(state, obs, CAM, ext, chain, gravity, fixed, iters=10)
    for key, ours, atol in (("r_cw", single.r_cw, 1e-4), ("t_cw", single.t_cw, 1e-4), ("p", single_vi.nav.p, 5e-4),
                            ("v", single_vi.nav.v, 1e-3)):
        np.testing.assert_allclose(a[key], ours.numpy(), atol=atol, err_msg=key)
    for chi2, ref in (("chi2", "vision_dist_chi2"), ("vi_chi2", "vi_dist_chi2")):
        rms = float(np.sqrt(np.concatenate([a[chi2], b[chi2]]).astype(np.float64).mean()))
        assert abs(rms - float(np.sqrt(g[ref].astype(np.float64).mean()))) < 0.05 and rms < 1.0, (chi2, rms)
