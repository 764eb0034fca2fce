"""Seeded small VI problems for the port's optimizer tests
(tests/test_torch_vi_optim.py) and their goldens (tests/make_torch_goldens.py,
set `optim`): numpy only, so the goldens script and the tests build the
same inputs.

  * `pose_problem`: frame j of the half-size arc 0.1 s after anchor i, 200
    landmarks seen by j with 0.7 px noise, 10 gross outliers, 5 invalid
    rows, a perturbed start for j, a non-identity body-camera extrinsic,
    the IMU samples between the two and a 15x15 prior on i;
  * `ba_problem`: 6 keyframes 0.4 s apart on the arc, 96 landmarks in a
    4-slot observation grid (0.5 px noise), the IMU samples of each gap,
    every pose, velocity and landmark perturbed (positions scaled by 1.03),
    a tilted gravity.
"""

import numpy as np

from viorb_tpu_torch.io.synthetic import _arc_pose_params, _rodrigues_np, make_imu

FX, CX, CY = 225.0, 188.0, 120.0


def _project(pc):
    return np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FX * pc[:, 1] / pc[:, 2] + CY], 1)


def _velocity(imu, t):
    return np.array([np.interp(t, imu.t, imu.velocity[:, k]) for k in range(3)])


def pose_problem(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    imu = make_imu(10, 0.1)
    ti, tj = 0.3, 0.4
    sel = (imu.t > ti) & (imu.t <= tj)
    R, C = _arc_pose_params(np.array([ti, tj]))
    r_bc = _rodrigues_np(np.array([0.01, -0.02, 0.03])).astype(np.float32)
    p_bc = np.array([0.02, -0.01, 0.03], np.float32)

    def body(r_wc, c):  # x_b = r_bc x_c + p_bc
        return (r_wc @ r_bc.T).astype(np.float32), (c + r_wc @ -(r_bc.T @ p_bc)).astype(np.float32)

    rbi, pbi = body(R[0], C[0])
    rbj, pbj = body(R[1], C[1])
    n = 200
    pw = C[1] + (R[1] @ np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 6, n)])).T
    pw = pw.astype(np.float32)
    pc = ((pw - pbj) @ rbj - p_bc) @ r_bc
    uv = (_project(pc) + rng.normal(0, 0.7, (n, 2))).astype(np.float32)
    uv[:10] += 30.0  # gross outliers
    valid = np.ones(n, bool)
    valid[-5:] = False
    z = np.zeros(3, np.float32)
    bg = np.array([0.002, -0.001, 0.003], np.float32)
    ba = np.array([0.01, 0.02, -0.01], np.float32)
    return dict(
        gyro=imu.gyro[sel], acc=imu.acc[sel], t=imu.t[sel], t_i=np.float32(ti), t_j=np.float32(tj),
        bg=bg, ba=ba, r_bc=r_bc, p_bc=p_bc,
        nsi_p=pbi, nsi_v=_velocity(imu, ti).astype(np.float32), nsi_r=rbi,
        nsj_p=(pbj + np.array([0.03, -0.02, 0.01])).astype(np.float32),
        nsj_v=(_velocity(imu, tj) + 0.05).astype(np.float32),
        nsj_r=(rbj @ _rodrigues_np(np.array([0.01, 0.005, -0.01]))).astype(np.float32),
        dbg=z, dba=z,
        points=pw, uv=uv, inv_sigma2=rng.choice([1.0, 0.694, 0.482], n).astype(np.float32), valid=valid,
        prior_info=np.diag(np.r_[[1e4] * 3, [1e2] * 3, [1e4] * 3, [1e6] * 6]).astype(np.float32),
        bias_info=(np.r_[[1 / (2e-5**2)] * 3, [1 / (5e-3**2)] * 3] / 0.1).astype(np.float32),
        gravity=np.array([0, 0, -9.81], np.float32),
    )


def ba_problem(seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    k, m, r = 6, 96, 4
    ts = np.arange(k) * 0.4
    imu = make_imu(30, 0.1)
    R, C = _arc_pose_params(ts)
    pts = np.array([C[i % k] + R[i % k] @ np.array([rng.uniform(-2, 2), rng.uniform(-1.2, 1.2), rng.uniform(2.5, 5)])
                    for i in range(m)], np.float32)
    kf_idx = np.zeros((m, r), np.int64)
    uv = np.zeros((m, r, 2), np.float32)
    valid = np.zeros((m, r), bool)
    for i in range(m):
        for s in range(r):
            kf = (i % k + s) % k
            pc = R[kf].T @ (pts[i] - C[kf])
            if pc[2] < 0.5:
                continue
            kf_idx[i, s], uv[i, s], valid[i, s] = kf, _project(pc[None])[0], True
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    cap = 128
    gyro = np.zeros((k - 1, cap, 3), np.float32)
    acc = np.zeros((k - 1, cap, 3), np.float32)
    t = np.zeros((k - 1, cap), np.float32)
    mask = np.zeros((k - 1, cap), bool)
    for e in range(k - 1):
        sel = (imu.t > ts[e]) & (imu.t <= ts[e + 1])
        n = int(sel.sum())
        gyro[e, :n], acc[e, :n], t[e, :n], mask[e, :n] = imu.gyro[sel], imu.acc[sel], imu.t[sel], True
    grav = np.array([0.05, -0.1, -9.8])
    zero = np.zeros((k, 3), np.float32)
    fixed = np.zeros(k, bool)
    fixed[0] = True
    return dict(
        kf_idx=kf_idx, uv=uv, inv_sigma2=np.ones((m, r), np.float32), valid=valid,
        gyro=gyro, acc=acc, t=t, mask=mask,
        t0=ts[:-1].astype(np.float32), t1=ts[1:].astype(np.float32),
        nav_p=(C * 1.03 + rng.normal(0, 0.01, C.shape)).astype(np.float32),
        nav_v=(np.stack([_velocity(imu, x) for x in ts]) * 1.02).astype(np.float32),
        nav_r=R.astype(np.float32), nav_bg=zero, nav_ba=zero, nav_dbg=zero, nav_dba=zero,
        points=(pts * 1.03 + rng.normal(0, 0.02, pts.shape)).astype(np.float32),
        fixed=fixed,
        bias_info=(np.r_[[1 / (2e-5**2)] * 3, [1 / (5e-3**2)] * 3] * 0.005).astype(np.float32),
        gravity=(grav / np.linalg.norm(grav) * 9.81).astype(np.float32),
        r_bc=np.eye(3, dtype=np.float32), p_bc=np.zeros(3, np.float32),
    )


IMU_BOUNDS = [(0.3, 1.45), (0.0, 0.5), (0.5, 1.0), (1.0, 1.7), (1.7, 2.0)]


def imu_problem() -> dict:
    """The arc's IMU with noise and a gyro bias, cut into one 1.15 s segment
    (`one_*`) and four more (`many_*`), padded to capacity 256, with the
    linearization biases and a NavState to propagate."""
    imu = make_imu(30, 0.1, bias_g=np.array([0.01, -0.02, 0.005]), noise_g=1e-3, noise_a=1e-2)
    cap = 256
    g = np.zeros((len(IMU_BOUNDS), cap, 3), np.float32)
    a = np.zeros((len(IMU_BOUNDS), cap, 3), np.float32)
    t = np.zeros((len(IMU_BOUNDS), cap), np.float32)
    m = np.zeros((len(IMU_BOUNDS), cap), bool)
    for i, (t0, t1) in enumerate(IMU_BOUNDS):
        sel = (imu.t > t0) & (imu.t <= t1)
        n = int(sel.sum())
        g[i, :n], a[i, :n], t[i, :n], m[i, :n] = imu.gyro[sel], imu.acc[sel], imu.t[sel], True
    bounds = np.array(IMU_BOUNDS, np.float32)
    return dict(
        gyro=g, acc=a, t=t, mask=m, t0=bounds[:, 0], t1=bounds[:, 1],
        bg=np.array([0.005, 0.0, -0.01], np.float32), ba=np.array([0.02, -0.01, 0.03], np.float32),
        nav_p=np.array([0.1, -0.2, 0.3], np.float32), nav_v=np.array([0.5, 0.1, -0.2], np.float32),
        nav_r=_rodrigues_np(np.array([0.1, 0.2, -0.3])).astype(np.float32),
        nav_dbg=np.array([1e-3, 0, -2e-3], np.float32), nav_dba=np.array([0.01, 0, 0.02], np.float32),
    )
