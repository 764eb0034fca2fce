"""The port's VI factors and optimizers against the JAX reference's.

  * `imu_factors`: the preintegration, bias-walk and prior residuals and
    `whitener_from_cov` at random states, and the residuals' forward-mode
    Jacobians, against the reference's `jax.jacfwd` under one `jax.jit`:
    within 1e-4 of each array's largest entry (f32 through a rotation log);
  * the analytic navstate reprojection Jacobian against `torch.func.jacfwd`
    of the port's residual (1e-4 relative);
  * `pose_optimization_vi` (2 rounds x 5 iterations, as the VI core runs
    it) frame-to-keyframe and frame-to-frame with the prior, on
    tests/torch_vi_problems.py's problem: the solved states within 1e-5 m,
    1e-5 m/s and 1e-5 of rotation, biases within 1e-6 (measured <= 4e-7),
    the inlier masks equal, the 15x15 marginal within 1e-4 of its largest
    entry (measured 5e-6);
  * `vi_ba` and `vi_ba_gw` (6 LM iterations, K=6, M=96): positions and
    landmarks within 5e-4 m, velocities 5e-4 m/s, rotations 5e-5, bias
    increments 1e-3 of the reference's, gravity within 1e-3 m/s^2
    (measured: 3e-5 m, 1e-4 m/s^2 for the free-gravity BA, whose accepted
    steps compound the order in which the port sums).
The reference's optimizer outputs come from tests/torch_optim_golden.npz
(tests/make_torch_goldens.py, set `optim`): their live compiles take 4-8 s
each on a CPU. Its inputs are in the golden too, and must equal the
builders' here.

One test per file: see tests/test_torch_fast.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.func import jacfwd

from make_torch_goldens import BA_ITERS, OPTIM_GOLDEN, POSE_ITERS, POSE_ROUNDS, load
from torch_vi_problems import ba_problem, pose_problem
from viorb_tpu.imu.navstate import NavState as RefNavState
from viorb_tpu.imu.preintegration import PreintegratedImu as RefPre
from viorb_tpu.optim import imu_factors as ref_factors
from viorb_tpu_torch import interop
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.geometry.so3 import exp_so3
from viorb_tpu_torch.imu import ImuBatch, NavState, PreintegratedImu, preintegrate, preintegrate_batch
from viorb_tpu_torch.optim import ba as pba
from viorb_tpu_torch.optim import imu_factors
from viorb_tpu_torch.optim.pose_only import PoseObs, ViPosePrior, pose_optimization_vi
from viorb_tpu_torch.optim.reprojection import (
    Extrinsics,
    reproj_residual_jacobians_navstate,
    reproj_residual_navstate,
)

torch.set_num_threads(1)

CAM = PinholeCamera(fx=225.0, fy=225.0, cx=188.0, cy=120.0, width=376, height=240)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _random_nav(rng, scale=1.0):
    return {
        "p": rng.normal(size=3) * scale, "v": rng.normal(size=3), "r": np.asarray(exp_so3(torch.from_numpy(
            rng.normal(size=3).astype(np.float32)))), "bg": rng.normal(size=3) * 1e-2,
        "ba": rng.normal(size=3) * 0.1, "dbg": rng.normal(size=3) * 1e-3, "dba": rng.normal(size=3) * 1e-2,
    }


def _factors_match_reference():
    rng = np.random.default_rng(4)
    ni = {k: np.asarray(v, np.float32) for k, v in _random_nav(rng).items()}
    nj = {k: np.asarray(v, np.float32) for k, v in _random_nav(rng).items()}
    npr = {k: np.asarray(v, np.float32) for k, v in _random_nav(rng).items()}
    a = rng.normal(size=(9, 9))
    pre = dict(delta_p=rng.normal(size=3), delta_v=rng.normal(size=3),
               delta_r=np.asarray(exp_so3(torch.tensor([0.2, -0.1, 0.3]))),
               j_p_bg=rng.normal(size=(3, 3)) * 0.1, j_p_ba=rng.normal(size=(3, 3)) * 0.1,
               j_v_bg=rng.normal(size=(3, 3)) * 0.1, j_v_ba=rng.normal(size=(3, 3)) * 0.1,
               j_r_bg=rng.normal(size=(3, 3)) * 0.1, cov=(a @ a.T) * 1e-6 + np.eye(9) * 1e-8, dt=0.45)
    pre = {k: np.asarray(v, np.float32) for k, v in pre.items()}
    g = np.array([0.1, -0.2, -9.8], np.float32)
    di = (rng.normal(size=15) * 1e-2).astype(np.float32)
    dj = (rng.normal(size=15) * 1e-2).astype(np.float32)

    @jax.jit
    def ref(ni, nj, npr, pre, di, dj):
        ni, nj, npr, pre = RefNavState(**ni), RefNavState(**nj), RefNavState(**npr), RefPre(**pre)
        z15 = jnp.zeros(15)
        return (
            ref_factors.preint_residual(di, dj[:9], ni, nj, pre, g),
            jax.jacfwd(ref_factors.preint_residual, argnums=(0, 1))(z15, z15[:9], ni, nj, pre, g),
            ref_factors.bias_walk_residual(di, dj, ni, nj),
            ref_factors.prior_residual(di, ni, npr),
            jax.jacfwd(ref_factors.prior_residual)(z15, ni, npr),
            ref_factors.whitener_from_cov(pre.cov),
        )

    want = ref(*[jax.tree.map(jnp.asarray, x) for x in (ni, nj, npr, pre, di, dj)])
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    nsi, nsj, nsp, pr = NavState(**t(ni)), NavState(**t(nj)), NavState(**t(npr)), PreintegratedImu(**t(pre))
    gt, dit, djt = torch.from_numpy(g), torch.from_numpy(di), torch.from_numpy(dj)
    z15 = torch.zeros(1, 15)
    got = (
        imu_factors.preint_residual(dit, djt[:9], nsi, nsj, pr, gt),
        [x[0, :, 0] for x in jacfwd(imu_factors.preint_residual, argnums=(0, 1))(z15, z15[:, :9], nsi, nsj, pr, gt)],
        imu_factors.bias_walk_residual(dit, djt, nsi, nsj),
        imu_factors.prior_residual(dit, nsi, nsp),
        jacfwd(imu_factors.prior_residual)(z15, nsi, nsp)[0, :, 0],
        imu_factors.whitener_from_cov(pr.cov),
    )
    for n, (a_, b_) in enumerate(zip(got, want)):
        for x, y in (zip(a_, b_) if isinstance(a_, list) else [(a_, b_)]):
            x = x.numpy()
            assert x.dtype == np.float32 and _rel(x, y) <= 1e-4, (n, _rel(x, y))

    # the analytic navstate reprojection Jacobian against forward-mode AD
    ext = Extrinsics(torch.from_numpy(np.asarray(exp_so3(torch.tensor([0.02, -0.01, 0.03])))),
                     torch.tensor([0.02, -0.01, 0.03]))
    p_w = torch.from_numpy((rng.normal(size=(7, 3)) + [0, 0, 4]).astype(np.float32))
    uv = torch.from_numpy(rng.uniform(0, 200, (7, 2)).astype(np.float32))
    r, J9, Jl = reproj_residual_jacobians_navstate(nsi.p, nsi.r, p_w, uv, CAM, ext)
    z9, z3 = torch.zeros(9), torch.zeros(3)
    for i in range(len(p_w)):
        Ja, Jb = jacfwd(lambda a, b: reproj_residual_navstate(a[None], b[None], nsi.p, nsi.r, p_w[i], uv[i],
                                                              CAM, ext)[0], argnums=(0, 1))(z9, z3)
        assert _rel(J9[i], Ja) <= 1e-4 and _rel(Jl[i], Jb) <= 1e-4, i
        assert _rel(r[i], reproj_residual_navstate(z9, z3, nsi.p, nsi.r, p_w[i], uv[i], CAM, ext)) <= 1e-6


def _nav(d, prefix):
    return interop.nav_state_from_numpy(**{f: d[prefix + f] for f in NavState._fields}, device="cpu")


def _assert_nav(got: NavState, gold, prefix, tol_p, tol_v, tol_r, tol_b, what):
    for f, tol in zip(NavState._fields, (tol_p, tol_v, tol_r, tol_b, tol_b, tol_b, tol_b)):
        err = np.abs(getattr(got, f).numpy() - gold[prefix + f]).max()
        assert err <= tol, (what, f, err)


def _pose_matches_golden(gold):
    pp = pose_problem()
    for k, v in pp.items():
        np.testing.assert_array_equal(np.asarray(v), gold["pose_in_" + k])
    pre = preintegrate(ImuBatch.from_arrays(pp["gyro"], pp["acc"], pp["t"], capacity=256, device="cpu"),
                       torch.from_numpy(pp["bg"]), torch.from_numpy(pp["ba"]), torch.tensor(pp["t_i"]),
                       torch.tensor(pp["t_j"]))
    g = {f"nsi_{f}": pp[f"nsi_{f}"] for f in ("p", "v", "r")} | {f"nsj_{f}": pp[f"nsj_{f}"] for f in ("p", "v", "r")}
    g.update({f"{s}_{f}": pp[f] for s in ("nsi", "nsj") for f in ("bg", "ba", "dbg", "dba")})
    obs = PoseObs(*(torch.from_numpy(pp[k]) for k in ("points", "uv", "inv_sigma2", "valid")))
    ext = Extrinsics(torch.from_numpy(pp["r_bc"]), torch.from_numpy(pp["p_bc"]))
    for tag, opt in (("kf", False), ("ff", True)):
        prior = ViPosePrior(_nav(g, "nsi_"), torch.from_numpy(pp["prior_info"]), torch.tensor(True)) if opt else None
        ns_j, ns_i, inl, marg = pose_optimization_vi(
            _nav(g, "nsj_"), _nav(g, "nsi_"), obs, CAM, ext, pre, torch.from_numpy(pp["gravity"]),
            torch.from_numpy(pp["bias_info"]), prior=prior, rounds=POSE_ROUNDS, iters_per_round=POSE_ITERS,
            optimize_i=opt)
        _assert_nav(ns_j, gold, f"pose_{tag}_nsj_", 1e-5, 1e-5, 1e-5, 1e-6, ("pose", tag, "j"))
        _assert_nav(ns_i, gold, f"pose_{tag}_nsi_", 1e-5, 1e-5, 1e-5, 1e-6, ("pose", tag, "i"))
        np.testing.assert_array_equal(inl.numpy(), gold[f"pose_{tag}_inlier"])
        assert _rel(marg, gold[f"pose_{tag}_marg"]) <= 1e-4, ("marg", tag, _rel(marg, gold[f"pose_{tag}_marg"]))
        assert 150 <= int(inl.sum()) < 190  # the 10 outliers and 5 invalid rows are out


def _ba_matches_golden(gold):
    bp = ba_problem()
    for k, v in bp.items():
        np.testing.assert_array_equal(np.asarray(v), gold["ba_in_" + k])
    t = lambda k: torch.from_numpy(np.ascontiguousarray(bp[k]))  # noqa: E731
    pre = preintegrate_batch(interop.imu_batch_from_numpy(bp["gyro"], bp["acc"], bp["t"], bp["mask"], device="cpu"),
                             torch.zeros(3), torch.zeros(3), t("t0"), t("t1"))
    k = bp["nav_p"].shape[0]
    state = interop.vi_ba_state_from_numpy({f: bp["nav_" + f] for f in NavState._fields}, bp["points"], device="cpu")
    obs = pba.BAObservations(t("kf_idx"), t("uv"), t("inv_sigma2"), t("valid"))
    chain = interop.imu_chain_from_numpy({f: x.numpy() for f, x in zip(pre._fields, pre)}, np.ones(k - 1, bool),
                                         bp["bias_info"], device="cpu")
    ext = Extrinsics(t("r_bc"), t("p_bc"))
    out, chi2 = pba.vi_ba(state, obs, CAM, ext, chain, t("gravity"), t("fixed"), iters=BA_ITERS)
    out_gw, g_gw, _ = pba.vi_ba_gw(state, obs, CAM, ext, chain, t("gravity"), t("fixed"), iters=BA_ITERS)
    for tag, o in (("vi", out), ("gw", out_gw)):
        _assert_nav(o.nav, gold, f"ba_{tag}_nav_", 5e-4, 5e-4, 5e-5, 1e-3, ("ba", tag))
        assert np.abs(o.points.numpy() - gold[f"ba_{tag}_points"]).max() <= 5e-4, ("ba points", tag)
    assert np.abs(g_gw.numpy() - gold["ba_gw_gravity"]).max() <= 1e-3
    assert abs(np.linalg.norm(g_gw.numpy()) - 9.81) < 1e-4  # the gravity vertex keeps |g|
    assert np.abs(chi2.numpy() - gold["ba_vi_chi2"]).max() <= 1e-2 * max(gold["ba_vi_chi2"].max(), 1.0)


def test_vi_optimizers_match_reference():
    _factors_match_reference()
    gold = load(OPTIM_GOLDEN)
    _pose_matches_golden(gold)
    _ba_matches_golden(gold)
