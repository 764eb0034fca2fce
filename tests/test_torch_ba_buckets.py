"""The local BAs padded to the reference's pose buckets, against the JAX
reference:

  * the port's `optim/ba.py::pose_bucket` equals the reference's
    `viorb_tpu/slam/mono.py::_pose_bucket` for n = 1..100;
  * a vision problem of K=7 keyframes (M=64 landmarks, R=4 slots, 0.5 px
    noise, a few gross outliers, the first two keyframes fixed: anchors
    that pin the gauge, scale included, as a local BA's do) padded to
    `pose_bucket(7)` = 20 poses as both pipelines pad it (identity poses,
    fixed, named by no observation) through the port's and the reference's
    `vision_ba_two_phase` on the same numpy inputs: tests/test_torch_ba.py's
    tolerances (poses within 1e-3, points within 2e-3 absolute plus 2e-3
    relative, the surviving-observation masks equal on >= 99 %); the port's
    padded and unpadded solves agree within the same tolerances, the padded
    poses stay the identity, and the graphed local BA
    (`make_local_vision_ba`, eager on the CPU) is that padded solve bit for
    bit;
  * the VI BA on tests/torch_vi_problems.py's problem (K=6) padded to 20
    NavStates (identity, fixed, no observation, no valid edge: the default
    chain's 19 edges, the 14 past the window invalid) against the
    reference's unpadded solve in tests/torch_optim_golden.npz with
    tests/test_torch_vi_optim.py's tolerances (positions and landmarks 5e-4
    m, velocities 5e-4 m/s, rotations 5e-5, bias increments 1e-3); the
    padded and unpadded port solves agree within them; the graphed local
    VI BA (`make_local_vi_ba`) is the padded `vi_ba_two_phase` bit for bit.

One test per file: see tests/test_torch_fast.py."""

import jax.numpy as jnp
import numpy as np
import torch

from make_torch_goldens import BA_ITERS, OPTIM_GOLDEN, load
from test_torch_ba import REF_CAM, _rodrigues
from torch_vi_problems import ba_problem
from viorb_tpu.optim import ba as ref_ba
from viorb_tpu.slam.mono import _pose_bucket
from viorb_tpu_torch import interop
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.imu.navstate import NavState
from viorb_tpu_torch.imu.preintegration import preintegrate_batch
from viorb_tpu_torch.interop import camera_from_fields
from viorb_tpu_torch.optim import ba
from viorb_tpu_torch.optim.reprojection import Extrinsics

torch.set_num_threads(1)

K, M, R = 7, 64, 4
VI_CAM = PinholeCamera(fx=225.0, fy=225.0, cx=188.0, cy=120.0, width=376, height=240)


def _vision_problem(seed=3):
    from viorb_tpu.geometry.camera import project as ref_project

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M), rng.uniform(3, 8, M)], 1)
    r_cw = _rodrigues(rng.normal(0, 0.05, (K, 3)))
    t_cw = rng.normal(0, 0.3, (K, 3))
    kf_idx = np.stack([rng.permutation(K)[:R] for _ in range(M)])
    pc = np.einsum("mrij,mj->mri", r_cw[kf_idx], pts) + t_cw[kf_idx]
    uv = np.asarray(ref_project(REF_CAM, jnp.asarray(pc, jnp.float32))) + rng.normal(0, 0.5, (M, R, 2))
    valid = rng.random((M, R)) > 0.12
    gross = (rng.random((M, R)) < 0.03) & valid
    uv[gross] += rng.uniform(-40, 40, (int(gross.sum()), 2))
    obs = dict(kf_idx=kf_idx, uv=uv.astype(np.float32),
               inv_sigma2=(1.0 / (1.2 ** rng.integers(0, 8, (M, R))) ** 2).astype(np.float32), valid=valid)
    state = dict(r_cw=(_rodrigues(rng.normal(0, 0.01, (K, 3))) @ r_cw).astype(np.float32),
                 t_cw=(t_cw + rng.normal(0, 0.02, (K, 3))).astype(np.float32),
                 points=(pts + rng.normal(0, 0.05, (M, 3))).astype(np.float32))
    fixed = np.zeros(K, bool)
    fixed[:2] = True  # two anchors pin the gauge, scale included, as a local BA's outside anchors do
    return obs, state, fixed


def _pad_vision(state, fixed, k):
    """The pipelines' padding: identity poses, fixed."""
    r = np.broadcast_to(np.eye(3, dtype=np.float32), (k, 3, 3)).copy()
    t = np.zeros((k, 3), np.float32)
    r[: len(fixed)], t[: len(fixed)] = state["r_cw"], state["t_cw"]
    f = np.ones(k, bool)
    f[: len(fixed)] = fixed
    return dict(state, r_cw=r, t_cw=t), f


def _assert_vision_close(a_state, a_valid, b_state, b_valid, n, what):
    np.testing.assert_allclose(np.asarray(a_state.r_cw)[:n], np.asarray(b_state.r_cw)[:n], rtol=0, atol=1e-3,
                               err_msg=what)
    np.testing.assert_allclose(np.asarray(a_state.t_cw)[:n], np.asarray(b_state.t_cw)[:n], rtol=0, atol=1e-3,
                               err_msg=what)
    np.testing.assert_allclose(np.asarray(a_state.points), np.asarray(b_state.points), rtol=2e-3, atol=2e-3,
                               err_msg=what)
    assert (np.asarray(a_valid) == np.asarray(b_valid)).mean() >= 0.99, what


def _vision_padded(cam):
    np_obs, np_state, fixed = _vision_problem()
    kb = ba.pose_bucket(K)
    assert kb == _pose_bucket(K) == 20
    p_state, p_fixed = _pad_vision(np_state, fixed, kb)
    obs = interop.ba_observations_from_numpy(**np_obs, device="cpu")

    def port(st, fx):
        return ba.vision_ba_two_phase(interop.vision_ba_state_from_numpy(**st, device="cpu"), obs, cam,
                                      torch.from_numpy(fx))

    padded, padded_obs = port(p_state, p_fixed)
    plain, plain_obs = port(np_state, fixed)
    r_obs = ref_ba.BAObservations(jnp.asarray(np_obs["kf_idx"], jnp.int32), jnp.asarray(np_obs["uv"]),
                                  jnp.asarray(np_obs["inv_sigma2"]), jnp.asarray(np_obs["valid"]))
    r_state = ref_ba.VisionBAState(*[jnp.asarray(p_state[k]) for k in ("r_cw", "t_cw", "points")])
    r_out, r_out_obs = ref_ba.vision_ba_two_phase(r_state, r_obs, REF_CAM, jnp.asarray(p_fixed))

    _assert_vision_close(padded, padded_obs.valid, r_out, r_out_obs.valid, kb, "padded: port vs reference")
    _assert_vision_close(padded, padded_obs.valid, plain, plain_obs.valid, K, "port: padded vs unpadded")
    eye = torch.eye(3).expand(kb - K, 3, 3)
    assert torch.equal(padded.r_cw[K:], eye) and not padded.t_cw[K:].any()
    assert torch.equal(padded.r_cw[:2], torch.from_numpy(p_state["r_cw"][:2]))

    # the graphed local BA (its eager function on the CPU) is that solve
    graphed = ba.make_local_vision_ba(cam)
    assert graphed is ba.make_local_vision_ba(cam)  # process-wide, one per camera
    out, valid = graphed(interop.vision_ba_state_from_numpy(**p_state, device="cpu"), *obs[:4],
                         torch.from_numpy(p_fixed))
    assert all(torch.equal(a, b) for a, b in zip(out, padded)) and torch.equal(valid, padded_obs.valid)


def _vi_padded(gold):
    bp = ba_problem()
    t = lambda k: torch.from_numpy(np.ascontiguousarray(bp[k]))  # noqa: E731
    k = bp["nav_p"].shape[0]
    kb = ba.pose_bucket(k)

    def pad(a, n, fill=0.0):
        out = np.full((n, *a.shape[1:]), fill, a.dtype)
        out[: len(a)] = a
        return out

    # the pipelines' padding: empty IMU segments for the padded edges
    # (invalid), identity NavStates (fixed) for the padded slots
    batch = interop.imu_batch_from_numpy(pad(bp["gyro"], kb - 1), pad(bp["acc"], kb - 1), pad(bp["t"], kb - 1),
                                         pad(bp["mask"], kb - 1, False), device="cpu")
    t0 = pad(bp["t0"], kb - 1)
    t1 = pad(bp["t1"], kb - 1, 0.01)
    pre = preintegrate_batch(batch, torch.zeros(3), torch.zeros(3), torch.from_numpy(t0), torch.from_numpy(t1))
    edge_valid = np.arange(kb - 1) < k - 1
    nav = {f: bp["nav_" + f] for f in NavState._fields}
    p_nav = {f: pad(v, kb) for f, v in nav.items()}
    p_nav["r"][k:] = np.eye(3, dtype=np.float32)
    p_fixed = pad(bp["fixed"], kb, True)
    obs = ba.BAObservations(t("kf_idx"), t("uv"), t("inv_sigma2"), t("valid"))
    ext = Extrinsics(t("r_bc"), t("p_bc"))
    chain = interop.imu_chain_from_numpy({f: x.numpy() for f, x in zip(pre._fields, pre)}, edge_valid,
                                         bp["bias_info"], device="cpu")
    state = interop.vi_ba_state_from_numpy(p_nav, bp["points"], device="cpu")
    out, _ = ba.vi_ba(state, obs, VI_CAM, ext, chain, t("gravity"), torch.from_numpy(p_fixed), iters=BA_ITERS)

    # against the reference's unpadded solve (the golden), the VI optimizer test's tolerances
    def assert_nav(got, want, what):
        for f, tol in (("p", 5e-4), ("v", 5e-4), ("r", 5e-5), ("dbg", 1e-3), ("dba", 1e-3)):
            err = np.abs(getattr(got, f).numpy()[:k] - want(f)).max()
            assert err <= tol, (what, f, err)

    assert_nav(out.nav, lambda f: gold["ba_vi_nav_" + f], "padded port vs the reference")
    assert np.abs(out.points.numpy() - gold["ba_vi_points"]).max() <= 5e-4
    assert torch.equal(out.nav.r[k:], torch.eye(3).expand(kb - k, 3, 3)) and not out.nav.p[k:].any()

    # against the port's unpadded solve
    pre_k = preintegrate_batch(interop.imu_batch_from_numpy(bp["gyro"], bp["acc"], bp["t"], bp["mask"], device="cpu"),
                               torch.zeros(3), torch.zeros(3), t("t0"), t("t1"))
    chain_k = interop.imu_chain_from_numpy({f: x.numpy() for f, x in zip(pre_k._fields, pre_k)}, np.ones(k - 1, bool),
                                           bp["bias_info"], device="cpu")
    plain, _ = ba.vi_ba(interop.vi_ba_state_from_numpy(nav, bp["points"], device="cpu"), obs, VI_CAM, ext, chain_k,
                        t("gravity"), t("fixed"), iters=BA_ITERS)
    assert_nav(out.nav, lambda f: getattr(plain.nav, f).numpy(), "port: padded vs unpadded")
    assert np.abs(out.points.numpy() - plain.points.numpy()).max() <= 5e-4

    # the graphed local VI BA (its eager function on the CPU) is the padded two-phase solve
    graphed = ba.make_local_vi_ba(VI_CAM)
    two, two_obs = ba.vi_ba_two_phase(state, obs, VI_CAM, ext, chain, t("gravity"), torch.from_numpy(p_fixed))
    g_out, g_valid = graphed(state, *obs[:4], ext, chain.pre, chain.valid, chain.bias_cov_inv_diag, t("gravity"),
                             torch.from_numpy(p_fixed))
    assert all(torch.equal(a, b) for a, b in zip(g_out.nav, two.nav))
    assert torch.equal(g_out.points, two.points) and torch.equal(g_valid, two_obs.valid)


def test_local_ba_pose_buckets():
    assert [ba.pose_bucket(n) for n in range(1, 101)] == [_pose_bucket(n) for n in range(1, 101)]
    _vision_padded(camera_from_fields(REF_CAM))
    _vi_padded(load(OPTIM_GOLDEN))
