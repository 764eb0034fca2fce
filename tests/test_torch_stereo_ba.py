"""The port's stereo bundle adjustment against the JAX reference on one
numpy-built mixed problem: K=4 keyframes (the first two fixed), M=64
landmarks, R=4 observation slots, 0.5 px noise on u, v and the right u,
12 % invalid slots, 60 % of the valid ones with a stereo match, a few gross
outliers; bf = 450 x 0.11.

  * the 3-row residual and its analytic Jacobians (the reference's
    `_vision_blocks` differentiates with `jax.jacfwd`) and the per-
    observation chi2 gates (7.815 stereo, 5.991 mono): residuals within
    2e-3 px, Jacobians within 1e-4 of their largest entry, gates equal;
  * `MapStore.build_stereo_ur_grid` on a 3-keyframe map built alike in both
    packages (`interop.keyframe_from_numpy`): equal;
  * `vision_ba_two_phase(bf=)` from the same start: poses within 2e-5,
    points within 1e-4 absolute plus 1e-4 relative, the surviving-
    observation masks equal on >= 99 % (measured 6e-7, 7e-6 and 100 %: with
    two fixed keyframes and the stereo row nothing is free, where
    tests/test_torch_ba.py's monocular problem drifts along its scale);
  * the stereo local-BA `GraphedFunction` (`make_local_vision_ba(cam, bf)`)
    on CPU tensors runs its eager function: equal to `vision_ba_two_phase`.

The reference's pieces run under `jax.jit` (its `vision_ba` is jitted).
One test per file: see
tests/test_torch_fast.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
from viorb_tpu.mapping.map import KeyFrameData as RefKeyFrame
from viorb_tpu.mapping.map import MapStore as RefMapStore
from viorb_tpu.optim import ba as ref_ba
from viorb_tpu_torch.interop import (
    ba_observations_from_numpy,
    camera_from_fields,
    keyframe_from_numpy,
    vision_ba_state_from_numpy,
)
from viorb_tpu_torch.mapping.map import MapStore
from viorb_tpu_torch.optim import ba

torch.set_num_threads(1)

REF_CAM = RefCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
BF = 450.0 * 0.11
K, M, R = 4, 64, 4


def _rodrigues(w):
    th = np.linalg.norm(w, axis=-1, keepdims=True)[..., None]
    k = w / th[..., 0]
    Kx = np.zeros((*w.shape[:-1], 3, 3))
    Kx[..., 0, 1], Kx[..., 0, 2], Kx[..., 1, 0] = -k[..., 2], k[..., 1], k[..., 2]
    Kx[..., 1, 2], Kx[..., 2, 0], Kx[..., 2, 1] = -k[..., 0], -k[..., 1], k[..., 0]
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M), rng.uniform(2, 8, M)], 1)
    r_cw = _rodrigues(rng.normal(0, 0.05, (K, 3)))
    t_cw = rng.normal(0, 0.3, (K, 3))
    kf_idx = np.stack([rng.permutation(K)[:R] for _ in range(M)])
    pc = np.einsum("mrij,mj->mri", r_cw[kf_idx], pts) + t_cw[kf_idx]
    u = REF_CAM.fx * pc[..., 0] / pc[..., 2] + REF_CAM.cx
    v = REF_CAM.fy * pc[..., 1] / pc[..., 2] + REF_CAM.cy
    noise = rng.normal(0, 0.5, (M, R, 3))
    uv = np.stack([u, v], -1) + noise[..., :2]
    ur = u - BF / pc[..., 2] + noise[..., 2]
    valid = rng.random((M, R)) > 0.12
    ur_valid = valid & (rng.random((M, R)) < 0.6)
    gross = (rng.random((M, R)) < 0.03) & valid
    uv[gross] += rng.uniform(-40, 40, (int(gross.sum()), 2))
    ur = np.where(ur_valid, ur, -1.0)
    inv_sigma2 = 1.0 / (1.2 ** rng.integers(0, 8, (M, R))) ** 2
    obs = dict(kf_idx=kf_idx, uv=uv.astype(np.float32), inv_sigma2=inv_sigma2.astype(np.float32), valid=valid,
               ur=ur.astype(np.float32), ur_valid=ur_valid)
    state = dict(
        r_cw=(_rodrigues(rng.normal(0, 0.01, (K, 3))) @ r_cw).astype(np.float32),
        t_cw=(t_cw + rng.normal(0, 0.02, (K, 3))).astype(np.float32),
        points=(pts + rng.normal(0, 0.05, (M, 3))).astype(np.float32),
    )
    state["r_cw"][:2], state["t_cw"][:2] = r_cw[:2], t_cw[:2]  # the fixed keyframes at the truth
    return obs, state


def _rel(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert got.shape == want.shape and err <= tol, (what, err)


def _ur_grid_matches_reference():
    rng = np.random.default_rng(1)
    maps = MapStore(), RefMapStore()
    n = 12
    for k in range(3):
        f = dict(timestamp=0.1 * k, r_cw=np.eye(3), t_cw=np.array([0.1 * k, 0, 0]),
                 xy=rng.uniform(0, 700, (n, 2)), level=rng.integers(0, 3, n), angle=np.zeros(n),
                 desc01=rng.integers(0, 2, (n, 256)), valid=np.ones(n, bool),
                 ur=np.where(rng.random(n) < 0.6, rng.uniform(0, 600, n), -1.0) if k != 1 else None)
        kf = keyframe_from_numpy(**f)
        for m, frame in zip(maps, (kf, RefKeyFrame(**vars(kf)))):
            m.add_keyframe(frame)
    obs = [(p, [(k, int(rng.integers(0, n))) for k in rng.permutation(3)[: 1 + p % 3]]) for p in range(10)]
    for m in maps:
        for p, views in obs:
            (k0, f0), rest = views[0], views[1:]
            i = m.add_point(np.array([0.0, 0.0, 5.0 + p]), m.keyframes[k0].desc01[f0], k0, f0)
            for k, f in rest:
                m.add_observation(i, k, f)
    pt_ids = np.arange(10)[::-1].copy()
    got = maps[0].build_stereo_ur_grid(pt_ids, [2, 0, 1], 16)
    want = maps[1].build_stereo_ur_grid(pt_ids, [2, 0, 1], 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].sum() > 3, got[1].sum()


def test_stereo_ba_matches_reference():
    np_obs, np_state = _problem()
    cam = camera_from_fields(REF_CAM)
    obs = ba_observations_from_numpy(**np_obs, device="cpu")
    state = vision_ba_state_from_numpy(**np_state, device="cpu")
    r_obs = ref_ba.BAObservations(
        jnp.asarray(np_obs["kf_idx"], jnp.int32), *(jnp.asarray(np_obs[k]) for k in ("uv", "inv_sigma2", "valid")),
        jnp.asarray(np_obs["ur"]), jnp.asarray(np_obs["ur_valid"]),
    )
    r_state = ref_ba.VisionBAState(*[jnp.asarray(np_state[k]) for k in ("r_cw", "t_cw", "points")])
    np.testing.assert_array_equal(obs.chi2_delta2().numpy(), np.asarray(r_obs.chi2_delta2()))

    # the 3-row residual and its Jacobians
    r, Jp, Jl = ba._vision_blocks(state, obs, cam, BF)
    rr, rJp, rJl = jax.jit(lambda s, o: ref_ba._vision_blocks(s, o, REF_CAM, jnp.float32(BF)))(r_state, r_obs)
    assert r.shape == (M, R, 3) and Jp.shape == (M, R, 3, 6) and Jl.shape == (M, R, 3, 3)
    np.testing.assert_allclose(r.numpy(), np.asarray(rr), rtol=0, atol=2e-3)
    _rel(Jp.numpy(), rJp, 1e-4, "Jp")
    _rel(Jl.numpy(), rJl, 1e-4, "Jl")
    assert not r.numpy()[..., 2][~np_obs["ur_valid"]].any() and not Jp.numpy()[..., 2, :][~np_obs["ur_valid"]].any()

    _ur_grid_matches_reference()

    # the two-phase solve, two keyframes fixed
    fixed = np.array([True, True, False, False])
    out, out_obs = ba.vision_ba_two_phase(state, obs, cam, torch.from_numpy(fixed), bf=BF)
    r_out, r_out_obs = ref_ba.vision_ba_two_phase(r_state, r_obs, REF_CAM, jnp.asarray(fixed), bf=jnp.float32(BF))
    d_pose = max(np.abs(out.r_cw.numpy() - np.asarray(r_out.r_cw)).max(),
                 np.abs(out.t_cw.numpy() - np.asarray(r_out.t_cw)).max())
    want_pts = np.asarray(r_out.points)
    d_pts = np.abs(out.points.numpy() - want_pts) / (1e-4 + 1e-4 * np.abs(want_pts))
    agree = (out_obs.valid.numpy() == np.asarray(r_out_obs.valid)).mean()
    print(f"stereo vision_ba_two_phase vs the reference: poses {d_pose:.2e}, points "
          f"{np.abs(out.points.numpy() - want_pts).max():.2e}, masks agree on {agree:.4f}")
    assert d_pose <= 2e-5 and d_pts.max() <= 1.0 and agree >= 0.99, (d_pose, d_pts.max(), agree)

    # the stereo local BA's graph runs its eager function on the CPU
    graph = ba.make_local_vision_ba(cam, BF)
    assert graph is ba.make_local_vision_ba(cam, BF) and graph is not ba.make_local_vision_ba(cam)
    g_state, g_valid = graph(state, obs.kf_idx, obs.uv, obs.inv_sigma2, obs.valid, obs.ur, obs.ur_valid,
                             torch.from_numpy(fixed))
    assert all(torch.equal(a, b) for a, b in zip(g_state, out)) and torch.equal(g_valid, out_obs.valid)
