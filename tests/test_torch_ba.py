"""The port's vision bundle adjustment against the JAX reference on one
numpy-built problem: K=4 keyframes (the first fixed), M=64 landmarks, R=4
observation slots, 0.5 px noise, 12 % invalid slots, a few gross outliers.

Tolerances (f32, relative to each quantity's largest magnitude): analytic
Jacobians against `jax.jacfwd` 1e-4; S, b of one iteration 1e-4 (the port
sums per keyframe with `index_add_`, the reference with one-hot matmuls);
dx, dl 2e-3 (a Cholesky of a system of condition ~1e4 in f32); the final
state of `vision_ba_two_phase`: poses within 1e-3, points within 2e-3
absolute plus 2e-3 relative (one fixed keyframe leaves the scale free, and
ten f32 iterations drift along it), the surviving-observation masks equal
on >= 99 %.

The reference's pieces run under `jax.jit`, as they do inside its
`vision_ba`: op by op they dispatch hundreds of one-off programs.

One test per file: see tests/test_torch_fast.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
from viorb_tpu.optim import ba as ref_ba
from viorb_tpu_torch.interop import (
    ba_observations_from_numpy,
    camera_from_fields,
    vision_ba_state_from_numpy,
)
from viorb_tpu_torch.optim import ba

torch.set_num_threads(1)

REF_CAM = RefCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, k1=-0.05, k2=0.01, width=752, height=480)
K, M, R = 4, 64, 4


def _rodrigues(w):
    th = np.linalg.norm(w, axis=-1, keepdims=True)[..., None]
    k = w / th[..., 0]
    Kx = np.zeros((*w.shape[:-1], 3, 3))
    Kx[..., 0, 1], Kx[..., 0, 2], Kx[..., 1, 0] = -k[..., 2], k[..., 1], k[..., 2]
    Kx[..., 1, 2], Kx[..., 2, 0], Kx[..., 2, 1] = -k[..., 0], -k[..., 1], k[..., 0]
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def _problem(seed=0):
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
    inv_sigma2 = 1.0 / (1.2 ** rng.integers(0, 8, (M, R))) ** 2
    obs = dict(kf_idx=kf_idx, uv=uv.astype(np.float32), inv_sigma2=inv_sigma2.astype(np.float32), valid=valid)
    state = dict(
        r_cw=(_rodrigues(rng.normal(0, 0.01, (K, 3))) @ r_cw).astype(np.float32),
        t_cw=(t_cw + rng.normal(0, 0.02, (K, 3))).astype(np.float32),
        points=(pts + rng.normal(0, 0.05, (M, 3))).astype(np.float32),
    )
    return obs, state, dict(r_cw=r_cw, t_cw=t_cw, points=pts, gross=gross)


def _rel(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert got.shape == want.shape and err <= tol, (what, err)


def test_vision_ba_matches_reference():
    np_obs, np_state, truth = _problem()
    cam = camera_from_fields(REF_CAM)
    obs = ba_observations_from_numpy(**np_obs, device="cpu")
    state = vision_ba_state_from_numpy(**np_state, device="cpu")
    r_obs = ref_ba.BAObservations(
        jnp.asarray(np_obs["kf_idx"], jnp.int32), jnp.asarray(np_obs["uv"]),
        jnp.asarray(np_obs["inv_sigma2"]), jnp.asarray(np_obs["valid"]),
    )
    r_state = ref_ba.VisionBAState(*[jnp.asarray(np_state[k]) for k in ("r_cw", "t_cw", "points")])
    assert (obs.m, obs.r) == (M, R) and obs.chi2_delta2() == r_obs.chi2_delta2()

    # --- one iteration, piece by piece ------------------------------------
    r, Jp, Jl = ba._vision_blocks(state, obs, cam)
    rr, rJp, rJl = jax.jit(lambda s, o: ref_ba._vision_blocks(s, o, REF_CAM))(r_state, r_obs)
    np.testing.assert_allclose(r.numpy(), np.asarray(rr), rtol=0, atol=2e-3)  # pixels
    _rel(Jp.numpy(), rJp, 1e-4, "Jp")
    _rel(Jl.numpy(), rJl, 1e-4, "Jl")

    A = np.asarray(rJl).reshape(-1, 2, 3)[:50]
    A = np.einsum("nci,ncj->nij", A, A) + 50.0 * np.eye(3, dtype=np.float32)
    _rel(ba._inv3x3(torch.from_numpy(A)).numpy(), ref_ba._inv3x3(jnp.asarray(A)), 1e-5, "inv3x3")
    _rel(ba._inv3x3(torch.from_numpy(A)).numpy(), np.linalg.inv(A.astype(np.float64)), 1e-3, "inv3x3 vs f64")

    # the same residuals, Jacobians and weights (the reference's) into both
    w_np = np_obs["inv_sigma2"] * np_obs["valid"] * rng_weights(np_obs)
    lam = 1e-4
    t_blocks = [torch.from_numpy(np.array(x)) for x in (rr, rJp, rJl)]
    S, b, Hll_inv, b_l, U = ba._schur_system(*t_blocks, torch.from_numpy(w_np), obs, K, 6, lam)
    rS, rb, rHll_inv, rb_l, rU = jax.jit(lambda *a: ref_ba._schur_system(*a[:5], K, 6, a[5]))(
        rr, rJp, rJl, jnp.asarray(w_np), r_obs, jnp.float32(lam)
    )
    for name, got, want in (("S", S, rS), ("b", b, rb), ("Hll_inv", Hll_inv, rHll_inv), ("b_l", b_l, rb_l), ("U", U, rU)):
        _rel(got.numpy(), want, 1e-4, name)
    assert np.abs(S.numpy() - S.numpy().T).max() <= 1e-5 * np.abs(S.numpy()).max()

    fixed_kf = np.array([True, False, False, False])
    fixed_kd = np.repeat(fixed_kf, 6)
    dx = ba._solve_reduced(torch.from_numpy(np.array(rS)), torch.from_numpy(np.array(rb)), torch.from_numpy(fixed_kd), lam)
    r_dx = jax.jit(ref_ba._solve_reduced)(rS, rb, jnp.asarray(fixed_kd), jnp.float32(lam))
    _rel(dx.numpy(), r_dx, 2e-3, "dx")
    assert not dx.numpy()[:6].any()
    # ... and against a float64 solve of the same damped, masked system
    S64 = np.array(rS, np.float64)
    S64 += np.diag(lam * np.maximum(np.diag(S64), 1e-6))
    free = ~fixed_kd
    want = np.zeros(K * 6)
    want[free] = torch.linalg.solve(
        torch.from_numpy(S64[np.ix_(free, free)]), torch.from_numpy(np.array(rb, np.float64)[free])
    ).numpy()
    _rel(dx.numpy(), want, 5e-3, "dx vs linalg.solve in f64")

    t_dx = torch.from_numpy(np.array(r_dx))
    dl = ba._back_substitute(*[torch.from_numpy(np.array(x)) for x in (rHll_inv, rb_l, rU)], t_dx, obs, 6)
    r_dl = jax.jit(lambda *a: ref_ba._back_substitute(*a, 6))(rHll_inv, rb_l, rU, r_dx, r_obs)
    _rel(dl.numpy(), r_dl, 2e-3, "dl")

    fixed_lm = np.zeros(M, bool)
    fixed_lm[:5] = True
    cand = ba._apply_vision_update(state, t_dx, torch.from_numpy(np.array(r_dl)), K, torch.from_numpy(fixed_lm))
    r_cand = jax.jit(lambda *a: ref_ba._apply_vision_update(*a[:3], K, a[3]))(r_state, r_dx, r_dl, jnp.asarray(fixed_lm))
    for got, want in zip(cand, r_cand):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert torch.equal(cand.points[:5], state.points[:5])
    cost, chi2 = ba._vision_cost_and_chi2(cand, obs, cam, 5.991)
    r_cost, r_chi2 = jax.jit(lambda s, o: ref_ba._vision_cost_and_chi2(s, o, REF_CAM, 5.991))(r_cand, r_obs)
    _rel(cost.numpy(), r_cost, 1e-3, "cost")
    np.testing.assert_allclose(chi2.numpy(), np.asarray(r_chi2), rtol=2e-3, atol=1e-3)

    # --- the whole solve ---------------------------------------------------
    t_fixed = torch.from_numpy(fixed_kf)
    cost0, _ = ba._vision_cost_and_chi2(state, obs, cam, 5.991)
    one, _ = ba.vision_ba(state, obs, cam, t_fixed, iters=3)
    assert float(ba._vision_cost_and_chi2(one, obs, cam, 5.991)[0]) < 0.2 * float(cost0)

    final, out_obs = ba.vision_ba_two_phase(state, obs, cam, t_fixed)
    r_final, r_out_obs = ref_ba.vision_ba_two_phase(r_state, r_obs, REF_CAM, jnp.asarray(fixed_kf))
    np.testing.assert_allclose(final.r_cw.numpy(), np.asarray(r_final.r_cw), rtol=0, atol=1e-3)
    np.testing.assert_allclose(final.t_cw.numpy(), np.asarray(r_final.t_cw), rtol=0, atol=1e-3)
    np.testing.assert_allclose(final.points.numpy(), np.asarray(r_final.points), rtol=2e-3, atol=2e-3)
    assert (out_obs.valid.numpy() == np.asarray(r_out_obs.valid)).mean() >= 0.99
    # the fixed keyframe stayed, the gross outliers went, the rest stayed
    assert torch.equal(final.r_cw[0], state.r_cw[0]) and torch.equal(final.t_cw[0], state.t_cw[0])
    assert not out_obs.valid.numpy()[truth["gross"]].any()
    assert out_obs.valid.sum() >= 0.9 * (np_obs["valid"] & ~truth["gross"]).sum()
    assert torch.equal(out_obs.kf_idx, obs.kf_idx)

    # an out-of-range keyframe index on an invalid slot changes nothing
    bad_idx = np_obs["kf_idx"].copy()
    bad_idx[~np_obs["valid"]] = -1
    bad = ba_observations_from_numpy(**dict(np_obs, kf_idx=bad_idx), device="cpu")
    again, _ = ba.vision_ba(state, bad, cam, t_fixed, iters=3)
    ref_again, _ = ba.vision_ba(state, obs._replace(kf_idx=obs.kf_idx * obs.valid), cam, t_fixed, iters=3)
    for got, want in zip(again, ref_again):
        assert torch.equal(got, want)

    # stereo observations with no stereo match solve the monocular problem
    # (tests/test_torch_stereo_ba.py holds the stereo BA to the reference)
    stereo = obs._replace(ur=torch.full_like(obs.uv[..., 0], -1.0), ur_valid=torch.zeros_like(obs.valid))
    assert (stereo.chi2_delta2() == obs.chi2_delta2()).all()
    r3, Jp3, Jl3 = ba._vision_blocks(state, stereo, cam, 450.0 * 0.11)
    assert torch.equal(r3[..., :2], r) and torch.equal(Jp3[..., :2, :], Jp) and not r3[..., 2].any()
    mono_st, _ = ba.vision_ba(state, obs, cam, t_fixed, iters=3)
    stereo_st, _ = ba.vision_ba(state, stereo, cam, t_fixed, iters=3, bf=450.0 * 0.11)
    for got, want in zip(stereo_st, mono_st):
        _rel(got.numpy(), want.numpy(), 1e-5, "stereo without matches")


def rng_weights(np_obs):
    """Huber-like weights in (0.3, 1]: any positive weights serve the
    comparison of the two Schur builds."""
    return np.random.default_rng(5).uniform(0.3, 1.0, np_obs["valid"].shape).astype(np.float32)
