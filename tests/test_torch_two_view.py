"""The port's two-view initialization against the JAX reference: the
fitting, scoring and motion-check functions on the same given index sets,
and `two_view_init` by its outcome (the two packages draw their hypotheses
from different random streams).

Inputs are made with numpy from a seed: 240 matches of a 3-D scene (F wins)
and of a plane (H wins) seen from two poses, 0.1 px noise, 10 % gross
outliers, 5 % invalid rows. Tolerances: F and H, normalized to unit norm and
a common sign, to 2e-3 (f32 SVD null vectors of the same matrix); scores of
the same matrix to 1e-3 relative; candidate motions as sets to 1e-3;
`two_view_init`: rotation within 1e-2 rad and translation direction within
3 degrees of the reference's (both within the same of the truth), inlier
sets overlapping >= 95 %: with 64 hypotheses and no refinement the best
model depends on the draw, and the noise is kept low so that any clean
minimal set gives nearly the same inlier set.

One test per file: see tests/test_torch_fast.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
from viorb_tpu.solvers import two_view as ref_tv
from viorb_tpu_torch.interop import camera_from_fields
from viorb_tpu_torch.solvers import two_view as tv

torch.set_num_threads(1)

REF_CAM = RefCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
N = 240
N_HYPOTHESES = 64


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _scene(seed, planar):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N), rng.uniform(3, 9, N)], 1)
    if planar:
        pts[:, 2] = 5.0 + 0.2 * pts[:, 0]
    R = _rodrigues(np.array([0.03, -0.08, 0.02]))
    t = np.array([0.5, 0.05, 0.1])
    K = np.array([[450.0, 0, 376.0], [0, 450.0, 240.0], [0, 0, 1]])

    def proj(p):
        q = p @ K.T
        return q[:, :2] / q[:, 2:]

    x1 = proj(pts) + rng.normal(0, 0.1, (N, 2))
    x2 = proj(pts @ R.T + t) + rng.normal(0, 0.1, (N, 2))
    outlier = rng.random(N) < 0.10
    x2[outlier] += rng.uniform(-60, 60, (int(outlier.sum()), 2))
    valid = rng.random(N) > 0.05
    good = np.flatnonzero(valid & ~outlier)
    idx_h = np.stack([rng.choice(good, 4, replace=False) for _ in range(16)])
    idx_f = np.stack([rng.choice(good, 8, replace=False) for _ in range(16)])
    return dict(
        x1=x1.astype(np.float32), x2=x2.astype(np.float32), valid=valid, R=R, t=t / np.linalg.norm(t),
        K=K, idx_h=idx_h, idx_f=idx_f, clean=valid & ~outlier,
    )


def _unit(m):
    """Unit Frobenius norm, largest entry positive: a homogeneous matrix's
    representative."""
    m = np.asarray(m, np.float64)
    m = m / np.linalg.norm(m, axis=(-2, -1), keepdims=True)
    flat = m.reshape(*m.shape[:-2], 9)
    big = np.take_along_axis(flat, np.abs(flat).argmax(-1)[..., None], -1)
    return m * np.sign(big)[..., None]


def _rot_angle(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) @ np.asarray(b, np.float64).T - np.eye(3)) / np.sqrt(2)


def _set_distance(got_r, got_t, ref_r, ref_t):
    """Largest distance from a reference candidate to its nearest candidate
    of the port: the SVD's free signs permute the candidates."""
    worst = 0.0
    for r, t in zip(np.asarray(ref_r), np.asarray(ref_t)):
        d = [max(np.abs(r - gr).max(), np.abs(t - gt).max()) for gr, gt in zip(got_r.numpy(), got_t.numpy())]
        worst = max(worst, min(d))
    return worst


def _fits_and_scores_match(s):
    x1, x2, valid = (torch.from_numpy(s[k]) for k in ("x1", "x2", "valid"))
    jx1, jx2, jvalid = (jnp.asarray(s[k]) for k in ("x1", "x2", "valid"))
    (x1n, T1), (x2n, T2) = tv._normalize_points(x1), tv._normalize_points(x2)
    (rx1n, rT1), (rx2n, rT2) = ref_tv._normalize_points(jx1), ref_tv._normalize_points(jx2)
    np.testing.assert_allclose(x1n.numpy(), np.asarray(rx1n), rtol=0, atol=1e-5)
    np.testing.assert_allclose(T2.numpy(), np.asarray(rT2), rtol=1e-5, atol=1e-6)

    idx_h, idx_f = s["idx_h"], s["idx_f"]
    H = tv._fit_homography(x1n[idx_h], x2n[idx_h])
    F = tv._fit_fundamental(x1n[idx_f], x2n[idx_f])
    rH = jax.vmap(ref_tv._fit_homography)(rx1n[idx_h], rx2n[idx_h])
    rF = jax.vmap(ref_tv._fit_fundamental)(rx1n[idx_f], rx2n[idx_f])
    assert H.shape == (16, 3, 3) and F.shape == (16, 3, 3)
    np.testing.assert_allclose(_unit(H.numpy()), _unit(rH), rtol=0, atol=2e-3)
    np.testing.assert_allclose(_unit(F.numpy()), _unit(rF), rtol=0, atol=2e-3)
    assert np.abs(np.linalg.det(_unit(F.numpy()))).max() < 1e-6  # rank 2

    # scores of the SAME (reference-fitted, denormalized) matrices
    rHp = jnp.linalg.inv(rT2) @ rH @ rT1
    rFp = rT2.T @ rF @ rT1
    for fn, ref_fn, mats in ((tv._h_score, ref_tv._h_score, rHp), (tv._f_score, ref_tv._f_score, rFp)):
        score, ok = fn(torch.from_numpy(np.array(mats)), x1, x2, valid)
        r_score, r_ok = jax.vmap(lambda m: ref_fn(m, jx1, jx2, jvalid))(mats)
        np.testing.assert_allclose(score.numpy(), np.asarray(r_score), rtol=1e-3, atol=1e-2)
        assert (ok.numpy() == np.asarray(r_ok)).mean() >= 0.995
        assert score.numpy().max() > 100.0
        # unbatched call, as the reference's
        one, one_ok = fn(torch.from_numpy(np.array(mats[3])), x1, x2, valid)
        assert one.shape == () and torch.equal(one_ok, ok[3])


def _motions_match(s):
    K = s["K"]
    tx = np.array([[0, -s["t"][2], s["t"][1]], [s["t"][2], 0, -s["t"][0]], [-s["t"][1], s["t"][0], 0]])
    E = (tx @ s["R"]).astype(np.float32)
    Rs, ts = tv._motion_candidates_from_e(torch.from_numpy(E))
    rRs, rts = ref_tv._motion_candidates_from_e(jnp.asarray(E))
    assert Rs.shape == (4, 3, 3) and _set_distance(Rs, ts, rRs, rts) < 1e-3
    assert min(_rot_angle(r, s["R"]) + np.abs(t - s["t"]).max() for r, t in zip(Rs.numpy(), ts.numpy())) < 1e-3
    # calibrated homography of the plane n.X = d: A = R + t n^T / d
    n, d = np.array([-0.2, 0.0, 1.0]), 5.0
    A = (s["R"] + np.outer(s["t"] * 0.52, n) / d).astype(np.float32)
    Rs_h, ts_h = tv._motion_candidates_from_h(torch.from_numpy(A))
    rRs_h, rts_h = ref_tv._motion_candidates_from_h(jnp.asarray(A))
    assert Rs_h.shape == (8, 3, 3) and _set_distance(Rs_h, ts_h, rRs_h, rts_h) < 1e-3
    assert min(_rot_angle(r, s["R"]) for r in Rs_h.numpy()) < 1e-3

    # cheirality check of every candidate on the same normalized coords
    Kinv = np.linalg.inv(K)
    x1n = (np.c_[s["x1"], np.ones(N)] @ Kinv.T)[:, :2].astype(np.float32)
    x2n = (np.c_[s["x2"], np.ones(N)] @ Kinv.T)[:, :2].astype(np.float32)
    sig = (1.0 / 450.0) ** 2
    rRs_np, rts_np = np.array(rRs), np.array(rts)
    good, X, cosp = tv._check_motion(
        torch.from_numpy(rRs_np), torch.from_numpy(rts_np), torch.from_numpy(x1n), torch.from_numpy(x2n),
        torch.from_numpy(s["valid"]), sig,
    )
    r_good, r_X, r_cosp = jax.vmap(
        lambda R, t: ref_tv._check_motion(R, t, jnp.asarray(x1n), jnp.asarray(x2n), jnp.asarray(s["valid"]), sig)
    )(rRs, rts)
    r_good = np.asarray(r_good)
    assert good.shape == (4, N) and (good.numpy() == r_good).mean() >= 0.995
    assert sorted(r_good.sum(1))[-1] > 0.8 * s["clean"].sum() and sorted(r_good.sum(1))[-2] < 20
    both = good.numpy() & r_good
    np.testing.assert_allclose(X.numpy()[both], np.asarray(r_X)[both], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(cosp.numpy()[both], np.asarray(r_cosp)[both], rtol=0, atol=1e-5)
    one_good, one_X, _ = tv._check_motion(
        torch.from_numpy(rRs_np[0]), torch.from_numpy(rts_np[0]), torch.from_numpy(x1n),
        torch.from_numpy(x2n), torch.from_numpy(s["valid"]), sig,
    )
    assert torch.equal(one_good, good[0]) and one_X.shape == (N, 3)


def _init_outcome_matches(s, want_h):
    cam = camera_from_fields(REF_CAM)
    x1, x2, valid = (torch.from_numpy(s[k]) for k in ("x1", "x2", "valid"))
    gen = torch.Generator().manual_seed(2)
    idx_h, idx_f = tv.sample_minimal_sets(valid, N_HYPOTHESES, gen)
    assert idx_h.shape == (N_HYPOTHESES, 4) and idx_f.shape == (N_HYPOTHESES, 8)
    assert bool(valid[idx_f].all()) and all(len(set(row.tolist())) == 8 for row in idx_f)
    # nested as the reference's one-key draw: each H set is its F set's first 4
    assert torch.equal(idx_h, idx_f[:, :4])
    res = tv.two_view_init(x1, x2, valid, cam, torch.Generator().manual_seed(2), N_HYPOTHESES)
    again = tv.two_view_from_samples(x1, x2, valid, cam, idx_h, idx_f)
    assert torch.equal(res.r_cw2, again.r_cw2) and torch.equal(res.is_inlier, again.is_inlier)
    ref = ref_tv.two_view_init(
        jnp.asarray(s["x1"]), jnp.asarray(s["x2"]), jnp.asarray(s["valid"]), REF_CAM,
        jax.random.PRNGKey(2), n_hypotheses=N_HYPOTHESES,
    )
    assert bool(res.success) and bool(ref.success)
    assert bool(res.used_h) == bool(ref.used_h) == want_h
    for r, t in ((res.r_cw2.numpy(), res.t_cw2.numpy()), (np.asarray(ref.r_cw2), np.asarray(ref.t_cw2))):
        assert _rot_angle(r, s["R"]) < 1e-2
        assert np.degrees(np.arccos(np.clip(t @ s["t"], -1, 1))) < 3.0
    assert _rot_angle(res.r_cw2.numpy(), np.asarray(ref.r_cw2)) < 1e-2
    assert np.degrees(np.arccos(np.clip(res.t_cw2.numpy() @ np.asarray(ref.t_cw2), -1, 1))) < 3.0
    inl, r_inl = res.is_inlier.numpy(), np.asarray(ref.is_inlier)
    assert (inl & r_inl).sum() >= 0.95 * max(inl.sum(), r_inl.sum())
    assert inl.sum() > 0.9 * s["clean"].sum() and not inl[~s["valid"]].any()
    # triangulated points: the same bearings (view 1 pins them); depths
    # follow the translation direction, which 64 hypotheses fix to degrees
    both = inl & r_inl
    X, r_X = res.points.numpy()[both], np.asarray(ref.points)[both]
    bearing = lambda p: p / np.linalg.norm(p, axis=1, keepdims=True)
    np.testing.assert_allclose(bearing(X), bearing(r_X), rtol=0, atol=5e-3)
    assert abs(np.median(X[:, 2] / r_X[:, 2]) - 1.0) < 0.15


def test_two_view_matches_reference():
    general, planar = _scene(0, planar=False), _scene(1, planar=True)
    _fits_and_scores_match(general)
    _motions_match(general)
    _init_outcome_matches(general, want_h=False)
    _init_outcome_matches(planar, want_h=True)
