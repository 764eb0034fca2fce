"""The port's PnP RANSAC (solvers/pnp.py) against the JAX reference's.

On the same given minimal sets, each hypothesis's DLT-P6P fit and its
inlier count are held to the reference's `_dlt_p6p` + scoring under ONE
`jax.jit`; the winner is the same hypothesis. The whole of `pnp_ransac`,
whose sets come from a `torch.Generator` where the reference splits
`jax.random` keys, is held to the ground truth by outcome. The scene: 240 world points 3-9 m in front of the
half-size camera of tests/torch_port_scene.py, 0.5 px noise, 25 % gross
outliers, 10 % invalid rows.

One test per file: see tests/test_torch_fast.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_scene import REF_CAM
from viorb_tpu.geometry.camera import project as ref_project
from viorb_tpu.solvers import pnp as ref_pnp
from viorb_tpu_torch.interop import camera_from_fields
from viorb_tpu_torch.solvers import pnp

torch.set_num_threads(1)

N_POINTS = 240
N_SETS = 128
# f32 SVDs of the 12x12 DLT systems in two libraries: on the sets that
# explain >= 10 points the fits agree to ~4e-6 (R) and ~2e-5 m (t); allow
# 1e-4 and 1e-3 m, and an inlier count within 1 of the reference's on every
# set (a point at the 4 px gate may flip).
FIT_R_TOL, FIT_T_TOL, SCORE_TOL = 1e-4, 1e-3, 1
# the whole RANSAC against the truth: its winner is a raw 6-point fit (the
# caller refines it with the pose LM), 2.7-3.6 cm and 0.5-0.6 degree off in
# either package with this scene; allow 5 cm and 1 degree, and >= 90 % of
# the valid inlier rows found
TRUTH_T_TOL, TRUTH_DEG_TOL, TRUTH_INLIER_SHARE = 5e-2, 1.0, 0.9


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    w = np.array([0.05, -0.2, 0.03])
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    r_cw = (np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * (k @ k)).astype(np.float32)
    t_cw = np.array([0.3, -0.1, 0.4], np.float32)
    pc = np.stack([rng.uniform(-3, 3, N_POINTS), rng.uniform(-2, 2, N_POINTS), rng.uniform(3, 9, N_POINTS)], 1)
    uv = np.stack([REF_CAM.fx * pc[:, 0] / pc[:, 2] + REF_CAM.cx, REF_CAM.fy * pc[:, 1] / pc[:, 2] + REF_CAM.cy], 1)
    uv += rng.normal(0, 0.5, uv.shape)
    outlier = rng.random(N_POINTS) < 0.25
    uv[outlier] += rng.uniform(-40, 40, (int(outlier.sum()), 2))
    points = (pc - t_cw) @ r_cw  # world = R^T (pc - t)
    valid = rng.random(N_POINTS) > 0.10
    # minimal sets from the valid rows, as both samplers draw them
    rows = np.nonzero(valid)[0]
    idx = np.stack([rng.choice(rows, 6, replace=False) for _ in range(N_SETS)])
    return points.astype(np.float32), uv.astype(np.float32), valid, idx, r_cw, t_cw, valid & ~outlier


@jax.jit
def _reference_hypotheses(points, uv, valid, idx):
    """The reference's per-hypothesis body of `pnp_ransac` on given sets."""
    cam = REF_CAM
    n = points.shape[0]
    Kinv = jnp.linalg.inv(cam.K.astype(points.dtype))
    xn = (jnp.concatenate([uv, jnp.ones((n, 1), points.dtype)], 1) @ Kinv.T)[:, :2]

    def hypo(i):
        R, t = ref_pnp._dlt_p6p(points[i], xn[i])
        pc = points @ R.T + t
        err = jnp.sum((ref_project(cam, pc) - uv) ** 2, axis=1)
        inl = valid & (pc[:, 2] > 0) & (err < 16.0)
        return jnp.sum(inl), R, t, inl

    return jax.vmap(hypo)(idx)


def _rotation_deg(a, b):
    return float(np.degrees(np.arccos(np.clip((np.trace(a @ b.T) - 1) / 2, -1, 1))))


def _fits_match_reference(scene, cam):
    points, uv, valid, idx, *_ = scene
    ref = [np.asarray(x) for x in _reference_hypotheses(points, uv, valid, idx)]
    got = [x.numpy() for x in pnp.pnp_hypotheses(
        torch.from_numpy(points), torch.from_numpy(uv), torch.from_numpy(valid), cam, torch.from_numpy(idx)
    )]
    scores, ref_scores = got[0], ref[0]
    assert np.abs(scores - ref_scores).max() <= SCORE_TOL, np.abs(scores - ref_scores).max()
    posed = ref_scores >= 10
    assert posed.sum() >= 8, posed.sum()  # ~0.75**6 of the sets hold no outlier
    assert np.abs(got[1][posed] - ref[1][posed]).max() <= FIT_R_TOL
    assert np.abs(got[2][posed] - ref[2][posed]).max() <= FIT_T_TOL
    # the winner: the same hypothesis, the same pose, the same inliers
    best = pnp.pnp_from_samples(
        torch.from_numpy(points), torch.from_numpy(uv), torch.from_numpy(valid), cam, torch.from_numpy(idx)
    )
    b = int(np.argmax(ref_scores))
    assert bool(best.success) and int(best.inliers.sum()) == int(ref_scores[b])
    np.testing.assert_array_equal(best.inliers.numpy(), ref[3][b])
    np.testing.assert_allclose(best.r_cw.numpy(), ref[1][b], rtol=0, atol=FIT_R_TOL)


def _ransac_finds_the_pose(scene, cam):
    points, uv, valid, _, r_cw, t_cw, true_inliers = scene
    out = pnp.pnp_ransac(
        torch.from_numpy(points), torch.from_numpy(uv), torch.from_numpy(valid), cam,
        torch.Generator().manual_seed(0),
    )
    assert bool(out.success)
    t_err, r_err = np.abs(out.t_cw.numpy() - t_cw).max(), _rotation_deg(out.r_cw.numpy(), r_cw)
    assert t_err <= TRUTH_T_TOL and r_err <= TRUTH_DEG_TOL, (t_err, r_err)
    found = int((out.inliers.numpy() & true_inliers).sum())
    assert found >= TRUTH_INLIER_SHARE * true_inliers.sum(), (found, true_inliers.sum())
    # fewer than 6 valid rows: the sampler still returns, the fit fails
    few = np.zeros(N_POINTS, bool)
    few[:4] = True
    weak = pnp.pnp_ransac(torch.from_numpy(points), torch.from_numpy(uv), torch.from_numpy(few), cam,
                          torch.Generator().manual_seed(1), n_hypotheses=8)
    assert not bool(weak.success)


def test_pnp_matches_reference():
    cam = camera_from_fields(REF_CAM)
    scene = _scene()
    _fits_match_reference(scene, cam)
    _ransac_finds_the_pose(scene, cam)
