"""The port's device functions of local mapping against the JAX reference:
SE(3) / SO(3) (log, Jacobians), the matching gates, triangulation, and
`slam/kernels.py`'s fundamental_from_poses, match_for_triangulation,
triangulate_between, fuse_match_gathered, project_depth.

Inputs are made with numpy from a seed and given to both packages: two
keyframes 0.4 m apart seeing 160 points, descriptors with a few flipped
bits, distractors and bound (non-free) features. Match decisions on equal
descriptors must be EXACT (Hamming distances are small integers and ties
break to the lowest index in both packages); floats to the tolerance stated
at each check.

One test per file: see tests/test_torch_fast.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from viorb_tpu.features import matching as ref_matching
from viorb_tpu.geometry import se3 as ref_se3
from viorb_tpu.geometry import so3 as ref_so3
from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
from viorb_tpu.slam import kernels as ref_kernels
from viorb_tpu.solvers import triangulation as ref_tri
from viorb_tpu_torch.features import matching
from viorb_tpu_torch.geometry import se3, so3
from viorb_tpu_torch.geometry.camera import camera_matrix
from viorb_tpu_torch.interop import camera_from_fields, local_map_upload_from_numpy
from viorb_tpu_torch.slam import kernels
from viorb_tpu_torch.solvers import triangulation as tri

torch.set_num_threads(1)

REF_CAM = RefCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
N = 160


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


JACOBIANS = ("right_jacobian", "right_jacobian_inv", "left_jacobian", "left_jacobian_inv")


@jax.jit
def _ref_lie_groups(w, xi, x):
    """Every reference value `_lie_groups_match` needs, as one program (op
    by op the reference dispatches a few hundred one-off programs)."""
    R = ref_so3.exp_so3(w)
    Ra, ta = ref_se3.exp_se3(xi)
    return dict(
        R=R, log=ref_so3.log_so3(R), log12=ref_so3.log_so3(R[12]),
        jac={name: getattr(ref_so3, name)(w) for name in JACOBIANS},
        Ra=Ra, ta=ta, log_se3=ref_se3.log_se3(Ra, ta),
        compose=ref_se3.se3_compose(Ra, ta, Ra[::-1], ta[::-1]), inverse=ref_se3.se3_inverse(Ra, ta),
        apply=ref_se3.se3_apply(Ra, ta, x), matrix=ref_se3.se3_matrix(Ra, ta),
    )


def _lie_groups_match():
    rng = np.random.default_rng(0)
    # rotation vectors: generic, tiny (series branch), and near pi
    w = rng.normal(0, 1.0, (40, 3)).astype(np.float32)
    w[:5] *= 1e-7
    axis = rng.normal(size=(5, 3))
    w[5:10] = (axis / np.linalg.norm(axis, axis=1, keepdims=True) * np.array([3.0, 3.1, 3.13, 3.14, 3.1415])[:, None])
    xi = rng.normal(0, 0.5, (20, 6)).astype(np.float32)
    x = rng.normal(size=(20, 3)).astype(np.float32)
    ref = _ref_lie_groups(jnp.asarray(w), jnp.asarray(xi), jnp.asarray(x))

    R = _t(np.array(ref["R"]))
    _close(so3.exp_so3(_t(w)), ref["R"], 1e-6)
    _close(so3.log_so3(R), ref["log"], 2e-4)
    _close(so3.log_so3(R[12]), ref["log12"], 2e-4)  # unbatched
    for name in JACOBIANS:
        _close(getattr(so3, name)(_t(w)), ref["jac"][name], 2e-5, rtol=1e-5)
    _close(so3.vee(so3.hat(_t(w))), w, 0.0)

    Ra, ta = se3.exp_se3(_t(xi))
    _close(Ra, ref["Ra"], 1e-6)
    _close(ta, ref["ta"], 1e-6)
    _close(se3.log_se3(Ra, ta), ref["log_se3"], 1e-5)
    _close(se3.log_se3(Ra, ta), xi, 1e-5)
    Rb, tb = Ra.flip(0), ta.flip(0)
    for got, want in zip(se3.se3_compose(Ra, ta, Rb, tb), ref["compose"]):
        _close(got, want, 1e-6)
    for got, want in zip(se3.se3_inverse(Ra, ta), ref["inverse"]):
        _close(got, want, 1e-6)
    _close(se3.se3_apply(Ra, ta, _t(x)), ref["apply"], 1e-6)
    _close(se3.se3_matrix(Ra, ta), ref["matrix"], 1e-6)
    assert se3.make_se3(Ra, ta)[0] is Ra


def _gates_match():
    rng = np.random.default_rng(1)
    n, m = 90, 70
    ang_a = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    idx = rng.integers(-1, m, n)
    # most matches share one rotation, a second cluster ties bins, the rest scatter
    ok = np.flatnonzero(idx >= 0)
    ang_a[ok[:40]] = ang_b[idx[ok[:40]]] + 0.5 + rng.normal(0, 0.02, 40).astype(np.float32)
    ang_a[ok[40:52]] = ang_b[idx[ok[40:52]]] - 1.0
    for keep in (3, 1):
        got = matching.rotation_consistency_mask(_t(ang_a), _t(ang_b), _t(idx), keep_bins=keep)
        want = ref_matching.rotation_consistency_mask(
            jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.asarray(idx, jnp.int32), keep_bins=keep
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 30 < int(got.sum()) < len(ok)
    xy_a = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    xy_b = rng.uniform(0, 100, (m, 2)).astype(np.float32)
    lv_a, lv_b = rng.integers(0, 8, n), rng.integers(0, 8, m)
    per_row = rng.uniform(5, 30, n).astype(np.float32)
    for radius, jradius, levels in ((20.0, 20.0, False), (_t(per_row), jnp.asarray(per_row), True)):
        got = matching.window_gate(_t(xy_a), _t(xy_b), radius, *((_t(lv_a), _t(lv_b)) if levels else ()))
        want = ref_matching.window_gate(
            jnp.asarray(xy_a), jnp.asarray(xy_b), jradius,
            *((jnp.asarray(lv_a), jnp.asarray(lv_b)) if levels else ()),
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < int(got.sum()) < n * m


def _rodrigues(w):
    return np.array(ref_so3.exp_so3(jnp.asarray(w, jnp.float32)))


def _two_keyframes(seed=2):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N), rng.uniform(3, 9, N)], 1).astype(np.float32)
    r1, t1 = _rodrigues([0.01, -0.02, 0.005]), np.array([0.05, 0.0, 0.02], np.float32)
    r2, t2 = _rodrigues([-0.02, 0.06, 0.01]), np.array([-0.35, 0.03, 0.05], np.float32)
    K = np.array([[450.0, 0, 376.0], [0, 450.0, 240.0], [0, 0, 1]], np.float32)

    def proj(r, t):
        q = (pts @ r.T + t) @ K.T
        return (q[:, :2] / q[:, 2:]).astype(np.float32)

    xy1 = proj(r1, t1) + rng.normal(0, 0.4, (N, 2)).astype(np.float32)
    perm = rng.permutation(N)  # KF2 lists the same points in another order
    xy2 = (proj(r2, t2) + rng.normal(0, 0.4, (N, 2)).astype(np.float32))[perm]
    d1 = rng.integers(0, 2, (N, 256)).astype(np.uint8)
    d2 = d1.copy()
    d2[rng.random((N, 256)) < 0.05] ^= 1
    d2 = d2[perm]
    d2[:12] = rng.integers(0, 2, (12, 256))  # distractors
    free1, free2 = rng.random(N) < 0.85, rng.random(N) < 0.85
    lv1, lv2 = rng.integers(0, 8, N), rng.integers(0, 8, N)
    sigma2 = (1.2 ** np.arange(8)).astype(np.float32) ** 2
    return dict(r1=r1, t1=t1, xy1=xy1, lv1=lv1, d1=d1, free1=free1, r2=r2, t2=t2, xy2=xy2,
                lv2=lv2, d2=d2, free2=free2, sigma2=sigma2, K=K, pts=pts, perm=perm)


def _triangulation_matches(s):
    """DLT on the true correspondences: X to 1e-3 (relative, f32 SVD of the
    same 4x4 systems), against the reference and the true points."""
    inv = np.argsort(s["perm"])
    x2 = s["xy2"][inv]
    P1 = tri.projection_matrix(_t(s["K"]), _t(s["r1"]), _t(s["t1"]))
    P2 = tri.projection_matrix(_t(s["K"]), _t(s["r2"]), _t(s["t2"]))
    rP1 = ref_tri.projection_matrix(jnp.asarray(s["K"]), jnp.asarray(s["r1"]), jnp.asarray(s["t1"]))
    rP2 = ref_tri.projection_matrix(jnp.asarray(s["K"]), jnp.asarray(s["r2"]), jnp.asarray(s["t2"]))
    _close(P1, rP1, 1e-4)
    X = tri.triangulate_two_view(P1, P2, _t(s["xy1"]), _t(x2))  # P broadcasts over the points
    rX = ref_tri.triangulate_two_view(
        jnp.broadcast_to(rP1, (N, 3, 4)), jnp.broadcast_to(rP2, (N, 3, 4)), jnp.asarray(s["xy1"]), jnp.asarray(x2)
    )
    _close(X, rX, atol=1e-3, rtol=1e-3)
    assert np.median(np.linalg.norm(X.numpy() - s["pts"], axis=1)) < 0.1
    c1, c2 = -s["r1"].T @ s["t1"], -s["r2"].T @ s["t2"]
    _close(tri.parallax_cos(_t(c1), _t(c2), X), ref_tri.parallax_cos(jnp.asarray(c1), jnp.asarray(c2), rX), 1e-6)
    cam = camera_from_fields(REF_CAM)
    _close(camera_matrix(cam, "cpu"), REF_CAM.K, 0.0)
    uv, depth = kernels.project_depth(_t(s["r1"]), _t(s["t1"]), _t(s["pts"]), cam)
    r_uv, r_depth = ref_kernels.project_depth(jnp.asarray(s["r1"]), jnp.asarray(s["t1"]), jnp.asarray(s["pts"]), REF_CAM)
    _close(uv, r_uv, 1e-3)
    _close(depth, r_depth, 1e-5)


def _epipolar_matching_matches(s):
    cam = camera_from_fields(REF_CAM)
    F12 = kernels.fundamental_from_poses(*(_t(s[k]) for k in ("r1", "t1", "r2", "t2", "K")))
    rF12 = ref_kernels.fundamental_from_poses(*(jnp.asarray(s[k]) for k in ("r1", "t1", "r2", "t2", "K")))
    _close(F12, rF12, atol=1e-9, rtol=1e-4)
    pm1 = lambda d: d.astype(np.float32) * 2 - 1
    res = kernels.match_for_triangulation(
        _t(s["xy1"]), _t(pm1(s["d1"])), _t(s["free1"]), _t(s["xy2"]), _t(pm1(s["d2"])), _t(s["free2"]),
        _t(np.array(rF12)),
    )
    ref = ref_kernels.match_for_triangulation(
        jnp.asarray(s["xy1"]), jnp.asarray(pm1(s["d1"]), jnp.bfloat16), jnp.asarray(s["free1"]),
        jnp.asarray(s["xy2"]), jnp.asarray(pm1(s["d2"]), jnp.bfloat16), jnp.asarray(s["free2"]), rF12,
    )
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(res.dist.numpy(), np.asarray(ref.dist))
    matched = res.idx.numpy() >= 0
    assert matched.sum() > 60 and (s["perm"][res.idx.numpy()[matched]] == np.flatnonzero(matched)).mean() > 0.95

    idx, X, good = kernels.triangulate_between(
        _t(s["r1"]), _t(s["t1"]), _t(s["xy1"]), _t(s["lv1"]), _t(s["d1"]), _t(s["free1"]),
        _t(s["r2"]), _t(s["t2"]), _t(s["xy2"]), _t(s["lv2"]), _t(s["d2"]), _t(s["free2"]),
        cam, _t(s["sigma2"]),
    )
    r_idx, r_X, r_good = ref_kernels.triangulate_between(
        *(jnp.asarray(s[k]) for k in ("r1", "t1", "xy1", "lv1", "d1", "free1", "r2", "t2", "xy2", "lv2", "d2", "free2")),
        REF_CAM, jnp.asarray(s["sigma2"]),
    )
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    r_good = np.asarray(r_good)
    assert (good.numpy() == r_good).mean() >= 0.99 and r_good.sum() > 50
    both = good.numpy() & r_good
    _close(X[_t(both)], np.asarray(r_X)[both], atol=1e-3, rtol=1e-3)
    assert np.median(np.linalg.norm(X.numpy()[both] - s["pts"][both], axis=1)) < 0.15


def _fuse_matching_matches(s):
    """The union payload packed as the mapper uploads it; one pair selects a
    subset with -1 padding. Same descriptors in both packages: decisions
    exact but for projections that round across the window edge (none
    here)."""
    rng = np.random.default_rng(3)
    cam = camera_from_fields(REF_CAM)
    U = 200
    xyz = np.concatenate([s["pts"], rng.uniform(-3, 3, (U - N, 3)).astype(np.float32) + [0, 0, 6]]).astype(np.float32)
    normal = xyz / np.linalg.norm(xyz, axis=1, keepdims=True)
    packed = np.concatenate([xyz, normal, np.zeros((U, 1)), np.full((U, 1), 1e9)], 1).astype(np.float32)
    desc01 = np.concatenate([s["d1"], rng.integers(0, 2, (U - N, 256)).astype(np.uint8)])
    bits = np.packbits(desc01, axis=1, bitorder="little")
    valid = rng.random(U) < 0.9
    sel = np.concatenate([rng.choice(U, 120, replace=False), -np.ones(8, np.int64)]).astype(np.int32)
    kf_pm1 = (s["d2"].astype(np.float32) * 2 - 1) * s["free2"][:, None]
    upload = local_map_upload_from_numpy(packed, bits, valid, device="cpu")
    for got, want in zip(kernels.unpack_local_map(*upload), ref_kernels.unpack_local_map(
            jnp.asarray(packed), jnp.asarray(bits), jnp.asarray(valid))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32 if got.is_floating_point() else None))
    pf, res, n, vis = kernels.fuse_match_gathered(
        *upload, _t(sel), _t(s["r2"]), _t(s["t2"]), _t(s["xy2"]), _t(kf_pm1), _t(s["free2"]), cam, 8.0
    )
    r_pf, r_res, r_n, r_vis = ref_kernels.fuse_match_gathered(
        jnp.asarray(packed), jnp.asarray(bits), jnp.asarray(valid), jnp.asarray(sel),
        jnp.asarray(s["r2"]), jnp.asarray(s["t2"]), jnp.asarray(s["xy2"]), jnp.asarray(kf_pm1, jnp.bfloat16),
        jnp.asarray(s["free2"]), REF_CAM, jnp.float32(8.0),
    )
    np.testing.assert_array_equal(pf.numpy(), np.asarray(r_pf))
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(r_res.idx))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(r_vis))
    assert int(n) == int(r_n) > 40 and not vis.numpy()[-8:].any()


def test_mapping_kernels_match_reference():
    _lie_groups_match()
    _gates_match()
    s = _two_keyframes()
    _triangulation_matches(s)
    _epipolar_matching_matches(s)
    _fuse_matching_matches(s)
