"""The port's Hamming matching and projection matching against the JAX
reference. Distances are small integers, so ties are the rule: the port
must break them as jax.lax.top_k / argmin do, to the lowest index.

One test per file: see tests/test_torch_fast.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_scene import N_FEATURES, REF_CAM, reference_map, render_scene
from viorb_tpu.features import matching as ref_matching
from viorb_tpu.features.extractor import OrbExtractor as RefExtractor
from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
from viorb_tpu.geometry.camera import project as ref_project
from viorb_tpu.geometry.camera import undistort_points as ref_undistort
from viorb_tpu.slam import kernels as ref_kernels
from viorb_tpu_torch.features.matching import hamming_matrix, match_with_mask, valid_gate
from viorb_tpu_torch.interop import camera_from_fields, device_map_from_numpy
from viorb_tpu_torch.slam.kernels import match_by_projection, unpack_local_map

torch.set_num_threads(1)


def _pm1(rng, n, zero_rows=0):
    d = (rng.integers(0, 2, (n, 256)) * 2 - 1).astype(np.float32)
    d[:zero_rows] = 0.0  # invalid rows
    return d


def _hamming_matrix_and_gate_exact():
    rng = np.random.default_rng(0)
    a, b = _pm1(rng, 70, zero_rows=3), _pm1(rng, 90, zero_rows=2)
    ref = np.asarray(
        ref_matching.hamming_matrix(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    )
    out = hamming_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[:3] == 128).all()
    va, vb = rng.random(70) < 0.8, rng.random(90) < 0.8
    np.testing.assert_array_equal(
        valid_gate(torch.from_numpy(va), torch.from_numpy(vb)).numpy(),
        np.asarray(ref_matching.valid_gate(jnp.asarray(va), jnp.asarray(vb))),
    )


def _match_with_mask_exact_with_ties(ratio, mutual):
    rng = np.random.default_rng(1)
    # distances drawn from a handful of values: most rows hold ties for
    # both the best and the second best
    levels = np.array([4.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0, 64.0])
    dist = rng.choice(levels, (120, 80)).astype(np.float32)
    allowed = rng.random((120, 80)) < 0.08
    ref = ref_matching.match_with_mask(
        jnp.asarray(dist), jnp.asarray(allowed), max_dist=50.0, ratio=ratio, mutual=mutual
    )
    out = match_with_mask(
        torch.from_numpy(dist), torch.from_numpy(allowed), max_dist=50.0, ratio=ratio,
        mutual=mutual,
    )
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(out.dist.numpy(), np.asarray(ref.dist))
    assert (out.idx.numpy() >= 0).sum() > 5


def _projection_state(seed=2, n_pts=1024, n_feat=300):
    """A local map and a frame's features built with numpy: map points in
    front of the camera, features at their projections (plus pixel noise)
    carrying their descriptors with a few flipped bits, distractors, and
    invalid map slots and features."""
    rng = np.random.default_rng(seed)
    cam = RefCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, k1=-0.05, k2=0.01,
                    width=752, height=480)
    xyz = np.stack(
        [rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts), rng.uniform(2, 9, n_pts)], 1
    ).astype(np.float32)
    desc01 = rng.integers(0, 2, (n_pts, 256))
    valid = rng.random(n_pts) < 0.9
    normal = xyz / np.linalg.norm(xyz, axis=1, keepdims=True)  # camera to point
    r_cw = np.eye(3, dtype=np.float32)
    t_cw = np.array([0.02, -0.01, 0.03], np.float32)
    uv = np.asarray(ref_project(cam, jnp.asarray(xyz + t_cw)))
    src = rng.choice(n_pts, n_feat, replace=False)
    feat_xy = (uv[src] + rng.normal(0, 1.5, (n_feat, 2))).astype(np.float32)
    feat01 = desc01[src].copy()
    flips = rng.random((n_feat, 256)) < 0.06
    feat01[flips] ^= 1
    feat01[: n_feat // 10] = rng.integers(0, 2, (n_feat // 10, 256))  # distractors
    feat_valid = rng.random(n_feat) < 0.95
    pts_pm1 = (desc01 * 2 - 1) * valid[:, None]
    feat_pm1 = (feat01 * 2 - 1) * feat_valid[:, None]
    args = dict(
        pts_xyz=xyz, pts_desc=pts_pm1.astype(np.float32), pts_valid=valid,
        pts_normal=normal.astype(np.float32), pts_min_dist=np.zeros(n_pts, np.float32),
        pts_max_dist=np.full(n_pts, 1e9, np.float32), r_cw=r_cw, t_cw=t_cw,
        feat_xy=feat_xy, feat_desc=feat_pm1.astype(np.float32), feat_valid=feat_valid,
    )
    return cam, args


def _reference_built_state():
    """The tracking step's first match of the half-size arc, built by the
    reference: its frame-0 map and its frame-1 features, predicted at the
    frame-0 pose."""
    _, r_wc, c_w, _, _, frames = render_scene(2)
    fields = reference_map(r_wc[0], c_w[0], frames[0])
    feats = RefExtractor(n_features=N_FEATURES).extract(frames[1].numpy())
    args = dict(
        pts_xyz=fields["xyz"], pts_desc=fields["desc_pm1"], pts_valid=fields["valid"],
        pts_normal=fields["normal"], pts_min_dist=fields["dmin"], pts_max_dist=fields["dmax"],
        r_cw=r_wc[0].T, t_cw=-r_wc[0].T @ c_w[0],
        feat_xy=np.asarray(ref_undistort(REF_CAM, feats.xy)),
        feat_desc=np.asarray(feats.descriptors_pm1(jnp.float32)),
        feat_valid=np.asarray(feats.valid),
    )
    # the map reaches the port through interop, as the tracking test's does
    dmap = device_map_from_numpy(**fields, device="cpu")
    for key, field in (("pts_xyz", "xyz"), ("pts_desc", "desc_pm1"), ("pts_valid", "valid")):
        np.testing.assert_array_equal(getattr(dmap, field).numpy(), args[key])
    return REF_CAM, args


def _match_by_projection_agrees_with_reference(state):
    """point_for_feat agrees on >= 99.5 % of features and the match count
    within +-1: projections differ by float rounding, which can move a
    pair across the window edge. Two states: numpy-built (a distorted
    camera, distractors, invalid slots) and the reference-built first
    match of the rendered arc."""
    ref_cam, args = state()
    ref_args = {
        k: jnp.asarray(v, jnp.bfloat16) if k.endswith("desc") else jnp.asarray(v)
        for k, v in args.items()
    }
    ref_pf, _, ref_n, ref_vis = ref_kernels.match_by_projection(
        **ref_args, cam=ref_cam, radius=jnp.float32(15.0)
    )
    pf, _, n, vis = match_by_projection(
        **{k: torch.tensor(np.asarray(v)) for k, v in args.items()},
        cam=camera_from_fields(ref_cam), radius=15.0,
    )
    ref_pf = np.asarray(ref_pf)
    assert (ref_pf >= 0).sum() > 50
    assert (pf.numpy() == ref_pf).mean() >= 0.995
    assert abs(int(n) - int(ref_n)) <= 1
    assert (vis.numpy() == np.asarray(ref_vis)).mean() >= 0.995


def _unpack_local_map_equals_reference():
    rng = np.random.default_rng(4)
    packed = rng.normal(size=(50, 8)).astype(np.float32)
    bits = rng.integers(0, 256, (50, 32)).astype(np.uint8)
    valid = rng.random(50) < 0.8
    ref = jax.jit(ref_kernels.unpack_local_map)(
        jnp.asarray(packed), jnp.asarray(bits), jnp.asarray(valid)
    )
    out = unpack_local_map(torch.from_numpy(packed), torch.from_numpy(bits), torch.from_numpy(valid))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r, np.float32 if o.is_floating_point() else None))


def test_matching_matches_reference():
    _hamming_matrix_and_gate_exact()
    for ratio, mutual in [(0.9, True), (1.0, True), (0.9, False)]:
        _match_with_mask_exact_with_ties(ratio, mutual)
    _match_by_projection_agrees_with_reference(_projection_state)
    _match_by_projection_agrees_with_reference(_reference_built_state)
    _unpack_local_map_equals_reference()
