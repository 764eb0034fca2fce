"""The port's geometry and pose-only LM against the JAX reference: SO(3),
the distorted pinhole camera, the analytic reprojection Jacobian (held to
jax.jacfwd of the reference residual) and pose_optimization_tcw on the
same observations.

One test per file: see tests/test_torch_fast.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from viorb_tpu.geometry import camera as ref_camera
from viorb_tpu.geometry import so3 as ref_so3
from viorb_tpu.optim.pose_only import PoseObs as RefPoseObs
from viorb_tpu.optim.pose_only import pose_optimization_tcw as ref_pose_opt
from viorb_tpu.optim.reprojection import reproj_residual_tcw as ref_residual
from viorb_tpu_torch.geometry import camera, so3
from viorb_tpu_torch.interop import camera_from_fields
from viorb_tpu_torch.optim.pose_only import PoseObs, pose_optimization_tcw
from viorb_tpu_torch.optim.reprojection import (
    reproj_residual_jacobian_tcw,
    reproj_residual_tcw,
)

torch.set_num_threads(1)

REF_CAM = ref_camera.PinholeCamera(
    fx=450.0, fy=455.0, cx=376.0, cy=240.0, k1=-0.28, k2=0.07, p1=2e-4, p2=-1e-4,
    k3=0.01, width=752, height=480,
)
CAM = camera_from_fields(REF_CAM)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _so3_agrees_with_reference():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.8, (64, 3)).astype(np.float32)
    w[:8] *= 1e-7  # the small-angle series
    R_ref = np.asarray(jax.jit(ref_so3.exp_so3)(jnp.asarray(w)))
    R = so3.exp_so3(_t(w)).numpy()
    np.testing.assert_allclose(R, R_ref, rtol=0, atol=2e-6)
    assert (so3.exp_so3(torch.zeros(3)) == torch.eye(3)).all()  # exact at 0
    # a rotation bent off orthonormal, as a long carry chain bends it
    Rb = (R_ref * (1 + rng.normal(0, 1e-3, R_ref.shape))).astype(np.float32)
    np.testing.assert_allclose(
        so3.normalize_rotation(_t(Rb)).numpy(),
        np.asarray(jax.jit(ref_so3.normalize_rotation)(jnp.asarray(Rb))), rtol=0, atol=2e-6,
    )
    np.testing.assert_allclose(
        so3.matrix_to_quat(_t(R_ref)).numpy(),
        np.asarray(jax.jit(ref_so3.matrix_to_quat)(jnp.asarray(R_ref))), rtol=0, atol=2e-6,
    )
    q = np.asarray(jax.jit(ref_so3.matrix_to_quat)(jnp.asarray(R_ref)))
    np.testing.assert_allclose(
        so3.quat_to_matrix(_t(q)).numpy(),
        np.asarray(jax.jit(ref_so3.quat_to_matrix)(jnp.asarray(q))), rtol=0, atol=2e-6,
    )


def _camera_agrees_with_reference():
    rng = np.random.default_rng(1)
    pc = np.stack([rng.uniform(-3, 3, 200), rng.uniform(-2, 2, 200), rng.uniform(1, 8, 200)], 1)
    pc = pc.astype(np.float32)
    pc[:3, 2] = [0.0, 5e-7, -5e-7]  # the zsafe rule
    np.testing.assert_allclose(
        camera.project(CAM, _t(pc)).numpy(),
        np.asarray(ref_camera.project(REF_CAM, jnp.asarray(pc))), rtol=1e-6, atol=1e-3,
    )
    uv = np.stack([rng.uniform(0, 752, 200), rng.uniform(0, 480, 200)], 1).astype(np.float32)
    und = camera.undistort_points(CAM, _t(uv)).numpy()
    np.testing.assert_allclose(
        und, np.asarray(ref_camera.undistort_points(REF_CAM, jnp.asarray(uv))), rtol=0, atol=1e-3
    )
    np.testing.assert_array_equal(
        camera.in_image_mask(CAM, _t(und), margin=1.0).numpy(),
        np.asarray(ref_camera.in_image_mask(REF_CAM, jnp.asarray(und), margin=1.0)),
    )


def _pose_problem(seed, n=400, outliers=40, noise=0.7):
    rng = np.random.default_rng(seed)
    r_true = np.asarray(ref_so3.exp_so3(jnp.asarray(rng.normal(0, 0.2, 3), jnp.float32)))
    t_true = rng.normal(0, 0.3, 3).astype(np.float32)
    pw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(3, 9, n)], 1)
    pw = (pw - t_true) @ r_true  # keep them in front of the true camera
    pw = pw.astype(np.float32)
    uv = np.asarray(ref_camera.project(REF_CAM, jnp.asarray(pw @ r_true.T + t_true)))
    uv = uv + rng.normal(0, noise, uv.shape)
    uv[:outliers] += rng.uniform(-40, 40, (outliers, 2))
    level = rng.integers(0, 8, n)
    inv_sigma2 = (1.0 / 1.44 ** level).astype(np.float32)
    valid = rng.random(n) < 0.9
    # a perturbed start
    r0 = np.asarray(ref_so3.exp_so3(jnp.asarray(rng.normal(0, 0.02, 3), jnp.float32))) @ r_true
    t0 = t_true + rng.normal(0, 0.05, 3).astype(np.float32)
    return dict(points=pw, uv=uv.astype(np.float32), inv_sigma2=inv_sigma2, valid=valid), r0, t0


def _analytic_jacobian_matches_jacfwd():
    obs, r0, t0 = _pose_problem(2, n=50)
    z6 = jnp.zeros(6, jnp.float32)

    def one(pw, uv):
        f = lambda d: ref_residual(d, jnp.asarray(r0), jnp.asarray(t0), pw, uv, REF_CAM)
        return f(z6), jax.jacfwd(f)(z6)

    r_ref, J_ref = jax.jit(jax.vmap(one))(jnp.asarray(obs["points"]), jnp.asarray(obs["uv"]))
    r, J = reproj_residual_jacobian_tcw(_t(r0), _t(t0), _t(obs["points"]), _t(obs["uv"]), CAM)
    J_ref = np.asarray(J_ref)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=0, atol=1e-3)
    # 1e-4 relative to each observation's largest Jacobian entry
    scale = np.abs(J_ref).max(axis=(1, 2), keepdims=True)
    assert (np.abs(J.numpy() - J_ref) <= 1e-4 * scale).all()
    # the residual itself at a nonzero increment
    d = np.array([0.01, -0.02, 0.03, 0.004, -0.003, 0.002], np.float32)
    np.testing.assert_allclose(
        reproj_residual_tcw(_t(d), _t(r0), _t(t0), _t(obs["points"]), _t(obs["uv"]), CAM).numpy(),
        np.asarray(jax.vmap(lambda p, u: ref_residual(jnp.asarray(d), jnp.asarray(r0),
                                                       jnp.asarray(t0), p, u, REF_CAM))(
            jnp.asarray(obs["points"]), jnp.asarray(obs["uv"]))),
        rtol=0, atol=1e-3,
    )


def _pose_optimization_agrees_with_reference(rounds, iters):
    """Same observations and start: poses within 1e-4 rad and 1e-4 m,
    inlier masks equal on >= 99 %."""
    obs, r0, t0 = _pose_problem(4)
    ref_r, ref_t, ref_inl = ref_pose_opt(
        jnp.asarray(r0), jnp.asarray(t0),
        RefPoseObs(*[jnp.asarray(obs[k]) for k in RefPoseObs._fields]), REF_CAM,
        rounds=rounds, iters_per_round=iters,
    )
    r, t, inl = pose_optimization_tcw(
        _t(r0), _t(t0), PoseObs(*[torch.from_numpy(obs[k]) for k in PoseObs._fields]), CAM,
        rounds=rounds, iters_per_round=iters,
    )
    ref_r = np.asarray(ref_r, np.float64)
    d_rot = np.linalg.norm(r.numpy().astype(np.float64) @ ref_r.T - np.eye(3)) / np.sqrt(2)
    assert d_rot <= 1e-4, d_rot
    assert np.abs(t.numpy() - np.asarray(ref_t)).max() <= 1e-4
    assert (inl.numpy() == np.asarray(ref_inl)).mean() >= 0.99
    assert inl.sum() > 250


def test_geometry_and_pose_lm_match_reference():
    _so3_agrees_with_reference()
    _camera_agrees_with_reference()
    _analytic_jacobian_matches_jacfwd()
    for rounds, iters in [(2, 4), (4, 10)]:  # make_tracking_step's, the default
        _pose_optimization_agrees_with_reference(rounds, iters)
