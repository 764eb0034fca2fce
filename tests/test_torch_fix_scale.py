"""The port's fixed-scale Sim3 pieces (stereo and RGB-D loop closing, the
reference Sim3Solver's bFixScale) against the JAX reference, with s = 1
exactly in every result:

  * `horn_sim3(fix_scale=True)` on a noisy 12-point problem (a true scale
    of 1.3 that the fit must ignore) against the reference's under
    `jax.jit`: within 2e-6 (f32 rounding in another order);
  * `sim3_from_samples(fix_scale=True)` fed the 128 minimal sets the
    reference's `sim3_ransac(fix_scale=True)` draws on the mono loop run's
    recorded problem (tests/torch_loop_golden.npz): the same success and
    inliers, R and t within 2e-5;
  * `optimize_sim3_reproj(fix_scale=True)` from that result on the run's
    recorded refine problem: the same inliers, R and t within 2e-5;
  * `optimize_sim3_graph(fix_scale=True)` on tests/test_bow_posegraph.py's
    drifted circle started at unit scales: within 2e-5;
  * `LoopCloser(fix_scale=)` wiring: a StereoSlam's and an RgbdSlam's loop
    closer pins the scale, a MonoSlam's does not.
The reference's three solver results are recorded in
tests/torch_stereo_golden.npz (`fix_*`; tests/make_torch_goldens.py): their
jit compiles take longer than this file may. One test per file: see
tests/test_torch_fast.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from make_torch_goldens import (
    CIRCLE_ITERS,
    LOOP_CONFIG,
    LOOP_GOLDEN,
    STEREO_GOLDEN,
    circle_graph_problem,
    load,
)
from viorb_tpu.solvers.sim3_solver import horn_sim3 as ref_horn
from viorb_tpu_torch.bow import default_vocabulary
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.optim.pose_graph import Sim3Graph, optimize_sim3_graph
from viorb_tpu_torch.optim.sim3_refine import optimize_sim3_reproj
from viorb_tpu_torch.slam.mono import MonoSlam
from viorb_tpu_torch.slam.rgbd import RgbdSlam
from viorb_tpu_torch.slam.stereo import StereoSlam
from viorb_tpu_torch.solvers.sim3_solver import horn_sim3, sim3_from_samples

torch.set_num_threads(1)

OPS_ATOL = 2e-6
SOLVE_ATOL = 2e-5
T = torch.from_numpy


def _close(got, want, atol, what):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=atol, err_msg=what)


def test_fixed_scale_sim3_matches_reference():
    rng = np.random.default_rng(5)
    p2 = rng.normal(0.0, 2.0, (12, 3)).astype(np.float32)
    r_true = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    r_true *= np.sign(np.linalg.det(r_true))
    p1 = (1.3 * p2 @ r_true.T + [0.5, -0.2, 3.0] + rng.normal(0, 0.01, (12, 3))).astype(np.float32)
    s, r, t = horn_sim3(T(p1), T(p2), fix_scale=True)
    assert float(s) == 1.0
    _close((s, r, t), jax.jit(lambda a, b: ref_horn(a, b, True))(jnp.asarray(p1), jnp.asarray(p2)), OPS_ATOL, "horn")

    gold, loop = load(STEREO_GOLDEN), load(LOOP_GOLDEN)
    out = sim3_from_samples(T(loop["mono_ransac_p1"]), T(loop["mono_ransac_p2"]), T(loop["mono_ransac_valid"]),
                            T(gold["fix_ransac_idx"]), inlier_th=0.1, min_inliers=20, fix_scale=True)
    assert bool(out.success) == bool(gold["fix_ransac_success"]) and float(out.s) == 1.0
    np.testing.assert_array_equal(out.inliers.numpy(), gold["fix_ransac_inliers"])
    _close(out[2:4], [gold["fix_ransac_r"], gold["fix_ransac_t"]], SOLVE_ATOL, "ransac")

    c = LOOP_CONFIG
    cam = PinholeCamera(fx=c["fx"], fy=c["fx"], cx=c["cx"], cy=c["cy"], width=c["width"], height=c["height"])
    names = ("x1", "uv1", "x2", "uv2", "valid")
    s, r, t, inl = optimize_sim3_reproj(out.s, out.r, out.t, *(T(loop["mono_refine_" + k]) for k in names), cam,
                                        fix_scale=True)
    assert float(s) == 1.0
    np.testing.assert_array_equal(inl.numpy(), gold["fix_refine_inliers"])
    _close((r, t), [gold["fix_refine_r"], gold["fix_refine_t"]], SOLVE_ATOL, "refine")

    p = circle_graph_problem()
    graph = Sim3Graph(*(T(p[f]) for f in ("edge_i", "edge_j", "meas_s", "meas_r", "meas_t", "weight")))
    s, r, t = optimize_sim3_graph(torch.ones(len(p["s"])), T(p["r"]), T(p["t"]), graph, T(p["fixed"]),
                                  iters=CIRCLE_ITERS, fix_scale=True)
    assert (s.numpy() == 1.0).all()
    _close((r, t), [gold["fix_circle_r"], gold["fix_circle_t"]], SOLVE_ATOL, "essential graph")

    cam = PinholeCamera(fx=225.0, fy=225.0, cx=188.0, cy=120.0, width=376, height=240)
    vocab = default_vocabulary()
    for cls, kw, fixed in ((StereoSlam, {"baseline": 0.11}, True), (RgbdSlam, {}, True), (MonoSlam, {}, False)):
        slam = cls(cam, vocabulary=vocab, enable_loop_closing=True, device="cpu", **kw)
        assert slam.loop_closer.fix_scale is fixed and slam.loop_fix_scale is fixed, cls
