"""The port's Sim3 pieces (viorb_tpu_torch/geometry/sim3.py,
solvers/sim3_solver.py, optim/sim3_refine.py, optim/pose_graph.py) against
the JAX reference's, on the same numpy inputs:

  * compose, inverse, apply, exp and log on 8 increments that hit every
    branch of the V coefficients (general, theta ~ 0, sigma ~ 0, both), and
    `horn_sim3` on a noisy 12-point problem, against the reference's under
    one `jax.jit`: within 2e-6 absolute (f32 rounding in another order;
    measured ~2e-7);
  * `sim3_from_samples` fed the reference's own 128 minimal sets of the
    loop runs in tests/torch_loop_golden.npz (mono and VI circuits): the
    same success and inliers, S within 2e-5 (measured 2e-6);
  * `optimize_sim3_reproj` on the refine problems recorded there: the same
    inliers, S within 2e-5;
  * `optimize_sim3_graph` on test_bow_posegraph.py's drifted circle at 12
    keyframes (20 iterations) against the reference's result on the same
    problem, recorded in that golden (its jit compile alone takes ~10 s on
    a CPU): within 2e-5 (measured ~2e-6), and the reference test's recovery
    bounds.

One test per file: see tests/test_torch_fast.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from make_torch_goldens import CIRCLE_ITERS, LOOP_GOLDEN, LOOP_RUNS, circle_graph_problem, load
from viorb_tpu.geometry import sim3 as ref_sim3
from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
from viorb_tpu.solvers.sim3_solver import horn_sim3 as ref_horn
from viorb_tpu_torch.geometry import sim3
from viorb_tpu_torch.interop import camera_from_fields
from viorb_tpu_torch.optim.pose_graph import Sim3Graph, optimize_sim3_graph
from viorb_tpu_torch.optim.sim3_refine import optimize_sim3_reproj
from viorb_tpu_torch.solvers.sim3_solver import horn_sim3, sim3_from_samples

torch.set_num_threads(1)

OPS_ATOL = 2e-6
SOLVE_ATOL = 2e-5
CAM = RefCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
T = torch.from_numpy


def _close(got, want, atol, what):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=atol, err_msg=what)


def _ops_match_reference(rng):
    xi = (rng.normal(size=(8, 7)) * 0.5).astype(np.float32)
    xi[1, 3:6] = [2e-4, -1e-4, 3e-4]  # theta ~ 0
    xi[2, 6] = 3e-5  # sigma ~ 0
    xi[3, 3:7] = [1e-4, 0.0, 0.0, -2e-5]  # both
    xi[4] = 0.0
    xb = (rng.normal(size=(8, 7)) * 0.4).astype(np.float32)
    x = rng.normal(size=(8, 3)).astype(np.float32)

    @jax.jit
    def ref(xi, xb, x):
        a = ref_sim3.exp_sim3(xi)
        b = ref_sim3.exp_sim3(xb)
        c = ref_sim3.sim3_compose(*a, *b)
        return (*a, *c, *ref_sim3.sim3_inverse(*c), ref_sim3.sim3_apply(*c, x), ref_sim3.log_sim3(*c),
                ref_sim3.log_sim3(*a))

    a = sim3.exp_sim3(T(xi))
    b = sim3.exp_sim3(T(xb))
    c = sim3.sim3_compose(*a, *b)
    got = (*a, *c, *sim3.sim3_inverse(*c), sim3.sim3_apply(*c, T(x)), sim3.log_sim3(*c), sim3.log_sim3(*a))
    want = ref(xi, xb, x)
    _close(got[:-1], want[:-1], OPS_ATOL, "sim3 ops")
    # log(exp(xi)) = xi on every branch; the reference's own roundtrip is as close
    _close([got[-1]], [xi], 5 * OPS_ATOL, "log(exp(xi))")
    _close([got[-1]], [want[-1]], 5 * OPS_ATOL, "log_sim3")

    p2 = rng.uniform(-2, 2, size=(12, 3)).astype(np.float32) + np.array([0, 0, 5], np.float32)
    s, r, t = sim3.exp_sim3(T(np.array([0.3, -0.2, 0.1, 0.2, -0.1, 0.3, 0.15], np.float32)))
    p1 = (s * (T(p2) @ r.T) + t).numpy() + rng.normal(size=(12, 3)).astype(np.float32) * 0.01
    _close(horn_sim3(T(p1), T(p2)), jax.jit(ref_horn)(p1, p2), OPS_ATOL * 10, "horn_sim3")


def _solvers_match_reference_draws(gold):
    cam = camera_from_fields(CAM)
    for run in LOOP_RUNS:
        g = {k[len(run) + 1:]: v for k, v in gold.items() if k.startswith(run + "_")}
        out = sim3_from_samples(T(g["ransac_p1"]), T(g["ransac_p2"]), T(g["ransac_valid"]), T(g["ransac_idx"]),
                                inlier_th=0.1, min_inliers=20)
        assert bool(out.success) == bool(g["ransac_success"]), run
        np.testing.assert_array_equal(out.inliers.numpy(), g["ransac_inliers"])
        _close(out[1:4], [g["ransac_s"], g["ransac_r"], g["ransac_t"]], SOLVE_ATOL, f"{run} ransac")
        names = ("s12", "r12", "t12", "x1", "uv1", "x2", "uv2", "valid")
        s, r, t, inl = optimize_sim3_reproj(*(T(np.asarray(g["refine_" + k])) for k in names), cam)
        np.testing.assert_array_equal(inl.numpy(), g["refine_out_inliers"])
        _close((s, r, t), [g["refine_out_s"], g["refine_out_r"], g["refine_out_t"]], SOLVE_ATOL, f"{run} refine")


def _pose_graph_matches_reference(gold):
    p = circle_graph_problem()
    graph = Sim3Graph(*(T(p[f]) for f in ("edge_i", "edge_j", "meas_s", "meas_r", "meas_t", "weight")))
    got = optimize_sim3_graph(T(p["s"]), T(p["r"]), T(p["t"]), graph, T(p["fixed"]), iters=CIRCLE_ITERS)
    _close(got, [gold[f"circle_out_{f}"] for f in "srt"], SOLVE_ATOL, "optimize_sim3_graph")
    np.testing.assert_allclose(got[0].numpy(), np.ones(len(p["s"])), rtol=0.02)
    np.testing.assert_allclose(got[1].numpy(), p["gt_r"], atol=0.03)
    np.testing.assert_allclose(got[2].numpy(), p["gt_t"], atol=0.1)


def test_sim3_matches_reference():
    gold = load(LOOP_GOLDEN)
    _ops_match_reference(np.random.default_rng(3))
    _solvers_match_reference_draws(gold)
    _pose_graph_matches_reference(gold)
