"""The port's IMU package (viorb_tpu_torch/imu/) and synthetic IMU against the
JAX reference's, and against closed-form integrals.

  * the port's versions of tests/test_preintegration.py's 10 cases, with
    their tolerances (the compile-once case becomes: two calls agree bit
    for bit);
  * `preintegrate` (one 1.15 s segment of the arc's IMU with noise and
    biases) and `preintegrate_batch` (4 segments) at capacity 256 against
    the reference's outputs on the same seeded inputs
    (tests/torch_vi_problems.py; the reference's from
    tests/torch_optim_golden.npz: their compile takes ~15 s on a CPU),
    and `compose_preint` and `propagate_navstate` against the reference's
    under one `jax.jit`, on the reference's preintegrations: every field
    within 2e-5 of its largest entry (the covariance and the bias
    Jacobians too; measured ~1e-7 for the deltas, ~6e-6 for the bias
    Jacobians);
  * the pairwise reduction (which groups the products as the reference's
    scan does for its last element) against the plain per-sample
    recursion, `preintegrate_sequential`, within the same 2e-5;
  * `make_imu` and `make_trajectory` equal to the reference's, array for
    array, for every trajectory kind (arc, circuit, laps, spin), and one
    rendered circuit frame at half size in the closed room within 0.05
    grey levels, its pixel noise the reference's numpy draw.

One test per file: see tests/test_torch_fast.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from make_torch_goldens import OPTIM_GOLDEN, load
from torch_vi_problems import imu_problem
from viorb_tpu import imu as ref_imu
from viorb_tpu.imu.preintegration import compose_preint as ref_compose
from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
from viorb_tpu.io import synthetic as ref_synthetic
from viorb_tpu_torch.interop import camera_from_fields
from viorb_tpu_torch.geometry.so3 import exp_so3
from viorb_tpu_torch.imu import (
    ImuBatch,
    ImuNoise,
    NavState,
    PreintegratedImu,
    compose_preint,
    preintegrate,
    preintegrate_batch,
    propagate_navstate,
)
from viorb_tpu_torch.imu.preintegration import preintegrate_sequential
from viorb_tpu_torch.io import synthetic

torch.set_num_threads(1)

NOISE = ImuNoise()
REL = 2e-5  # port vs reference, per field, relative to the field's largest entry
Z3 = torch.zeros(3)


def _t(x):
    return torch.tensor(x, dtype=torch.float32)


def make_batch(gyro_fn, acc_fn, t0, t1, hz=200.0, cap=1024):
    ts = np.arange(t0, t1, 1.0 / hz)
    gyro = np.stack([gyro_fn(t) for t in ts])
    acc = np.stack([acc_fn(t) for t in ts])
    return ImuBatch.from_arrays(gyro, acc, ts, capacity=cap, device="cpu"), ts


def pre(batch, t0, t1, bg=Z3, ba=Z3):
    return preintegrate(batch, bg, ba, _t(t0), _t(t1), NOISE)


def _closed_form_cases():
    """tests/test_preintegration.py's cases on the port."""
    # static: dP = dV = 0, dR = I, dt accumulates
    batch, _ = make_batch(lambda t: np.zeros(3), lambda t: np.zeros(3), 0.0, 0.5)
    out = pre(batch, 0.0, 0.5)
    np.testing.assert_allclose(out.dt.numpy(), 0.5, atol=1e-4)
    np.testing.assert_allclose(out.delta_p.numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(out.delta_v.numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(out.delta_r.numpy(), np.eye(3), atol=1e-6)

    # constant body acceleration: dV = a T, dP = 1/2 a T^2
    a = np.array([1.0, -2.0, 0.5])
    batch, _ = make_batch(lambda t: np.zeros(3), lambda t: a, 0.0, 1.0, hz=400.0)
    out = pre(batch, 0.0, 1.0)
    np.testing.assert_allclose(out.dt.numpy(), 1.0, atol=1e-4)
    np.testing.assert_allclose(out.delta_v.numpy(), a, rtol=1e-3)
    np.testing.assert_allclose(out.delta_p.numpy(), 0.5 * a, rtol=5e-3)

    # constant rotation rate: dR = Exp(w T)
    w = np.array([0.3, -0.5, 0.8])
    batch, _ = make_batch(lambda t: w, lambda t: np.zeros(3), 0.0, 1.0, hz=800.0)
    out = pre(batch, 0.0, 1.0)
    np.testing.assert_allclose(out.delta_r.numpy(), exp_so3(_t(w)).numpy(), atol=2e-3)

    # the bias Jacobians: corrected deltas vs re-preintegration with shifted biases
    rng = np.random.default_rng(0)
    batch, _ = make_batch(
        lambda t: np.array([0.4 * np.sin(t * 5), 0.2, -0.3 * np.cos(t * 3)]),
        lambda t: np.array([1.0, 0.5 * np.sin(t * 4), -0.8]), 0.0, 0.5,
    )
    out0 = pre(batch, 0.0, 0.5)
    dbg = _t(rng.normal(size=3).astype(np.float32) * 1e-3)
    dba = _t(rng.normal(size=3).astype(np.float32) * 1e-3)
    out1 = pre(batch, 0.0, 0.5, dbg, dba)
    dp, dv, dr = out0.corrected_deltas(dbg, dba)
    np.testing.assert_allclose(dp.numpy(), out1.delta_p.numpy(), atol=5e-6)
    np.testing.assert_allclose(dv.numpy(), out1.delta_v.numpy(), atol=5e-6)
    np.testing.assert_allclose(dr.numpy(), out1.delta_r.numpy(), atol=5e-5)

    # covariance symmetric PSD, and it grows
    batch, _ = make_batch(lambda t: np.array([0.1, 0.2, -0.1]), lambda t: np.array([0.5, -0.3, 9.8]), 0.0, 1.0)
    cov = pre(batch, 0.0, 1.0).cov.numpy().astype(np.float64)
    np.testing.assert_allclose(cov, cov.T, atol=1e-10)
    eigs = np.linalg.eigvalsh(cov)
    assert eigs.min() > -1e-9 and eigs.max() > 0

    # padding rows change nothing
    small, _ = make_batch(lambda t: np.array([0.1, -0.2, 0.3]), lambda t: np.array([1.0, 0.0, -0.5]), 0.0, 0.3, cap=64)
    big, _ = make_batch(lambda t: np.array([0.1, -0.2, 0.3]), lambda t: np.array([1.0, 0.0, -0.5]), 0.0, 0.3, cap=512)
    o1, o2 = pre(small, 0.0, 0.3), pre(big, 0.0, 0.3)
    np.testing.assert_allclose(o1.delta_p.numpy(), o2.delta_p.numpy(), atol=1e-7)
    np.testing.assert_allclose(o1.cov.numpy(), o2.cov.numpy(), atol=1e-10)

    # the gap before the first sample is integrated with the first measurement
    a = np.array([2.0, 0.0, 0.0])
    batch, _ = make_batch(lambda t: np.zeros(3), lambda t: a, 0.1, 0.5, hz=400.0)
    out = pre(batch, 0.0, 0.5)
    np.testing.assert_allclose(out.dt.numpy(), 0.5, atol=1e-4)
    np.testing.assert_allclose(out.delta_v.numpy(), a * 0.5, rtol=1e-3)

    # free fall: propagation is pure gravity kinematics
    batch, _ = make_batch(lambda t: np.zeros(3), lambda t: np.zeros(3), 0.0, 1.0)
    ns = NavState.identity(device="cpu")._replace(v=_t([1.0, 0.0, 0.0]))
    out = propagate_navstate(ns, pre(batch, 0.0, 1.0))
    g = np.array([0.0, 0.0, -9.81])
    np.testing.assert_allclose(out.p.numpy(), np.array([1.0, 0, 0]) + 0.5 * g, rtol=1e-3)
    np.testing.assert_allclose(out.v.numpy(), np.array([1.0, 0, 0]) + g, rtol=1e-3)

    # the batched call matches single calls
    batches = [make_batch(lambda t, i=i: np.array([0.1 * (i + 1), 0.0, -0.05]),
                          lambda t, i=i: np.array([0.5, 0.1 * i, 9.8]), 0.0, 0.4, cap=128)[0] for i in range(4)]
    stacked = ImuBatch(*(torch.stack(x) for x in zip(*batches)))
    out = preintegrate_batch(stacked, Z3, Z3, torch.zeros(4), torch.full((4,), 0.4), NOISE)
    for i in range(4):
        single = pre(batches[i], 0.0, 0.4)
        np.testing.assert_allclose(out.delta_p[i].numpy(), single.delta_p.numpy(), atol=1e-6)
        np.testing.assert_allclose(out.delta_r[i].numpy(), single.delta_r.numpy(), atol=1e-6)

    # two calls on the same inputs agree bit for bit
    batch, _ = make_batch(lambda t: np.zeros(3), lambda t: np.array([1.0, 0, 0]), 0.0, 0.2, cap=64)
    assert torch.equal(pre(batch, 0.0, 0.2).delta_v, pre(batch, 0.0, 0.2).delta_v)


def _assert_close(got, want, what):
    for name, g, w in zip(got._fields, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= REL * scale, (what, name, np.abs(g - w).max() / scale)


def _matches_reference():
    """preintegrate / preintegrate_batch at capacity 256 against the
    reference's (tests/torch_optim_golden.npz); compose_preint and
    propagate_navstate against the reference's under one jax.jit, on the
    reference's preintegrations."""
    gold = load(OPTIM_GOLDEN)
    ip = imu_problem()
    for k, v in ip.items():
        np.testing.assert_array_equal(v, gold["imu_in_" + k])
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ip.items()}
    first = ImuBatch(t["gyro"][0], t["acc"][0], t["t"][0], t["mask"][0])
    rest = ImuBatch(t["gyro"][1:], t["acc"][1:], t["t"][1:], t["mask"][1:])
    one = preintegrate(first, t["bg"], t["ba"], t["t0"][0], t["t1"][0], NOISE)
    many = preintegrate_batch(rest, t["bg"], t["ba"], t["t0"][1:], t["t1"][1:], NOISE)
    ref_one = [gold["imu_one_" + f] for f in one._fields]
    ref_many = [gold["imu_many_" + f] for f in many._fields]
    _assert_close(one, ref_one, "preintegrate")
    _assert_close(many, ref_many, "preintegrate_batch")

    nav = {f: ip.get("nav_" + f, ip.get(f)) for f in ("p", "v", "r", "bg", "ba", "dbg", "dba")}

    @jax.jit
    def ref_fn(many, one, ns):
        many, one = ref_imu.PreintegratedImu(*many), ref_imu.PreintegratedImu(*one)
        comp = ref_compose(jax.tree.map(lambda x: x[:2], many), jax.tree.map(lambda x: x[1:3], many))
        return comp, ref_imu.propagate_navstate(ref_imu.NavState(**ns), one)

    ref_comp, ref_prop = ref_fn([jnp.asarray(x) for x in ref_many], [jnp.asarray(x) for x in ref_one],
                                {k: jnp.asarray(v) for k, v in nav.items()})
    p_many = PreintegratedImu(*(torch.from_numpy(x) for x in ref_many))
    comp = compose_preint(PreintegratedImu(*(x[:2] for x in p_many)), PreintegratedImu(*(x[1:3] for x in p_many)))
    prop = propagate_navstate(NavState(**{k: torch.from_numpy(v) for k, v in nav.items()}),
                              PreintegratedImu(*(torch.from_numpy(x) for x in ref_one)))
    _assert_close(comp, ref_comp, "compose_preint")
    _assert_close(prop, ref_prop, "propagate_navstate")

    # the pairwise reduction against the per-sample recursion
    seq = preintegrate_sequential(first, t["bg"], t["ba"], t["t0"][0], t["t1"][0], NOISE)
    _assert_close(one, [x.numpy() for x in seq], "sequential")


def _make_imu_matches_reference():
    for kw in (dict(), dict(bias_g=np.array([0.01, -0.02, 0.005]), bias_a=np.array([0.1, 0.0, -0.05]),
                            noise_g=1e-3, noise_a=1e-2, seed=3)):
        got = synthetic.make_imu(30, 0.1, **kw)
        want = ref_synthetic.make_imu(30, 0.1, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(synthetic.GRAVITY_W, ref_synthetic.GRAVITY_W)
    # every trajectory kind: the poses and the biased, noisy IMU of the loop tests
    kw = dict(noise_g=0.002, noise_a=0.03, bias_g=np.array([0.002, -0.001, 0.0015], np.float32),
              bias_a=np.array([0.03, -0.02, 0.01], np.float32))
    for kind in ("circuit", "laps", "spin"):
        for g, w in zip(synthetic.make_trajectory(100, 0.1, kind=kind), ref_synthetic.make_trajectory(100, 0.1, kind=kind)):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(synthetic.make_imu(30, 0.1, kind=kind, **kw), ref_synthetic.make_imu(30, 0.1, kind=kind, **kw)):
            np.testing.assert_array_equal(g, w)
    # one circuit frame at half size in the closed room, the pixel noise on
    # top: f32 ray-plane arithmetic in another order, <= 0.05 grey levels
    # (tests/test_torch_tracking.py); the noise is the same numpy draw
    ref_cam = RefCamera(fx=225.0, fy=225.0, cx=188.0, cy=120.0, width=376, height=240)
    r_wc, c_w = synthetic.make_trajectory(100, 0.1, kind="circuit")
    rooms = synthetic.default_room(0, closed=True)
    ref_rooms = ref_synthetic.default_room(0, closed=True)
    assert len(rooms) == len(ref_rooms) == 6
    for p, q in zip(rooms, ref_rooms):
        np.testing.assert_array_equal(p.texture, q.texture)
    img = synthetic.render_frame(camera_from_fields(ref_cam), r_wc[40], c_w[40], synthetic.stack_planes(rooms, device="cpu"))
    np.testing.assert_allclose(img.numpy(), ref_synthetic.render_frame(ref_cam, r_wc[40], c_w[40], ref_rooms),
                               rtol=0, atol=0.05)
    seq = synthetic.make_sequence(2, cam=camera_from_fields(ref_cam), dt=0.1, kind="circuit", noise_std=4.0,
                                  device="cpu")
    clean = synthetic.render_frame(seq.cam, seq.r_wc[1], seq.c_w[1], synthetic.stack_planes(rooms, device="cpu"))
    noise = np.random.default_rng(991).normal(0.0, 4.0, (2, 240, 376)).astype(np.float32)[1]
    np.testing.assert_array_equal(seq.images[1].numpy(), np.clip(clean.numpy() + noise, 0.0, 255.0))


def test_imu_matches_reference():
    _closed_form_cases()
    _make_imu_matches_reference()
    _matches_reference()
