"""The port's VI initialization (viorb_tpu_torch/slam/vi_init.py) against
the JAX reference's `try_vi_init` on tests/test_vi_init.py's clean and
biased keyframe chains (12 keyframes at scale 2.5, and 16 with gyro and
accelerometer biases at scale 1.8).

Per chain: success equal; scale within 1e-4 relative, gravity within 1e-3
m/s^2, gyro bias within 1e-5 rad/s, accel bias within 1e-3 m/s^2 and the
keyframe velocities within 1e-3 m/s of the reference's (measured: 2e-6,
6e-6, 1e-7, 6e-6, 2e-6); and the reference test's own bounds against the
truth. The reference's results come from tests/torch_optim_golden.npz (set
`optim` of tests/make_torch_goldens.py: its live run compiles for 8-15 s
on a CPU). Also the port's `eval/gravity.py` against the reference's.

One test per file: see tests/test_torch_fast.py."""

import numpy as np
import torch

from make_torch_goldens import INIT_FIXTURES, OPTIM_GOLDEN, load
from test_vi_init import build_chain
from viorb_tpu.eval import gravity as ref_gravity
from viorb_tpu_torch.eval import gravity
from viorb_tpu_torch.imu import ImuBatch
from viorb_tpu_torch.io.synthetic import GRAVITY_W
from viorb_tpu_torch.slam.vi_init import try_vi_init

torch.set_num_threads(1)

TOL = dict(gravity_w=1e-3, bias_g=1e-5, bias_a=1e-3, velocities=1e-3)


def _gravity_eval_matches_reference():
    rng = np.random.default_rng(5)
    for _ in range(4):
        q = rng.normal(size=4)
        np.testing.assert_allclose(gravity.quat_to_rot(q), ref_gravity.quat_to_rot(q), rtol=0, atol=1e-12)
        a, b = rng.normal(size=3), rng.normal(size=3)
        assert gravity.gravity_angle_deg(a, b) == ref_gravity.gravity_angle_deg(a, b)


def test_vi_init_matches_reference():
    _gravity_eval_matches_reference()
    gold = load(OPTIM_GOLDEN)
    for tag, kw in INIT_FIXTURES.items():
        p_c, r_wc, ts, batches, _ = build_chain(**kw)
        res = try_vi_init(p_c, r_wc, ts, ImuBatch(*(torch.from_numpy(np.array(x)) for x in batches)))
        assert res is not None and res.success == bool(gold[f"init_{tag}_success"]) and res.success, tag
        want = float(gold[f"init_{tag}_scale"])
        assert abs(res.scale - want) <= 1e-4 * want, (tag, res.scale, want)
        for f, tol in TOL.items():
            err = np.abs(np.asarray(getattr(res, f)) - gold[f"init_{tag}_{f}"]).max()
            assert err <= tol, (tag, f, err)
        # tests/test_vi_init.py's bounds against the truth
        assert abs(res.scale - kw["scale"]) / kw["scale"] < (0.02 if tag == "clean" else 0.05), (tag, res.scale)
        np.testing.assert_allclose(res.gravity_w, GRAVITY_W, atol=0.15 if tag == "clean" else 0.3)
        np.testing.assert_allclose(res.bias_g, kw.get("bias_g", 0.0), atol=5e-3)
        np.testing.assert_allclose(res.bias_a, kw.get("bias_a", 0.0), atol=0.15 if tag == "clean" else 0.3)
