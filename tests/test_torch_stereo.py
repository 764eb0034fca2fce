"""The port's lock-step StereoSlam on the CPU against the JAX reference's
run on the same frames: the port's rendered 0.11 m stereo pair at half size
(tests/make_torch_goldens.py's STEREO_CONFIG: the 376x240 camera, the
first 14 frames of the arc at dt=0.2 s, 300 features, a keyframe at least
every 5 frames), the reference's outcome a committed golden
(tests/torch_stereo_golden.npz), so this test compiles nothing in JAX. The
run covers the single-frame stereo initialization, the left-only steady
state through the pipeline core, the right image matched for each new
keyframe (extraction, `match_stereo`, the sub-pixel refinement), the close
points and the mapping jobs with the stereo local BA. Tolerances:
  * the same state on every frame; `n_stereo` (the frame's features with a
    stereo match) within 2 % of the reference's on every frame;
  * keyframes within 1 and points within 5 % of the reference's on every
    frame;
  * every trajectory position within 5 mm of the reference's (both metric,
    from the same origin: no alignment), the metric ATE to the ground
    truth at most 1.1x the reference's.
Today the per-frame counts are equal and the positions 3e-5 m apart. Then:
a keyframe built from arrays (`interop.frame_from_numpy`, with right u and
depth) gets a close point exactly where its features' depth is within
(0.1 m, 35 baselines), at the back-projected position (1e-5 m); the entry
point defaults to the card and raises without one, and `streaming=True`
means async mapping, as in the reference, whose stereo entry never takes
the streaming dispatch (tests/test_torch_async_stereo.py runs the threaded
modes).

One test per file: see tests/test_torch_fast.py."""

import numpy as np
import pytest
import torch

from make_torch_goldens import SLAM_KEYS, STATES, STEREO_CONFIG, STEREO_GOLDEN, load, stereo_inputs
from viorb_tpu_torch.eval.ate import ate_rmse
from viorb_tpu_torch.interop import frame_from_numpy
from viorb_tpu_torch.slam.stereo import StereoSlam, add_close_points

torch.set_num_threads(1)

STEREO_SHARE = 0.02
KF_TOL = 1
POINT_SHARE = 0.05
POS_TOL_M = 0.005
ATE_FACTOR = 1.1
FIELDS = ("state", "n_tracked", "n_kfs", "n_points", "n_stereo")


def held_to_golden(name, rows, traj, seq, gold):
    """The tolerances of the module docstring (tests/test_torch_rgbd.py
    shares them)."""
    rows = dict(zip(FIELDS, np.asarray(rows).T))
    want = {f: gold[f"{name}_{f}"] for f in FIELDS}
    np.testing.assert_array_equal(rows["state"], want["state"])
    assert (np.abs(rows["n_stereo"] - want["n_stereo"]) <= STEREO_SHARE * want["n_stereo"]).all(), rows["n_stereo"]
    assert np.abs(rows["n_kfs"] - want["n_kfs"]).max() <= KF_TOL, (rows["n_kfs"], want["n_kfs"])
    assert (np.abs(rows["n_points"] - want["n_points"]) <= POINT_SHARE * want["n_points"]).all(), rows["n_points"]
    gt = gold[f"{name}_traj"]
    np.testing.assert_array_equal(traj[:, 0], gt[:, 0])
    d = np.linalg.norm(traj[:, 1:4] - gt[:, 1:4], axis=1).max()
    ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=False)
    print(f"{name}: positions within {d:.2e} m of the reference's, metric ATE {ate:.4f} m "
          f"(the reference's {float(gold[name + '_ate']):.4f} m)")
    assert d <= POS_TOL_M and ate <= ATE_FACTOR * float(gold[f"{name}_ate"]), (d, ate)


def _close_points_from_arrays(cam, baseline):
    rng = np.random.default_rng(3)
    n = 24
    xy = rng.uniform([0, 0], [cam.width, cam.height], (n, 2))
    depth = rng.uniform(0.5, 6.0, n)
    depth[:4] = -1.0  # no stereo match
    slam = StereoSlam(cam, baseline=baseline, device="cpu")
    r_cw, t_cw = np.eye(3), np.array([0.1, -0.2, 0.3])
    fr = frame_from_numpy(0.0, xy, np.zeros(n), np.zeros(n), rng.integers(0, 2, (n, 256)), np.ones(n, bool),
                          r_cw=r_cw, t_cw=t_cw, ur=np.where(depth > 0, xy[:, 0] - slam.bf / depth, -1.0),
                          depth=depth, device="cpu")
    kf_id = slam.map.add_keyframe(slam._kf_from_frame(fr))
    add_close_points(slam, fr, kf_id, fr.depth, slam.depth_th)
    bound = slam.map.keyframes[kf_id].point_idx
    close = (depth > 0.1) & (depth < slam.depth_th)
    np.testing.assert_array_equal(bound >= 0, close)
    xn = np.stack([(xy[:, 0] - cam.cx) / cam.fx, (xy[:, 1] - cam.cy) / cam.fy, np.ones(n)], 1)
    want = (xn * depth[:, None] - t_cw) @ r_cw
    np.testing.assert_allclose(slam.map.pt_xyz[bound[close]], want[close], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(slam.map.keyframes[kf_id].ur, fr.ur)


def test_stereo_slam_matches_reference():
    c = STEREO_CONFIG
    cam, seq, right = stereo_inputs("stereo")
    slam = StereoSlam(cam, baseline=c["baseline"], device="cpu", **{k: c[k] for k in SLAM_KEYS})
    assert slam.bf == cam.fx * c["baseline"] and slam.loop_fix_scale
    rows = []
    for img_l, img_r, ts in zip(seq.images, right, seq.timestamps):
        info = slam.process_frame_stereo(img_l, img_r, float(ts))
        rows.append([STATES.index(info["state"]), info["n_tracked"], info["n_kfs"], info["n_points"], info["n_stereo"]])
    held_to_golden("stereo", rows, slam.trajectory_tum(), seq, load(STEREO_GOLDEN))
    # one right extraction for the initialization and each keyframe after it;
    # every local BA the stereo one (eager on the CPU)
    assert slam.right_extractions == rows[-1][2], (slam.right_extractions, rows[-1][2])
    assert set(slam.ba_eager_calls) == {"stereo_local"} and not slam.ba_replays, slam.ba_eager_calls

    _close_points_from_arrays(cam, c["baseline"])
    for kw in ({"streaming": True}, {"async_mapping": True}):
        threaded = StereoSlam(cam, baseline=c["baseline"], device="cpu", **kw)
        assert threaded.async_mapping and not threaded.streaming and threaded._worker is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            StereoSlam(cam, baseline=c["baseline"])
