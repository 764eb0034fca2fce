"""The port's lock-step MonoSlam on the CPU against the JAX reference's
outcome on the same frames.

The frames are the port's renderer's, at half size (the 376x240 camera of
tests/torch_port_scene.py): 20 frames of the arc at dt=0.2 s, 300
features, a keyframe at least every 5 frames, 1024 local-map slots, 512 BA
landmarks. The run covers two-view initialization, steady tracking through
the pipeline core and six mapping jobs (triangulation, fusion, statistics,
local BA, culling). The reference's outcome on the same frames is a
committed golden (tests/make_torch_goldens.py says why and how it is made),
so this test compiles nothing in JAX.

The port draws its RANSAC hypotheses from a torch.Generator, the reference
from jax.random: the two are held to each other by outcome, with these
tolerances, the same as chip_smoke.py's at full width:
  * the same initialization frame and the same state on every frame;
  * keyframe count within 1 of the reference's on every frame (a
    ratio-triggered keyframe may come a frame earlier or later);
  * map points at the end within 15 % of the reference's;
  * the two trajectories within 3 % of the reference trajectory's extent
    (RMS after Sim3 alignment; a mono map has its own scale, so the
    tolerance is relative: ~4.5 cm on the ~1.5 m arc);
  * ATE to the ground truth at most 1.5x the reference's.
The last two leave room for the RANSAC draw: at full width the reference's
own runs with seeds 0-4 (tests/torch_mono_golden.npz) lie 0.89-2.16 % of
the extent apart and 1.10-1.33x apart in ATE where they initialized at the
same frame (tests/make_torch_goldens.py prints it). Here the two agree to
~3e-5 of the extent.
Then a map checkpoint of the run is read by the reference's `load_map`, and
a fresh port MonoSlam loads it, relocalizes a frame into it by PnP, tracks
the next one, and recovers a third through the fallback chain after its
motion model was thrown off by 0.3 rad, each within 5 % of the extent of
the run's own pose of that frame (1-3 % today). Last, map hygiene: the
spanning tree, consistent bindings after triangulation on its own, and
tests/test_map_hygiene.py's duplicate-point case through the port's fusion.

One test per file: see tests/test_torch_fast.py."""

import numpy as np
import pytest
import torch

from make_torch_goldens import CONFIGS, SLAM_KEYS, STATES, load
from viorb_tpu.mapping.serialize import load_map as ref_load_map
from viorb_tpu_torch.bow import default_vocabulary
from viorb_tpu_torch.eval.ate import associate, ate_rmse, umeyama_alignment
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.io import synthetic
from viorb_tpu_torch.slam.mono import MonoSlam

torch.set_num_threads(1)

KF_TOL = 1
POINT_SHARE_TOL = 0.15
TRAJ_RMS_SHARE = 0.02  # of the reference trajectory's extent
RELOC_SHARE = 0.05
ATE_FACTOR = 1.25
RELOC_FRAME = 12


def _extent(traj):
    """Largest distance of a (T,8) TUM trajectory's positions from its first."""
    return float(np.linalg.norm(traj[:, 1:4] - traj[0, 1:4], axis=1).max())


def _sim3_rms(a, b):
    """RMS distance between two (T,8) TUM trajectories after aligning `a`
    onto `b` with a Sim3 (timestamps associated)."""
    ia, ib = associate(a[:, 0], b[:, 0])
    x, y = a[ia, 1:4], b[ib, 1:4]
    s, R, t = umeyama_alignment(x, y, with_scale=True)
    return float(np.sqrt(((y - (s * x @ R.T + t)) ** 2).sum(1).mean())), len(ia)


def _run(seq, cfg):
    slam = MonoSlam(seq.cam, device="cpu", **{k: cfg[k] for k in SLAM_KEYS})
    rows = []
    for image, ts in zip(seq.images, seq.timestamps):
        info = slam.process_frame(image, float(ts))
        rows.append((STATES.index(info["state"]), info["n_tracked"], info["n_kfs"], info["n_points"]))
    return slam, np.asarray(rows)


def _entry_points_take_a_vocabulary(cam):
    # a vocabulary builds the loop closer, wired to the seam fusion and the
    # post-loop GBA; on an empty map the GBA has nothing to solve
    slam = MonoSlam(cam, device="cpu", vocabulary=default_vocabulary(), enable_loop_closing=True)
    assert slam.loop_closer is not None and slam.enable_loop_closing
    assert slam.loop_closer.gba_fn == slam._post_loop_gba and slam.loop_closer.fuse_fn == slam._fuse_points_into_kf
    slam._post_loop_gba(0, {})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MonoSlam(cam)


def _matches_golden(slam, rows, seq, gold):
    state, n_kfs, n_points = rows[:, 0], rows[:, 2], rows[:, 3]
    init = int(np.argmax(state == STATES.index("OK")))
    assert init == int(gold["half_init_frame"]), (init, int(gold["half_init_frame"]))
    np.testing.assert_array_equal(state, gold["half_state"])
    assert np.abs(n_kfs - gold["half_n_kfs"]).max() <= KF_TOL, (n_kfs, gold["half_n_kfs"])
    share = abs(int(n_points[-1]) - int(gold["half_n_points"][-1])) / int(gold["half_n_points"][-1])
    assert share <= POINT_SHARE_TOL, (n_points, gold["half_n_points"])
    # one mapping job per keyframe after the two of the initialization
    assert len(slam.job_times) >= 2 and len(slam.job_times) == slam.map._next_kf - 2, len(slam.job_times)
    traj = slam.trajectory_tum()
    rms, n = _sim3_rms(traj, gold["half_traj"])
    assert n == len(gold["half_traj"]) and rms <= TRAJ_RMS_SHARE * _extent(gold["half_traj"]), (n, rms)
    ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)
    assert ate <= ATE_FACTOR * float(gold["half_ate"]), (ate, float(gold["half_ate"]))


def _map_is_consistent(m):
    """Every feature bound to a point is one of the point's observations,
    and the point is alive."""
    for k, kf in m.keyframes.items():
        for f in np.nonzero(kf.point_idx >= 0)[0]:
            p = kf.point_idx[f]
            assert m.pt_active[p] and ((m.obs_kf[p] == k) & (m.obs_feat[p] == f)).any(), (k, f, p)


def _map_hygiene(slam):
    """The spanning tree (every keyframe but the first has an older, live
    parent), the map's bindings, and triangulation on its own (the job's
    pairs again: only features still free may bind) leave it consistent."""
    m = slam.map
    ids = sorted(m.keyframes)
    assert [k for k in ids if m.keyframes[k].parent_kf < 0] == [ids[0]]
    assert all(m.keyframes[k].parent_kf in m.keyframes and m.keyframes[k].parent_kf < k for k in ids[1:])
    _map_is_consistent(m)
    cov = m.covisibility_weights(slam.last_kf_id)
    slam._triangulate_batch(slam.last_kf_id, sorted(cov, key=cov.get, reverse=True)[:3])
    _map_is_consistent(m)


def _fusion_merges_duplicates(cam):
    """tests/test_map_hygiene.py's revisit case through the port: two
    keyframes see the same 40 points through duplicate map entries, and
    SearchInNeighbors merges them."""
    from viorb_tpu_torch.mapping.map import KeyFrameData

    rng = np.random.default_rng(1)
    slam = MonoSlam(cam, n_features=200, device="cpu")
    n = 40
    pts3d = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.7, 0.7, n), rng.uniform(4, 8, n)], 1).astype(np.float32)
    desc = rng.integers(0, 2, (n, 256)).astype(np.uint8)
    ids = []
    for x, ts in ((0.0, 0.0), (0.2, 1.0)):
        pc = pts3d + np.array([x, 0, 0], np.float32)
        xy = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx, cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], 1)
        ids.append(slam.map.add_keyframe(KeyFrameData(
            kf_id=-1, timestamp=ts, r_cw=np.eye(3, dtype=np.float32), t_cw=np.array([x, 0, 0], np.float32),
            xy=xy.astype(np.float32), level=np.zeros(n, np.int32), angle=np.zeros(n, np.float32),
            desc01=desc, valid=np.ones(n, bool), point_idx=np.full(n, -1, np.int32),
        )))
    for k in ids:
        for f in range(n):
            slam.map.add_point(pts3d[f], desc[f], k, f)
    assert len(slam.map.active_point_ids()) == 2 * n
    slam._search_in_neighbors(ids[1], [ids[0]])
    pts = slam.map.active_point_ids()
    assert len(pts) <= 1.2 * n, len(pts)
    both = sum(1 for p in pts if set(ids) <= set(slam.map.obs_kf[p][slam.map.obs_kf[p] >= 0].tolist()))
    assert both > 0.8 * len(pts), (both, len(pts))
    _map_is_consistent(slam.map)


def _checkpoint_relocalizes(slam, seq, cfg, tmp_path):
    path = str(tmp_path / "map.npz")
    slam.save_map(path)
    ref = ref_load_map(path)
    assert sorted(ref.keyframes) == sorted(slam.map.keyframes)
    np.testing.assert_array_equal(ref.pt_active, slam.map.pt_active)
    fresh = MonoSlam(seq.cam, device="cpu", **{k: cfg[k] for k in SLAM_KEYS})
    fresh.load_map(path, localization_only=True)
    assert fresh.state == "LOST"
    n_points = len(fresh.map.active_point_ids())
    run = slam.trajectory_tum()
    for i in (RELOC_FRAME, RELOC_FRAME + 1):
        info = fresh.process_frame(seq.images[i], float(seq.timestamps[i]))
        assert info["state"] == "OK" and info["n_tracked"] >= 15, (i, info)
        r_wc = fresh.last_frame.r_cw.T
        c = -r_wc @ fresh.last_frame.t_cw
        # the map's frame is the run's: compare with its pose of that frame
        row = run[np.argmin(np.abs(run[:, 0] - seq.timestamps[i]))]
        assert np.linalg.norm(c - row[1:4]) <= RELOC_SHARE * _extent(run), (i, c, row)
    # a motion model gone wrong (0.3 rad of yaw, ~70 px): the core finds too
    # few matches, and the fallback chain recovers the frame through the
    # reference keyframe
    yaw = np.float32(0.3)
    fresh.velocity = (np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]],
                               np.float32), np.zeros(3, np.float32))
    i = RELOC_FRAME + 2
    info = fresh.process_frame(seq.images[i], float(seq.timestamps[i]))
    assert info["state"] == "OK" and info["n_tracked"] >= 15, info
    c = -fresh.last_frame.r_cw.T @ fresh.last_frame.t_cw
    row = run[np.argmin(np.abs(run[:, 0] - seq.timestamps[i]))]
    assert np.linalg.norm(c - row[1:4]) <= RELOC_SHARE * _extent(run), (i, c, row)
    # localization only: the map is frozen
    assert len(fresh.map.active_point_ids()) == n_points and len(fresh.map.kf_ids()) == len(slam.map.kf_ids())


def test_mono_slam_matches_reference(tmp_path):
    cfg = CONFIGS["half"]
    gold = load()
    cam = PinholeCamera(fx=cfg["fx"], fy=cfg["fx"], cx=cfg["cx"], cy=cfg["cy"], width=cfg["width"],
                        height=cfg["height"])
    _entry_points_take_a_vocabulary(cam)
    seq = synthetic.make_sequence(cfg["n_frames"], cam=cam, dt=cfg["dt"], device="cpu")
    slam, rows = _run(seq, cfg)
    _matches_golden(slam, rows, seq, gold)
    _checkpoint_relocalizes(slam, seq, cfg, tmp_path)
    _map_hygiene(slam)
    _fusion_merges_duplicates(cam)
