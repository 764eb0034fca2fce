"""An async MonoViSlam keeps its tracker and its mapping worker in one map:
the tracker waits for the worker until VI init has settled, and the
keyframes it makes while the worker solves follow the solve.

The worker's VI init and VI BAs take their snapshot, solve outside the map
lock (an eager global VI BA takes seconds), and write back; meanwhile the
tracker keeps inserting keyframes. The reference writes back the snapshot's
keyframes only: the VI init leaves the new ones without a NavState (so the
tracker's re-base finds none on the newest keyframe and keeps no NavState
at all), and a VI BA leaves them, and the tracker that re-bases on the
newest of them, in the unsolved map while the solved window moves. On the
card, un-paced async VI runs made keyframes while 1.4-4.5 s VI BAs ran
(probes/async_vi_runs.py). And the closed-form VI init solves on the
keyframe chain's camera centres: keyframes made from frames tracked ahead
of their predecessors' jobs gave it as little as half the true scale, and
un-paced runs on the card ended 12-35 % short of the true size. The port:
  * until VI init and its refinement window have passed,
    `process_frame_vi` holds a frame until the worker is idle (a job held
    on an Event holds it back; after the window it does not): beside the
    window's closed-form refinements and eager VI BAs an async tracker that
    ran on lost the map on the card;
  * VI init (and its refinement): a chain keyframe made during the solve
    gets a NavState at its rescaled pose, with its own velocity rescaled or,
    without one, the velocity from its chain predecessor, and the tracker's
    drain re-derives `nav_cur` from the newest;
  * a VI BA: a keyframe made during the solve (the solver replaced by one
    that moves the window's newest keyframe and makes a keyframe as the
    tracker would) keeps its pose, NavState position, rotation and
    velocity relative to the newest solved keyframe, and the drain re-bases
    the tracker on it in the solved map.
The state is tests/test_torch_async_vi.py's (from the VI golden). No
reference pipeline runs here.

One test per file: see tests/test_torch_fast.py."""

import threading

import numpy as np
import torch

from make_torch_goldens import VI_CONFIGS, VI_GOLDEN, VI_KEYS, load
from test_torch_async_vi import G_NEW, SCALE, _build, _init_result, _moved, _tiny_problem
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.io.synthetic import make_imu
from viorb_tpu_torch.mapping.map import MAX_OBS_PER_POINT, KeyFrameData
from viorb_tpu_torch.slam import mono_vi
from viorb_tpu_torch.slam.mono import FrameRecord
from viorb_tpu_torch.slam.mono_vi import MonoViSlam

torch.set_num_threads(1)


def _relative(ref, ns):
    """ns's position, rotation and velocity in ref's body frame."""
    r_t = np.asarray(ref.r).T
    return r_t @ (np.asarray(ns.p) - np.asarray(ref.p)), r_t @ np.asarray(ns.r), r_t @ np.asarray(ns.v)


def _waits_for_the_worker(cam, cfg):
    """Until VI init and its refinement window have passed a frame waits
    for a held job; after them it does not."""
    slam = MonoViSlam(cam, device="cpu", async_mapping=True, **{k: cfg[k] for k in VI_KEYS})
    release = threading.Event()
    slam._mapping_job = lambda kf_id: release.wait(timeout=60)
    image = np.zeros((cfg["height"], cfg["width"]), np.float32)

    def frame_held(ts):
        done = []
        frame = threading.Thread(target=lambda: done.append(slam.process_frame_vi(image, ts, [])))
        frame.start()
        frame.join(timeout=1.0)
        return frame, done

    try:
        slam._ensure_threads(image)
        for ts, (vi_ready, window) in enumerate(((False, 12.0), (True, 12.0), (True, 0.0))):
            slam.vi_ready, slam.init_refine_window = vi_ready, window
            release.clear()
            slam._mapping_queue.put(0)
            frame, done = frame_held(float(ts))
            if window:  # the frame waits for the held job
                assert frame.is_alive() and not done, (vi_ready, window)
            release.set()
            frame.join(timeout=60)
            assert not frame.is_alive() and done
            slam._mapping_queue.join()
    finally:
        release.set()
        slam.shutdown()


def test_async_vi_tracker_and_worker_stay_in_one_map():
    cfg = VI_CONFIGS["vi_half"]
    cam = PinholeCamera(fx=cfg["fx"], fy=cfg["fx"], cx=cfg["cx"], cy=cfg["cy"], width=cfg["width"],
                        height=cfg["height"])
    _waits_for_the_worker(cam, cfg)
    traj = load(VI_GOLDEN)["vi_half_traj"]
    slam = MonoViSlam(cam, device="cpu", async_mapping=True, **{k: cfg[k] for k in VI_KEYS})
    chain = _build(slam, KeyFrameData, FrameRecord, traj, make_imu(cfg["n_frames"], cfg["dt"], hz=200.0), cfg)

    # a VI init (or its refinement) solved on the first two chain keyframes;
    # the third and fourth came during the solve, the third with a NavState
    # of the scale before (as the tracker gives one after VI init)
    kf2, kf3 = (slam.map.keyframes[k] for k in chain[2:])
    v2 = np.array([0.2, -0.1, 0.05], np.float32)
    kf2.nav["state"] = slam._nav_host(kf2.r_cw, kf2.t_cw, v=v2)
    slam._apply_init_result(_init_result(traj, 2), chain[:2])
    slam.vi_ready = True
    for kf in (kf2, kf3):
        ns = kf.nav["state"]
        np.testing.assert_allclose(ns.p, kf.center(), atol=1e-6)  # the body is the camera here
        np.testing.assert_allclose(np.asarray(ns.r), kf.r_cw.T, atol=1e-6)
    np.testing.assert_allclose(kf2.nav["state"].v, v2 * SCALE, atol=1e-6)
    np.testing.assert_allclose(kf3.nav["state"].v, (kf3.nav["state"].p - kf2.nav["state"].p)
                               / (kf3.timestamp - kf2.timestamp), atol=1e-5)
    slam._drain_tracker_rebase()
    assert slam._nav_cur_host is not None and slam.rebases == 1

    # a VI BA over the chain, and a keyframe the tracker makes during its solve
    made = []

    def solve(state, obs, cam_, ext, chain_, gravity, fixed, iters1=15, iters2=10):
        src = slam.map.keyframes[chain[-1]]
        kf = KeyFrameData(kf_id=-1, timestamp=src.timestamp + 0.2, r_cw=src.r_cw.copy(),
                          t_cw=(src.t_cw + np.array([0.05, 0.0, -0.02], np.float32)), xy=src.xy, level=src.level,
                          angle=src.angle, desc01=src.desc01, valid=src.valid, point_idx=src.point_idx.copy())
        k = slam.map.add_keyframe(kf)
        kf.nav = dict(src.nav, state=slam._nav_host(kf.r_cw, kf.t_cw, v=np.array([0.3, -0.1, 0.05])))
        kf.prev_kf, src.next_kf = chain[-1], k
        slam.kf_chain.append(k)
        made.append((k, _relative(src.nav["state"], kf.nav["state"])))
        p, v, r = (torch.from_numpy(x) for x in _moved(state.nav, len(chain) - 1))
        return state._replace(nav=state.nav._replace(p=p, v=v, r=r)), torch.from_numpy(G_NEW), obs

    slam.map.build_ba_problem = _tiny_problem(slam.max_ba_landmarks, MAX_OBS_PER_POINT)
    ref_before = slam.map.keyframes[chain[-1]].nav["state"]
    solver = mono_vi.vi_ba_gw_two_phase
    mono_vi.vi_ba_gw_two_phase = solve
    try:
        slam._vi_local_ba(chain[-1], window_size=len(chain), optimize_gravity=True, iters=(10, 8))
    finally:
        mono_vi.vi_ba_gw_two_phase = solver
    (k, rel_before), = made
    ref, new = slam.map.keyframes[chain[-1]], slam.map.keyframes[k]
    assert np.abs(np.asarray(ref.nav["state"].p) - np.asarray(ref_before.p)).max() > 0.01  # the solve moved it
    for a, b in zip(_relative(ref.nav["state"], new.nav["state"]), rel_before):
        np.testing.assert_allclose(a, b, atol=2e-5)
    np.testing.assert_allclose(new.r_cw, np.asarray(new.nav["state"].r).T, atol=1e-6)
    np.testing.assert_allclose(new.center(), new.nav["state"].p, atol=1e-5)
    # the tracker re-bases on the carried keyframe, in the solved map (its
    # last frame is that keyframe's frame: nothing to propagate)
    slam.last_frame.timestamp = new.timestamp
    slam._drain_tracker_rebase()
    assert slam.rebases == 2
    np.testing.assert_array_equal(slam.gravity, G_NEW)
    for a, b in zip(slam._nav_cur_host, new.nav["state"]):
        np.testing.assert_array_equal(a, b)
