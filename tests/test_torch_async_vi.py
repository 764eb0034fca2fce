"""The port's async MonoViSlam against the JAX reference's own methods, on
the same state: the rebase epoch and the two async mapping decisions.

The state is built from the VI golden (tests/torch_vi_golden.npz, the
reference's run of "vi_half"): four chain keyframes at the poses its
trajectory took at 4.2-5.4 s, the arc's 200 Hz IMU between them and up to
the current frame, the last frame at 5.8 s. No reference pipeline runs:
each package's MonoViSlam gets the same keyframes, NavStates, IMU samples
and last frame, and the test calls the same method on both.
  * the 1.5 s keyframe gap: `_need_new_keyframe` with 0-3 jobs in the
    mapping queue and gaps of 0.4-1.6 s, decisions equal;
  * the BA skip: `_mapping_ba` with a newer keyframe queued or not, after
    0, 1 and 2 skips in a row and at a gravity-vertex GBA mark (the VI BA
    itself recorded, not run), decisions equal;
  * a pending VI init rescale: `_apply_init_result` (scale 1.25) leaves the
    tracker alone and bumps the epoch; then `_drain_tracker_rebase`:
    `nav_cur` (the newest keyframe's NavState propagated through the
    since-keyframe IMU samples to the last frame's time, on each package's
    own preintegration) within 2e-5 (position, m), 2e-5 (velocity, m/s)
    and 2e-6 (rotation) of the reference's, the last frame's pose within
    the same, biases and gravity taken from the pending values, equal. The
    port's drain is also given the current frame's samples, as its frame
    entry appends them first, and leaves them to the VI core: the
    reference's integrates them as well (its preintegration integrates
    every sample but the last past the interval's end), and the core does
    again, so its prediction runs a frame ahead;
  * a VI BA that moved the newest keyframe: the port's `_vi_local_ba`
    over the chain with a free gravity direction, its solver replaced by one
    that moves the newest keyframe's NavState and tilts gravity; the
    write-back leaves gravity pending and bumps the epoch. The reference
    gets what its write-back (viorb_tpu/slam/mono_vi.py:1225-1249) writes
    for that solve: the keyframe's NavState and pose, gravity pending, the
    epoch bumped (its solve is not run: its eager, op-by-op assembly
    compiles for seconds). The drains then give `nav_cur` and the last
    frame's pose as the reference's, within the same tolerances.
After VI init only the drain re-poses the last frame: MonoSlam's vision
re-base (`_rebase_last_frame`) is a no-op then, and it still re-bases a
vision frame before VI init.

One test per file: see tests/test_torch_fast.py."""

import types

import numpy as np
import torch

from make_torch_goldens import VI_CONFIGS, VI_GOLDEN, VI_KEYS, imu_between, load
from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
from viorb_tpu.mapping.map import KeyFrameData as RefKeyFrame
from viorb_tpu.slam import mono_vi as ref_mono_vi
from viorb_tpu.slam.mono import FrameRecord as RefFrame
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.imu.navstate import NavState
from viorb_tpu_torch.io.synthetic import make_imu
from viorb_tpu_torch.mapping.map import MAX_OBS_PER_POINT, KeyFrameData
from viorb_tpu_torch.slam import mono_vi
from viorb_tpu_torch.slam.mono import FrameRecord
from viorb_tpu_torch.slam.mono_vi import MonoViSlam

torch.set_num_threads(1)

CHAIN_ROWS = (20, 22, 24, 26)  # golden trajectory rows (t = 4.2 ... 5.4 s)
FRAME_ROW = 28  # the last frame (t = 5.8 s); the current frame comes 0.2 s later
SCALE = 1.25
P_TOL, V_TOL, R_TOL = 2e-5, 2e-5, 2e-6
MOVE_P = np.array([0.03, -0.02, 0.01], np.float32)
MOVE_V = np.array([0.02, 0.01, -0.03], np.float32)
G_NEW = np.array([0.05, -0.2, -9.808], np.float32)


def _pose(row):
    """(r_cw, t_cw) of a TUM row (t, c_w, q_wc as x y z w)."""
    x, y, z, w = row[4:8]
    r_wc = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]], np.float32)
    return r_wc.T, (-r_wc.T @ row[1:4]).astype(np.float32)


def _build(slam, kf_class, frame_class, traj, imu, cfg):
    """The shared state: the chain keyframes at 1/SCALE of the golden's
    poses (VI init's rescale restores them), their IMU segments, the
    since-keyframe samples up to the current frame, the last frame."""
    chain = []
    for n, row in enumerate(CHAIN_ROWS):
        r_cw, t_cw = _pose(traj[row])
        kf = kf_class(kf_id=-1, timestamp=float(traj[row, 0]), r_cw=r_cw, t_cw=(t_cw / SCALE).astype(np.float32),
                      xy=np.zeros((0, 2), np.float32), level=np.zeros(0, np.int32), angle=np.zeros(0, np.float32),
                      desc01=np.zeros((0, 256), np.uint8), valid=np.zeros(0, bool),
                      point_idx=np.zeros(0, np.int32))
        k = slam.map.add_keyframe(kf)
        samples = imu_between(imu, float(traj[CHAIN_ROWS[n - 1], 0]) if n else float(traj[row, 0]) - 0.4,
                              float(traj[row, 0]))
        kf.nav = {"imu_t": np.array([s[0] for s in samples], np.float32),
                  "imu_g": np.stack([s[1] for s in samples]).astype(np.float32),
                  "imu_a": np.stack([s[2] for s in samples]).astype(np.float32)}
        if chain:
            kf.prev_kf = chain[-1]
            slam.map.keyframes[chain[-1]].next_kf = k
        chain.append(k)
    slam.kf_chain = list(chain)
    slam.last_kf_id = chain[-1]
    slam.imu_since_kf = imu_between(imu, float(traj[CHAIN_ROWS[-1], 0]), float(traj[FRAME_ROW, 0]))
    r_cw, t_cw = _pose(traj[FRAME_ROW])
    slam.last_frame = frame_class(float(traj[FRAME_ROW, 0]), np.zeros((0, 2), np.float32), np.zeros(0, np.int32),
                                  np.zeros(0, np.float32), None, np.zeros(0, bool), None, r_cw=r_cw,
                                  t_cw=(t_cw / SCALE).astype(np.float32))
    return chain


def _init_result(traj, chain_len):
    c = traj[list(CHAIN_ROWS), 1:4]
    vel = np.gradient(c, traj[list(CHAIN_ROWS), 0], axis=0).astype(np.float32)
    return types.SimpleNamespace(scale=SCALE, success=True, condition_number=1.0, velocities=vel[:chain_len],
                                 bias_g=np.array([0.002, -0.001, 0.0015], np.float32),
                                 bias_a=np.array([0.03, -0.02, 0.01], np.float32),
                                 gravity_w=np.array([0.01, -0.24, -9.807], np.float32))


def _decisions(slam):
    """The keyframe-gap and BA-skip decisions of `slam` on the built state."""
    out = []
    slam.n_tracked, slam.frames_since_kf = 100, 1
    kf_ts = slam.map.keyframes[slam.last_kf_id].timestamp
    for queued in range(4):
        for _ in range(queued):
            slam._mapping_queue.put(-1)
        out += [("keyframe", queued, gap, slam._need_new_keyframe(kf_ts + gap)) for gap in (0.4, 0.6, 1.4, 1.6)]
        while not slam._mapping_queue.empty():
            slam._mapping_queue.get_nowait()
    calls = []
    slam._vi_local_ba = lambda kf_id, window_size=None, optimize_gravity=False, iters=(5, 5): calls.append(
        ("gba" if optimize_gravity else "ba", kf_id, window_size))
    slam.init_refine_window, slam.init_time = 0.0, kf_ts - 1.2
    chain = list(slam.kf_chain)
    for step, queued in enumerate((0, 1, 1, 1, 1, "mark", 1)):
        if queued == "mark":  # a gravity-vertex GBA mark is due
            slam.init_refine_window, slam.gw_refine_marks, slam._gw_mark_done = 12.0, [1.0, 5.0], 0
        while not slam._mapping_queue.empty():
            slam._mapping_queue.get_nowait()
        if queued:
            slam._mapping_queue.put(-1)
        n = len(calls)
        slam._mapping_ba(chain[-1], chain)
        out.append(("ba", step, calls[n:], slam._ba_skips))
        slam.init_refine_window = 0.0
    while not slam._mapping_queue.empty():
        slam._mapping_queue.get_nowait()
    del slam._vi_local_ba
    return out


def _moved(nav, slot):
    """The NavState stack (numpy fields) with slot `slot` moved."""
    p, v, r = (np.array(x, np.float32) for x in nav[:3])
    p[slot] += MOVE_P
    v[slot] += MOVE_V
    c, s = np.cos(0.02), np.sin(0.02)
    r[slot] = r[slot] @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return p, v, r


def _solver(slot):
    def solve(state, obs, cam, ext, chain, gravity, fixed, iters1=15, iters2=10):
        p, v, r = (torch.from_numpy(x) for x in _moved(state.nav, slot))
        return state._replace(nav=state.nav._replace(p=p, v=v, r=r)), torch.from_numpy(G_NEW), obs
    return solve


def _tiny_problem(m, r):
    def build(window, fixed, max_landmarks):
        return (list(window) + [k for k in fixed if k not in window], np.zeros(1, np.int64),
                np.zeros((m, r), np.int32), np.zeros((m, r, 2), np.float32), np.ones((m, r), np.float32),
                np.zeros((m, r), bool))
    return build


def _nav_close(a, b):
    for name, tol in (("p", P_TOL), ("v", V_TOL), ("r", R_TOL)):
        np.testing.assert_allclose(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)), atol=tol, err_msg=name)


def _frame_close(a, b):
    np.testing.assert_allclose(a.r_cw, b.r_cw, atol=R_TOL)
    np.testing.assert_allclose(a.t_cw, b.t_cw, atol=P_TOL)


def test_async_vi_rebase_and_decisions_match_reference():
    cfg = VI_CONFIGS["vi_half"]
    cam = PinholeCamera(fx=cfg["fx"], fy=cfg["fx"], cx=cfg["cx"], cy=cfg["cy"], width=cfg["width"],
                        height=cfg["height"])
    imu = make_imu(cfg["n_frames"], cfg["dt"], hz=200.0)
    traj = load(VI_GOLDEN)["vi_half_traj"]
    kw = {k: cfg[k] for k in VI_KEYS}
    port = MonoViSlam(cam, device="cpu", async_mapping=True, **kw)
    ref = ref_mono_vi.MonoViSlam(RefCamera(fx=cfg["fx"], fy=cfg["fx"], cx=cfg["cx"], cy=cfg["cy"],
                                           width=cfg["width"], height=cfg["height"]), async_mapping=True, **kw)
    ref.shutdown()  # its worker stops: the test calls the methods itself
    chain = _build(port, KeyFrameData, FrameRecord, traj, imu, cfg)
    assert _build(ref, RefKeyFrame, RefFrame, traj, imu, cfg) == chain
    port.vi_ready = ref.vi_ready = True

    # the two async mapping decisions
    got, want = _decisions(port), _decisions(ref)
    assert got == want, (got, want)
    assert ("keyframe", 2, 1.4, False) in got and ("keyframe", 1, 0.6, True) in got
    assert [d[2] for d in got if d[0] == "ba"] == [[("ba", chain[-1], None)], [], [], [("ba", chain[-1], None)], [],
                                                   [("gba", chain[-1], len(chain))], []]

    # a pending VI init rescale, then the drain
    port.vi_ready = ref.vi_ready = False
    res = _init_result(traj, len(chain))
    epochs = (port._rebase_epoch, ref._rebase_epoch)
    for slam in (port, ref):
        slam._apply_init_result(res, chain)
        slam.vi_ready = True
    assert (port._rebase_epoch, ref._rebase_epoch) == (epochs[0] + 1, epochs[1] + 1)
    assert port.nav_cur is None and port._pending_imu_params is not None and port.gravity is None
    # after VI init the vision re-base leaves the last frame alone: only the drain re-poses it
    last = port.last_frame
    pose = (last.r_cw.copy(), last.t_cw.copy())
    last.ref = (chain[-1], np.eye(3, dtype=np.float32), np.zeros(3, np.float32), port.map.version - 1)
    port._rebase_last_frame()
    assert np.array_equal(last.r_cw, pose[0]) and np.array_equal(last.t_cw, pose[1])
    port.vi_ready = False
    port._rebase_last_frame()  # a vision frame before VI init is re-based on its keyframe
    assert np.allclose(last.t_cw, port.map.keyframes[chain[-1]].t_cw)
    last.r_cw, last.t_cw, last.ref, port.vi_ready = pose[0], pose[1], None, True
    # the current frame's samples, appended at its entry before the drain:
    # the port's drain leaves them to the VI core (the reference integrates
    # them here too, so the two are compared without them)
    current = imu_between(imu, float(traj[FRAME_ROW, 0]), float(traj[FRAME_ROW, 0]) + cfg["dt"])
    port.imu_since_kf = port.imu_since_kf + current
    port._drain_tracker_rebase()
    ref._drain_tracker_rebase()
    port.imu_since_kf = port.imu_since_kf[: len(port.imu_since_kf) - len(current)]
    assert port.rebases == 1 and port._rebase_seen == port._rebase_epoch
    for name in ("bias_g", "bias_a", "gravity"):
        np.testing.assert_array_equal(getattr(port, name), np.asarray(getattr(ref, name)))
    assert port.frame_prior is None and port.velocity is None and port._pending_imu_params is None
    _nav_close(port._nav_cur_host, ref.nav_cur)
    _frame_close(port.last_frame, ref.last_frame)
    port._drain_tracker_rebase()  # once per epoch
    assert port.rebases == 1

    # a VI BA with a free gravity direction that moved the newest keyframe
    port.map.build_ba_problem = _tiny_problem(port.max_ba_landmarks, MAX_OBS_PER_POINT)
    solve = mono_vi.vi_ba_gw_two_phase
    mono_vi.vi_ba_gw_two_phase = _solver(len(chain) - 1)
    try:
        port._vi_local_ba(chain[-1], window_size=len(chain), optimize_gravity=True, iters=(10, 8))
    finally:
        mono_vi.vi_ba_gw_two_phase = solve
    assert port._rebase_epoch == port._rebase_seen + 1
    np.testing.assert_array_equal(port._pending_imu_params[2], G_NEW)
    assert not np.array_equal(port.gravity, G_NEW)  # the tracker's gravity waits for the drain
    moved = port.map.keyframes[chain[-1]].nav["state"]
    kf = ref.map.keyframes[chain[-1]]
    ns = kf.nav["state"]
    p, v, r = _moved([np.asarray(x)[None] for x in ns[:3]], 0)
    kf.nav["state"] = ns._replace(p=p[0], v=v[0], r=r[0])
    kf.r_cw, kf.t_cw = ref._tcw_from_nav(kf.nav["state"])
    ref._map_gravity = G_NEW
    ref._pending_imu_params = (ref._map_bias_g, ref._map_bias_a, ref._map_gravity)
    ref._rebase_epoch += 1
    _nav_close(moved, kf.nav["state"])
    np.testing.assert_allclose(port.map.keyframes[chain[-1]].t_cw, kf.t_cw, atol=P_TOL)
    port._drain_tracker_rebase()
    ref._drain_tracker_rebase()
    np.testing.assert_array_equal(port.gravity, np.asarray(ref.gravity))
    _nav_close(port._nav_cur_host, ref.nav_cur)
    _frame_close(port.last_frame, ref.last_frame)
    assert isinstance(port._nav_cur_host, NavState) and port.rebases == 2
