"""Two rules of the port's threaded tracking that the reference lacks, on
the CPU with tests/test_torch_mono.py's half-size arc and configuration:

  * the stream is seeded only with a velocity measured between two frames
    tracked synchronously one after the other. After initialization (no
    velocity) the next frame is tracked synchronously, and the frame after
    it streams; after a stream failure likewise. A carry seeded with no
    velocity, or with one measured across frames lost in flight,
    mispredicts the next frames on a fast camera, and they fail in flight
    (the reference reseeds at once);
  * a synchronously tracked frame is booked in the map state it was
    tracked in: a write-back that moves the frame's reference keyframe
    while the frame is tracked (here: the whole map moved rigidly during
    the core's call, as a loop correction would move it) moves the booked
    pose along, and the velocity and the trajectory's frame-to-keyframe
    pose come out as without the move.

One test per file: see tests/test_torch_fast.py."""

import numpy as np
import torch

from make_torch_goldens import CONFIGS, SLAM_KEYS
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.io import synthetic
from viorb_tpu_torch.slam.mono import MonoSlam

torch.set_num_threads(1)

SEED_FRAMES, FAIL_AT = 6, 4
BOOK_FRAMES = 5


def _rigid(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.2, 3)
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    return R.astype(np.float32), rng.normal(0, 0.5, 3).astype(np.float32)


def _seeded_after(seq, cfg):
    """Per frame: whether the device carry is seeded after it, with a stream
    failure forced before frame FAIL_AT."""
    slam = MonoSlam(seq.cam, device="cpu", streaming=True, streaming_depth=1, **{k: cfg[k] for k in SLAM_KEYS})
    seeded = []
    try:
        for i in range(SEED_FRAMES):
            if i == FAIL_AT:
                slam._stream_failed = True
            prev = slam.last_frame
            slam.process_frame(seq.images[i], float(seq.timestamps[i]))
            slam.flush_stream()
            seeded.append(slam._dev_carry is not None)
            if seeded[-1] and (i == 0 or not seeded[-2]):
                # seeded now: the carry's velocity is this frame's motion from
                # the frame before it (as re-based in this frame's map state)
                r0, t0, r1, t1 = prev.r_cw, prev.t_cw, slam.last_frame.r_cw, slam.last_frame.t_cw
                c = slam._dev_carry
                np.testing.assert_allclose(c.vel_r.numpy(), r1 @ r0.T, atol=1e-5)
                np.testing.assert_allclose(c.vel_t.numpy(), t1 - r1 @ r0.T @ t0, atol=1e-5)
        states = slam.state
    finally:
        slam.shutdown()
    assert states == "OK", states
    return seeded


def _booked_moved_along(seq, cfg):
    slam = MonoSlam(seq.cam, device="cpu", **{k: cfg[k] for k in SLAM_KEYS})
    for i in range(BOOK_FRAMES - 1):
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
    assert slam.state == "OK" and slam.last_frame.r_cw is not None
    last = (slam.last_frame.r_cw.copy(), slam.last_frame.t_cw.copy())
    kf_id = slam.last_kf_id
    kf_old = (slam.map.keyframes[kf_id].r_cw.copy(), slam.map.keyframes[kf_id].t_cw.copy())
    r_d, t_d = _rigid(3)  # x_old = r_d x_new + t_d
    core = slam._track_core
    seen = {}

    def core_then_move(*args):
        out = core(*args)
        seen["r"], seen["t"] = out[4].numpy().copy(), out[5].numpy().copy()
        with slam.map_lock:  # a write-back landing while the frame is tracked
            for kf in slam.map.keyframes.values():
                kf.r_cw, kf.t_cw = (kf.r_cw @ r_d).astype(np.float32), (kf.r_cw @ t_d + kf.t_cw).astype(np.float32)
            slam.map.pt_xyz[:] = (slam.map.pt_xyz - t_d) @ r_d
            slam.map.version += 1
        return out

    slam._track_core = core_then_move
    slam.process_frame(seq.images[BOOK_FRAMES - 1], float(seq.timestamps[BOOK_FRAMES - 1]))
    fr = slam.last_frame
    assert slam.state == "OK" and "r" in seen and slam.last_kf_id == kf_id, "the frame must track, not insert"
    # the core's pose, moved with the map
    np.testing.assert_allclose(fr.r_cw, seen["r"] @ r_d, atol=1e-5)
    np.testing.assert_allclose(fr.t_cw, seen["r"] @ t_d + seen["t"], atol=1e-5)
    # the velocity: the core's pose after the last frame's, both before the move
    v_r = seen["r"] @ last[0].T
    np.testing.assert_allclose(slam.velocity[0], v_r, atol=1e-5)
    np.testing.assert_allclose(slam.velocity[1], seen["t"] - v_r @ last[1], atol=1e-5)
    # the trajectory's frame-to-keyframe pose: as tracked, before the move
    _, k, r_rel, t_rel = slam.traj_entries[-1]
    r_want = seen["r"] @ kf_old[0].T
    assert k == kf_id
    np.testing.assert_allclose(r_rel, r_want, atol=1e-5)
    np.testing.assert_allclose(t_rel, seen["t"] - r_want @ kf_old[1], atol=1e-5)


def test_stream_seed_and_mid_frame_booking():
    cfg = CONFIGS["half"]
    cam = PinholeCamera(fx=cfg["fx"], fy=cfg["fx"], cx=cfg["cx"], cy=cfg["cy"], width=cfg["width"],
                        height=cfg["height"])
    seq = synthetic.make_sequence(cfg["n_frames"], cam=cam, dt=cfg["dt"], device="cpu")
    seeded = _seeded_after(seq, cfg)
    init = 1  # the arc initializes at frame 1
    assert seeded[:init + 1] == [False, False], ("the initialization frame must not seed the stream", seeded)
    assert seeded[init + 1], ("the frame after initialization seeds with a one-step velocity", seeded)
    assert not seeded[FAIL_AT], ("the frame after a stream failure must not seed the stream", seeded)
    assert seeded[FAIL_AT + 1], ("the next synchronous frame seeds it", seeded)
    _booked_moved_along(seq, cfg)
