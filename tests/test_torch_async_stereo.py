"""The port's threaded StereoSlam and RgbdSlam on the CPU: the reference's
semantics (`async_mapping=True`, and `streaming=True`, which means the same
for these entries) held to the lock-step golden, as tests/test_torch_async.py
does for MonoSlam.

The frames and configuration are tests/test_torch_stereo.py's and
tests/test_torch_rgbd.py's (STEREO_CONFIG: the half-size arc, 14 frames,
the 0.11 m pair or the depth images). Fed one frame at a time with the
mapping queue drained between frames (`wait_mapping_idle`), a threaded run
is lock-step with a deferred BA write-back, so it is held to the reference's
lock-step golden (tests/torch_stereo_golden.npz) with the lock-step tests'
tolerances (`held_to_golden`). Besides:
  * every mapping job ran on the worker thread, and when it started, its
    keyframe already held the close points it made from its stereo or
    depth, made on the tracker's thread before the job was queued (the
    same count, and some in all); the stereo run matched one right image a
    keyframe;
  * a streaming StereoSlam starts the worker and no collector thread.

One test per file: see tests/test_torch_fast.py."""

import threading

import numpy as np
import torch

from make_torch_goldens import SLAM_KEYS, STATES, STEREO_CONFIG, STEREO_GOLDEN, load, stereo_inputs
from test_torch_stereo import held_to_golden
from viorb_tpu_torch.slam.rgbd import RgbdSlam
from viorb_tpu_torch.slam.stereo import StereoSlam

torch.set_num_threads(1)


def _drained_run(name, slam, seq, second, step, gold):
    """Feed every frame, drain after each; check the jobs' threads and their
    keyframes' close points at the start of each job."""
    made, at_start = {}, {}
    created, run_job = slam._on_keyframe_created, slam._mapping_job

    def own_points(kf_id):  # the points the keyframe made (first observed by it)
        with slam.map_lock:
            kf = slam.map.keyframes[kf_id]
            return int((slam.map.pt_first_kf[kf.point_idx[kf.point_idx >= 0]] == kf_id).sum())

    def on_created(fr, kf_id):
        created(fr, kf_id)
        made[kf_id] = (threading.current_thread() is threading.main_thread(), own_points(kf_id))

    def job(kf_id):
        at_start[kf_id] = (threading.current_thread() is slam._worker, own_points(kf_id))
        run_job(kf_id)

    slam._on_keyframe_created, slam._mapping_job = on_created, job
    rows = []
    try:
        for image, other, ts in zip(seq.images, second, seq.timestamps):
            info = step(image, other, float(ts))
            slam.wait_mapping_idle()
            info = {**slam._info(), "n_stereo": info.get("n_stereo", 0)}
            rows.append([STATES.index(info["state"]), info["n_tracked"], info["n_kfs"], info["n_points"],
                         info["n_stereo"]])
        worker = slam._worker
        assert worker is not None and worker.is_alive() and slam._collector is None
        held_to_golden(name, rows, slam.trajectory_tum(), seq, gold)
    finally:
        slam.shutdown()
    assert len(at_start) == len(slam.job_times) == rows[-1][2] - 1 >= 2, (at_start, rows[-1])
    assert all(on_worker for on_worker, _ in at_start.values()), at_start
    assert all(made[k] == (True, own) for k, (_, own) in at_start.items()), (made, at_start)
    assert sum(own for _, own in at_start.values()) > 0, at_start
    return rows


def test_threaded_stereo_and_rgbd_match_lockstep_golden():
    c = STEREO_CONFIG
    gold = load(STEREO_GOLDEN)
    kw = {k: c[k] for k in SLAM_KEYS}

    cam, seq, right = stereo_inputs("stereo")
    slam = StereoSlam(cam, baseline=c["baseline"], device="cpu", streaming=True, **kw)
    assert slam.async_mapping and not slam.streaming
    rows = _drained_run("stereo", slam, seq, right, slam.process_frame_stereo, gold)
    assert slam.right_extractions == rows[-1][2], (slam.right_extractions, rows[-1][2])
    assert set(slam.ba_eager_calls) == {"stereo_local"}, slam.ba_eager_calls

    cam, seq, depths = stereo_inputs("rgbd")
    slam = RgbdSlam(cam, device="cpu", async_mapping=True, **kw)
    _drained_run("rgbd", slam, seq, depths, slam.process_frame_rgbd, gold)
    assert set(slam.ba_eager_calls) == {"local"}, slam.ba_eager_calls
    assert np.isfinite(slam.trajectory_tum()).all()
