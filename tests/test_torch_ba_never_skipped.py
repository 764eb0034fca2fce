"""The port's async MonoSlam runs every job's local BA, on a map of any age.

The reference's async mapping skips a job's local BA while a newer
keyframe waits in the queue (at most twice in a row). Traced on the card
(probes/stream_loop_trace.py --async, the noisy circuit with loop closing
at the camera's rate), that rule is what failed the threaded loop runs: the
rejected Sim3 verifications of the revisit hold the worker, the turn's
keyframes queue up behind them, their BAs are skipped, tracking drifts and
no verification passes. Without the skip every traced run closed its loop.
So no BA is skipped (ROADMAP, deliberate differences).

Here an async MonoSlam on the CPU (tests/test_torch_mono.py's half-size
frames, a local window of 3 keyframes, so the map soon holds more
keyframes than the window) tracks until a job starts on such a map; the job
is held at its entry until the tracker has queued the next keyframe, then
released. The job finds that keyframe waiting (the reference's rule would
skip its BA), and its BA runs; no BA of the run is skipped. No reference
pipeline runs here.

One test per file: see tests/test_torch_fast.py."""

import threading

import torch

from make_torch_goldens import CONFIGS, SLAM_KEYS
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.io import synthetic
from viorb_tpu_torch.slam.mono import MonoSlam

torch.set_num_threads(1)

WINDOW = 3


def test_local_ba_never_skipped_behind_a_waiting_keyframe():
    cfg = CONFIGS["half"]
    cam = PinholeCamera(fx=cfg["fx"], fy=cfg["fx"], cx=cfg["cx"], cy=cfg["cy"], width=cfg["width"],
                        height=cfg["height"])
    seq = synthetic.make_sequence(cfg["n_frames"], cam=cam, dt=cfg["dt"], device="cpu")
    slam = MonoSlam(cam, device="cpu", async_mapping=True, **{**{k: cfg[k] for k in SLAM_KEYS},
                                                              "local_window": WINDOW})
    entered, release = threading.Event(), threading.Event()
    held, decisions = [], {}
    run_job, mapping_ba, local_ba = slam._mapping_job, slam._mapping_ba, slam._local_ba
    solved = []

    def job(kf_id):
        if not held and len(slam.map.keyframes) > WINDOW:
            held.append(kf_id)
            entered.set()
            if not release.wait(timeout=120):
                raise RuntimeError("the held mapping job was never released")
        run_job(kf_id)

    def deciding(kf_id, window):
        waiting, n = not slam._mapping_queue.empty(), len(solved)
        mapping_ba(kf_id, window)
        decisions[kf_id] = dict(newer_waiting=waiting, solved=len(solved) > n, keyframes=len(slam.map.keyframes))

    def solving(*a, **kw):
        solved.append(a[0])
        return local_ba(*a, **kw)

    slam._mapping_job, slam._mapping_ba, slam._local_ba = job, deciding, solving
    try:
        for image, ts in zip(seq.images, seq.timestamps):
            slam.process_frame(image, float(ts))
            if entered.is_set() and slam._mapping_queue.qsize() >= 1:
                break  # the held job's map is older than its window and a newer keyframe waits
        assert held and slam._mapping_queue.qsize() >= 1, (held, slam._mapping_queue.qsize())
        release.set()
        slam.wait_mapping_idle()
    finally:
        release.set()
        slam.shutdown()
    first = decisions[held[0]]
    assert first["newer_waiting"] and first["keyframes"] > WINDOW, first
    assert first["solved"] and all(d["solved"] for d in decisions.values()), decisions
    assert slam.ba_skipped == 0 and slam.state == "OK" and slam.map.version > 0
