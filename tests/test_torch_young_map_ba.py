"""The port's async mapping never skips the local BA of a young map.

The reference's mapping worker skips a job's local BA while a newer
keyframe waits in the queue (its BA abort, at most twice in a row): the
next job solves a window that holds this one's. Right after the two-view
initialization that rule starves the new map: the first jobs are the
slowest of a run, the tracker inserts keyframes quickly while the map is
small, and the reference's rule skips the first local BA after the
initialization's. Traced on the card (probes/stream_loop_trace.py, threaded
loop runs on the noisy circuit at the camera's rate), every run that ended
above 0.1 m had skipped that BA, and in the worst the map went unrefined
for 14 frames while the inliers fell from 273 to 17 and tracking was lost.
So the port skips no BA while the map holds no more keyframes than
`local_window` (the window is the whole map and its solve is cheap), and,
on older maps too, none at all (tests/test_torch_ba_never_skipped.py).

Here an async MonoSlam on the CPU tracks tests/test_torch_mono.py's
half-size frames; the worker's first job after the initialization is held
at its entry until the tracker has queued the next keyframe, then released.
The job finds that keyframe waiting (the reference's rule would skip its
BA), and its BA runs. No reference pipeline runs here.

One test per file: see tests/test_torch_fast.py."""

import threading

import torch

from make_torch_goldens import CONFIGS, SLAM_KEYS
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.io import synthetic
from viorb_tpu_torch.slam.mono import MonoSlam

torch.set_num_threads(1)


def test_young_map_ba_is_never_skipped():
    cfg = CONFIGS["half"]
    cam = PinholeCamera(fx=cfg["fx"], fy=cfg["fx"], cx=cfg["cx"], cy=cfg["cy"], width=cfg["width"],
                        height=cfg["height"])
    seq = synthetic.make_sequence(cfg["n_frames"], cam=cam, dt=cfg["dt"], device="cpu")
    slam = MonoSlam(cam, device="cpu", async_mapping=True, **{k: cfg[k] for k in SLAM_KEYS})
    entered, release = threading.Event(), threading.Event()
    held, decisions = [], {}
    run_job, mapping_ba = slam._mapping_job, slam._mapping_ba

    def job(kf_id):
        if not held:
            held.append(kf_id)
            entered.set()
            if not release.wait(timeout=120):
                raise RuntimeError("the held mapping job was never released")
        run_job(kf_id)

    def deciding(kf_id, window):
        waiting, skipped = not slam._mapping_queue.empty(), slam.ba_skipped
        mapping_ba(kf_id, window)
        decisions[kf_id] = dict(newer_waiting=waiting, skipped=slam.ba_skipped > skipped,
                                keyframes=len(slam.map.keyframes))

    slam._mapping_job, slam._mapping_ba = job, deciding
    try:
        for image, ts in zip(seq.images, seq.timestamps):
            slam.process_frame(image, float(ts))
            if entered.is_set() and slam._mapping_queue.qsize() >= 1:
                break  # the first job is held and a newer keyframe waits behind it
        assert held and slam._mapping_queue.qsize() >= 1, (held, slam._mapping_queue.qsize())
        release.set()
        slam.wait_mapping_idle()
    finally:
        release.set()
        slam.shutdown()
    first = decisions[held[0]]
    assert first["newer_waiting"] and first["keyframes"] <= slam.local_window, first
    assert not first["skipped"] and slam.ba_skipped == 0, decisions
    assert slam.state == "OK" and slam.map.version > 0
