"""The port's async-mapping MonoSlam on the CPU: the reference's async
contract (tests/test_async_mapping.py) and the four reference faults the
port guards against.

The frames and configuration are tests/test_torch_mono.py's: the port's
renderer at half size (376x240), 20 frames of the arc at dt=0.2 s, 300
features, a keyframe at least every 5 frames. The checks:
  * the contract: fed one frame at a time with the mapping queue drained
    between frames (`wait_mapping_idle`, so the worker's schedule, and with
    it the outcome, does not depend on this host's load), the run ends OK,
    mapping published (`map.version > 0`), every job ran on the worker, and
    the ATE after Sim3 is within twice the lock-step golden's bound
    (tests/torch_mono_golden.npz, 2 x 1.25 x the reference's lock-step ATE);
    after every frame the state and keyframe count equal the reference's
    lock-step run's and inliers and points are within
    tests/test_streaming.py's tolerances (6, 12): a drained queue makes
    async mapping lock-step with a deferred write-back. Fed as fast as the
    host tracks, un-paced, the outcome depends on thread timing in both
    packages (on this CPU the port's ATE reads 0.06-0.18 m and the
    reference's 0.12-0.18 m on these frames);
  * a mapping job held on a threading.Event: keyframe-inserting frames still
    return, the job waits in the queue, and the queue-depth gate bounds
    keyframe production to frames / kf_max_interval + 3; then the held jobs
    run, and shutdown() stops the worker (`_worker` None, thread dead);
  * two threads flushing one pending BA at once apply it exactly once (the
    reference swaps `_pending_ba` with no lock, mono.py:1799);
  * a deferred write-back leaves a point slot that was culled and reused
    after the solve alone (reference mono.py:1845);
  * a keyframe's deferred descriptor block survives another thread filling
    it between the job's read of the handle and its pull (reference
    mono.py:1244, :1513);
  * fusion uploads and dispatches with `map_lock` released (reference
    mono.py:1659 holds it);
  * a CUDA graph capture is refused while a thread that works on the card
    is declared (`cuda_graph.register_thread`): a threaded MonoSlam
    captures its cores before it starts its threads. On the CPU MonoSlam
    declares none.

One test per file: see tests/test_torch_fast.py."""

import sys
import threading

import numpy as np
import pytest
import torch

from make_torch_goldens import CONFIGS, SLAM_KEYS, STATES, load
from test_torch_mono import ATE_FACTOR
from viorb_tpu_torch import cuda_graph
from viorb_tpu_torch.eval.ate import ate_rmse
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.io import synthetic
from viorb_tpu_torch.slam import mono as mono_module
from viorb_tpu_torch.slam.mono import MonoSlam

torch.set_num_threads(1)

INLIER_TOL, POINT_TOL = 6, 12  # tests/test_streaming.py's
HELD_FRAMES = 12
FLUSH_ROUNDS = 20
FLUSH_THREADS = 4


def _slam(seq, cfg):
    return MonoSlam(seq.cam, device="cpu", async_mapping=True, **{k: cfg[k] for k in SLAM_KEYS})


def _contract(seq, cfg, gold):
    slam = _slam(seq, cfg)
    for i, (image, ts) in enumerate(zip(seq.images, seq.timestamps)):
        slam.process_frame(image, float(ts))
        slam.wait_mapping_idle()
        info = slam._info()
        want = [int(gold[f"half_{k}"][i]) for k in ("state", "n_tracked", "n_kfs", "n_points")]
        got = [STATES.index(info["state"]), info["n_tracked"], info["n_kfs"], info["n_points"]]
        assert got[0] == want[0] and got[2] == want[2], (i, got, want)
        assert abs(got[1] - want[1]) <= INLIER_TOL and abs(got[3] - want[3]) <= POINT_TOL, (i, got, want)
    assert info["state"] == "OK", info
    assert slam.map.version > 0, "the mapping worker never published"
    assert slam._worker is not None and slam._worker.is_alive() and slam._worker is not threading.current_thread()
    assert len(slam.job_times) == slam.map._next_kf - 2 >= 2, (len(slam.job_times), slam.map._next_kf)
    traj = slam.trajectory_tum()
    ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)
    bound = 2 * ATE_FACTOR * float(gold["half_ate"])
    assert len(traj) == len(seq.images) - 1 and ate <= bound, (len(traj), ate, bound)
    return slam


def _held_job_gates_keyframes(seq, cfg):
    slam = _slam(seq, cfg)
    release = threading.Event()
    run_job = slam._mapping_job

    def held_job(kf_id):
        if not release.wait(timeout=120):
            raise RuntimeError("the held mapping job was never released")
        run_job(kf_id)

    slam._mapping_job = held_job
    inserted = 0
    try:
        for i, (image, ts) in enumerate(zip(seq.images[:HELD_FRAMES], seq.timestamps[:HELD_FRAMES])):
            made = slam.map._next_kf
            slam.process_frame(image, float(ts))
            if i > 1 and slam.map._next_kf > made:
                # this frame inserted a keyframe and returned: the job only queued
                inserted += 1
                assert slam._mapping_queue.unfinished_tasks >= 1 and not slam.job_times
        assert inserted >= 2 and not release.is_set(), inserted
        assert inserted <= HELD_FRAMES / slam.kf_max_interval + 3, inserted
        release.set()
        slam.wait_mapping_idle()
        assert len(slam.job_times) == inserted and slam.map.version > 0
    finally:
        release.set()
        worker = slam._worker
        slam.shutdown()
    assert slam._worker is None and slam._collector is None and not worker.is_alive()


def _pending_ba(slam):
    """A deferred local BA over the newest keyframes, left pending."""
    kf_ids = sorted(slam.map.keyframes)
    slam._local_ba(kf_ids[-4:], [kf_ids[-4]], defer=True)
    assert slam._pending_ba is not None
    return slam._pending_ba


def _flush_applies_once(slam):
    applied = []
    apply = slam._apply_ba_result

    def counting_apply(*job):
        applied.append(threading.get_ident())
        apply(*job)

    slam._apply_ba_result = counting_apply
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        job = _pending_ba(slam)
        for _ in range(FLUSH_ROUNDS):
            slam._pending_ba = job
            version = slam.map.version
            applied.clear()
            start = threading.Barrier(FLUSH_THREADS)

            def flush():
                start.wait(timeout=30)
                slam._flush_pending_ba()

            threads = [threading.Thread(target=flush) for _ in range(FLUSH_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert len(applied) == 1 and slam.map.version == version + 1, (applied, slam.map.version, version)
            assert slam._pending_ba is None
    finally:
        sys.setswitchinterval(interval)
        slam._apply_ba_result = apply


def _reused_slot_left_alone(slam):
    # a solve with work to do: the window's points nudged off the optimum
    # the BA before this one left them at (from there a BA may accept no step)
    window = sorted(slam.map.keyframes)[-4:]
    nudged = slam.map.local_map_points(window)
    slam.map.pt_xyz[nudged] += np.float32(0.01)
    kf_list, pt_ids = _pending_ba(slam)[:2]
    moved = [int(p) for p in pt_ids[:20]]
    culled = moved[0]
    slam.map.remove_point(culled)
    kf = slam.map.keyframes[kf_list[0]]
    feat = int(np.nonzero(kf.point_idx < 0)[0][0])
    xyz = np.array([100.0, 100.0, 100.0], np.float32)
    reused = slam.map.add_point(xyz, np.zeros(256, np.uint8), kf_list[0], feat)
    assert reused == culled, (reused, culled)
    before = slam.map.pt_xyz[moved[1:]].copy()
    slam._flush_pending_ba()
    np.testing.assert_array_equal(slam.map.pt_xyz[reused], xyz)
    assert slam.map.pt_active[reused] and kf.point_idx[feat] == reused
    # the write-back itself happened: the other points moved
    assert (slam.map.pt_xyz[moved[1:]] != before).any()


def _deferred_descriptors_kept(slam):
    kf_id = max(slam.map.keyframes)
    kf = slam.map.keyframes[kf_id]
    block = kf.desc01.copy()
    pull = slam._pull

    for fill_first in (False, True):
        kf.desc01, kf.desc01_dev = None, torch.from_numpy(block.copy())
        if fill_first:
            kf.ensure_desc01()  # another thread filled the block before the job read the handle

        def pull_after_a_fill(*tensors, **kwargs):
            kf.ensure_desc01()  # ... or between the job's read of the handle and its pull
            return pull(*tensors, **kwargs)

        slam._pull = pull_after_a_fill
        try:
            slam._pull_and_merge(kf_id, [], [])
        finally:
            slam._pull = pull
        assert kf.desc01 is not None and kf.desc01_dev is None, fill_first
        np.testing.assert_array_equal(kf.desc01, block)


def _fusion_dispatches_unlocked(slam):
    held = []
    up = slam._up
    fuse = mono_module.fuse_match_gathered

    def watched_up(*args, **kwargs):
        held.append(slam.map_lock._is_owned())
        return up(*args, **kwargs)

    def watched_fuse(*args, **kwargs):
        held.append(slam.map_lock._is_owned())
        return fuse(*args, **kwargs)

    slam._up = watched_up
    mono_module.fuse_match_gathered = watched_fuse
    try:
        kf_ids = sorted(slam.map.keyframes)
        launches, _own, _nb = slam._fuse_batch_dispatch(kf_ids[-1], kf_ids[-3:-1])
    finally:
        slam._up = up
        mono_module.fuse_match_gathered = fuse
    assert launches and len(held) > len(launches) and not any(held), held


def _captures_refused_beside_threads():
    assert cuda_graph.card_threads() == 0
    cuda_graph.register_thread()
    try:
        with pytest.raises(RuntimeError, match="capture before starting"):
            cuda_graph._Capture(lambda x: x + 1, None, [torch.zeros(3)])
    finally:
        cuda_graph.unregister_thread()
    with pytest.raises(RuntimeError):
        cuda_graph.unregister_thread()
    assert cuda_graph.card_threads() == 0


def test_async_mapping_matches_contract():
    cfg = CONFIGS["half"]
    gold = load()
    cam = PinholeCamera(fx=cfg["fx"], fy=cfg["fx"], cx=cfg["cx"], cy=cfg["cy"], width=cfg["width"],
                        height=cfg["height"])
    seq = synthetic.make_sequence(cfg["n_frames"], cam=cam, dt=cfg["dt"], device="cpu")
    slam = _contract(seq, cfg, gold)
    try:
        _flush_applies_once(slam)
        _reused_slot_left_alone(slam)
        _deferred_descriptors_kept(slam)
        _fusion_dispatches_unlocked(slam)
    finally:
        worker = slam._worker
        slam.shutdown()
    assert slam._worker is None and not worker.is_alive()
    _held_job_gates_keyframes(seq, cfg)
    _captures_refused_beside_threads()
