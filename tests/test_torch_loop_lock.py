"""The map lock's scope around loop closing in the port's async mapping job:
held from `add_keyframe` to the end of `try_close`, as the reference's
mapping job holds it (viorb_tpu/slam/mono.py:1277-1282).

The map is the reference's MonoSlam loop run at the entry of the
`try_close` that closed its first loop (tests/torch_loop_golden.npz,
"mono"), loaded into an async MonoSlam with the reference's vocabulary,
keyframe BoWs (the closing keyframe's added by the job), consistency state
and Sim3 RANSAC draw, so the job closes the reference's loop; the job's
earlier phases (triangulation, fusion, local BA, culling) are stubbed out
to keep the checkpoint's map, and the post-loop GBA is recorded, not run.
The job runs on the mapping worker. `map_lock` is a recording RLock: from
the worker's entry into `add_keyframe` to its exit from `try_close` the
worker never lets the lock go (its depth never falls to 0), and a second
thread that asks for the lock while the essential graph is solved gets it
only after `try_close` has returned. The loop closes at the reference's
candidate.

No reference pipeline runs here: the golden holds it. One test per file:
see tests/test_torch_fast.py."""

import threading

import numpy as np
import torch

from make_torch_goldens import LOOP_GOLDEN, load, load_checkpoint, load_vocab_arrays
from viorb_tpu_torch.bow import BinaryVocabulary, KeyframeDatabase
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.slam import loop_closing
from viorb_tpu_torch.slam.mono import MonoSlam
from viorb_tpu_torch.solvers.sim3_solver import sim3_from_samples

torch.set_num_threads(1)

CAM = PinholeCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)


class RecordingLock:
    """An RLock that logs, in order, each time a thread lets it go entirely
    and each time a thread acquires it from not holding it."""

    def __init__(self):
        self._lock = threading.RLock()
        self._depth = {}
        self.log = []
        self._log_lock = threading.Lock()

    def _note(self, what):
        with self._log_lock:
            self.log.append((what, threading.current_thread().name))

    def acquire(self, blocking=True, timeout=-1):
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            me = threading.get_ident()
            self._depth[me] = self._depth.get(me, 0) + 1
            if self._depth[me] == 1:
                self._note("acquired")
        return ok

    def release(self):
        me = threading.get_ident()
        self._depth[me] -= 1
        if self._depth[me] == 0:
            self._note("freed")
        self._lock.release()

    def held(self) -> bool:
        return self._depth.get(threading.get_ident(), 0) > 0

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()


def test_async_loop_closing_holds_the_map_lock():
    gold = load(LOOP_GOLDEN)
    g = {k[5:]: v for k, v in gold.items() if k.startswith("mono_")}
    v = load_vocab_arrays(gold, "mono_")
    vocab = BinaryVocabulary(v["children"], v["centers"].astype(np.float32) * 2 - 1, v["is_leaf"], v["word_id"],
                             v["idf"])
    ck = load_checkpoint(gold, "mono_ckpt_")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ckpt.npz"
        np.savez(path, **ck)
        slam = MonoSlam(CAM, n_features=800, kf_max_interval=5, device="cpu", vocabulary=vocab,
                        enable_loop_closing=True, async_mapping=True)
        slam.load_map(path, localization_only=False)
    kf_id = int(g["kf"])
    lc = slam.loop_closer
    # the database as the reference's before the job: the checkpoint's BoWs
    # of every other keyframe (the job adds the closing keyframe's)
    lc.db = KeyframeDatabase(vocab)
    for k, kf in slam.map.keyframes.items():
        kf.bow = None
        if k != kf_id and f"kf{k}_bow" in ck:
            kf.bow = {int(w): float(x) for w, x in ck[f"kf{k}_bow"]}
            lc.db.add(k, kf.bow)
    lc._consistency = {int(a): int(b) for a, b in g["consistency"]}
    lc.last_loop_kf = int(g["last_loop_kf"])

    lock = RecordingLock()
    slam.map_lock = lc.lock = lock
    # the job's earlier phases keep the checkpoint's map
    slam._tri_dispatch = lambda kf, nbs: []
    slam._fuse_batch_dispatch = lambda kf, nbs: ([], np.zeros(0, np.int64), np.zeros(0, np.int64))
    slam._mapping_ba = lambda kf, window: None
    slam._cull_points = slam._cull_keyframes = lambda *a: None
    seen = {}
    lc.gba_fn = lambda anchor, scale: seen.update(anchor=anchor)

    def marked(name, fn):
        def call(*a, **kw):
            lock._note(f"{name} begins" if lock.held() else f"{name} begins UNLOCKED")
            out = fn(*a, **kw)
            lock._note(f"{name} ends" if lock.held() else f"{name} ends UNLOCKED")
            return out
        return call

    lc.add_keyframe = marked("add_keyframe", lc.add_keyframe)
    lc.try_close = marked("try_close", lc.try_close)
    solve = loop_closing.optimize_sim3_graph
    second = []

    def tracker():
        with lock:
            second.append(True)

    def solving(*a, **kw):
        t = threading.Thread(target=tracker, name="tracker")
        t.start()
        second.append(t)
        t.join(timeout=0.2)
        return solve(*a, **kw)

    ransac = loop_closing.sim3_ransac
    loop_closing.optimize_sim3_graph = solving
    loop_closing.sim3_ransac = lambda p1, p2, valid, gen, **kw: sim3_from_samples(
        p1, p2, valid, torch.from_numpy(g["ransac_idx"]), **kw)
    try:
        slam._start_threads(np.zeros((CAM.height, CAM.width), np.float32))
        slam._mapping_queue.put(kf_id)
        slam.wait_mapping_idle()
    finally:
        loop_closing.optimize_sim3_graph, loop_closing.sim3_ransac = solve, ransac
        slam.shutdown()
    second[0].join(timeout=30)

    assert lc.loops_closed == 1 and lc.last_loop_kf == kf_id and seen["anchor"] == int(g["corr_anchor"])
    worker = [e for e in lock.log if e[1] == "viorb-mapping"]
    names = [e[0] for e in worker]
    begin, end = names.index("add_keyframe begins"), names.index("try_close ends")
    assert begin < end and "freed" not in names[begin:end], worker
    assert not any("UNLOCKED" in n for n in names), worker
    # the second thread had to wait for the whole closure
    order = [e for e in lock.log if e[0] in ("try_close ends", "acquired") and e[1] in ("viorb-mapping", "tracker")]
    assert order.index(("try_close ends", "viorb-mapping")) < order.index(("acquired", "tracker")), lock.log
    assert second[-1] is True
