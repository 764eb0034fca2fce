"""The port's loop closing (viorb_tpu_torch/slam/loop_closing.py and
MonoSlam's loop path) against the JAX reference's:

  * tests/test_loop_closing.py's constructed drifted map, run through the
    port's LoopCloser with the port's own RANSAC draws: the loop closes on
    a revisit and the reference test's bounds hold (the revisiting keyframe
    within 0.3 m of its true centre, the far end of the chain moved toward
    the truth);
  * the reference's MonoSlam loop run on the rendered circuit
    (tests/torch_loop_golden.npz, "mono"): the map checkpoint at the entry
    of the `try_close` that closed its first loop, loaded into the port's
    MonoSlam with the reference's vocabulary and keyframe BoWs (where the
    checkpoint kept a keyframe's descriptors, the port's BoW from them
    equals the reference's within 1e-6), the loop closer's consistency
    state restored and the reference's Sim3 RANSAC draw replayed: the same
    candidate, the same matched pairs, S12 within 1e-5 and the confirm
    count within 2; after `correct` (essential graph, point moves, seam
    replacement and fusion) every keyframe pose within 2e-5 (rotation
    entries; translations in map units, the map's extent ~4) and the
    active points the reference's (at most 0.5 % differ, those by fusion
    decisions at the 4 px radius), within 2e-4 on the common ones;
  * the same correction in async mode, with the map lock held across it
    as the mapping job holds it (the reference's scope): a second thread
    that tries to insert a keyframe during the essential graph's solve
    waits until the write-back is done, the snapshot's keyframes land
    within 2e-5 of the reference's, and the inserted one keeps the pose it
    was given;
  * the post-loop GBA from the reference's checkpoint at its entry: every
    pose entry within 2e-3 and the points' median distance within 3e-3 of
    the reference's (two-phase LM over 40 keyframes and ~3900 points in
    another float order; measured 3e-4 and 7.5e-4, against a median point
    move of 2.3e-2 by the GBA);
  * the same GBA in async mode, where it runs in the loop job as in
    lock-step (not on a thread of its own beside the tracker, as the
    reference's does): the same map, array for array;
  * BoW relocalization: the port's host transform of the closing
    keyframe's descriptors gives the reference's words, and the keyframe
    database built from the reference's BoWs returns the reference's 5
    candidates in its order, scores within 1e-9.

No reference pipeline runs here: the golden holds it. One test per file:
see tests/test_torch_fast.py."""

import threading

import numpy as np
import torch

from make_torch_goldens import LOOP_GOLDEN, load, load_checkpoint, load_vocab_arrays
from viorb_tpu_torch.bow import BinaryVocabulary, KeyframeDatabase, train_vocabulary
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.mapping.map import KeyFrameData, MapStore
from viorb_tpu_torch.slam import loop_closing
from viorb_tpu_torch.slam.loop_closing import LoopCloser
from viorb_tpu_torch.slam.mono import MonoSlam
from viorb_tpu_torch.solvers.sim3_solver import sim3_from_samples

torch.set_num_threads(1)

CAM = PinholeCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
POSE_ATOL, POINT_ATOL = 2e-5, 2e-4
GBA_POSE_ATOL, GBA_POINT_MEDIAN = 2e-3, 3e-3


def _make_kf(ts, r_cw, t_cw, xy, desc, n_feat=256):
    valid = np.zeros(n_feat, bool)
    valid[: len(xy)] = True
    xy_p = np.zeros((n_feat, 2), np.float32)
    xy_p[: len(xy)] = xy
    d = np.zeros((n_feat, 256), np.uint8)
    d[: len(desc)] = desc
    return KeyFrameData(kf_id=0, timestamp=ts, r_cw=r_cw.astype(np.float32), t_cw=t_cw.astype(np.float32),
                        xy=xy_p, level=np.zeros(n_feat, np.int32), angle=np.zeros(n_feat, np.float32), desc01=d,
                        valid=valid, point_idx=np.full(n_feat, -1, np.int32))


def _constructed_drift_closes(rng):
    """tests/test_loop_closing.py, the port's classes on the CPU."""
    n_places, per = 12, 40
    place_pts = [
        np.stack([rng.uniform(-2, 2, per), rng.uniform(-2, 2, per), rng.uniform(5, 8, per)], 1).astype(np.float32)
        + np.array([4.0 * i, 0, 0], np.float32)
        for i in range(n_places)
    ]
    place_desc = [rng.integers(0, 2, size=(per, 256)).astype(np.uint8) for _ in range(n_places)]
    vocab = train_vocabulary(np.concatenate(place_desc), k=8, depth=3)
    store = MapStore()
    lc = LoopCloser(store, vocab, min_matches=15, covis_consistency=2, device="cpu")
    visits = list(range(n_places)) + [0, 1, 2]
    n_v = len(visits)
    step_s = 1.08 ** (1.0 / (n_v - 1))
    step_t = np.array([0.8, 0.5, -0.4], np.float32) / (n_v - 1)
    kf_of_visit, closed_at = [], None
    for v_idx, place in enumerate(visits):
        r_cw = np.eye(3, dtype=np.float32)
        c_w = np.array([4.0 * place, 0.0, 0.0], np.float32)
        t_cw = -c_w
        pts, desc = place_pts[place], place_desc[place]
        if v_idx > 0:
            t_cw = -(c_w * step_s**v_idx + step_t * v_idx)
            pts = (pts * step_s**v_idx + step_t * v_idx).astype(np.float32)
        uv = rng.uniform(0, 400, size=(per, 2)).astype(np.float32)
        kf_id = store.add_keyframe(_make_kf(float(v_idx), r_cw, t_cw, uv, desc))
        kf_of_visit.append(kf_id)
        for f in range(per):
            store.add_point(pts[f], desc[f], kf_id, f)
        if v_idx > 0:
            prev = kf_of_visit[v_idx - 1]
            for f in range(16):
                store.add_observation(int(store.keyframes[prev].point_idx[f + 16]), kf_id, int(per + f) % 256)
        if lc.process(kf_id):
            closed_at = v_idx
            break
    assert lc.loops_closed >= 1 and closed_at is not None and closed_at >= n_places
    c_gt = np.array([4.0 * visits[closed_at], 0, 0])
    err = np.linalg.norm(store.keyframes[kf_of_visit[closed_at]].center() - c_gt)
    assert err < 0.3, err
    c_far = np.array([4.0 * (n_places - 1), 0, 0])
    err_far = np.linalg.norm(store.keyframes[kf_of_visit[n_places - 1]].center() - c_far)
    drift_far = np.linalg.norm(c_far * step_s ** (n_places - 1) + step_t * (n_places - 1) - c_far)
    assert err_far < drift_far, (err_far, drift_far)


def _vocabulary(gold, prefix):
    v = load_vocab_arrays(gold, prefix)
    return BinaryVocabulary(v["children"], v["centers"].astype(np.float32) * 2 - 1, v["is_leaf"], v["word_id"], v["idf"])


def _slam_from_checkpoint(gold, prefix, path, **kw):
    np.savez(path, **load_checkpoint(gold, prefix))
    slam = MonoSlam(CAM, n_features=800, kf_max_interval=5, device="cpu", **kw)
    slam.load_map(str(path), localization_only=False)
    return slam


def _poses_points(m):
    ids = sorted(m.keyframes)
    pts = np.nonzero(m.pt_active)[0]
    return (ids, np.stack([m.keyframes[i].r_cw for i in ids]), np.stack([m.keyframes[i].t_cw for i in ids]),
            pts, m.pt_xyz[pts])


def _golden_loop_matches(gold, tmp_path, monkeypatch):
    g = {k[5:]: v for k, v in gold.items() if k.startswith("mono_")}
    vocab = _vocabulary(gold, "mono_")
    slam = _slam_from_checkpoint(gold, "mono_ckpt_", tmp_path / "ckpt.npz", vocabulary=vocab,
                                 enable_loop_closing=True)
    lc = slam.loop_closer
    ck = load_checkpoint(gold, "mono_ckpt_")
    # the database as the reference's: the checkpoint's BoWs; where it kept
    # a keyframe's descriptors the port's (K8's twin) are the same
    lc.db = KeyframeDatabase(vocab)
    kept = 0
    for k, kf in slam.map.keyframes.items():
        if f"kf{k}_bow" not in ck:  # the two-view pair: no mapping job, no BoW
            kf.bow = None
            continue
        ref_bow = {int(w): float(v) for w, v in ck[f"kf{k}_bow"]}
        if ck[f"kf{k}_desc01"].any():
            kept += 1
            assert set(kf.bow) == set(ref_bow), k
            assert all(abs(kf.bow[w] - v) <= 1e-6 * v for w, v in ref_bow.items()), k
        kf.bow = ref_bow
        lc.db.add(k, ref_bow)
    assert kept >= 3
    kf_id = int(g["kf"])

    # BoW relocalization's candidates for the closing keyframe's features
    kf = slam.map.keyframes[kf_id]
    words, qbow = vocab.transform(kf.desc01, kf.valid)
    np.testing.assert_array_equal(words, g["reloc_words"])
    hits = lc.db.query(qbow, max_results=5)
    assert [h for h, _ in hits] == g["reloc_hits"].tolist()
    np.testing.assert_allclose([s for _, s in hits], g["reloc_scores"], rtol=0, atol=1e-9)

    # try_close with the reference's consistency state and Sim3 draw
    lc._consistency = {int(a): int(b) for a, b in g["consistency"]}
    lc.last_loop_kf = int(g["last_loop_kf"])
    monkeypatch.setattr(loop_closing, "sim3_ransac", lambda p1, p2, valid, gen, **kw: sim3_from_samples(
        p1, p2, valid, torch.from_numpy(g["ransac_idx"]), **kw))
    seen = {}
    compute = lc.compute_sim3

    def recording(kf_id_, cand):
        seen["cand"] = cand
        seen["sim3"] = compute(kf_id_, cand)
        return seen["sim3"]

    lc.compute_sim3 = recording
    lc.gba_fn = lambda anchor, scale: seen.update(corr=_poses_points(slam.map), anchor=anchor, scale=scale)
    assert lc.try_close(kf_id)
    assert seen["cand"] == int(g["cand"]) and seen["anchor"] == int(g["corr_anchor"])
    s12, r12, t12, n_proj, (cur_pts, loop_pts) = seen["sim3"]
    np.testing.assert_allclose([s12], [g["sim3_s"]], rtol=0, atol=1e-5)
    np.testing.assert_allclose(r12, g["sim3_r"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t12, g["sim3_t"], rtol=0, atol=1e-5)
    assert abs(n_proj - int(g["sim3_n"])) <= 2, (n_proj, int(g["sim3_n"]))
    np.testing.assert_array_equal(cur_pts, g["sim3_cur_pts"])
    np.testing.assert_array_equal(loop_pts, g["sim3_loop_pts"])
    ids, r, t, pts, xyz = seen["corr"]
    assert ids == g["corr_kf_ids"].tolist()
    np.testing.assert_allclose(r, g["corr_r_cw"], rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(t, g["corr_t_cw"], rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose([seen["scale"][i] for i in ids], g["corr_scale"], rtol=1e-5)
    common, ia, ib = np.intersect1d(pts, g["corr_pt_ids"], return_indices=True)
    assert len(common) >= 0.995 * max(len(pts), len(g["corr_pt_ids"])), (len(common), len(pts), len(g["corr_pt_ids"]))
    np.testing.assert_allclose(xyz[ia], g["corr_pt_xyz"][ib], rtol=0, atol=POINT_ATOL)
    assert lc.loops_closed == 1 and lc.last_loop_kf == kf_id


def _threaded_correction(gold, tmp_path, monkeypatch):
    """Async: the correction runs with the map lock held, as the mapping job
    holds it from add_keyframe to the end of try_close; a second thread that
    tries to insert a keyframe during the essential graph's solve waits
    until the write-back is done; the keyframes of the snapshot land where
    lock-step's do, and the inserted one keeps the pose it was given."""
    g = {k[5:]: v for k, v in gold.items() if k.startswith("mono_")}
    slam = _slam_from_checkpoint(gold, "mono_ckpt_", tmp_path / "ckpt_async.npz",
                                 vocabulary=_vocabulary(gold, "mono_"), enable_loop_closing=True, async_mapping=True)
    lc, m = slam.loop_closer, slam.map
    ref = m.keyframes[max(m.keyframes)]
    c, s_ = np.cos(0.05), np.sin(0.05)
    r_new = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]], np.float32) @ ref.r_cw
    t_new = ref.t_cw + np.array([0.1, -0.02, 0.03], np.float32)
    new_id, threads = [], []
    waiting = threading.Event()
    solve = loop_closing.optimize_sim3_graph

    def insert():
        waiting.set()
        with slam.map_lock:
            n = len(ref.valid)
            new_id.append(m.add_keyframe(KeyFrameData(
                kf_id=-1, timestamp=ref.timestamp + 0.1, r_cw=r_new.copy(), t_cw=t_new.copy(), xy=ref.xy.copy(),
                level=ref.level.copy(), angle=ref.angle.copy(), desc01=ref.ensure_desc01().copy(),
                valid=ref.valid.copy(), point_idx=np.full(n, -1, np.int32))))

    def solving(*a, **kw):
        threads.append(threading.Thread(target=insert))
        threads[0].start()
        assert waiting.wait(timeout=30)
        threads[0].join(timeout=0.2)
        assert not new_id, "a keyframe was inserted during the essential graph's solve"
        return solve(*a, **kw)

    monkeypatch.setattr(loop_closing, "optimize_sim3_graph", solving)
    lc.gba_fn = lambda anchor, scale: None
    version = m.version
    with slam.map_lock:
        assert lc.correct(int(g["kf"]), int(g["cand"]), float(g["sim3_s"]), g["sim3_r"], g["sim3_t"],
                          pairs=(g["sim3_cur_pts"], g["sim3_loop_pts"]))
        assert not new_id, "a keyframe was inserted before the correction's write-back"
    threads[0].join(timeout=30)
    assert new_id and m.version > version
    ids = g["corr_kf_ids"].tolist()
    np.testing.assert_allclose(np.stack([m.keyframes[i].r_cw for i in ids]), g["corr_r_cw"], rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(np.stack([m.keyframes[i].t_cw for i in ids]), g["corr_t_cw"], rtol=0, atol=POSE_ATOL)
    kf = m.keyframes[new_id[0]]
    np.testing.assert_array_equal(kf.r_cw, r_new)
    np.testing.assert_array_equal(kf.t_cw, t_new)
    slam.shutdown()


def _golden_gba_matches(gold, tmp_path):
    g = {k[5:]: v for k, v in gold.items() if k.startswith("mono_")}
    slam = _slam_from_checkpoint(gold, "mono_gck_", tmp_path / "gck.npz")
    ids = sorted(slam.map.keyframes)
    anchor, scale = int(g["corr_anchor"]), dict(zip(ids, g["corr_scale"]))
    slam._post_loop_gba(anchor, scale)
    ids, r, t, pts, xyz = _poses_points(slam.map)

    # async: the same solve, in the loop job as in lock-step, writes back
    # the same map
    threaded = _slam_from_checkpoint(gold, "mono_gck_", tmp_path / "gck.npz", async_mapping=True)
    threads = threading.active_count()
    threaded._post_loop_gba(anchor, scale)
    assert threading.active_count() == threads  # no thread of its own
    threaded.wait_mapping_idle()
    for a, b in zip(_poses_points(threaded.map)[1:], (r, t, pts, xyz)):
        np.testing.assert_array_equal(a, b)
    threaded.shutdown()
    assert ids == g["gba_kf_ids"].tolist()
    np.testing.assert_allclose(r, g["gba_r_cw"], rtol=0, atol=GBA_POSE_ATOL)
    np.testing.assert_allclose(t, g["gba_t_cw"], rtol=0, atol=GBA_POSE_ATOL)
    common, ia, ib = np.intersect1d(pts, g["gba_pt_ids"], return_indices=True)
    assert len(common) >= 0.99 * len(g["gba_pt_ids"])
    assert np.median(np.linalg.norm(xyz[ia] - g["gba_pt_xyz"][ib], axis=1)) <= GBA_POINT_MEDIAN


def test_loop_closing_matches_reference(tmp_path, monkeypatch):
    _constructed_drift_closes(np.random.default_rng(42))
    gold = load(LOOP_GOLDEN)
    _golden_loop_matches(gold, tmp_path, monkeypatch)
    _threaded_correction(gold, tmp_path, monkeypatch)
    _golden_gba_matches(gold, tmp_path)
