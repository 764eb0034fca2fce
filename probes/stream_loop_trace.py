"""Where a streaming MonoSlam loop run on the card loses its accuracy:
chip_smoke.py phase 9's streaming run with loop closing (the 100-frame
noisy circuit fed at the camera's 10 fps), warmed up first by a lock-step
loop run, then repeated, with a trace of each run.

    python3 probes/stream_loop_trace.py [runs] [--async] [--both] [--own]

(`--both`: the runs in async, then as many streaming; `--own`: the threaded
runs draw their own two-view RANSAC samples, as chip_smoke.py's async loop
run does, where by default every run replays the reference's draws.) Per
run: the loops closed and the Sim3 ATE against the threaded envelope
max(5 x the lock-step loop run's, 0.20 m); the loop trace (the lock-step run
too): each mapping job's keyframe, the frames at which the job started and
ended, whether its keyframe was culled (and by which job) before it
reached place recognition, `LoopCloser.detect`'s candidates with their
scores and consistency counts, and the keyframes the queue-depth gate
refused (frames whose interval or ratio rule fired while two jobs were
unfinished); per frame its state, inliers, frames in flight, its position error
after the run's own Sim3 alignment (cm), the motion model's prediction
error (cm, async), the shift a re-base gave the last frame (cm, async),
the jobs unfinished when it entered and whether it became a keyframe; the
events with the frame being dispatched when they happened (loop
correction begin and end, post-loop GBA begin and end, local BA
write-backs with the frames the tracker was ahead of the solve's snapshot
and the largest keyframe shift, stream failures, carry
re-anchors over 1 cm, a map publish while a frame was tracked
synchronously); each keyframe's position error at the end (cm)."""
import sys, time, numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from viorb_tpu_torch.bow import train_vocabulary  # noqa: E402
from viorb_tpu_torch.eval.ate import associate, umeyama_alignment  # noqa: E402
from viorb_tpu_torch.features.extractor import OrbExtractor  # noqa: E402
from viorb_tpu_torch.geometry.camera import PinholeCamera  # noqa: E402
from viorb_tpu_torch.io import synthetic  # noqa: E402
from viorb_tpu_torch.slam.mono import MonoSlam  # noqa: E402

RUNS = int(next((a for a in sys.argv[1:] if a.isdigit()), 4))
ASYNC = "--async" in sys.argv
BOTH = "--both" in sys.argv
OWN = "--own" in sys.argv
tag = cs._card()
print(tag, flush=True)
dev = torch.device("cuda")
cam = PinholeCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
z = np.load("tests/torch_loop_golden.npz")
draws = [tuple(z[f"mono_two_view{i}_{k}"] for k in ("x1", "valid", "idx_h", "idx_f"))
         for i in range(int(z["mono_two_view_calls"]))]
seq = synthetic.make_sequence(100, cam=cam, dt=0.1, kind="circuit", noise_std=4.0, device=dev)
ex = OrbExtractor(n_features=600)
descs = []
for i in range(0, 100, 12):
    f = ex.extract(seq.images[i], device=dev)
    descs.append(f.desc01[f.valid].cpu().numpy())
vocab = train_vocabulary(np.concatenate(descs), k=8, depth=3)
CFG = dict(n_features=800, kf_max_interval=5)
cur = [0]
events = []
frame_log = {}  # frame -> dict of what the instrumentation saw
jobs_log = {}  # kf id -> what its mapping job saw
gate_refused = []  # frames whose keyframe rule fired but the queue-depth gate refused
lock_ate = [None]


def ev(what):
    events.append((cur[0], time.perf_counter(), what))


def errors(slam):
    tr = slam.trajectory_tum()
    ia, ib = associate(tr[:, 0], seq.timestamps, 0.02)
    s, R, t = umeyama_alignment(tr[ia, 1:4], seq.c_w[ib], True)
    err = np.linalg.norm(seq.c_w[ib] - (s * (tr[ia, 1:4] @ R.T) + t), axis=1)
    per_frame = dict(zip(ib.tolist(), err.tolist()))
    kf_err = []
    with slam.map_lock:
        for k in sorted(slam.map.keyframes):
            kf = slam.map.keyframes[k]
            c = -kf.r_cw.T @ kf.t_cw
            fi = int(np.argmin(np.abs(seq.timestamps - kf.timestamp)))
            kf_err.append((k, fi, float(np.linalg.norm(seq.c_w[fi] - (s * (R @ c) + t)))))
    return float(np.sqrt((err ** 2).mean())), per_frame, kf_err, (s, R, t)


def trace_loop(slam):
    """Each mapping job's frames, culls and place recognition; the gate."""
    jobs_log.clear()
    gate_refused.clear()
    lc = slam.loop_closer
    orig_job = slam._mapping_job

    def job(kf_id):
        rec = jobs_log.setdefault(kf_id, {})
        rec["start"] = cur[0]
        rec["queued_behind"] = slam.map._next_kf - 1 - kf_id
        out = orig_job(kf_id)
        rec["end"] = cur[0]
        return out
    slam._mapping_job = job
    orig_on_cull = slam._on_cull
    running = {}

    def on_cull(k):
        jobs_log.setdefault(k, {})["culled_by"] = (running.get("kf"), cur[0])
        return orig_on_cull(k)
    slam._on_cull = on_cull
    orig_cull = slam._cull_keyframes

    def cull(window):
        running["kf"] = window[0]
        return orig_cull(window)
    slam._cull_keyframes = cull
    orig_add = lc.add_keyframe

    def add(kf_id, *a, **kw):
        jobs_log.setdefault(kf_id, {})["bow"] = True
        return orig_add(kf_id, *a, **kw)
    lc.add_keyframe = add
    orig_cands = lc.db.detect_loop_candidates

    def cands(kf_id, *a, **kw):
        out = orig_cands(kf_id, *a, **kw)
        jobs_log.setdefault(kf_id, {})["cands"] = [(c, round(float(sc), 3)) for c, sc in out]
        return out
    lc.db.detect_loop_candidates = cands
    orig_detect = lc._detect

    def detect(kf_id):
        best = orig_detect(kf_id)
        rec = jobs_log.setdefault(kf_id, {})
        rec["detect"] = best
        rec["consistency"] = max(lc._consistency.values(), default=0)
        if "cands" not in rec:
            rec["cands"] = "not queried (cooldown or no BoW)"
        return best
    lc._detect = detect
    orig_need = slam._need_new_keyframe

    def need(ts):
        out = orig_need(ts)
        if not out and slam.async_mapping and slam._mapping_queue.unfinished_tasks >= 2 \
                and not (slam.suppress_keyframes or slam.localization_only or slam.n_tracked <= 15):
            with slam.map_lock:
                ref = int((slam.map.keyframes[slam.last_kf_id].point_idx >= 0).sum())
            if slam.frames_since_kf >= slam.kf_max_interval or (
                    slam.frames_since_kf >= slam.kf_min_interval and slam.n_tracked < 0.6 * max(ref, 1)):
                gate_refused.append(cur[0])
        return out
    slam._need_new_keyframe = need


def print_loop_trace(slam):
    print("  gate refused at frames " + (" ".join(map(str, gate_refused)) or "none"))
    for k in sorted(jobs_log):
        r = jobs_log[k]
        if "start" not in r and "culled_by" not in r:
            continue
        culled = f" culled by job {r['culled_by'][0]} at frame {r['culled_by'][1]}" if "culled_by" in r else ""
        where = "no BoW (culled first)" if not r.get("bow") else (
            f"candidates {r.get('cands')} consistency {r.get('consistency')} -> {r.get('detect')}")
        print(f"  kf {k}: job frames {r.get('start')}-{r.get('end')} ({r.get('queued_behind', 0)} newer "
              f"keyframes made before it started){culled}; {where}")


def instrument(slam):
    orig_correct = slam.loop_closer.correct

    def correct(*a, **kw):
        ev(f"correct begin kf {a[0]} cand {a[1]}")
        out = orig_correct(*a, **kw)
        ev("correct end")
        return out
    slam.loop_closer.correct = correct
    orig_gba = slam.loop_closer.gba_fn

    def gba(anchor, scale_by_kf=None):
        ev("GBA begin")
        out = orig_gba(anchor, scale_by_kf)
        ev("GBA end")
        return out
    slam.loop_closer.gba_fn = gba
    orig_apply = slam._apply_ba_result
    orig_local = slam._local_ba
    solve_frame = {}

    def local_ba(*a, **kw):
        solve_frame[slam.map._next_kf] = cur[0]
        return orig_local(*a, **kw)
    slam._local_ba = local_ba

    def centers():
        return {k: -kf.r_cw.T @ kf.t_cw for k, kf in slam.map.keyframes.items()}

    def apply(*a, **kw):
        with slam.map_lock:
            before = centers()
        out = orig_apply(*a, **kw)
        with slam.map_lock:
            after = centers()
        shift = max((float(np.linalg.norm(after[k] - before[k])) for k in before if k in after), default=0.0)
        carried = [k for k in after if k >= a[8] and k not in a[0]]
        ev(f"BA write-back ({len(a[0])} kfs, tracker {cur[0] - solve_frame.get(a[8], cur[0])} "
           f"frames past the snapshot, largest kf shift {shift:.4f}, carried {carried})")
        return out
    slam._apply_ba_result = apply
    orig_rebase = slam._rebase_last_frame

    def rebase():
        last = slam.last_frame
        c0 = None if last is None or last.r_cw is None else -last.r_cw.T @ last.t_cw
        out = orig_rebase()
        if c0 is not None and last.r_cw is not None:
            d = float(np.linalg.norm(-last.r_cw.T @ last.t_cw - c0))
            if d > 0:
                log = frame_log.setdefault(cur[0], {})
                log["rebase"] = log.get("rebase", 0.0) + d
        return out
    slam._rebase_last_frame = rebase
    orig_pred = slam._predict_pose

    def predict():
        r, t = orig_pred()
        frame_log.setdefault(cur[0], {})["pred"] = (r.copy(), t.copy())
        return r, t
    slam._predict_pose = predict
    orig_re = slam._reanchor_carry

    def reanchor():
        n = len(slam.carry_deltas)
        out = orig_re()
        if len(slam.carry_deltas) != n or (n == 256):
            d = slam.carry_deltas[-1]
            if d[0] > 0.01 or d[1] > 0.01:
                ev(f"carry re-anchor |dt| {d[0]:.3f} |dR| {d[1]:.3f}")
        return out
    slam._reanchor_carry = reanchor
    orig_track = slam._track_fused

    def track(image, ts):
        v = slam.map.version
        out = orig_track(image, ts)
        if slam.map.version != v:
            ev(f"map published while frame {cur[0]} was tracked synchronously")
        return out
    slam._track_fused = track


def run(mode):
    events.clear()
    frame_log.clear()
    kw = dict(streaming=True) if mode == "streaming" else dict(async_mapping=True) if mode == "async" else {}
    slam = MonoSlam(cam, device=dev, vocabulary=vocab, enable_loop_closing=True, **kw, **CFG)
    trace_loop(slam)
    if mode != "lock-step":
        instrument(slam)
    rows, t_start, failed = [], time.perf_counter(), False
    replay = cs._two_view_replay([] if OWN and mode != "lock-step" else draws)
    try:
        with replay:
            for i in range(100):
                cur[0] = i
                frame_log.setdefault(i, {})["jobs"] = slam._mapping_queue.unfinished_tasks
                kfs = slam.map._next_kf
                ts = float(seq.timestamps[i])
                if mode != "lock-step":
                    time.sleep(max(0.0, t_start + ts - time.perf_counter()))
                info = slam.process_frame(seq.images[i], ts)
                if getattr(slam, "_stream_failed", False) and not failed:
                    ev("stream failed")
                failed = getattr(slam, "_stream_failed", False)
                rows.append((info["state"], info["n_tracked"], info.get("queued", 0)))
                frame_log[i]["kf"] = slam.map._next_kf > kfs
        slam.wait_mapping_idle()
        ate, per_frame, kf_err, sim3 = errors(slam)
    finally:
        slam.shutdown()
    if mode == "lock-step":
        lock_ate[0] = ate
    bound = max(5.0 * lock_ate[0], 0.20)
    ok = slam.loop_closer.loops_closed >= 1 and ate <= bound
    print(f"{tag} {mode} loop run{' (own two-view draw)' if OWN and mode != 'lock-step' else ''}: loops "
          f"{slam.loop_closer.loops_closed}, Sim3 ATE {ate:.4f} m (envelope {bound:.4f} m: "
          f"{'within' if ok else 'MISSED'}), {len(per_frame)} trajectory frames, {len(slam.map.keyframes)} "
          f"keyframes", flush=True)
    print_loop_trace(slam)
    if mode == "lock-step":
        return ok
    print("  states  " + "".join(r[0][0] for r in rows))
    print("  inliers " + " ".join(str(r[1]) for r in rows))
    print("  queued  " + "".join(str(min(r[2], 9)) for r in rows))
    print("  err cm  " + " ".join(f"{i}:{per_frame[i] * 100:.0f}" if i in per_frame else f"{i}:-" for i in range(100)))
    if mode == "async":
        s, R, t = sim3
        pe = []
        for i in range(100):
            pr = frame_log.get(i, {}).get("pred")
            pe.append(f"{i}:-" if pr is None else
                      f"{i}:{np.linalg.norm(seq.c_w[i] - (s * (R @ (-pr[0].T @ pr[1])) + t)) * 100:.0f}")
        print("  pred err cm " + " ".join(pe))
        print("  rebase cm " + " ".join(f"{i}:{frame_log[i]['rebase'] * s * 100:.1f}" for i in range(100)
                                        if frame_log.get(i, {}).get("rebase")))
    print("  jobs    " + "".join(str(min(frame_log.get(i, {}).get("jobs", 0), 9)) for i in range(100)))
    print("  kf      " + "".join("K" if frame_log.get(i, {}).get("kf") else "." for i in range(100)))
    print("  kf err cm " + " ".join(f"{k}@{fi}:{e * 100:.0f}" for k, fi, e in kf_err))
    t0 = events[0][1] if events else 0.0
    print("  events " + "; ".join(f"f{f} +{t - t0:.2f}s {w}" for f, t, w in events), flush=True)
    return ok


run("lock-step")  # warm-up, as chip_smoke runs the lock-step loop pair first
for mode in (["async", "streaming"] if BOTH else ["async" if ASYNC else "streaming"]):
    results = [run(mode) for _ in range(RUNS)]
    print(f"{tag} {mode}: {sum(results)} of {RUNS} loop runs closed a loop within the envelope", flush=True)
