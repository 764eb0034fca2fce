"""Where a streaming MonoSlam loop run on the card loses its accuracy:
chip_smoke.py phase 9's streaming run with loop closing (the 100-frame
noisy circuit fed at the camera's 10 fps), warmed up first by a lock-step
loop run, then repeated, with a trace of each run.

    python3 probes/stream_loop_trace.py [runs] [--async]

Per run: the Sim3 ATE; per frame its state, inliers, frames in flight and
its position error after the run's own Sim3 alignment (cm); the events
with the frame being dispatched when they happened (loop correction begin
and end, post-loop GBA begin, applied or dropped, local BA write-backs
applied or dropped, stream failures, carry re-anchors over 1 cm, a map
publish while a frame was tracked synchronously); each
keyframe's position error at the end (cm)."""
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
    return float(np.sqrt((err ** 2).mean())), per_frame, kf_err


def instrument(slam):
    orig_correct = slam.loop_closer.correct

    def correct(*a, **kw):
        ev(f"correct begin kf {a[0]} cand {a[1]}")
        out = orig_correct(*a, **kw)
        ev("correct end")
        return out
    slam.loop_closer.correct = correct
    orig_gba = slam._post_loop_gba_impl

    def gba(anchor, scale_by_kf, epoch):
        ev(f"GBA begin (epoch {epoch})")
        out = orig_gba(anchor, scale_by_kf, epoch)
        ev(f"GBA end (epoch now {slam._loop_epoch})")
        return out
    slam._post_loop_gba_impl = gba
    orig_apply = slam._apply_ba_result

    def apply(*a, **kw):
        out = orig_apply(*a, **kw)
        ev(f"BA write-back {'applied' if out else 'dropped'} ({len(a[0])} kfs)")
        return out
    slam._apply_ba_result = apply
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
    kw = dict(streaming=True) if mode == "streaming" else dict(async_mapping=True) if mode == "async" else {}
    slam = MonoSlam(cam, device=dev, vocabulary=vocab, enable_loop_closing=True, **kw, **CFG)
    if mode != "lock-step":
        instrument(slam)
    rows, t_start, failed = [], time.perf_counter(), False
    try:
        with cs._two_view_replay(draws):
            for i in range(100):
                cur[0] = i
                ts = float(seq.timestamps[i])
                if mode != "lock-step":
                    time.sleep(max(0.0, t_start + ts - time.perf_counter()))
                info = slam.process_frame(seq.images[i], ts)
                if getattr(slam, "_stream_failed", False) and not failed:
                    ev("stream failed")
                failed = getattr(slam, "_stream_failed", False)
                rows.append((info["state"], info["n_tracked"], info.get("queued", 0)))
        slam.wait_mapping_idle()
        ate, per_frame, kf_err = errors(slam)
    finally:
        slam.shutdown()
    print(f"{tag} {mode} loop run: loops {slam.loop_closer.loops_closed}, Sim3 ATE {ate:.4f} m, "
          f"{len(per_frame)} trajectory frames, {len(slam.map.keyframes)} keyframes", flush=True)
    if mode == "lock-step":
        return
    print("  states  " + "".join(r[0][0] for r in rows))
    print("  inliers " + " ".join(str(r[1]) for r in rows))
    print("  queued  " + "".join(str(min(r[2], 9)) for r in rows))
    print("  err cm  " + " ".join(f"{i}:{per_frame[i] * 100:.0f}" if i in per_frame else f"{i}:-" for i in range(100)))
    print("  kf err cm " + " ".join(f"{k}@{fi}:{e * 100:.0f}" for k, fi, e in kf_err))
    t0 = events[0][1] if events else 0.0
    print("  events " + "; ".join(f"f{f} +{t - t0:.2f}s {w}" for f, t, w in events), flush=True)


run("lock-step")  # warm-up, as chip_smoke runs the lock-step loop pair first
for _ in range(RUNS):
    run("async" if ASYNC else "streaming")
