"""Async MonoViSlam at tests/test_async_vi.py's configuration, run after run,
on the card: how often the un-paced async run meets the test's contract.

    python3 probes/async_vi_runs.py [runs] [--own] [--trace]
    python3 probes/async_vi_runs.py [runs] --laps

chip_smoke.py's run, repeated: the 60-frame arc with the 200 Hz IMU, 800
features, VI init after 2.5 s and 8 keyframes, a keyframe at least every 5
frames, frames fed as fast as the tracker takes them, then
wait_mapping_idle and one last drain; the two-view hypotheses of the
reference's seed-0 run replayed (`--own`: the port's own draw, seed 0).
A warm-up run first (graph captures), then `runs` runs (default 10). Per run:
VI ready, frames OK, gravity cos, metric ATE, whether the contract holds
(VI ready, > 60 % OK, cos > 0.99, ATE < 0.12 m), re-bases, BAs skipped,
jobs, the VI BAs; with `--trace`, also the Sim3 ATE and scale, each frame's
metric error (cm, SE3 alignment), the keyframes' times, and the worker's
VI events (init, each VI BA) by the frame the tracker was on; last, the
count of runs that meet the contract.

`--laps`: chip_smoke.py's run past VI init's refinement window instead
(`_vi_laps_run`: the 300-frame laps with the IMU at the same
configuration, the port's own draw): one lock-step run, then `runs` async
runs at the camera's 10 fps and `runs` fed un-paced (after one async
frame that captures the graphs), each with its outcome
and its concurrent regime (frames past the window beside a running job,
BAs skipped, keyframe decisions under the 1.5 s gap, keyframes carried,
frames tracked across a write-back)."""
import contextlib
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from viorb_tpu_torch import default_device  # noqa: E402
from viorb_tpu_torch.eval.ate import ate_rmse  # noqa: E402
from viorb_tpu_torch.geometry.camera import PinholeCamera  # noqa: E402
from viorb_tpu_torch.io import synthetic  # noqa: E402
from viorb_tpu_torch.slam.mono_vi import MonoViSlam  # noqa: E402

RUNS = int(next((a for a in sys.argv[1:] if a.isdigit()), 10))
OWN = "--own" in sys.argv
TRACE = "--trace" in sys.argv
tag = cs._card()
print(tag, flush=True)
dev = default_device()
cam = PinholeCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
if "--laps" in sys.argv:
    laps, laps_imu = cs._vi_laps(cam, dev)
    launches = {}
    warm = MonoViSlam(cam, device=dev, async_mapping=True, **cs.VI_CONFIG)
    try:  # the graph captures, before the counted runs
        warm.process_frame_vi(laps.images[0], float(laps.timestamps[0]), [])
    finally:
        warm.shutdown()
    cs._vi_laps_run(cam, laps, laps_imu, tag, launches, paced=False, async_mapping=False)
    for paced in (True, False):
        for _ in range(RUNS):
            cs._vi_laps_run(cam, laps, laps_imu, tag, launches, paced=paced)
    sys.exit(0)
with np.load(os.path.join("tests", "torch_vi_golden.npz")) as z:
    name = cs.VI_GOLDENS[0]
    draws = [tuple(z[f"{name}_two_view{i}_{k}"] for k in ("x1", "valid", "idx_h", "idx_f"))
             for i in range(int(z[f"{name}_two_view_calls"]))]
seq = synthetic.make_sequence(cs.VI_FRAMES, cam=cam, dt=cs.VI_DT, device=dev)
imu = synthetic.make_imu(cs.VI_FRAMES, cs.VI_DT, hz=200.0)
samples, prev = [], -np.inf
for ts in seq.timestamps:
    sel = (imu.t > prev) & (imu.t <= ts)
    samples.append([(float(t), g, a) for t, g, a in zip(imu.t[sel], imu.gyro[sel], imu.acc[sel])])
    prev = ts


def run():
    slam = MonoViSlam(cam, device=dev, async_mapping=True, **cs.VI_CONFIG)
    states, t0, cur, events = [], time.perf_counter(), [0], []
    if TRACE:
        for name in ("_apply_init_result", "_vi_local_ba", "_drain_tracker_rebase"):
            fn = getattr(slam, name)

            def traced(*a, _fn=fn, _name=name, **kw):
                n = slam.rebases
                out = _fn(*a, **kw)
                if _name != "_drain_tracker_rebase" or slam.rebases != n:
                    events.append(f"f{cur[0]} {_name} {kw.get('window_size', '')}{'gw' if kw.get('optimize_gravity') else ''}")
                return out
            setattr(slam, name, traced)
    try:
        with contextlib.nullcontext() if OWN else cs._two_view_replay(draws):
            for i, (image, ts, imu_samples) in enumerate(zip(seq.images, seq.timestamps, samples)):
                cur[0] = i
                states.append(slam.process_frame_vi(image, float(ts), imu_samples)["state"])
        slam.wait_mapping_idle()
        slam._drain_tracker_rebase()
        wall = time.perf_counter() - t0
        traj = slam.trajectory_tum()
    finally:
        slam.shutdown()
    g = np.asarray(slam.gravity if slam.gravity is not None else np.zeros(3), np.float64)
    cos = float(g @ synthetic.GRAVITY_W / max(np.linalg.norm(g) * np.linalg.norm(synthetic.GRAVITY_W), 1e-12))
    ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=False)
    n_ok = states.count("OK")
    ok = slam.vi_ready and n_ok > 0.6 * cs.VI_FRAMES and cos > 0.99 and ate < 0.12
    if TRACE:
        from viorb_tpu_torch.eval.ate import associate, umeyama_alignment

        ia, ib = associate(traj[:, 0], seq.timestamps)
        sim3 = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)
        s_, r_, t_ = umeyama_alignment(traj[ia, 1:4], seq.c_w[ib], True)
        _, r1, t1 = umeyama_alignment(traj[ia, 1:4], seq.c_w[ib], False)
        err = np.linalg.norm(seq.c_w[ib] - (traj[ia, 1:4] @ r1.T + t1), axis=1)
        with slam.map_lock:
            kf_t = sorted(kf.timestamp for kf in slam.map.keyframes.values())
        print(f"  Sim3 ATE {sim3:.4f} m, scale {s_:.4f}; metric err cm "
              + " ".join(f"{j}:{e * 100:.0f}" for j, e in zip(ib.tolist(), err.tolist()) if j % 2 == 0)
              + "; keyframes at frames " + " ".join(f"{t / cs.VI_DT:.0f}" for t in kf_t)
              + "; events " + "; ".join(events))
    print(f"{tag} async MonoViSlam ({'own draw, seed 0' if OWN else 'the reference seed-0 draw'}): VI ready "
          f"{slam.vi_ready}, {n_ok} of {cs.VI_FRAMES} OK, gravity cos {cos:.6f}, metric ATE {ate:.4f} m, contract "
          f"{'met' if ok else 'MISSED'}; re-bases {slam.rebases}, BAs skipped {slam.ba_skipped}, "
          f"{len(slam.job_times)} jobs, {wall:.2f} s; states {''.join(s[0] for s in states)}; VI BAs (kind, K, ms) "
          + ", ".join(f"{k} {n} {ms:.0f}" for k, n, ms in slam.vi_ba_times), flush=True)
    return ok


run()  # warm-up: the graph captures
met = sum(run() for _ in range(RUNS))
print(f"{tag} async MonoViSlam at tests/test_async_vi.py's configuration: the contract met in {met} of {RUNS} runs")
