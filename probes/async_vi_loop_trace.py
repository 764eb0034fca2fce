"""Async MonoViSlam with loop closing at the camera's rate, traced: chip_smoke.py
phase 9's run (the 100-frame noisy circuit with the biased 200 Hz IMU,
800 features, a keyframe at least every 5 frames, VI init after 2.5 s and 8
keyframes, the reference's two-view draw replayed), after a lock-step VI
loop run as warm-up.

    python3 probes/async_vi_loop_trace.py [runs]

Per run: loops, Sim3 and metric ATE, re-bases, BAs skipped; per frame its
state (N not initialized, O OK, I IMU_ONLY, L LOST, R in the
relocalization bias re-solve), inliers, host ms, whether it made a
keyframe and the jobs unfinished at its entry; the worker's events (VI
init, each VI BA, the loop correction) by the frame the tracker was on."""
import sys, time, numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from viorb_tpu_torch.bow import train_vocabulary  # noqa: E402
from viorb_tpu_torch.eval.ate import ate_rmse  # noqa: E402
from viorb_tpu_torch.features.extractor import OrbExtractor  # noqa: E402
from viorb_tpu_torch.geometry.camera import PinholeCamera  # noqa: E402
from viorb_tpu_torch.io import synthetic  # noqa: E402
from viorb_tpu_torch.slam.mono_vi import MonoViSlam  # noqa: E402

RUNS = int(next((a for a in sys.argv[1:] if a.isdigit()), 2))
tag = cs._card()
print(tag, flush=True)
dev = torch.device("cuda")
cam = PinholeCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
z = np.load("tests/torch_loop_golden.npz")
draws = [tuple(z[f"vi_two_view{i}_{k}"] for k in ("x1", "valid", "idx_h", "idx_f"))
         for i in range(int(z["vi_two_view_calls"]))]
seq = synthetic.make_sequence(100, cam=cam, dt=0.1, kind="circuit", noise_std=4.0, device=dev)
imu = synthetic.make_imu(100, 0.1, hz=200.0, kind="circuit", noise_g=0.002, noise_a=0.03,
                         bias_g=np.array([0.002, -0.001, 0.0015], np.float32),
                         bias_a=np.array([0.03, -0.02, 0.01], np.float32))
samples, prev = [], -np.inf
for ts in seq.timestamps:
    sel = (imu.t > prev) & (imu.t <= ts)
    samples.append([(float(t), g, a) for t, g, a in zip(imu.t[sel], imu.gyro[sel], imu.acc[sel])])
    prev = ts
ex = OrbExtractor(n_features=600)
descs = []
for i in range(0, 100, 12):
    f = ex.extract(seq.images[i], device=dev)
    descs.append(f.desc01[f.valid].cpu().numpy())
vocab = train_vocabulary(np.concatenate(descs), k=8, depth=3)


def run(async_mapping):
    slam = MonoViSlam(cam, device=dev, vocabulary=vocab, enable_loop_closing=True, async_mapping=async_mapping,
                      **cs.LOOP_VI_CONFIG)
    cur, events, rows = [0], [], []
    for name in ("_apply_init_result", "_vi_local_ba"):
        fn = getattr(slam, name)

        def traced(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            events.append(f"f{cur[0]} {_name} {kw.get('window_size', '')}{'gw' if kw.get('optimize_gravity') else ''}")
            return out
        setattr(slam, name, traced)
    correct = slam.loop_closer.correct

    def traced_correct(*a, **kw):
        events.append(f"f{cur[0]} loop correction")
        return correct(*a, **kw)
    slam.loop_closer.correct = traced_correct
    t_start = time.perf_counter()
    try:
        with cs._two_view_replay(draws):
            for i in range(100):
                cur[0] = i
                ts = float(seq.timestamps[i])
                if async_mapping:
                    time.sleep(max(0.0, t_start + ts - time.perf_counter()))
                kfs, jobs, t0 = slam.map._next_kf, slam._mapping_queue.unfinished_tasks, time.perf_counter()
                info = slam.process_frame_vi(seq.images[i], ts, samples[i])
                state = "R" if slam.reloc_bias_prepare else info["state"][0]
                rows.append((state, info["n_tracked"], (time.perf_counter() - t0) * 1e3, slam.map._next_kf > kfs, jobs))
        slam.wait_mapping_idle()
        if async_mapping:
            slam._drain_tracker_rebase()
        traj = slam.trajectory_tum()
    finally:
        slam.shutdown()
    sim3 = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)
    metric = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=False)
    print(f"{tag} {'async' if async_mapping else 'lock-step'} VI loop run: loops {slam.loop_closer.loops_closed}, "
          f"Sim3 ATE {sim3:.4f} m, metric {metric:.4f} m, VI ready {slam.vi_ready}, re-bases "
          f"{getattr(slam, 'rebases', 0)}, BAs skipped {slam.ba_skipped}, {len(slam.job_times)} jobs, "
          f"{len(traj)} trajectory frames", flush=True)
    print("  states  " + "".join(r[0] for r in rows))
    print("  inliers " + " ".join(str(r[1]) for r in rows))
    print("  ms      " + " ".join(f"{r[2]:.0f}" for r in rows))
    print("  kf      " + "".join("K" if r[3] else "." for r in rows))
    print("  jobs    " + "".join(str(min(r[4], 9)) for r in rows))
    print("  events  " + "; ".join(events), flush=True)


run(False)
for _ in range(RUNS):
    run(True)
