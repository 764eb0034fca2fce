"""The loop paths of chip_smoke.py's phase 9 that the default mode leaves
open, on the card:

1. reproducibility: the vision BA and the MonoSlam / MonoViSlam loop pairs
   (the reference's two-view draws replayed) in the default mode, run
   twice, with `index_add_`'s float atomics as they are ("atomic") and
   with the sorted accumulation of `index_put_(accumulate=True)` in their
   place ("sorted"): each run's Sim3 (and VI metric) ATE, BA ms an LM
   iteration, its host syncs, and whether two runs agree bit for bit;
2. streaming MonoSlam with loop closing (four runs) and without on the
   circuit fed at the camera's 10 fps: per frame the state, tracked
   points, frames in flight and keyframes, the slow dispatches, the jobs
   and the phases of those over 500 ms, the ATE;
3. async MonoSlam with loop closing at the camera's rate: the tracker's
   frame times around the closure.

    python3 probes/loop_modes.py [reproducibility] [streaming] [async]

(no argument: all three)."""
import os, sys, time, contextlib, numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from viorb_tpu_torch.bow import train_vocabulary
from viorb_tpu_torch.eval.ate import ate_rmse
from viorb_tpu_torch.features.extractor import OrbExtractor
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.io import synthetic
from viorb_tpu_torch.slam.mono import MonoSlam
from viorb_tpu_torch.slam.mono_vi import MonoViSlam

PARTS = set(sys.argv[1:]) or {"reproducibility", "streaming", "async"}
tag = cs._card()
print(tag, flush=True)
dev = torch.device("cuda")
cam = PinholeCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
z = np.load("tests/torch_loop_golden.npz")
draws = {r: [tuple(z[f"{r}_two_view{i}_{k}"] for k in ("x1", "valid", "idx_h", "idx_f"))
             for i in range(int(z[f"{r}_two_view_calls"]))] for r in ("mono", "vi")}
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
CFG = dict(n_features=800, kf_max_interval=5)
VI_CFG = dict(CFG, vi_init_min_time=2.5, vi_init_min_kfs=8)

_index_add = torch.Tensor.index_add_


def _sorted_index_add(self, dim, index, source, alpha=1):
    if self.is_cuda and self.is_floating_point() and dim == 0 and alpha == 1:
        return self.index_put_((index,), source, accumulate=True)
    return _index_add(self, dim, index, source, alpha=alpha)


@contextlib.contextmanager
def accumulation(kind):
    if kind == "sorted":
        torch.Tensor.index_add_ = _sorted_index_add
    try:
        yield
    finally:
        torch.Tensor.index_add_ = _index_add


def ate(slam, scale=True):
    tr = slam.trajectory_tum()
    return ate_rmse(tr[:, 0], tr[:, 1:4], seq.timestamps, seq.c_w, with_scale=scale), tr


def run(kind, vi, close, timed=None):
    cls, cfg = (MonoViSlam, VI_CFG) if vi else (MonoSlam, CFG)
    slam = cls(cam, device=dev, vocabulary=vocab, enable_loop_closing=close, **cfg)
    if timed is not None and slam.loop_closer is not None:
        gba = slam.loop_closer.gba_fn

        def wrapped(*a):
            torch.cuda.synchronize(); t = time.perf_counter()
            gba(*a)
            torch.cuda.synchronize(); timed.append((time.perf_counter() - t) * 1e3)
        slam.loop_closer.gba_fn = wrapped
    t0 = time.perf_counter()
    with accumulation(kind), cs._two_view_replay(draws["vi" if vi else "mono"]):
        for i in range(100):
            img, ts = seq.images[i], float(seq.timestamps[i])
            slam.process_frame_vi(img, ts, samples[i]) if vi else slam.process_frame(img, ts)
    wall = time.perf_counter() - t0
    s, tr = ate(slam)
    m, _ = ate(slam, False)
    jobs = [j["total"] for j in slam.job_times]
    return dict(sim3=s, metric=m, loops=0 if slam.loop_closer is None else slam.loop_closer.loops_closed,
                traj=tr, wall=wall, job_med=float(np.median(jobs)), job_sum=float(np.sum(jobs)))


if "reproducibility" in PARTS:
    from viorb_tpu_torch.interop import ba_observations_from_numpy, vision_ba_state_from_numpy
    from viorb_tpu_torch.optim.ba import vision_ba
    obs_np, st_np = cs._ba_problem()
    obs, st = ba_observations_from_numpy(**obs_np, device=dev), vision_ba_state_from_numpy(**st_np, device=dev)
    fixed = torch.zeros(cs.BA_K, dtype=torch.bool, device=dev)
    fixed[:2] = True
    for kind in ("atomic", "sorted", "atomic", "sorted"):
        with accumulation(kind):
            outs = [vision_ba(st, obs, cam, fixed, iters=cs.BA_ITERS)[0] for _ in range(2)]
            same = all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
            syncs = cs._count_syncs(lambda: vision_ba(st, obs, cam, fixed, iters=cs.BA_ITERS))
            ms = cs._event_ms(lambda: vision_ba(st, obs, cam, fixed, iters=cs.BA_ITERS), reps=5, warmup=1) / cs.BA_ITERS
        print(f"{tag} vision_ba K={cs.BA_K} M={cs.BA_M} R={cs.BA_R}, {kind}: {ms:.3f} ms an LM iteration, host syncs "
              f"{len(syncs)}, two solves bit-equal {same}", flush=True)
    run("atomic", False, True)  # warm-up: captures, first calls
    for vi in (False, True):
        res = {}
        for kind in ("atomic", "sorted"):
            for close in (False, True, True) if kind == "sorted" else (False, True):
                gb = []
                r = run(kind, vi, close, gb)
                res.setdefault((kind, close), []).append(r)
                print(f"{tag} {'MonoViSlam' if vi else 'MonoSlam'} {kind}, loop closing {close}: Sim3 ATE "
                      f"{r['sim3']:.6f} m, metric {r['metric']:.6f} m, loops {r['loops']}, {r['wall']:.2f} s, "
                      f"jobs median {r['job_med']:.1f} ms, sum {r['job_sum']:.0f} ms, GBA {['%.1f' % x for x in gb]} ms",
                      flush=True)
        a, b = res[("sorted", True)]
        print(f"{tag} {'MonoViSlam' if vi else 'MonoSlam'} sorted, two loop runs' trajectories bit-equal: "
              f"{a['traj'].shape == b['traj'].shape and np.array_equal(a['traj'], b['traj'])}", flush=True)


def paced(slam, name):
    rows, t_start = [], time.perf_counter()
    for i in range(100):
        ts = float(seq.timestamps[i])
        time.sleep(max(0.0, t_start + ts - time.perf_counter()))
        t = time.perf_counter()
        info = slam.process_frame(seq.images[i], ts)
        rows.append((info["state"], info["n_tracked"], info.get("queued", 0), info["n_kfs"],
                     (time.perf_counter() - t) * 1e3, 0 if slam.loop_closer is None else slam.loop_closer.loops_closed,
                     time.perf_counter() - t_start))
    slam.wait_mapping_idle()
    s, tr = ate(slam)
    closed = next((i for i, r in enumerate(rows) if r[5] >= 1), -1)
    print(f"{tag} {name}: loops {rows[-1][5]} (first at frame {closed}), final {slam.state}, {len(tr)} trajectory "
          f"frames, Sim3 ATE {s:.4f} m, keyframes {len(slam.map.keyframes)}", flush=True)
    print("  states   " + "".join(r[0][0] for r in rows))
    print("  tracked  " + " ".join(str(r[1]) for r in rows))
    print("  queued   " + "".join(str(min(r[2], 9)) for r in rows))
    print("  kfs      " + " ".join(str(r[3]) for r in rows))
    print("  frame ms > 60: " + ", ".join(f"{i}:{r[4]:.0f}@{r[6]:.1f}s" for i, r in enumerate(rows) if r[4] > 60))
    print("  jobs (total ms, loop ms): " + ", ".join(f"{j['total']:.0f}" + (f"/L{j['loop']:.0f}" if "loop" in j else "")
                                               for j in slam.job_times), flush=True)
    print("  jobs over 500 ms: " + "; ".join(", ".join(f"{k} {v:.0f}" for k, v in j.items())
                                             for j in slam.job_times if j["total"] > 500), flush=True)
    return rows


if "streaming" in PARTS:
    for close in (True, True, True, True, False):
        st = MonoSlam(cam, device=dev, vocabulary=vocab, enable_loop_closing=close, streaming=True, **CFG)
        try:
            paced(st, f"streaming, loop closing {close}")
        finally:
            st.shutdown()

if "async" in PARTS:
    asy = MonoSlam(cam, device=dev, vocabulary=vocab, enable_loop_closing=True, async_mapping=True, **CFG)
    try:
        rows = paced(asy, "async, loop closing")
    finally:
        asy.shutdown()
