"""The spread of chip_smoke.py's VI loop pair on the card: MonoViSlam over
tests/test_e2e_vi_loop.py's 100-frame noisy circuit with the reference's
two-view draws replayed, without and with loop closing, several times.

    python3 probes/vi_loop_spread.py [--deterministic]

Prints each run's Sim3 and metric ATE, its loop (keyframe, candidate, S12
scale, matched pairs), keyframe count and a hash of its trajectory's bits
(equal hashes: runs equal bit for bit). --deterministic runs in PyTorch's
deterministic mode (as chip_smoke.py's loop pairs do) and 2 + 2 runs;
otherwise 2 runs without and 4 with loop closing."""
import hashlib, os, sys, time, numpy as np
DETERMINISTIC = "--deterministic" in sys.argv
if DETERMINISTIC:
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
import torch
if DETERMINISTIC:
    torch.use_deterministic_algorithms(True)
sys.path.insert(0, ".")
import chip_smoke as cs
from viorb_tpu_torch.bow import train_vocabulary
from viorb_tpu_torch.eval.ate import ate_rmse
from viorb_tpu_torch.features.extractor import OrbExtractor
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.io import synthetic
from viorb_tpu_torch.slam import loop_closing as lcm
from viorb_tpu_torch.slam.mono_vi import MonoViSlam
print(cs._card())
dev = torch.device("cuda")
cam = PinholeCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
z = np.load("tests/torch_loop_golden.npz")
draws = [tuple(z[f"vi_two_view{i}_{k}"] for k in ("x1", "valid", "idx_h", "idx_f")) for i in range(int(z["vi_two_view_calls"]))]
seq = synthetic.make_sequence(100, cam=cam, dt=0.1, kind="circuit", noise_std=4.0, device=dev)
imu = synthetic.make_imu(100, 0.1, hz=200.0, kind="circuit", noise_g=0.002, noise_a=0.03,
                         bias_g=np.array([0.002, -0.001, 0.0015], np.float32), bias_a=np.array([0.03, -0.02, 0.01], np.float32))
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
rec = {}
orig_correct = lcm.LoopCloser.correct
def correct(self, kf_id, cand_id, s12, r12, t12, pairs=None):
    rec.setdefault("loops", []).append((kf_id, cand_id, round(float(s12), 4), len(pairs[0]) if pairs else 0))
    return orig_correct(self, kf_id, cand_id, s12, r12, t12, pairs)
lcm.LoopCloser.correct = correct
def run(close):
    rec.clear()
    slam = MonoViSlam(cam, device=dev, vocabulary=vocab, enable_loop_closing=close, n_features=800, kf_max_interval=5, vi_init_min_time=2.5, vi_init_min_kfs=8)
    with cs._two_view_replay(draws):
        for i in range(100):
            slam.process_frame_vi(seq.images[i], float(seq.timestamps[i]), samples[i])
    tr = slam.trajectory_tum()
    s = ate_rmse(tr[:, 0], tr[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)
    m = ate_rmse(tr[:, 0], tr[:, 1:4], seq.timestamps, seq.c_w, with_scale=False)
    print(f"close={close}: sim3 {s:.4f} metric {m:.4f} loops {rec.get('loops')} kfs {len(slam.map.keyframes)} "
          f"bits {hashlib.sha1(tr.tobytes()).hexdigest()[:12]} init_time {slam.init_time:.2f} scale(extent) {np.linalg.norm(np.ptp(tr[:,1:4],0))/np.linalg.norm(np.ptp(seq.c_w,0)):.4f}", flush=True)
for close in (False, True, False, True) if DETERMINISTIC else (False, True, True, False, True, True):
    t = time.time(); run(close); print(f"  {time.time()-t:.1f} s", flush=True)
