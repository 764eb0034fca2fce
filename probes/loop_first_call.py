"""A short first card call for the loop-closing slice: build K1's and K8's
libraries at once, hold K8 to its plain twin, and run the Sim3 RANSAC, the
reprojection refine and the essential graph (tests/torch_loop_golden.npz's
mono problems) on the card against the CPU path, with their times, host
syncs and kernels an LM iteration.

    python3 probes/loop_first_call.py"""
import sys, time, numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from viorb_tpu_torch.cuda_build import load_libraries, build_info
from viorb_tpu_torch.features import fast_cuda
from viorb_tpu_torch.bow import descend_cuda, default_vocabulary, train_vocabulary
print(cs._card())
t = time.perf_counter()
load_libraries([fast_cuda.LIB_NAME, descend_cuda.LIB_NAME])
print("parallel build", time.perf_counter() - t)
for lib in (fast_cuda.LIB_NAME, descend_cuda.LIB_NAME):
    s, log = build_info(lib)
    print(lib, s, [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l])
dev = torch.device("cuda")
stock = default_vocabulary()
rng = np.random.default_rng(0)
train = rng.integers(0, 2, (3000, 256)).astype(np.uint8)
voc = train_vocabulary(train, k=8, depth=3)
desc = torch.from_numpy(rng.integers(0, 2, (1000, 256)).astype(np.uint8)).to(dev)
valid = torch.from_numpy(rng.random(1000) > 0.1).to(dev)
sets = {"a keyframe's features": (desc, valid), "every row invalid": (desc, torch.zeros(1000, dtype=torch.bool, device=dev))}
print(cs._k8_check(dev, {"stock": stock, "trained": voc}, sets, "[card]"))
# the Sim3 pieces on the card vs the CPU path, on the golden's problems
from viorb_tpu_torch.optim.pose_graph import Sim3Graph, optimize_sim3_graph
from viorb_tpu_torch.optim.sim3_refine import optimize_sim3_reproj
from viorb_tpu_torch.solvers.sim3_solver import sim3_from_samples
from viorb_tpu_torch.geometry.camera import PinholeCamera
cam = PinholeCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
z = np.load("tests/torch_loop_golden.npz")
P = lambda k: z["mono_" + k]
for d in (torch.device("cpu"), dev):
    T = lambda a: torch.from_numpy(np.asarray(a)).to(d)
    gr = Sim3Graph(*(T(P("graph_" + k).astype(np.int64) if k.startswith("edge") else P("graph_" + k)) for k in ("edge_i", "edge_j", "meas_s", "meas_r", "meas_t", "weight")))
    args = (T(P("graph_s")), T(P("graph_r")), T(P("graph_t")), gr, T(P("graph_fixed")))
    out = optimize_sim3_graph(*args, iters=40)
    err = [float(np.abs(o.cpu().numpy() - P("graph_out_" + k)).max()) for o, k in zip(out, "srt")]
    if d.type == "cuda":
        ms = cs._event_ms(lambda: optimize_sim3_graph(*args, iters=40), reps=3, warmup=1)
        syncs = cs._count_syncs(lambda: optimize_sim3_graph(*args, iters=2))
        kern = cs._kernels_per_call(lambda: optimize_sim3_graph(*args, iters=1))
        print(f"pose graph card K={len(P('graph_s'))} E={len(P('graph_edge_i'))}: err {err}, {ms:.2f} ms / 40 iterations, syncs {len(syncs)} {syncs[:3]}, kernels a 1-iteration call {kern}")
    else:
        print("pose graph cpu err", err)
    names = ("s12", "r12", "t12", "x1", "uv1", "x2", "uv2", "valid")
    r = optimize_sim3_reproj(*(T(P("refine_" + k)) for k in names), cam)
    print(d, "refine err", abs(float(r[0]) - float(P("refine_out_s"))), np.array_equal(r[3].cpu().numpy(), P("refine_out_inliers")))
    if d.type == "cuda":
        ms = cs._event_ms(lambda: optimize_sim3_reproj(*(T(P("refine_" + k)) for k in names), cam), reps=3, warmup=1)
        syncs = cs._count_syncs(lambda: optimize_sim3_reproj(*(T(P("refine_" + k)) for k in names), cam))
        print(f"refine card {ms:.2f} ms, syncs {len(syncs)}")
    o = sim3_from_samples(T(P("ransac_p1")), T(P("ransac_p2")), T(P("ransac_valid")), T(P("ransac_idx")), inlier_th=0.1)
    print(d, "ransac", bool(o.success), abs(float(o.s) - float(P("ransac_s"))), np.array_equal(o.inliers.cpu().numpy(), P("ransac_inliers")))
print("done")
