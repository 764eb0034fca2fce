#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's monocular tracking cores, mapping
functions, lock-step, async and streaming SLAM, lock-step and async
monocular-inertial SLAM, place recognition and loop closing, lock-step and
threaded stereo and RGB-D SLAM, its command line and its distributed bundle
adjustment on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. report the card (name, power limit), CUDA and nvcc versions;
  2. build the hand-written kernels from viorb_tpu_torch/csrc/ with nvcc,
     one process a source, all started together (K1's library, two kernel
     entries; K8's; K9's);
  3. hold each kernel entry to its plain PyTorch version on the card, at
     the shapes the tracking step gives it, with torch.equal: the
     single-image FAST score map on 24 level images, and the fused
     pyramid-wide FAST + per-cell maximum/argmax on the pyramids of a
     random, a rendered and a constant frame;
  4. render a 16-frame 752x480 arc, build a 4096-slot map from frame 0 and
     track frames 1-15 with OrbExtractor(n_features=1000) through each of
     the three cores (the 2x4 tracking step, the pipeline core and the
     streaming core at LM 4x10), each ONE CUDA graph: every frame must have
     > 30 inliers and a pose within 3 cm / 0.5 deg of the renderer's ground
     truth; FAST + cell argmax must have been exactly one fused launch a
     frame inside each graph (launches captured x replays) and no
     single-image launch; a replay must make 0 host syncs and equal the
     eager function on frames 1-3; the 15 px -> 30 px retry must select
     what a separate match at the rule's radius gives; a graph captured
     while a second thread allocates and launches on the card must hold
     its own launch alone and lose none of the thread's; frame 1's features
     must equal, field by field, those computed on the card through the
     plain halves, and the first frames must agree with the port's CPU
     path (which tests/test_torch_*.py hold to the JAX reference). Then
     the per-level entry points (fast_score_map + grid_topk_keypoints) are
     driven over frame 1's pyramid and held to the fused path;
  5. the mapping functions on the card against the port's CPU path:
     two_view_init on matches between frames 0 and 8 (pose against the
     renderer's ground truth up to scale), triangulate_between on the same
     two frames at 1000 features, vision_ba at K=10, M=2048, R=8; then the
     local BA as MonoSlam runs it, a graph (`make_local_vision_ba`) of a
     window of 10 keyframes and 8 anchors padded to the pose bucket 20
     (M=2048, R=16): the cost falls, a replay equals eager bit for bit and
     makes 0 host syncs, ms graphed and eager, kernels a replay;
  6. lock-step SLAM: MonoSlam at its defaults (1000 features, 4096
     local-map slots, 2048 BA landmarks) over the 40-frame 752x480 arc at
     dt=0.1 (tests/test_e2e_mono.py's sequence), rendered on the card, once
     to warm up and once measured: the reference's contract (final state
     OK, > 70 % of frames OK, >= 3 keyframes, > 100 points, ATE < 0.05 m
     after Sim3), agreement with the reference's golden on the same frames
     (tests/torch_mono_golden.npz) within tests/test_torch_mono.py's
     tolerances, K1 launches = frames processed; host syncs per steady
     frame, init ms, tracking ms/frame, the mapping job's phases, fps,
     every local BA a graph replay (the eager BAs are global ones only);
     then a fresh MonoSlam loads the saved map, relocalizes by PnP, tracks,
     and recovers a frame through the fallback chain;
  7. async mapping and streaming: MonoSlam with bench.py's pipeline
     configuration (1000 features, a keyframe at least every 5 frames,
     streaming depth 2) over the same 40-frame arc as 8-bit frames, each
     measured run after a warm-up run of the same mode: lock-step, async,
     streaming and staged streaming (frames already on the card), timed
     (fps with wait_mapping_idle, the tracker thread's host latency per
     frame, the mapping jobs' phases on the worker, frames dropped, carry
     re-anchors, K1 launches = graph replays + eager extractions = frames,
     host syncs of the tracker thread per steady frame: 1 async, 0
     streaming); the reference's contracts: async with the frames fed at
     the camera's rate ends OK with the map published and ATE < 0.06 m; a
     mapping job held on an event while keyframe frames return and the
     queue gate bounds keyframes; streaming flushed after every frame
     equal to lock-step on frames 0-9 within tests/test_streaming.py's
     tolerances; async and streaming fed as fast as the tracker takes the
     frames track >= 80 % of them with ATE <= max(5x lock-step, 0.20 m);
     recovery after frames 9-14 go blank; no graph capture beside the
     threads; clean shutdowns. Then async and streaming runs whose frames
     switch from float32 to uint8 (the same images) at frame 20: each stops
     its threads, captures once at the new key, restarts them and keeps
     the un-flushed contract; and un-paced async at
     tests/test_async_mapping.py's exact configuration, 5 runs, every ATE
     reported against its 0.06 m with the BAs run and skipped and the BA ms
     of each job. Every run: each local BA a graph replay, no kernel build,
     library load or graph capture off the main thread;
  8. lock-step monocular-inertial SLAM: MonoViSlam at tests/test_e2e_vi.py's
     configuration over its 60-frame arc with the 200 Hz IMU, a warm-up run
     and a measured one, both drawing the two-view RANSAC hypotheses of the
     reference's seed-0 run (tests/torch_vi_golden.npz): the reference's
     contract, agreement with that run, K1 launches = frames, one graph
     replay and one host sync a steady VI frame, 0 syncs in a replay and
     replay == eager in each of the VI core's two graphs, every local BA
     (vision before VI init, VI after) a graph replay, the local VI BA's
     graph on the run's last window replaying eager bit for bit with 0
     host syncs (ms graphed and eager, kernels); times of the VI
     core graphed and eager, K7 (the preintegration) alone, VI init, vi_ba
     and vi_ba_gw per LM iteration, the VI mapping job; then twelve runs with
     the port's own draws (seeds 0-11), reported beside the reference's
     seeds 0-5. Then async MonoViSlam (the rebase epoch) at
     tests/test_async_vi.py's configuration on the same draw: fed un-paced,
     that test's contract (VI ready, > 60 % of frames OK, gravity cos >
     0.99, metric ATE < 0.12 m), the tracker's frame times by kind, the
     worker's jobs and VI BAs, the re-bases and BAs skipped; drained after
     every frame, its positions within 0.01 m RMS of the lock-step run's;
     and lock-step MonoViSlam on the spin sequence with
     tests/test_stress.py's assertions (an IMU-only bridge through a fast
     yaw excursion, recovery, the tail's metric ATE < 0.6 m); last, the
     300-frame laps with the IMU at the camera's rate, lock-step then
     async, long enough that the async tracker runs beside its worker past
     VI init's refinement window: both VI-ready with gravity cos > 0.99, the
     async run beside a running job, keyframes carried through a VI BA's
     write-back, frames tracked across one; its outcome beside lock-step's
     reported, not enforced;
  9. place recognition and loop closing: K8 (the BoW descent, ONE launch
     of one thread-block cluster) against its plain twin (words
     torch.equal, weights within 1e-6 relative) on the stock and a trained
     tree at 0, 1, 1000 and 5000 descriptors, all-invalid rows too, on both
     of its paths (the histogram in shared memory, or in a scratch tensor
     for a tree too large), a second call equal to the first, exactly one
     device operation a call (the profiler), and its device time beside
     its bound and an empty launch; lock-step MonoSlam with and
     without loop closing on tests/test_e2e_loop.py's 100-frame noisy
     circuit, both with the reference's two-view draw
     (tests/torch_loop_golden.npz), and that test's contract (a loop
     closes, Sim3 ATE <= the no-loop run's, the globally aligned tail <=
     0.8x), then the loop run again with the loop closer's stage times,
     its trajectory equal to the first's bit for bit (the BAs and the
     essential graph add in a fixed order); lock-step MonoViSlam likewise at
     tests/test_e2e_vi_loop.py's configuration and contract, its loop run
     again equal to the first bit for bit;
     BoW relocalization after a blackout (tests/test_relocalization.py)
     and with the stock vocabulary after load_map (tests/test_map_io.py);
     the 300-frame laps of tests/test_stress.py; async MonoSlam with loop
     closing fed at the camera's rate (the loop closes, the post-loop GBA
     runs in the loop job on the mapping worker, the run ends OK with its
     Sim3 ATE within tests/test_streaming.py's threaded envelope of the
     lock-step loop run's, max(5x, 0.20 m), both enforced: the worker
     runs every job's local BA, which keeps the revisit's turn refined while
     rejected Sim3 verifications hold the worker; the tracker's longest
     frame and its frames around the closure printed: the job holds the map
     lock across the closure and its GBA), async MonoViSlam with loop closing at
     the camera's rate (the loop closes, the VI post-loop GBA runs in the
     loop job on the mapping worker, Sim3 ATE within max(5x the lock-step
     VI loop run's, 0.20 m), the loop job and the tracker's longest frame
     printed), and streaming MonoSlam with loop closing at the camera's
     rate (the GBA in the loop job, >= 80 % of the frames kept, final OK, Sim3
     ATE within the same envelope; loops, the first jobs and the dispatches
     around the closure printed); no kernel build, library load or graph
     capture off the main thread in any of them; K1 and K8 launches by path
     (K8's global path 0 on each);
 10. stereo and RGB-D, lock-step: K9 (the stereo sub-pixel SAD) against
     its plain version with torch.equal on the 0.11 m stereo arc's frame 0
     (its descriptor matches) and on keypoints at each image border with
     unmatched ur0 = -1 rows, its device time beside the plain version's,
     its bound and an empty launch; tests/test_e2e_stereo.py's contracts
     (the stereo depth of frame 0: > 200 matches, median error < 3 %; the
     40-frame arc at 800 features, a keyframe at least every 5 frames, a
     warm-up run and a measured one: > 90 % of frames OK, metric ATE <
     0.09 m, < 0.02 m from 2 s, scale ratio 0.97-1.03),
     tests/test_e2e_rgbd.py's (frame 0 OK, > 90 % OK, > 300 points, metric
     ATE < 0.05 m) and tests/test_e2e_stereo_loop.py's (the 100-frame noisy
     circuit with a vocabulary trained as that test trains it: a loop
     closed with the Sim3 scale pinned, metric ATE < 0.05 m, scale ratio
     0.97-1.03); in each run K1 launches = frames + right extractions, K9
     launches = right extractions, every local BA a graph replay (the
     stereo ones as "stereo_local"), host ms a frame by kind (init,
     keyframe, steady), no kernel build, library load or graph capture off
     the main thread. Then the threaded modes over the same arc, fed at the
     camera's 10 fps: async StereoSlam, streaming StereoSlam (which the
     reference's stereo entry runs as async: no collector thread) and
     async RgbdSlam, each ending OK with >= 80 % of frames tracked and its
     metric ATE within max(5x the lock-step run's, 0.20 m), the lock-step
     contract's numbers printed beside it, every mapping job on the
     worker, the same launch, replay and main-thread checks;
 11. the command line: `python -m viorb_tpu_torch` (viorb_tpu_torch/run.py)
     at full width over dumps written under a temporary directory from the
     port's renderer (8-bit PNG images and 16-bit PNG depth through
     io/png.py, with libpng's adaptive per-row filters as real files carry
     them, each dataset's text files; the decode's ms a frame at these
     filters): a fresh process running the
     synthetic VI arc through the lockstep stream (tests/test_run_cli.py's
     contract; its first frame, init frame, VI init frame, wall time and
     the CLI's median track time); EuRoC VI from a dump of the same arc and
     IMU (every image the loader returns equal to the uint8 written; the
     same contract), then the same frames and samples over the live TCP
     wire into a lockstep runner and MonoViSlam (inputs equal; trajectory
     equal, or its first difference printed); TUM RGB-D from a dump
     (tests/test_run_cli.py's contract, the metric ATE), again with no
     DepthMapFactor line (the trajectory equal: TUM's 5000 is the
     fallback); KITTI stereo with loop closing from a dump of the stereo
     loop circuit (a loop closed with s = 1, one 12-value KITTI row per
     tracked frame, K9 = right extractions, K8 = keyframes), then
     `--load-map --localization-only` over its first 20 frames (it
     relocalizes at the first frame, tracks, adds no keyframe, K8 = the
     keyframes loaded), and mono `--stream lockstep` over the whole
     circuit, more frames than the synchronizer's queue holds (every frame
     processed, none dropped); mono `--streaming --viz-dir` (every PNG decoded by
     io/png.py to its shape) and mono `--stream realtime --replay-speed
     1.0` (processed + dropped = frames; the drops reported). Every
     in-process run: K1 = frames processed + right extractions (the eager
     warm-up calls of a capture made in the run apart), no kernel build,
     library load or graph capture off the main thread, no thread left
     running;
 12. distributed bundle adjustment (viorb_tpu_torch/parallel) at
     bench_scaling.py's problem (K = 12 poses, M = 8192 landmarks, R = 8
     observations each, 10 LM iterations, vision and VI): the port's
     single-device vision_ba / vi_ba on the card, then distributed_vision_ba
     / distributed_vi_ba at world size 1 on NCCL in a child process and
     with two gloo ranks on the one card, CUDA tensors, in two child
     processes (each waited for with a timeout and killed past it), every
     child joining through the port's own init code, which binds the card:
     the ranks' poses equal bit for bit, within tests/test_distributed_ba.py's
     tolerances of the single-device solve, the whole problem's cost
     falls; ms an iteration of each and the bytes all-reduced an
     iteration. bench_scaling.py's VI chain is invalid (structure only), so
     each run also solves tests/test_distributed_ba.py's VI problem, whose
     chain is live: the ranks equal bit for bit, within 5e-4 m / 1e-3 m/s
     of the card's single-device solve (an IMU system added on every rank
     before the all-reduce would be ~1.5e-3 m off) and within that test's
     tolerances of the JAX package's distributed solve
     (tests/torch_parallel_golden.npz). NCCL refuses two ranks on one
     device, so its multi-rank path waits for a machine with two or more
     GPUs;
 13. time the fused launch, the 8 single-level launches, their plain
     versions and an empty kernel launch (device time, host run ahead),
     the wrappers back to back on the host clock, the extract / match /
     pose-LM stages per frame, each core as a graph over a 200-frame
     replay and eager over 30 frames, kernels a frame and the device busy
     share of each
     graphed core, and the mapping functions, with CUDA events after
     warm-up.

Prints one JSON line of kernels before the last line, and as the last line
{"ok": true, "device": {...}}. It needs the repository around it: run from
anywhere else, the package import fails.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import inspect
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import warnings
from typing import Tuple

N_FRAMES = 16  # frame 0 builds the map, frames 1-15 are tracked
MAP_SLOTS = 4096
REPLAY_FRAMES = 200
EAGER_REPLAY_FRAMES = 30  # the eager cores are timed over two cycles of the arc
INIT_FRAME = 8  # two-view init and triangulation pair frame 0 with this one
BA_K, BA_M, BA_R, BA_ITERS = 10, 2048, 8, 10  # the local-BA size of the reference's benchmark
# the graphed local BA: a window of 10 keyframes and 8 anchors padded to the
# pose bucket 20, MonoSlam's max_ba_landmarks and MAX_OBS_PER_POINT
GRAPH_BA_KFS, GRAPH_BA_ANCHORS, GRAPH_BA_R = 18, 8, 16
MAX_POS_ERR_M = 0.03
MAX_ROT_ERR_DEG = 0.5
MIN_INLIERS = 30
SLAM_FRAMES, SLAM_DT = 40, 0.1  # the sequence of tests/test_e2e_mono.py
# the CPU test's tolerances against the reference's golden (tests/test_torch_mono.py)
SLAM_KF_TOL, SLAM_POINT_SHARE, SLAM_TRAJ_SHARE, SLAM_ATE_FACTOR = 1, 0.15, 0.03, 1.5
SLAM_GOLDENS = tuple(f"full_seed{seed}" for seed in range(5))  # the reference's runs with seeds 0-4
# async mapping and streaming: bench.py's pipeline configuration on tests/test_streaming.py's clip
THREADED_KF_INTERVAL, THREADED_DEPTH = 5, 2
THREADED_MODES = {
    "lock-step": {},
    "async": {"async_mapping": True},
    "streaming": {"streaming": True},
    "staged streaming": {"streaming": True},
    "streaming, depth 1": {"streaming": True, "streaming_depth": 1},
}
WARM_FRAMES = 12  # a warm-up run: init, a few mapping jobs, steady frames
HELD_FRAMES = 20
FLUSHED_FRAMES = 10
BLACKOUT, BLACKOUT_FRAMES, RECOVERED_FROM = range(9, 15), 28, 16
# a threaded run whose frames switch from float32 to uint8 at this frame
SWITCH_AT, SWITCH_FEATURES = 20, 800
ASYNC_RUNS = 5  # un-paced async at tests/test_async_mapping.py's configuration
SPIN_FRAMES = 100  # tests/test_stress.py's spin sequence
# async MonoViSlam past VI init's refinement window: the laps with the IMU,
# 30 s at 10 fps, VI init near 4 s, the window's end near 16 s
VI_LAPS_FRAMES, VI_LAPS_DT = 300, 0.1
# visual-inertial: tests/test_e2e_vi.py's configuration and contract
VI_FRAMES, VI_DT, VI_POST_INIT_T = 60, 0.1, 4.5
VI_CONFIG = dict(n_features=800, vi_init_min_time=2.5, vi_init_min_kfs=8, kf_max_interval=5, imu_capacity=256)
VI_GOLDENS = tuple(f"vi_full_seed{seed}" for seed in range(6))  # the reference's runs with seeds 0-5
VI_OWN_SEEDS = range(12)  # runs with the port's own (nested) two-view draws
# tests/test_torch_mono_vi.py's tolerances against the reference's golden
VI_TRAJ_SHARE, VI_GRAVITY_DEG, VI_SCALE_TOL, VI_ATE_FACTOR = 0.03, 0.5, 0.02, 1.5
# place recognition and loop closing: tests/test_e2e_loop.py's and
# tests/test_e2e_vi_loop.py's noisy circuit, tests/test_relocalization.py's
# blackout, tests/test_map_io.py's stock-vocabulary relocalization and the
# laps case of tests/test_stress.py
LOOP_FRAMES, LOOP_DT, LOOP_NOISE = 100, 0.1, 4.0
LOOP_CONFIG = dict(n_features=800, kf_max_interval=5)
LOOP_VI_CONFIG = dict(LOOP_CONFIG, vi_init_min_time=2.5, vi_init_min_kfs=8)
LOOP_VOCAB_EVERY, LOOP_VOCAB_FEATURES = 12, 600
RELOC_FRAMES, RELOC_BLACKOUT, MAPIO_FRAMES = 40, range(20, 24), 45
LAPS_FRAMES, LAPS_REUSE_FROM = 300, 170
K8_N = 1000  # descriptors a K8 check: a keyframe's worth
# stereo and RGB-D: tests/test_e2e_stereo.py's and tests/test_e2e_rgbd.py's
# arc, tests/test_e2e_stereo_loop.py's circuit (LOOP_FRAMES, LOOP_NOISE)
STEREO_FRAMES, STEREO_DT, STEREO_BASELINE = 40, 0.1, 0.11
STEREO_CONFIG = dict(n_features=800, kf_max_interval=5)
RGBD_CONFIG = dict(n_features=800)
# Hopper's popcount rate: 16 a clock an SM (CUDA C++ Programming Guide's
# throughput table, compute capability 9.0) x 132 SMs x 1.98 GHz boost
POPC_PER_S = 16 * 132 * 1.98e9

# Published peaks of one H100 SXM (NVIDIA's data sheet): the yardsticks of
# each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# What the kernel executes for one scored pixel: 2 x (16 + 16 + 8) three-input
# integer min/max, 2 f32 subtractions, 2 f32 max.
FAST_OPS_PER_PIXEL = 84


def _check(ok: bool, what: str) -> None:
    # a check that `python -O` keeps
    if not ok:
        raise AssertionError(what)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _event_ms(fn, reps: int, warmup: int = 3, device_only: bool = False) -> float:
    """Mean ms per call of fn() over `reps` back-to-back calls, between two
    CUDA events. device_only=True first queues a ~0.1 s spin kernel, so the
    host has enqueued every call before the first one runs: the interval
    is then device time alone, without the host's launch cost."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if device_only:
        torch.cuda._sleep(200_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _host_us(fn, reps: int) -> float:
    """Mean microseconds of host time one call of fn() takes to return,
    back to back, on the host clock (the device is not waited for)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _bound(n_bytes: int, n_ops: int):
    """(least ms the card could take, which of the two limits it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _pose_errors(r_cw, t_cw, r_wc_gt, c_w_gt):
    """(camera-center error m, rotation error deg) of an estimate against
    the renderer's ground truth, computed in float64 on the host."""
    import numpy as np

    r = r_cw.double().cpu().numpy()
    c_est = -r.T @ t_cw.double().cpu().numpy()
    r_gt = np.asarray(r_wc_gt, np.float64).T
    cos = np.clip((np.trace(r @ r_gt.T) - 1.0) / 2.0, -1.0, 1.0)
    rot = np.degrees(np.arccos(cos))
    # arccos loses resolution near 0: fall back to the chordal angle
    chord = np.linalg.norm(r - r_gt) / (2.0 * np.sqrt(2.0))
    rot = max(rot, np.degrees(2.0 * np.arcsin(min(1.0, chord))))
    return float(np.linalg.norm(c_est - np.asarray(c_w_gt, np.float64))), float(rot)


def _leaves(obj):
    """The tensors of a nest of (named) tuples, in order."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    return [leaf for child in obj for leaf in _leaves(child)]


def _contiguous(obj):
    """A nest of (named) tuples of tensors with every tensor contiguous, as a
    graph's static inputs are (an eager call on other strides may take
    other kernels)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.contiguous()
    items = [_contiguous(x) for x in obj]
    return obj._make(items) if hasattr(obj, "_fields") else type(obj)(items)


def _count_syncs(fn) -> list:
    """The host syncs PyTorch reports while fn() runs."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]


def _ba_problem(seed: int = 0, k: int = BA_K, m: int = BA_M, r: int = BA_R, exact: int = 0, bf=None):
    """A local-BA problem as numpy arrays: k keyframes on an arc looking at
    m landmarks, each seen from r of them, 0.5 px noise, 10 % empty slots,
    perturbed start (but for the first `exact` poses, which start at the
    truth, as a local BA's anchors); with `bf`, 60 % of the slots with a
    stereo match (the right u, 0.5 px noise). Returns (observations, state)
    as dicts of the interop functions' arguments."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, m), rng.uniform(-2.5, 2.5, m), rng.uniform(4, 10, m)], 1)

    def rodrigues(w):
        th = np.linalg.norm(w)
        a = w / th
        kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * (kx @ kx)

    r_cw = np.stack([rodrigues(np.array([0.01, 0.03 * (i - k / 2), 0.005]) + 1e-9) for i in range(k)])
    t_cw = np.stack([np.array([-0.15 * (i - k / 2), 0.02 * i, 0.01 * i]) for i in range(k)])
    kf_idx = np.stack([rng.permutation(k)[:r] for _ in range(m)])
    pc = np.einsum("mrij,mj->mri", r_cw[kf_idx], pts) + t_cw[kf_idx]
    uv = np.stack([450.0 * pc[..., 0] / pc[..., 2] + 376.0, 450.0 * pc[..., 1] / pc[..., 2] + 240.0], -1)
    uv = uv + rng.normal(0, 0.5, uv.shape)
    obs = dict(kf_idx=kf_idx, uv=uv, inv_sigma2=1.0 / (1.2 ** rng.integers(0, 8, (m, r))) ** 2,
               valid=rng.random((m, r)) > 0.10)
    state = dict(
        r_cw=np.stack([rodrigues(rng.normal(0, 0.005, 3)) for _ in range(k)]) @ r_cw,
        t_cw=t_cw + rng.normal(0, 0.02, (k, 3)),
        points=pts + rng.normal(0, 0.05, (m, 3)),
    )
    state["r_cw"][:exact], state["t_cw"][:exact] = r_cw[:exact], t_cw[:exact]
    if bf is not None:
        obs["ur_valid"] = obs["valid"] & (rng.random((m, r)) < 0.6)
        ur = 450.0 * pc[..., 0] / pc[..., 2] + 376.0 - bf / pc[..., 2] + rng.normal(0, 0.5, (m, r))
        obs["ur"] = np.where(obs["ur_valid"], ur, -1.0)
    return obs, state


def _graph_check(tag: str, what: str, graph, args) -> dict:
    """A GraphedFunction on `args`: the replay equal to its eager function
    bit for bit, 0 host syncs in a replay; ms graphed and eager (CUDA
    events), the kernels a replay runs (the eager call's, by the profiler).
    Returns those numbers."""
    import torch

    out, ref = _leaves(graph(*args)), _leaves(graph.eager(*args))
    _check(all(torch.equal(a, b) for a, b in zip(out, ref)), f"{what}: a replay differs from eager")
    syncs = _count_syncs(lambda: graph(*args))
    _check(not syncs, f"{what}: a replay synced with the host: {syncs}")
    res = dict(graph_ms=_event_ms(lambda: graph(*args), reps=20), eager_ms=_event_ms(lambda: graph.eager(*args), reps=3,
                                                                                        warmup=1),
               kernels=_kernels_per_call(lambda: graph.eager(*args)))
    print(f"{tag} {what}: graphed {res['graph_ms']:.3f} ms, eager {res['eager_ms']:.3f} ms a solve (CUDA events); "
          f"{res['kernels']} kernels a replay (the eager call's, profiler); replay == eager bit for bit, 0 host "
          f"syncs in a replay")
    return res


def _graphed_ba_check(cam, dev, tag: str, bf=None) -> dict:
    """The local vision BA as MonoSlam runs it (`optim/ba.py::
    make_local_vision_ba`): a window of 10 keyframes and 8 anchors padded to
    the pose bucket 20 (identity poses, fixed, named by no observation), M =
    MonoSlam's max_ba_landmarks, R = MAX_OBS_PER_POINT: the cost falls, the
    padded slots stay, and `_graph_check`'s replay checks and times. With
    `bf`, the stereo flavour StereoSlam runs (its own graph, 3-row
    residuals where a slot has a stereo match)."""
    import numpy as np
    import torch

    from viorb_tpu_torch.interop import ba_observations_from_numpy, vision_ba_state_from_numpy
    from viorb_tpu_torch.mapping.map import MAX_OBS_PER_POINT
    from viorb_tpu_torch.optim.ba import _vision_cost_and_chi2, make_local_vision_ba, pose_bucket
    from viorb_tpu_torch.slam.mono import MonoSlam

    k, m = pose_bucket(GRAPH_BA_KFS), inspect.signature(MonoSlam).parameters["max_ba_landmarks"].default
    _check(k == 20 and m == BA_M and GRAPH_BA_R == MAX_OBS_PER_POINT, f"graphed BA shapes K={k} M={m}")
    obs_np, state_np = _ba_problem(seed=2, k=GRAPH_BA_KFS, m=m, r=GRAPH_BA_R, exact=GRAPH_BA_ANCHORS, bf=bf)
    state_np["r_cw"] = np.concatenate([state_np["r_cw"], np.broadcast_to(np.eye(3), (k - GRAPH_BA_KFS, 3, 3))])
    state_np["t_cw"] = np.concatenate([state_np["t_cw"], np.zeros((k - GRAPH_BA_KFS, 3))])
    fixed = torch.ones(k, dtype=torch.bool, device=dev)
    fixed[GRAPH_BA_ANCHORS:GRAPH_BA_KFS] = False
    state, obs = vision_ba_state_from_numpy(**state_np), ba_observations_from_numpy(**obs_np)
    graph = make_local_vision_ba(cam, bf)
    args = (state, *obs[:4], fixed) if bf is None else (state, *obs, fixed)
    out, _ = graph(*args)
    before = float(_vision_cost_and_chi2(state, obs, cam, obs.chi2_delta2(), bf)[0])
    after = float(_vision_cost_and_chi2(out, obs, cam, obs.chi2_delta2(), bf)[0])
    what = "local vision BA" if bf is None else "local stereo BA"
    print(f"{what}, graphed, K={k} ({GRAPH_BA_KFS - GRAPH_BA_ANCHORS} free + {GRAPH_BA_ANCHORS} anchors + "
          f"{k - GRAPH_BA_KFS} padded) M={m} R={GRAPH_BA_R}, 5 + 5 iterations: cost {before:.1f} -> {after:.1f}")
    _check(after < 0.1 * before and torch.equal(out.r_cw[GRAPH_BA_KFS:], state.r_cw[GRAPH_BA_KFS:])
           and torch.equal(out.t_cw[:GRAPH_BA_ANCHORS], state.t_cw[:GRAPH_BA_ANCHORS]),
           "graphed local BA: the cost must fall and the fixed and padded poses stay")
    return _graph_check(tag, f"{what} K={k} M={m} R={GRAPH_BA_R}", graph, args)


def _ba_split(slam, what: str, local_kinds=("local",)) -> str:
    """Checks that every local BA of a run replayed its graph (the eager
    calls are global BAs only) and returns the split as text."""
    eager_local = {k: n for k, n in slam.ba_eager_calls.items() if k in local_kinds}
    _check(not eager_local and any(slam.ba_replays.get(k, 0) for k in local_kinds),
           f"{what}: every local BA must replay its graph: replays {slam.ba_replays}, eager {slam.ba_eager_calls}")
    return f"BA graph replays {dict(slam.ba_replays)}, eager BAs {dict(slam.ba_eager_calls)}"


def _off_main_thread() -> dict:
    """Kernel-library builds, loads and graph captures made so far on any
    thread but the main one (each must stay 0)."""
    from viorb_tpu_torch import cuda_build, cuda_graph

    main = threading.main_thread().name
    return {what: sum(n for t, n in counts.items() if t != main) for what, counts in
            (("builds", cuda_build.BUILDS_BY_THREAD), ("loads", cuda_build.LOADS_BY_THREAD),
             ("captures", cuda_graph.CAPTURES_BY_THREAD))}


def _check_main_thread_only(what: str) -> None:
    off = _off_main_thread()
    _check(not any(off.values()), f"{what}: kernel builds, library loads or captures off the main thread: {off}")


def _slam_phase(cam, dev, tag: str) -> int:
    """Lock-step monocular SLAM over the rendered arc at MonoSlam's
    defaults: a warm-up run (it captures the pipeline core's graph for f32
    frames, builds the map store's native helpers), then the measured run,
    with the launch counts set to 0 just before it and read just after.
    Asserts the reference's end-to-end contract (tests/test_e2e_mono.py),
    agreement with the reference's golden on the same frames
    (tests/torch_mono_golden.npz, tests/make_torch_goldens.py) within the
    CPU test's tolerances, and K1 launches = frames processed. Returns the
    measured run's K1 launches."""
    import os

    import numpy as np
    import torch

    from viorb_tpu_torch.eval.ate import associate, ate_rmse, umeyama_alignment
    from viorb_tpu_torch.features import fast_cuda
    from viorb_tpu_torch.io import synthetic
    from viorb_tpu_torch.slam.mono import MonoSlam
    from viorb_tpu_torch.slam.tracking_loop import make_pipeline_track_core

    golden_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_mono_golden.npz")
    fields = ("state", "n_kfs", "n_points", "init_frame", "traj", "ate", "config")
    with np.load(golden_path) as z:
        goldens = {name: {f: z[f"{name}_{f}"] for f in fields} for name in SLAM_GOLDENS}
    for name, g in goldens.items():
        config = dict(g["config"].tolist())
        _check(int(config["n_frames"]) == SLAM_FRAMES and float(config["dt"]) == SLAM_DT
               and int(config["width"]) == cam.width and int(config["n_features"]) == 1000,
               f"the golden {name}'s configuration is not this phase's: {config}")
    seq = synthetic.make_sequence(SLAM_FRAMES, cam=cam, dt=SLAM_DT, device=dev)
    on_card = dev.type == "cuda"

    def run(measure: bool):
        slam = MonoSlam(cam, device=dev)  # MonoSlam's defaults
        core = make_pipeline_track_core(cam, slam.extractor)  # the process-wide core MonoSlam replays
        rows, frame_ms, frame_syncs, mapped = [], [], [], []
        if on_card:
            torch.cuda.synchronize()
            if measure:
                torch.cuda.set_sync_debug_mode("warn")
        core.reset_counts()
        fast_cuda.LAUNCHES = fast_cuda.CELL_LAUNCHES = 0
        t_run = time.perf_counter()
        try:
            for image, ts in zip(seq.images, seq.timestamps):
                jobs = len(slam.job_times)
                t0 = time.perf_counter()
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    info = slam.process_frame(image, float(ts))  # ends in a pull: the host clock is honest
                frame_ms.append((time.perf_counter() - t0) * 1e3)
                frame_syncs.append(sum("synchroniz" in str(w.message) for w in caught))
                mapped.append(len(slam.job_times) > jobs)
                rows.append(info)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
        wall_s = time.perf_counter() - t_run
        launches = core.launches()["CELL_LAUNCHES"] + fast_cuda.CELL_LAUNCHES
        counts = dict(graph=core.launches()["CELL_LAUNCHES"], eager=fast_cuda.CELL_LAUNCHES,
                      single=fast_cuda.LAUNCHES + core.launches()["LAUNCHES"], replays=core.replays)
        return slam, rows, frame_ms, frame_syncs, mapped, wall_s, launches, counts

    t_warm = time.perf_counter()
    run(measure=False)
    warm_s = time.perf_counter() - t_warm
    slam, rows, frame_ms, frame_syncs, mapped, wall_s, launches, counts = run(measure=True)

    # the reference's end-to-end contract (tests/test_e2e_mono.py)
    states = [r["state"] for r in rows]
    n_ok = states.count("OK")
    traj = slam.trajectory_tum()
    ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)
    init = states.index("OK") if "OK" in states else -1
    print(f"{tag} MonoSlam lock-step, {SLAM_FRAMES} rendered {cam.width}x{cam.height} frames at dt={SLAM_DT}: "
          f"init at frame {init}, {n_ok} frames OK, final {rows[-1]}, ATE {ate:.4f} m after Sim3")
    _check(rows[-1]["state"] == "OK" and n_ok > 0.7 * SLAM_FRAMES and rows[-1]["n_kfs"] >= 3
           and rows[-1]["n_points"] > 100 and len(traj) > 20 and ate < 0.05,
           f"MonoSlam misses the reference's contract: {n_ok} OK, final {rows[-1]}, ATE {ate:.4f} m")
    _check(np.isfinite(traj).all() and traj.shape[1] == 8, "MonoSlam: trajectory not finite or malformed")

    # agreement with the reference's golden, the CPU test's tolerances
    # (tests/test_torch_mono.py). At dt=0.1 the two-view test on frames 0-1
    # passes or fails by the RANSAC draw in either package (3 of the
    # reference's 5 seeds initialize there), and the map that follows
    # depends on the draw: the run is held to the reference's runs (seeds
    # 0-4) that initialized at its frame, by the lowest seed.
    same = [n for n, g in goldens.items() if int(g["init_frame"]) == init]
    _check(bool(same), f"init at frame {init}: no reference run initialized there "
           f"({ {n: int(g['init_frame']) for n, g in goldens.items()} })")
    gold_name = same[0]
    gold = goldens[gold_name]
    ok_code = 1  # make_torch_goldens.STATES
    _check([s == "OK" for s in states] == [int(c) == ok_code for c in gold["state"]],
           f"MonoSlam: states differ from the reference's ({gold_name})")
    n_kfs = np.array([r["n_kfs"] for r in rows])
    n_points = np.array([r["n_points"] for r in rows])
    _check(int(np.abs(n_kfs - gold["n_kfs"]).max()) <= SLAM_KF_TOL,
           f"keyframes per frame {n_kfs.tolist()}, the reference's {gold['n_kfs'].tolist()}")
    share = abs(int(n_points[-1]) - int(gold["n_points"][-1])) / int(gold["n_points"][-1])
    _check(share <= SLAM_POINT_SHARE, f"{int(n_points[-1])} points, the reference's {int(gold['n_points'][-1])}")

    def apart(a, b):
        """RMS distance of trajectory a from b after Sim3, as a share of b's
        extent (a mono map has its own scale)."""
        ia, ib = associate(a[:, 0], b[:, 0])
        s_, r_, t_ = umeyama_alignment(a[ia, 1:4], b[ib, 1:4], with_scale=True)
        err = b[ib, 1:4] - (s_ * a[ia, 1:4] @ r_.T + t_)
        return float(np.sqrt((err**2).sum(1).mean())) / float(np.linalg.norm(b[:, 1:4] - b[0, 1:4], axis=1).max())

    rms_share = apart(traj, gold["traj"])
    spread = [apart(goldens[a]["traj"], goldens[b]["traj"]) for a in same for b in same if a != b]
    ates = [float(goldens[n]["ate"]) for n in same]
    print(f"MonoSlam vs the reference's {gold_name} (init frame {init}, {int(gold['n_kfs'][-1])} keyframes, "
          f"{int(gold['n_points'][-1])} points, ATE {float(gold['ate']):.4f} m): trajectories "
          f"{rms_share * 100:.3f} % of the extent apart (RMS after Sim3), keyframes "
          f"{rows[-1]['n_kfs']}/{int(gold['n_kfs'][-1])}, points {rows[-1]['n_points']}/"
          f"{int(gold['n_points'][-1])}, ATE {ate / float(gold['ate']):.3f}x the reference's; to each of the "
          f"{len(same)} reference runs that initialized at frame {init}: "
          + ", ".join(f"{apart(traj, goldens[n]['traj']) * 100:.3f} %" for n in same)
          + f"; those runs among themselves {min(spread, default=0) * 100:.3f}-{max(spread, default=0) * 100:.3f} %, "
          f"ATE {min(ates):.4f}-{max(ates):.4f} m")
    _check(rms_share <= SLAM_TRAJ_SHARE and ate <= SLAM_ATE_FACTOR * float(gold["ate"]),
           f"MonoSlam and the reference's {gold_name} disagree: {rms_share * 100:.3f} % of the extent, ATE {ate:.4f}")

    # K1: each frame extracted exactly once, through the graphed core
    # (captured x replays) or the extractor's eager call
    print(f"MonoSlam K1 launches: {counts['graph']} through the core's graph ({counts['replays']} replays) + "
          f"{counts['eager']} eager = {launches} for {SLAM_FRAMES} frames; single-image launches {counts['single']}")
    if on_card:  # on the CPU every wrapper runs its plain version: nothing launches
        _check(launches == SLAM_FRAMES and counts["single"] == 0 and counts["graph"] == counts["replays"],
               f"K1 launches {counts} for {SLAM_FRAMES} frames: each frame must be extracted exactly once")

    # the map checkpoint, relocalization by PnP on the card, and the fallback
    # chain: a fresh MonoSlam loads the run's map (localization only),
    # relocalizes frame 20, tracks 21, and recovers 22 through the reference
    # keyframe after its motion model was thrown off by 0.3 rad of yaw
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(build_dir, exist_ok=True)
    map_path = os.path.join(build_dir, "monoslam_map.npz")
    slam.save_map(map_path)
    fresh = MonoSlam(cam, device=dev)
    fresh.load_map(map_path, localization_only=True)
    n_map_points = len(fresh.map.active_point_ids())
    extent = float(np.linalg.norm(traj[:, 1:4] - traj[0, 1:4], axis=1).max())
    for i in (20, 21, 22):
        if i == 22:
            yaw = np.float32(0.3)
            fresh.velocity = (np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]],
                                       np.float32), np.zeros(3, np.float32))
        info = fresh.process_frame(seq.images[i], float(seq.timestamps[i]))
        c = -fresh.last_frame.r_cw.T @ fresh.last_frame.t_cw
        off = float(np.linalg.norm(c - traj[np.argmin(np.abs(traj[:, 0] - seq.timestamps[i])), 1:4])) / extent
        how = {20: "relocalized by PnP", 21: "tracked", 22: "recovered through the fallback chain"}[i]
        print(f"MonoSlam from the saved map (localization only), frame {i} {how}: {info['state']}, "
              f"{info['n_tracked']} tracked, {off * 100:.2f} % of the extent from the run's pose")
        _check(info["state"] == "OK" and info["n_tracked"] >= 15 and off <= 0.05,
               f"MonoSlam from the saved map, frame {i}: {info}, {off * 100:.2f} % of the extent off")
    _check(len(fresh.map.active_point_ids()) == n_map_points, "localization only must leave the map as it was")

    steady = [i for i in range(SLAM_FRAMES) if i > init and states[i] == "OK" and not mapped[i]]
    steady_ms = np.array([frame_ms[i] for i in steady])
    steady_syncs = [frame_syncs[i] for i in steady]
    jobs = slam.job_times
    _check(len(steady) > 10 and len(jobs) >= 2, f"{len(steady)} steady frames and {len(jobs)} mapping jobs")
    if on_card:
        _check(np.median(steady_syncs) <= 1, f"a steady frame waits for the card more than once: {steady_syncs}")
    sync_hist = {int(k): int(v) for k, v in zip(*np.unique(steady_syncs, return_counts=True))}
    parts = {k: float(np.median([j[k] for j in jobs])) for k in jobs[0]}
    kf_ms = np.median([frame_ms[i] for i in range(SLAM_FRAMES) if mapped[i]])
    print(f"{tag} MonoSlam host syncs per steady frame: {sync_hist} (syncs: frames) over {len(steady)} steady frames")
    print(f"{tag} MonoSlam init (two-view + initial BA) frame {init}: {frame_ms[init]:.3f} ms")
    print(f"{tag} MonoSlam tracking, steady frames (one graph replay + one pull): median "
          f"{np.median(steady_ms):.3f} ms, p90 {np.percentile(steady_ms, 90):.3f} ms/frame (host clock)")
    print(f"{tag} MonoSlam mapping job, median of {len(jobs)}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f" ms; a keyframe frame (tracking + job) {kf_ms:.3f} ms")
    print(f"{tag} MonoSlam lock-step local BA ms a job (graph replay + write-back): "
          + ", ".join(f"{j['ba']:.1f}" for j in jobs) + f"; {_ba_split(slam, 'MonoSlam lock-step')}")
    print(f"{tag} MonoSlam whole run: {wall_s:.3f} s for {SLAM_FRAMES} frames = {SLAM_FRAMES / wall_s:.2f} fps "
          f"(host clock; warm-up run {warm_s:.2f} s)")
    return launches


class _SyncsByThread:
    """Host syncs PyTorch reports while the block runs, by the thread that
    made them (`threading.get_ident()`): the sync debug mode and the
    warnings module are process-wide, so counting them in one place would
    mix the tracker's syncs with a worker's."""

    def __init__(self):
        self.counts = collections.Counter()

    def hook(self, message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            self.counts[threading.get_ident()] += 1

    def __enter__(self):
        import torch

        torch.cuda.synchronize()
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self.hook
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self._warnings.__exit__(*exc)
        return False


def _threaded_slam_phase(cam, dev, tag: str) -> dict:
    """Async mapping and streaming MonoSlam at full width: bench.py's
    pipeline configuration (1000 features, a keyframe at least every 5
    frames, streaming depth 2) on tests/test_streaming.py's clip (the
    40-frame arc at dt=0.1), 8-bit frames from the host, or already on the
    card for staged streaming. Every measured run comes after a warm-up run
    of the same mode over the first WARM_FRAMES frames, with the launch
    counts set to 0 just before it. Asserts the reference's contracts
    (tests/test_async_mapping.py, tests/test_streaming.py), K1 launches =
    graph replays + eager extractions = frames, the tracker thread's host
    syncs per steady frame (1 async, 0 streaming), no graph capture beside
    the threads, and clean shutdowns. Returns K1 launches by path."""
    import numpy as np
    import torch

    from viorb_tpu_torch import cuda_graph
    from viorb_tpu_torch.eval.ate import ate_rmse
    from viorb_tpu_torch.features import fast_cuda
    from viorb_tpu_torch.io import synthetic
    from viorb_tpu_torch.slam.mono import MonoSlam
    from viorb_tpu_torch.slam.tracking_loop import make_pipeline_track_core, make_streaming_track_core

    seq = synthetic.make_sequence(SLAM_FRAMES, cam=cam, dt=SLAM_DT, device=dev)
    staged = [synthetic.to_uint8(im) for im in seq.images]  # on the card
    host = [im.cpu().numpy() for im in staged]  # 8-bit frames from the host, as bench.py feeds them
    me = threading.get_ident()
    cores = None

    def ate_of(traj):
        return ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)

    def run(mode, frames, measure=True, flushed=False, blank=(), hold=None, paced=False):
        """One MonoSlam run; returns its record. `hold`: a threading.Event
        the mapping jobs wait for; `paced`: each frame fed at its timestamp
        after the start, as a camera delivers it, else as fast as the
        tracker takes them."""
        nonlocal cores
        slam = MonoSlam(cam, device=dev, n_features=1000, kf_max_interval=THREADED_KF_INTERVAL,
                        **{"streaming_depth": THREADED_DEPTH, **THREADED_MODES[mode]})
        if cores is None:
            cores = (make_pipeline_track_core(cam, slam.extractor), make_streaming_track_core(cam, slam.extractor))
        if hold is not None:
            job = slam._mapping_job

            def held_job(kf_id):
                if not hold.wait(timeout=120):
                    raise RuntimeError("the held mapping job was never released")
                job(kf_id)

            slam._mapping_job = held_job
        blank_frame = np.zeros_like(host[0]) if isinstance(frames[0], np.ndarray) else torch.zeros_like(staged[0])
        captures = [len(c.captured()) for c in cores]
        for c in cores:
            c.reset_counts()
        fast_cuda.LAUNCHES = fast_cuda.CELL_LAUNCHES = 0
        rec = dict(ms=[], syncs=[], kf=[], dispatch=[], ok=[], busy=[], rows=[])
        with (_SyncsByThread() if measure else contextlib.nullcontext()) as syncs:
            t0 = time.perf_counter()
            try:
                for i in range(len(frames)):
                    if paced:
                        time.sleep(max(0.0, t0 + float(seq.timestamps[i]) - time.perf_counter()))
                    made, before = slam.map._next_kf, syncs.counts[me] if measure else 0
                    rec["busy"].append(slam._mapping_queue.unfinished_tasks > 0)  # a job queued or running
                    tick = time.perf_counter()
                    info = slam.process_frame(blank_frame if i in blank else frames[i], float(seq.timestamps[i]))
                    rec["ms"].append((time.perf_counter() - tick) * 1e3)
                    rec["syncs"].append((syncs.counts[me] if measure else 0) - before)
                    rec["kf"].append(slam.map._next_kf > made)
                    rec["dispatch"].append("queued" in info)
                    rec["ok"].append(info["state"] == "OK")
                    if flushed:
                        slam.flush_stream()
                        slam.wait_mapping_idle()
                        rec["rows"].append((slam.state, slam.n_tracked, sorted(slam.map.keyframes),
                                            int(slam.map.pt_active.sum())))
                    elif not slam.async_mapping:
                        rec["rows"].append((slam.state, slam.n_tracked, sorted(slam.map.keyframes),
                                            int(slam.map.pt_active.sum())))
                    if hold is not None and rec["kf"][-1] and i > 2:
                        _check(not slam.job_times and slam._mapping_queue.unfinished_tasks >= 1,
                               f"{mode}: a keyframe frame returned only after its mapping job ran")
                if hold is not None:
                    rec["held_kfs"] = sum(rec["kf"][3:])
                    hold.set()
                slam.wait_mapping_idle()
                rec["s"] = time.perf_counter() - t0
                rec["traj"] = slam.trajectory_tum()
                rec["state"], rec["version"] = slam.state, slam.map.version
                rec["n_kfs"], rec["n_points"] = len(slam.map.kf_ids()), len(slam.map.active_point_ids())
            finally:
                if hold is not None:
                    hold.set()
                threads = [t for t in (slam._worker, slam._collector) if t is not None]
                slam.shutdown()
        _check(slam._worker is None and slam._collector is None and not any(t.is_alive() for t in threads)
               and cuda_graph.card_threads() == 0, f"{mode}: shutdown left a thread running")
        _check([len(c.captured()) for c in cores] == captures or not measure,
               f"{mode}: a graph was captured during the measured run")
        rec["worker_syncs"] = sum(n for t, n in (syncs.counts.items() if measure else ()) if t != me)
        graph = sum(c.launches()["CELL_LAUNCHES"] for c in cores)
        rec["k1"] = dict(graph=graph, replays=sum(c.replays for c in cores), eager=fast_cuda.CELL_LAUNCHES,
                         single=fast_cuda.LAUNCHES + sum(c.launches()["LAUNCHES"] for c in cores))
        rec["jobs"], rec["deltas"], rec["waits"] = slam.job_times, slam.carry_deltas, slam.collector_waits
        rec["gate_ms"] = slam.gate_ms
        rec["ba_skipped"] = slam.ba_skipped
        _check_main_thread_only(f"MonoSlam {mode}")
        if measure and rec["jobs"]:
            rec["ba_split"] = _ba_split(slam, f"MonoSlam {mode}")
        if measure:
            _check(rec["k1"]["graph"] == rec["k1"]["replays"] and rec["k1"]["single"] == 0
                   and rec["k1"]["graph"] + rec["k1"]["eager"] == len(frames),
                   f"{mode}: K1 launches {rec['k1']} for {len(frames)} frames: each frame must be extracted once")
        return rec

    def report(mode, rec, n):
        """Prints a run's numbers; returns (its steady frames, their host syncs
        as {syncs: frames})."""
        ms, kf, dispatch, ok, busy = (np.array(rec[k]) for k in ("ms", "kf", "dispatch", "ok", "busy"))
        init = int(np.argmax(ok))  # the frame that initialized
        traj = rec["traj"]
        streaming = "streaming" in mode
        steady = dispatch.copy() if streaming else ok & ~kf
        other = ~dispatch if streaming else kf.copy()
        steady[: init + 1] = other[: init + 1] = False
        parts = {k: float(np.median([j[k] for j in rec["jobs"]])) for k in rec["jobs"][0]} if rec["jobs"] else {}
        deltas = np.array(rec["deltas"]).reshape(-1, 2)
        sync_hist = {int(k): int(v) for k, v in zip(*np.unique(np.array(rec["syncs"])[steady], return_counts=True))}
        print(f"{tag} MonoSlam {mode}: {n} frames in {rec['s']:.3f} s = {n / rec['s']:.2f} fps (host clock, "
              f"wait_mapping_idle included); final {rec['state']}, {rec['n_kfs']} keyframes, {rec['n_points']} "
              f"points, map version {rec['version']}; {n - len(traj)} frames dropped (no trajectory entry); "
              f"ATE {ate_of(traj):.4f} m after Sim3")
        print(f"{tag} MonoSlam {mode}, tracker thread, host clock: "
              f"{'dispatch-only' if streaming else 'steady'} frames median {np.median(ms[steady]):.3f} / "
              f"p90 {np.percentile(ms[steady], 90):.3f} ms ({int(steady.sum())} frames); "
              f"{'synchronous' if streaming else 'keyframe-inserting'} frames "
              + (f"median {np.median(ms[other]):.3f} / p90 {np.percentile(ms[other], 90):.3f} ms "
                 f"({int(other.sum())} frames)" if other.any() else "none"))
        if streaming:
            gate = np.zeros(n)
            gate[dispatch] = rec["gate_ms"]
            print(f"{tag} MonoSlam {mode}, dispatch-only frames: blocked in the backlog and depth gates median "
                  f"{np.median(gate[steady]):.3f} ms, the rest (local map, re-anchor, replay, copies) median "
                  f"{np.median((ms - gate)[steady]):.3f} / p90 {np.percentile((ms - gate)[steady], 90):.3f} ms")
        elif mode != "lock-step":
            for label, sel in (("a job queued or running", steady & busy), ("the worker idle", steady & ~busy)):
                if sel.any():
                    print(f"{tag} MonoSlam {mode}, steady frames with {label}: median {np.median(ms[sel]):.3f} ms "
                          f"({int(sel.sum())} frames)")
        print(f"{tag} MonoSlam {mode}, host syncs of the tracker thread per "
              f"{'dispatch-only' if streaming else 'steady'} frame: {sync_hist} (syncs: frames); the other threads' "
              f"syncs {rec['worker_syncs']}; the collector's waits {rec['waits']} (one a batch)")
        print(f"{tag} MonoSlam {mode}, mapping jobs {'on the worker thread' if mode != 'lock-step' else 'inline'}, "
              f"median of {len(rec['jobs'])}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + " ms; local BA ms a job "
              + ", ".join(f"{j['ba']:.1f}" for j in rec["jobs"]) + f"; BAs skipped {rec['ba_skipped']}; "
              + rec.get("ba_split", ""))
        print(f"{tag} MonoSlam {mode}: carry re-anchors {len(deltas)}"
              + (f", |d_t| max {deltas[:, 0].max():.2e} median {np.median(deltas[:, 0]):.2e}, |dR - I| max "
                 f"{deltas[:, 1].max():.2e}" if len(deltas) else "")
              + f"; K1 launches {rec['k1']['graph']} in {rec['k1']['replays']} graph replays + {rec['k1']['eager']} "
              f"eager = {rec['k1']['graph'] + rec['k1']['eager']} for {n} frames")
        return steady, sync_hist

    n = SLAM_FRAMES
    results = {}
    for mode, frames in (("lock-step", host), ("async", host), ("streaming", host), ("staged streaming", staged)):
        t_warm = time.perf_counter()
        run(mode, frames[:WARM_FRAMES], measure=False)
        rec = results[mode] = run(mode, frames)
        print(f"{tag} MonoSlam {mode}: warm-up run over {WARM_FRAMES} frames {time.perf_counter() - t_warm - rec['s']:.2f} s")
        steady, hist = report(mode, rec, n)
        if mode == "async":
            _check(np.median(np.array(rec["syncs"])[steady]) == 1, f"async: a steady frame syncs once: {hist}")
        if "streaming" in mode:
            _check(set(hist) == {0}, f"{mode}: the tracker thread synced on a dispatch-only frame: {hist}")
    lock_traj = results["lock-step"]["traj"]
    lock_ate = ate_of(lock_traj)

    # the async contract (tests/test_async_mapping.py), with the frames fed
    # at the camera's rate (dt = 0.1 s): fed as fast as the tracker takes
    # them (~20 ms a frame), a keyframe comes every ~0.1 s against a ~0.13 s
    # mapping job, the worker falls behind and skips BAs, and the outcome
    # depends on the thread timing (below: held to the laggy envelope)
    paced = run("async", host, paced=True)
    report("async, fed at the camera's rate", paced, n)
    _check(paced["state"] == "OK" and paced["version"] > 0 and ate_of(paced["traj"]) < 0.06,
           f"async at the camera's rate: final {paced['state']}, map version {paced['version']}, "
           f"ATE {ate_of(paced['traj']):.4f} m")
    rec = results["async"]
    _check(rec["state"] == "OK" and rec["version"] > 0, f"async: final {rec['state']}, map version {rec['version']}")
    # the un-flushed contract (tests/test_streaming.py): fed as fast as the
    # tracker takes them, async and streaming, host and staged frames
    for mode in ("async", "streaming", "staged streaming"):
        rec = results[mode]
        _check(len(rec["traj"]) >= 0.8 * n and ate_of(rec["traj"]) <= max(5 * lock_ate, 0.20),
               f"{mode}: {len(rec['traj'])} of {n} frames tracked, ATE {ate_of(rec['traj']):.4f} m "
               f"(lock-step {lock_ate:.4f} m)")

    # a mapping job held on an event: keyframe frames return, the queue gate
    # bounds keyframe production (tests/test_async_mapping.py)
    run("async", host[:WARM_FRAMES], measure=False)
    held = run("async", host[:HELD_FRAMES], hold=threading.Event())
    print(f"{tag} MonoSlam async, mapping held on an event for {HELD_FRAMES} frames: {held['held_kfs']} keyframes "
          f"queued, frames returned in median {np.median(held['ms'][3:]):.3f} ms; then "
          f"{len(held['jobs'])} jobs ran, clean shutdown")
    _check(2 <= held["held_kfs"] <= HELD_FRAMES / THREADED_KF_INTERVAL + 3,
           f"async, held mapping: {held['held_kfs']} keyframes inserted in {HELD_FRAMES} frames")

    # flushed after every frame, streaming reproduces lock-step on frames 0-9
    # with tests/test_streaming.py's tolerances
    run("streaming, depth 1", host[:FLUSHED_FRAMES], measure=False, flushed=True)
    flushed = run("streaming, depth 1", host[:FLUSHED_FRAMES], flushed=True)
    for i, (a, b) in enumerate(zip(flushed["rows"], results["lock-step"]["rows"])):
        _check(a[0] == b[0] and abs(a[1] - b[1]) <= 6 and a[2] == b[2] and abs(a[3] - b[3]) <= 12,
               f"flushed streaming vs lock-step, frame {i}: {a} vs {b}")
    print(f"{tag} MonoSlam streaming flushed after every frame (depth 1), frames 0-{FLUSHED_FRAMES - 1}: "
          f"state, keyframe ids equal to lock-step's; inliers within "
          f"{max(abs(a[1] - b[1]) for a, b in zip(flushed['rows'], results['lock-step']['rows']))}, points within "
          f"{max(abs(a[3] - b[3]) for a, b in zip(flushed['rows'], results['lock-step']['rows']))}")

    # a blackout: frames 9-14 blank; the run recovers (tests/test_streaming.py)
    run("streaming", host[:BLACKOUT_FRAMES], measure=False, blank=BLACKOUT)
    dark = run("streaming", host[:BLACKOUT_FRAMES], blank=BLACKOUT)
    after = int((dark["traj"][:, 0] >= seq.timestamps[RECOVERED_FROM]).sum())
    print(f"{tag} MonoSlam streaming, frames {BLACKOUT[0]}-{BLACKOUT[-1]} blank: {after} trajectory entries from "
          f"frame {RECOVERED_FROM} on, final {dark['state']}, {len(dark['traj'])} of {BLACKOUT_FRAMES} frames tracked")
    _check(after >= 4, f"streaming did not recover after the blackout: {after} entries from frame {RECOVERED_FROM} on")
    launches = {"MonoSlam async": results["async"]["k1"]["graph"] + results["async"]["k1"]["eager"],
                "MonoSlam streaming": results["streaming"]["k1"]["graph"] + results["streaming"]["k1"]["eager"]}
    return launches, lock_ate


def _dtype_switch_phase(cam, dev, tag: str, lock_ate: float) -> dict:
    """A threaded MonoSlam whose frames change dtype mid-run (float32, then
    uint8 frames of the same images from frame SWITCH_AT on), async and
    streaming, at SWITCH_FEATURES features (a configuration no earlier
    phase captured at uint8): the run stops its threads at the switch,
    captures the cores its mode replays at the new key (one new capture)
    and restarts them, and keeps the un-flushed contract
    (tests/test_streaming.py). Returns K1 launches by mode."""
    import numpy as np

    from viorb_tpu_torch import cuda_graph
    from viorb_tpu_torch.cuda_graph import WARMUP_CALLS
    from viorb_tpu_torch.eval.ate import ate_rmse
    from viorb_tpu_torch.features import fast_cuda
    from viorb_tpu_torch.io import synthetic
    from viorb_tpu_torch.slam.mono import MonoSlam
    from viorb_tpu_torch.slam.tracking_loop import make_pipeline_track_core, make_streaming_track_core

    seq = synthetic.make_sequence(SLAM_FRAMES, cam=cam, dt=SLAM_DT, device=dev)
    frames = [im.cpu().numpy() if i < SWITCH_AT else synthetic.to_uint8(im).cpu().numpy()
              for i, im in enumerate(seq.images)]
    launches = {}
    for mode in ("async", "streaming"):
        slam = MonoSlam(cam, device=dev, n_features=SWITCH_FEATURES, kf_max_interval=THREADED_KF_INTERVAL,
                        **THREADED_MODES[mode])
        cores = (make_pipeline_track_core(cam, slam.extractor), make_streaming_track_core(cam, slam.extractor))
        for c in cores:
            c.reset_counts()
        fast_cuda.LAUNCHES = fast_cuda.CELL_LAUNCHES = 0
        at_start = [len(c.captured()) for c in cores]
        try:
            for i, (image, ts) in enumerate(zip(frames, seq.timestamps)):
                if i == SWITCH_AT:
                    at_switch = [len(c.captured()) for c in cores]
                    threads = (slam._worker, slam._collector)
                slam.process_frame(image, float(ts))
            slam.wait_mapping_idle()
            traj = slam.trajectory_tum()
            state = slam.state
        finally:
            slam.shutdown()
        new = sum(len(c.captured()) - n for c, n in zip(cores, at_switch))
        ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)
        # each capture made in this run first ran its function eagerly
        # WARMUP_CALLS times (cuda_graph.py): those launches extract no frame
        warm = WARMUP_CALLS * sum(len(c.captured()) - n for c, n in zip(cores, at_start))
        launches[mode] = sum(c.launches()["CELL_LAUNCHES"] for c in cores) + fast_cuda.CELL_LAUNCHES - warm
        print(f"{tag} MonoSlam {mode}, float32 frames then uint8 frames of the same images from frame {SWITCH_AT}: "
              f"{slam.recaptures} recapture (threads stopped, {new} graph captured at the new key, threads "
              f"restarted), final {state}, {len(traj)} of {SLAM_FRAMES} frames tracked, ATE {ate:.4f} m after "
              f"Sim3; K1 launches {launches[mode]} for {SLAM_FRAMES} frames (the captures' warm-up calls apart)")
        _check(slam.recaptures == 1 and new == 1 and not any(t is not None and t.is_alive() for t in threads)
               and cuda_graph.card_threads() == 0,
               f"{mode}: the dtype switch must stop the first threads, capture once and restart")
        _check(state == "OK" and len(traj) >= 0.8 * SLAM_FRAMES and ate <= max(5 * lock_ate, 0.20),
               f"{mode} with a dtype switch: final {state}, {len(traj)} frames tracked, ATE {ate:.4f} m")
        _check(launches[mode] == SLAM_FRAMES, f"{mode} with a dtype switch: K1 launches {launches[mode]}")
        _check_main_thread_only(f"MonoSlam {mode} with a dtype switch")
    return launches


def _async_ate_phase(cam, dev, tag: str) -> None:
    """Un-paced async mapping at tests/test_async_mapping.py's exact
    configuration (its 40-frame sequence at dt=0.1, float32 frames,
    n_features=800, kf_max_interval=5), ASYNC_RUNS runs after a warm-up run,
    and one lock-step run for comparison: every ATE (after Sim3) against the
    test's 0.06 m, which this phase reports and does not enforce; the rest of
    the test's contract (final state OK, the map published) it does."""
    import numpy as np

    from viorb_tpu_torch.eval.ate import ate_rmse
    from viorb_tpu_torch.io import synthetic
    from viorb_tpu_torch.slam.mono import MonoSlam

    seq = synthetic.make_sequence(SLAM_FRAMES, cam=cam, dt=SLAM_DT, device=dev)
    frames = [im.cpu().numpy() for im in seq.images]  # float32 from the host, as the test feeds them

    def run(async_mapping: bool):
        slam = MonoSlam(cam, device=dev, n_features=800, kf_max_interval=5, async_mapping=async_mapping)
        solves = []
        local_ba = slam._local_ba
        slam._local_ba = lambda *a, **k: (solves.append(1), local_ba(*a, **k))[1]
        t0 = time.perf_counter()
        try:
            for image, ts in zip(frames, seq.timestamps):
                info = slam.process_frame(image, float(ts))
            slam.wait_mapping_idle()
            wall = time.perf_counter() - t0
            traj = slam.trajectory_tum()
        finally:
            slam.shutdown()
        ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)
        _check_main_thread_only("un-paced async")
        return dict(state=info["state"], version=slam.map.version, ate=ate, kfs=slam.map._next_kf,
                    jobs=len(slam.job_times), solves=len(solves), fps=SLAM_FRAMES / wall, skipped=slam.ba_skipped,
                    ba_ms=[j["ba"] for j in slam.job_times], job_ms=[j["total"] for j in slam.job_times],
                    split=_ba_split(slam, "un-paced async"))

    run(True)  # warm-up
    lock = run(False)
    runs = [run(True) for _ in range(ASYNC_RUNS)]
    ates = [r["ate"] for r in runs]
    print(f"{tag} MonoSlam at tests/test_async_mapping.py's configuration (800 features, a keyframe at least every "
          f"5 frames, float32 frames fed un-paced): lock-step ATE {lock['ate']:.4f} m ({lock['kfs']} keyframes, "
          f"{lock['solves']} local BAs, {lock['fps']:.1f} fps); async, {ASYNC_RUNS} runs: ATE "
          + ", ".join(f"{a:.4f}" for a in ates) + " m; " + ", ".join(
              f"{r['kfs']} keyframes / {r['jobs']} jobs / {r['solves']} local BAs run / {r['skipped']} skipped / "
              f"{r['fps']:.1f} fps" for r in runs)
          + f"; {sum(a < 0.06 for a in ates)} of {ASYNC_RUNS} under the test's 0.06 m")
    for i, r in enumerate(runs):
        print(f"{tag} un-paced async run {i}: job ms median {np.median(r['job_ms']):.1f} (max {max(r['job_ms']):.1f}), "
              f"local BA ms a job " + ", ".join(f"{x:.1f}" for x in r["ba_ms"]) + f"; {r['split']}")
    for r in runs + [lock]:
        _check(r["state"] == "OK" and r["version"] > 0, f"async at the test's configuration: {r}")


def _vi_phase(cam, dev, tag: str) -> int:
    """Lock-step monocular-inertial SLAM: MonoViSlam at
    tests/test_e2e_vi.py's configuration (800 features, VI init after 2.5 s
    and 8 keyframes, a keyframe at least every 5 frames, IMU capacity 256)
    over its 60-frame 752x480 arc at dt=0.1 with the 200 Hz synthetic IMU,
    rendered on the card: a warm-up run, then the measured run with the
    launch counts set to 0 just before it. Both draw the two-view RANSAC's
    hypotheses that the reference's run with seed 0 drew (its minimal sets
    are in tests/torch_vi_golden.npz; the port's own code fits and scores
    them): the outcome at this configuration hangs on that draw in both
    packages (the reference's seeds 0-5 in the golden), and with the same
    draw the port reproduces the reference's run. Asserts the reference's
    contract (VI ready; final state OK or IMU_ONLY; > 60 % of frames OK;
    gravity cos > 0.996; metric ATE < 0.05 m; after 4.5 s metric and Sim3
    ATE < 0.02 m; scale 0.94-1.06), agreement with that golden run (VI
    init at the same frame, tests/test_torch_mono_vi.py's tolerances),
    K1 launches = frames,
    ONE graph replay and ONE host sync of the tracker a steady VI frame, 0
    host syncs in a replay of each VI graph, and each graph's replay equal
    to its eager function on 3 frames. Then times: the VI core graphed and
    eager (ms and kernels a frame), K7 (a graph of `preintegrate` alone at
    capacity 256) and its share of the core, the steady VI frame, VI init,
    `vi_ba` and `vi_ba_gw` per LM iteration at the window the run used, and
    the VI mapping job. Last, VI_OWN_SEEDS runs with the port's own draws
    (its torch.Generator seeded 0-5): the contract's draw-independent part
    is asserted (VI ready, final OK or IMU_ONLY, > 60 % of frames OK,
    gravity cos > 0.996), the metric ATE and scale are reported beside the
    reference's seeds. Returns the measured run's K1 launches."""
    import os

    import numpy as np
    import torch

    from viorb_tpu_torch.cuda_graph import GraphedFunction
    from viorb_tpu_torch.eval.ate import associate, ate_rmse, umeyama_alignment
    from viorb_tpu_torch.eval.gravity import gravity_angle_deg
    from viorb_tpu_torch.features import fast_cuda
    from viorb_tpu_torch.imu.preintegration import preintegrate
    from viorb_tpu_torch.io import synthetic
    from viorb_tpu_torch.optim import ba as ba_module
    from viorb_tpu_torch.slam import mono as mono_module
    from viorb_tpu_torch.slam import mono_vi as mono_vi_module
    from viorb_tpu_torch.slam.mono_vi import MonoViSlam
    from viorb_tpu_torch.solvers.two_view import two_view_from_samples
    from viorb_tpu_torch.slam.tracking_loop import ViPipelineCore, make_pipeline_track_core, make_vi_pipeline_core

    golden_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_vi_golden.npz")
    fields = ("init_frame", "n_kfs", "gravity", "traj", "ate_metric", "ate_post_metric", "ate_post_sim3",
              "scale_ratio", "config", "two_view_calls")
    with np.load(golden_path) as z:
        goldens = {name: {f: z[f"{name}_{f}"] for f in fields} for name in VI_GOLDENS}
        replayed = VI_GOLDENS[0]
        draws = [tuple(z[f"{replayed}_two_view{i}_{k}"] for k in ("x1", "valid", "idx_h", "idx_f"))
                 for i in range(int(goldens[replayed]["two_view_calls"]))]
    for name, g in goldens.items():
        config = dict(g["config"].tolist())
        _check(int(config["n_frames"]) == VI_FRAMES and float(config["dt"]) == VI_DT
               and int(config["width"]) == cam.width and int(config["n_features"]) == VI_CONFIG["n_features"]
               and int(config["kf_max_interval"]) == VI_CONFIG["kf_max_interval"],
               f"the golden {name}'s configuration is not this phase's: {config}")
    seq = synthetic.make_sequence(VI_FRAMES, cam=cam, dt=VI_DT, device=dev)
    imu = synthetic.make_imu(VI_FRAMES, VI_DT, hz=200.0)
    samples = []
    prev = -np.inf
    for ts in seq.timestamps:
        sel = (imu.t > prev) & (imu.t <= ts)
        samples.append([(float(t), g, a) for t, g, a in zip(imu.t[sel], imu.gyro[sel], imu.acc[sel])])
        prev = ts
    on_card = dev.type == "cuda"
    recorded = {}  # use_prior -> the VI core's arguments on its first frames in that mode
    ba_calls = {}  # "vi_ba" / "vi_ba_gw" -> the last VI / gravity-vertex BA's arguments

    def record_core(call):
        def wrapped(self, *args, use_prior=False):
            kept = recorded.setdefault(use_prior, [])
            if len(kept) < 3:
                kept.append(tuple(a.clone() if isinstance(a, torch.Tensor) else type(a)(*[x.clone() for x in a])
                                  for a in args))
            return call(self, *args, use_prior=use_prior)
        return wrapped

    def record_ba(name, fn):
        def wrapped(*args, **kwargs):
            ba_calls[name] = (args, kwargs)  # the last: the window of the steady mapping jobs
            return fn(*args, **kwargs)
        return wrapped

    two_view = mono_module.two_view_init
    replay_log = []

    def replaying():
        """The reference's minimal sets, call by call, then the port's own."""
        calls = iter(draws)

        def two_view_init(x1, x2, valid, cam_, generator, n_hypotheses=256):
            ref = next(calls, None)
            if ref is None:
                replay_log.append("own draw")
                return two_view(x1, x2, valid, cam_, generator, n_hypotheses)
            ref_x1, ref_valid, idx_h, idx_f = ref
            replay_log.append((bool(np.array_equal(valid.cpu().numpy(), ref_valid)),
                               float(np.abs(x1.cpu().numpy() - ref_x1).max())))
            return two_view_from_samples(x1, x2, valid, cam_, torch.from_numpy(idx_h).to(x1.device),
                                         torch.from_numpy(idx_f).to(x1.device))

        return two_view_init

    def run(measure: bool, seed=None):
        """A run with the reference's draws, or with the port's own from `seed`."""
        slam = MonoViSlam(cam, device=dev, seed=seed or 0, **VI_CONFIG)
        replay_log.clear()
        mono_module.two_view_init = replaying() if seed is None else two_view
        # the process-wide cores this run replays (slam/tracking_loop.py's cache)
        pipe = make_pipeline_track_core(cam, slam.extractor)
        vi_core = make_vi_pipeline_core(cam, slam.extractor, slam.ext, slam.imu_noise)
        rows, frame_ms, frame_syncs, replays, mapped = [], [], [], [], []
        pipe.reset_counts()
        for g in vi_core.graphs.values():
            g.reset_counts()
        fast_cuda.LAUNCHES = fast_cuda.CELL_LAUNCHES = 0
        if on_card:
            torch.cuda.synchronize()
            if measure:
                torch.cuda.set_sync_debug_mode("warn")
        t_run = time.perf_counter()
        try:
            for image, ts, imu_samples in zip(seq.images, seq.timestamps, samples):
                before = sum(g.replays for g in vi_core.graphs.values()) + pipe.replays
                jobs = len(slam.job_times)
                t0 = time.perf_counter()
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    info = slam.process_frame_vi(image, float(ts), imu_samples)  # ends in a pull
                frame_ms.append((time.perf_counter() - t0) * 1e3)
                frame_syncs.append(sum("synchroniz" in str(w.message) for w in caught))
                replays.append(sum(g.replays for g in vi_core.graphs.values()) + pipe.replays - before)
                mapped.append(len(slam.job_times) > jobs)
                rows.append((info["state"], info["n_tracked"], info["n_kfs"], slam.vi_ready))
        finally:
            mono_module.two_view_init = two_view
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
        wall_s = time.perf_counter() - t_run
        _check(slam._vi_core is vi_core, "MonoViSlam replays another VI core than the process-wide one")
        graphs = list(vi_core.graphs.values())
        counts = dict(graph=sum(g.launches()["CELL_LAUNCHES"] for g in graphs) + pipe.launches()["CELL_LAUNCHES"],
                      eager=fast_cuda.CELL_LAUNCHES,
                      single=fast_cuda.LAUNCHES + sum(g.launches()["LAUNCHES"] for g in graphs + [pipe]),
                      replays=sum(g.replays for g in graphs) + pipe.replays)
        return slam, vi_core, rows, frame_ms, frame_syncs, replays, mapped, wall_s, counts

    def record_graph_ba(call):
        def wrapped(self, graph, *args):
            ba_calls["vi_ba"] = (graph, args)  # the last: the window of the steady mapping jobs
            return call(self, graph, *args)
        return wrapped

    t_warm = time.perf_counter()
    run(measure=False)
    warm_s = time.perf_counter() - t_warm
    orig = (ViPipelineCore.__call__, MonoViSlam._vi_ba_call, mono_vi_module.vi_ba_gw_two_phase)
    ViPipelineCore.__call__ = record_core(orig[0])
    MonoViSlam._vi_ba_call = record_graph_ba(orig[1])
    mono_vi_module.vi_ba_gw_two_phase = record_ba("vi_ba_gw", orig[2])
    try:
        slam, vi_core, rows, frame_ms, frame_syncs, replays, mapped, wall_s, counts = run(measure=True)
        measured_log = list(replay_log)
    finally:
        ViPipelineCore.__call__, MonoViSlam._vi_ba_call, mono_vi_module.vi_ba_gw_two_phase = orig
    launches = counts["graph"] + counts["eager"]
    ba_split = _ba_split(slam, "MonoViSlam", local_kinds=("local", "vi_local"))
    _check(slam.ba_replays.get("vi_local", 0) >= 1 and "vi_local" not in slam.ba_eager_calls,
           f"MonoViSlam: every local VI BA must replay its graph: {ba_split}")

    # the reference's contract (tests/test_e2e_vi.py)
    states = [r[0] for r in rows]
    n_ok = states.count("OK")
    vi_init = next((i for i, r in enumerate(rows) if r[3]), -1)
    g_est = np.asarray(slam.gravity, np.float64)
    g_true = synthetic.GRAVITY_W.astype(np.float64)
    cos = float(g_est @ g_true / (np.linalg.norm(g_est) * np.linalg.norm(g_true)))
    traj = slam.trajectory_tum()
    post = traj[:, 0] >= VI_POST_INIT_T
    ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=False)
    ate_post = ate_rmse(traj[post, 0], traj[post, 1:4], seq.timestamps, seq.c_w, with_scale=False)
    ate_post_sim3 = ate_rmse(traj[post, 0], traj[post, 1:4], seq.timestamps, seq.c_w, with_scale=True)
    scale = float(np.linalg.norm(np.ptp(traj[:, 1:4], axis=0)) / np.linalg.norm(np.ptp(seq.c_w, axis=0)))
    print(f"{tag} MonoViSlam lock-step, {VI_FRAMES} rendered {cam.width}x{cam.height} frames at dt={VI_DT} with "
          f"the 200 Hz IMU: vision init at frame {states.index('OK') if 'OK' in states else -1}, VI init at frame "
          f"{vi_init}, {n_ok} frames OK, final {rows[-1][0]}, {rows[-1][2]} keyframes; gravity cos {cos:.6f}; "
          f"metric ATE {ate:.4f} m, after {VI_POST_INIT_T} s metric {ate_post:.4f} m / Sim3 {ate_post_sim3:.4f} m; "
          f"scale {scale:.4f}")
    _check(slam.vi_ready and rows[-1][0] in ("OK", "IMU_ONLY") and n_ok > 0.6 * VI_FRAMES and cos > 0.996
           and ate < 0.05 and ate_post < 0.02 and ate_post_sim3 < 0.02 and 0.94 < scale < 1.06,
           "MonoViSlam misses tests/test_e2e_vi.py's contract")

    # the reference's run whose draws this run replayed
    gold_name = replayed
    gold = goldens[gold_name]
    print("MonoViSlam two-view RANSAC calls in the measured run: " + ", ".join(
        e if isinstance(e, str) else f"{gold_name}'s minimal sets (valid matches {'equal' if e[0] else 'DIFFERENT'}, "
        f"x1 within {e[1]:.2e} px of the reference's)" for e in measured_log))

    def apart(a, b):
        ia, ib = associate(a[:, 0], b[:, 0])
        s_, r_, t_ = umeyama_alignment(a[ia, 1:4], b[ib, 1:4], with_scale=True)
        err = b[ib, 1:4] - (s_ * a[ia, 1:4] @ r_.T + t_)
        return float(np.sqrt((err**2).sum(1).mean())) / float(np.linalg.norm(b[:, 1:4] - b[0, 1:4], axis=1).max())

    rms_share = apart(traj, gold["traj"])
    angle = gravity_angle_deg(g_est, gold["gravity"])
    n_kfs = np.array([r[2] for r in rows])
    print(f"MonoViSlam vs the reference's {gold_name} (VI init at frame {int(gold['init_frame'])}, metric ATE "
          f"{float(gold['ate_metric']):.4f} m, scale {float(gold['scale_ratio']):.4f}): trajectories "
          f"{rms_share * 100:.4f} % of the extent apart (RMS after Sim3), gravity {angle:.4f} deg apart, scale "
          f"{scale - float(gold['scale_ratio']):+.5f}, metric ATE {ate / float(gold['ate_metric']):.4f}x, keyframes "
          f"per frame within {int(np.abs(n_kfs - gold['n_kfs']).max())}")
    _check(vi_init == int(gold["init_frame"]) and rms_share <= VI_TRAJ_SHARE and angle <= VI_GRAVITY_DEG
           and abs(scale - float(gold["scale_ratio"])) <= VI_SCALE_TOL and ate <= VI_ATE_FACTOR * float(gold["ate_metric"])
           and int(np.abs(n_kfs - gold["n_kfs"]).max()) <= 1,
           f"MonoViSlam and the reference's {gold_name} disagree")

    # K1 and the steady VI frame: one graph replay and one host sync
    print(f"MonoViSlam K1 launches: {counts['graph']} through graphs ({counts['replays']} replays) + "
          f"{counts['eager']} eager = {launches} for {VI_FRAMES} frames; single-image launches {counts['single']}")
    steady = [i for i in range(VI_FRAMES) if i > vi_init >= 0 and states[i] == "OK" and not mapped[i]
              and rows[i - 1][0] == "OK"]
    steady_ms = np.array([frame_ms[i] for i in steady])
    steady_syncs = [frame_syncs[i] for i in steady]
    steady_replays = [replays[i] for i in steady]
    sync_hist = {int(k): int(v) for k, v in zip(*np.unique(steady_syncs, return_counts=True))}
    print(f"{tag} MonoViSlam steady VI frames ({len(steady)}): graph replays a frame "
          f"{sorted(set(steady_replays))}, host syncs of the tracker {sync_hist} (syncs: frames); median "
          f"{np.median(steady_ms):.3f} ms, p90 {np.percentile(steady_ms, 90):.3f} ms a frame (host clock)")
    _check(len(steady) >= 10 and set(steady_replays) == {1}, f"steady VI frames: replays {steady_replays}")
    if on_card:
        _check(launches == VI_FRAMES and counts["single"] == 0 and counts["graph"] == counts["replays"],
               f"MonoViSlam K1 launches {counts} for {VI_FRAMES} frames")
        _check(set(steady_syncs) == {1}, f"a steady VI frame must sync once: {steady_syncs}")

    # each VI graph: 0 host syncs in a replay, a replay equal to the eager
    # function on 3 recorded frames, graphed and eager times, kernels a frame
    core_ms = {}
    for use_prior, frames_args in sorted(recorded.items()):
        graph = vi_core.graphs[use_prior]
        label = "frame-to-frame with the prior" if use_prior else "frame-to-keyframe"
        _check(len(frames_args) == 3, f"VI core, {label}: {len(frames_args)} recorded frames")
        for args in frames_args:
            out, ref = _leaves(graph(*args)), _leaves(graph.eager(*args))
            _check(all(torch.equal(a, b) for a, b in zip(out, ref)), f"VI core, {label}: replay != eager")
        syncs = _count_syncs(lambda: graph(*frames_args[0]))
        _check(not syncs, f"VI core, {label}: a replay synced with the host: {syncs}")
        g_ms = _event_ms(lambda: graph(*frames_args[0]), reps=50)
        e_ms = _event_ms(lambda: graph.eager(*frames_args[0]), reps=5, warmup=1)
        core_ms[use_prior] = g_ms
        kernels = _kernels_per_call(lambda: graph.eager(*frames_args[0]))
        print(f"{tag} VI core, {label}: graphed {g_ms:.3f} ms a frame, eager {e_ms:.3f} ms a frame (CUDA events); "
              f"{kernels} kernels a frame (eager, profiler); 0 host syncs in a replay; replay == eager on 3 frames")

    # K7: the preintegration alone, as a graph at capacity 256, on the
    # recorded frame-to-keyframe frame's since-keyframe batch
    args = recorded[False][0]
    batch_kf, t_kf, t_now, bias_g, bias_a = args[4], args[7], args[6], args[8], args[9]
    k7 = GraphedFunction(lambda b, bg, ba, t0, t1: preintegrate(b, bg, ba, t0, t1, slam.imu_noise))
    k7_ms = _event_ms(lambda: k7(batch_kf, bias_g, bias_a, t_kf, t_now), reps=100)
    k7_eager = _event_ms(lambda: k7.eager(batch_kf, bias_g, bias_a, t_kf, t_now), reps=10)
    k7_kernels = _kernels_per_call(lambda: k7.eager(batch_kf, bias_g, bias_a, t_kf, t_now))
    print(f"{tag} K7 preintegrate, capacity {slam.imu_capacity}, one segment: graphed {k7_ms:.4f} ms, eager "
          f"{k7_eager:.3f} ms, {k7_kernels} kernels; two of them (since the frame, since the keyframe) are "
          f"{2 * k7_ms / core_ms[False] * 100:.1f} % of the frame-to-keyframe core's "
          f"{core_ms[False]:.3f} ms" + (f", one is {k7_ms / core_ms[True] * 100:.1f} % of the frame-to-frame "
                                         f"core's {core_ms[True]:.3f} ms" if True in core_ms else ""))

    # the local VI BA's graph on the measured run's last window: replay ==
    # eager, 0 host syncs, ms, kernels
    graph, graph_args = ba_calls["vi_ba"]
    graph_args = _contiguous(graph_args)
    vi_graph = _graph_check(tag, f"local VI BA K={graph_args[0].nav.p.shape[0]} M={graph_args[1].shape[0]} "
                                 f"R={graph_args[1].shape[1]} (the run's last window)", graph, graph_args)
    state_, kf_idx_, uv_, inv_s2_, valid_, ext_, pre_, edge_valid_, bias_info_, gravity_, fixed_ = graph_args
    ba_calls["vi_ba"] = ((state_, ba_module.BAObservations(kf_idx_, uv_, inv_s2_, valid_), cam, ext_,
                          ba_module.ImuChain(pre_, edge_valid_, bias_info_), gravity_, fixed_), {})

    # the VI BAs per LM iteration at the window the run used
    for name, fn in (("vi_ba", ba_module.vi_ba), ("vi_ba_gw", ba_module.vi_ba_gw)):
        if name not in ba_calls:
            print(f"{tag} {name}: not run in this run")
            continue
        (state, obs, cam_, ext, chain, gravity, fixed), kw = ba_calls[name][0][:7], ba_calls[name][1]
        ba_ms = _event_ms(lambda: fn(state, obs, cam_, ext, chain, gravity, fixed, iters=BA_ITERS),
                          reps=3, warmup=1) / BA_ITERS
        syncs = _count_syncs(lambda: fn(state, obs, cam_, ext, chain, gravity, fixed, iters=1))
        print(f"{tag} {name} K={state.nav.p.shape[0]} M={obs.kf_idx.shape[0]} R={obs.kf_idx.shape[1]} "
              f"E={chain.valid.shape[0]}: {ba_ms:.3f} ms per LM iteration (eager, CUDA events, {BA_ITERS} "
              f"iterations a solve); host syncs in one iteration: {len(syncs)}")

    vi_jobs = [j for j, i in zip(slam.job_times, [i for i in range(VI_FRAMES) if mapped[i]]) if i > vi_init]
    parts = {k: float(np.median([j[k] for j in vi_jobs])) for k in vi_jobs[0]} if vi_jobs else {}
    print(f"{tag} MonoViSlam VI init (the keyframe frame whose mapping job initialized VI, frame {vi_init}): "
          f"{frame_ms[vi_init]:.3f} ms; VI mapping jobs after it, median of {len(vi_jobs)}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + " ms; the VI BAs (kind, K, ms): "
          + ", ".join(f"{k} {n} {ms:.1f}" for k, n, ms in slam.vi_ba_times) + f"; {ba_split}")
    print(f"{tag} MonoViSlam whole run: {wall_s:.3f} s for {VI_FRAMES} frames = {VI_FRAMES / wall_s:.2f} fps "
          f"(host clock; warm-up run {warm_s:.2f} s)")

    # the port's own draws: the outcome spreads with the draw, as the
    # reference's seeds do
    def contract(metric, post, post_sim3, sc):
        return metric < 0.05 and post < 0.02 and post_sim3 < 0.02 and 0.94 < sc < 1.06

    own = []
    for seed in VI_OWN_SEEDS:
        o_slam, _, o_rows, *_ = run(measure=False, seed=seed)
        o_traj = o_slam.trajectory_tum()
        o_post = o_traj[:, 0] >= VI_POST_INIT_T
        g_o = np.asarray(o_slam.gravity, np.float64)
        o_cos = float(g_o @ g_true / (np.linalg.norm(g_o) * np.linalg.norm(g_true)))
        o_states = [r[0] for r in o_rows]
        vals = (ate_rmse(o_traj[:, 0], o_traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=False),
                ate_rmse(o_traj[o_post, 0], o_traj[o_post, 1:4], seq.timestamps, seq.c_w, with_scale=False),
                ate_rmse(o_traj[o_post, 0], o_traj[o_post, 1:4], seq.timestamps, seq.c_w, with_scale=True),
                float(np.linalg.norm(np.ptp(o_traj[:, 1:4], axis=0)) / np.linalg.norm(np.ptp(seq.c_w, axis=0))))
        own.append((seed, next((i for i, r in enumerate(o_rows) if r[3]), -1), o_cos, *vals))
        _check(o_slam.vi_ready and o_states[-1] in ("OK", "IMU_ONLY") and o_states.count("OK") > 0.6 * VI_FRAMES
               and o_cos > 0.996, f"MonoViSlam with its own draw, seed {seed}: {o_states[-1]}, cos {o_cos:.5f}")
    ref_vals = [(n, int(g["init_frame"]), float(g["ate_metric"]), float(g["ate_post_metric"]),
                 float(g["ate_post_sim3"]), float(g["scale_ratio"])) for n, g in goldens.items()]
    print(f"{tag} MonoViSlam with the port's own two-view draws (seed, VI init frame, gravity cos, metric ATE, "
          f"post-init metric / Sim3, scale): "
          + "; ".join(f"{s_} {f_} {c_:.5f} {m_:.4f} {p_:.4f}/{q_:.4f} {r_:.4f}" for s_, f_, c_, m_, p_, q_, r_ in own)
          + f"; the full contract holds in {sum(contract(*o[3:]) for o in own)} of {len(own)}. The reference's "
          f"seeds (golden): " + "; ".join(f"{n} {f_} {m_:.4f} {p_:.4f}/{q_:.4f} {r_:.4f}" for n, f_, m_, p_, q_, r_
                                          in ref_vals)
          + f"; the full contract holds in {sum(contract(*r[2:]) for r in ref_vals)} of {len(ref_vals)}")
    return launches, traj


def _feed_vi(cam, seq, imu, slam, label, launches, draws=None, drained=False, paced=False):
    """Every frame of `seq` with its IMU samples through `slam` (a
    MonoViSlam), with the K1 counters set to 0 just before; `draws`, the
    two-view hypotheses to replay (None: the port's own draw); `drained`,
    wait_mapping_idle after each frame; `paced`, each frame handed over at
    its timestamp (the camera's rate). Puts the run's K1 launches in
    `launches[label]` and checks them against the frames. Per frame (state,
    host ms, kind, after VI init's refinement window, features tracked, a
    keyframe made)."""
    import numpy as np

    from viorb_tpu_torch.features import fast_cuda
    from viorb_tpu_torch.slam.tracking_loop import make_pipeline_track_core, make_vi_pipeline_core

    prev, rows = -np.inf, []
    cores = [make_pipeline_track_core(cam, slam.extractor)] + list(
        make_vi_pipeline_core(cam, slam.extractor, slam.ext, slam.imu_noise).graphs.values())
    for c in cores:
        c.reset_counts()
    fast_cuda.LAUNCHES = fast_cuda.CELL_LAUNCHES = 0
    t_start = time.perf_counter()
    with (_two_view_replay(draws) if draws is not None else contextlib.nullcontext()) as log:
        for image, ts in zip(seq.images, seq.timestamps):
            sel = (imu.t > prev) & (imu.t <= ts)
            prev = ts
            samples = [(float(t), g, a) for t, g, a in zip(imu.t[sel], imu.gyro[sel], imu.acc[sel])]
            if paced:
                time.sleep(max(0.0, t_start + float(ts) - time.perf_counter()))
            vi, rebases, kfs = slam.vi_ready, slam.rebases, slam.map._next_kf
            ahead = vi and ts - slam.init_time >= slam.init_refine_window
            busy = slam._mapping_queue.unfinished_tasks > 0
            t0 = time.perf_counter()
            info = slam.process_frame_vi(image, float(ts), samples)
            ms = (time.perf_counter() - t0) * 1e3
            if drained:
                slam.wait_mapping_idle()
            kind = ("before VI init" if not vi else "re-basing" if slam.rebases > rebases
                    else "keyframe" if slam.map._next_kf > kfs else "beside a job" if busy else "worker idle")
            rows.append((info["state"], ms, kind, ahead, info["n_tracked"], slam.map._next_kf > kfs))
    _check(draws is None or (bool(log) and all(x is True for x in log if x != "own draw")),
           f"{label}: the replayed two-view draws met other matches: {log}")
    n = sum(c.launches()["CELL_LAUNCHES"] for c in cores) + fast_cuda.CELL_LAUNCHES
    launches[label] = n
    _check(seq.images[0].device.type != "cuda" or n == len(seq.images),
           f"{label}: K1 launches {n} for {len(seq.images)} frames")
    return rows


def _vi_laps(cam, dev):
    """The laps (two circuits of the closed room) rendered on `dev` and
    their clean 200 Hz IMU: (sequence, imu)."""
    from viorb_tpu_torch.io import synthetic

    return (synthetic.make_sequence(VI_LAPS_FRAMES, cam=cam, dt=VI_LAPS_DT, kind="laps", device=dev),
            synthetic.make_imu(VI_LAPS_FRAMES, VI_LAPS_DT, hz=200.0, kind="laps"))


def _vi_laps_run(cam, seq, imu, tag: str, launches: dict, paced: bool = True, async_mapping: bool = True,
                 seed: int = 0) -> dict:
    """MonoViSlam at VI_CONFIG (async unless told) over the laps with the
    IMU, the port's own two-view draw from `seed`, fed at the camera's 10
    fps (`paced`) or as fast as the tracker takes the frames; then
    wait_mapping_idle and one last drain. The run is long enough that the async tracker passes VI
    init's refinement window and runs beside the worker, as the reference's
    does. Prints and returns the outcome (VI ready, frames OK, gravity cos,
    metric and Sim3 ATE) and the concurrent regime: frames past the window,
    those begun beside a running job and their host ms, re-bases, BAs
    skipped, keyframe decisions under the 1.5 s gap, keyframes carried
    through a write-back, frames tracked across one."""
    import numpy as np

    from viorb_tpu_torch.eval.ate import ate_rmse
    from viorb_tpu_torch.io import synthetic
    from viorb_tpu_torch.slam.mono_vi import MonoViSlam

    slam = MonoViSlam(cam, device=seq.images[0].device, async_mapping=async_mapping, seed=seed, **VI_CONFIG)
    mode = ("async" if async_mapping else "lock-step") + (", camera rate" if paced else ", un-paced") + f", seed {seed}"
    label = f"MonoViSlam laps ({mode})"
    t0 = time.perf_counter()
    try:
        rows = _feed_vi(cam, seq, imu, slam, label, launches, paced=paced)
        slam.wait_mapping_idle()
        if async_mapping:
            slam._drain_tracker_rebase()
        wall = time.perf_counter() - t0
        traj = slam.trajectory_tum()
    finally:
        slam.shutdown()
    _check_main_thread_only(label)
    g = np.asarray(slam.gravity if slam.gravity is not None else np.zeros(3), np.float64)
    cos = float(g @ synthetic.GRAVITY_W / max(np.linalg.norm(g) * np.linalg.norm(synthetic.GRAVITY_W), 1e-12))
    ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=False)
    sim3 = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)
    ahead = [r for r in rows if r[3]]
    beside = [r[1] for r in ahead if r[2] == "beside a job"]
    out = dict(vi_ready=slam.vi_ready, ok=sum(r[0] == "OK" for r in rows), final=rows[-1][0], cos=cos, ate=ate,
               sim3=sim3, ahead=len(ahead), beside=len(beside), rebases=slam.rebases, skipped=slam.ba_skipped,
               saturated=slam.saturated_kf_decisions, carried=slam.kfs_carried,
               across=slam.frames_across_writeback)
    kinds = {}
    for r in ahead:
        kinds.setdefault(r[2], []).append(r[1])
    print(f"{tag} {label}: {VI_LAPS_FRAMES} frames at dt={VI_LAPS_DT}, {VI_CONFIG}, the port's own draw: VI ready "
          f"{slam.vi_ready} (at frame {next((i for i, r in enumerate(rows) if r[2] != 'before VI init'), -1)}), "
          f"{out['ok']} frames OK, final {out['final']}, gravity cos {cos:.6f}, metric ATE {ate:.4f} m, Sim3 ATE "
          f"{sim3:.4f} m; {len(ahead)} frames past the refinement window (from frame "
          f"{next((i for i, r in enumerate(rows) if r[3]), -1)}), {len(beside)} of them begun beside a running job; "
          f"re-bases {slam.rebases}, BAs skipped {slam.ba_skipped}, keyframe decisions under the 1.5 s gap "
          f"{slam.saturated_kf_decisions}, keyframes carried through a write-back {slam.kfs_carried}, frames tracked "
          f"across a write-back {slam.frames_across_writeback}; {len(slam.job_times)} jobs, {wall:.2f} s (host "
          f"clock); states {''.join(r[0][0] for r in rows)}")
    print(f"{tag} {label}, past the window, the tracker's frames by kind (host clock): "
          + ("; ".join(f"{k} {len(v)} frames, median {np.median(v):.2f} ms, max {max(v):.2f} ms"
                       for k, v in kinds.items()) or "none")
          + f"; the VI BAs (kind, K, ms): " + ", ".join(f"{k} {n} {ms:.1f}" for k, n, ms in slam.vi_ba_times)
          + f"; {_ba_split(slam, label, local_kinds=('local', 'vi_local'))}")
    out["rows"] = rows
    return out


def _async_vi_phase(cam, dev, tag: str, lock_traj) -> dict:
    """Async monocular-inertial SLAM (the reference's rebase epoch: the worker
    bumps an epoch, the tracker re-bases once at its next frame) and the spin
    stress case, on the card, after phase 8:
      1. MonoViSlam(async_mapping=True) at tests/test_async_vi.py's
         configuration (phase 8's: its 60-frame arc, seed 0, 800 features, VI
         init after 2.5 s and 8 keyframes, a keyframe at least every 5
         frames) fed un-paced, as that test feeds it, drawing the two-view
         hypotheses of the reference's seed-0 run as phase 8 does; then
         wait_mapping_idle and one last drain, as the test does: its
         contract (VI ready, > 60 % of frames OK, gravity cos > 0.99, metric
         ATE < 0.12 m). Printed: the tracker's frame times by kind (before
         VI init, re-basing, keyframe, beside a running job, worker idle;
         host clock), the worker's VI job phases and every VI BA (the eager
         global ones among them), the re-bases, the BAs skipped;
      2. the same run with wait_mapping_idle() after every frame: its
         per-frame positions within 0.01 m RMS of phase 8's lock-step run
         on the same draw (`lock_traj`);
      3. lock-step MonoViSlam on kind="spin", as
         tests/test_stress.py::test_vi_fast_rotation_imu_bridge: 100 frames,
         the biased, noisy 200 Hz IMU, the port's own draw (seed 0), and the
         test's assertions (VI ready; IMU_ONLY or LOST among frames 38-61;
         >= 12 of the last 15 frames OK; >= 10 frames after 7 s, their
         metric ATE < 0.6 m);
      4. MonoViSlam over the 300-frame laps with the IMU at the camera's
         rate (`_vi_laps_run`), lock-step, then async: VI init near 3 s,
         the refinement window over near 15 s, then the async tracker runs
         beside its worker as the reference's does. Checked: both VI-ready
         with gravity cos > 0.99; the async run past the window began frames
         beside a running job, carried keyframes made during a VI BA through
         its write-back and tracked frames across a write-back. Reported, not
         enforced: frames OK, final state, metric and Sim3 ATE beside
         lock-step's, BAs skipped, keyframe decisions under the 1.5 s gap.
    Each run: K1 launches = frames, every local BA a graph replay, no
    kernel build, library load or graph capture off the main thread.
    Returns {path: K1 launches}."""
    import os

    import numpy as np

    from viorb_tpu_torch.eval.ate import associate, ate_rmse
    from viorb_tpu_torch.io import synthetic
    from viorb_tpu_torch.slam.mono_vi import MonoViSlam

    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_vi_golden.npz")) as z:
        name = VI_GOLDENS[0]
        draws = [tuple(z[f"{name}_two_view{i}_{k}"] for k in ("x1", "valid", "idx_h", "idx_f"))
                 for i in range(int(z[f"{name}_two_view_calls"]))]
    launches = {}

    def async_run(drained):
        slam = MonoViSlam(cam, device=dev, async_mapping=True, **VI_CONFIG)
        label = f"MonoViSlam async{', drained' if drained else ''}"
        t0 = time.perf_counter()
        try:
            rows = _feed_vi(cam, seq, imu, slam, label, launches, draws=draws, drained=drained)
            slam.wait_mapping_idle()
            slam._drain_tracker_rebase()  # the asserted state reflects the last BA, as the test's
            wall = time.perf_counter() - t0
            traj = slam.trajectory_tum()
        finally:
            slam.shutdown()
        _check_main_thread_only(label)
        split = _ba_split(slam, label, local_kinds=("local", "vi_local"))
        g = np.asarray(slam.gravity, np.float64)
        cos = float(g @ synthetic.GRAVITY_W / (np.linalg.norm(g) * np.linalg.norm(synthetic.GRAVITY_W)))
        ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=False)
        n_ok = sum(r[0] == "OK" for r in rows)
        print(f"{tag} {label} at tests/test_async_vi.py's configuration ({VI_CONFIG}), the reference's seed-0 "
              f"two-view draw: VI ready {slam.vi_ready} (at frame "
              f"{next((i for i, r in enumerate(rows) if r[2] != 'before VI init'), -1)}), {n_ok} of {VI_FRAMES} "
              f"frames OK, final {rows[-1][0]}, gravity cos {cos:.6f}, metric ATE {ate:.4f} m; re-bases "
              f"{slam.rebases}, BAs skipped {slam.ba_skipped}, {len(slam.job_times)} jobs, {wall:.2f} s "
              f"({VI_FRAMES / wall:.1f} fps, host clock); {split}")
        return slam, rows, traj, dict(ok=n_ok, cos=cos, ate=ate)

    seq = synthetic.make_sequence(VI_FRAMES, cam=cam, dt=VI_DT, device=dev)
    imu = synthetic.make_imu(VI_FRAMES, VI_DT, hz=200.0)
    slam, rows, _traj, out = async_run(drained=False)
    _check(slam.vi_ready and out["ok"] > 0.6 * VI_FRAMES and out["cos"] > 0.99 and out["ate"] < 0.12,
           f"async MonoViSlam misses tests/test_async_vi.py's contract: {out}")
    kinds = {}
    for _state, ms, kind, *_ in rows[1:]:
        kinds.setdefault(kind, []).append(ms)
    print(f"{tag} async MonoViSlam, the tracker's frames by kind (host clock, frame 0 with the thread start "
          f"left out): " + "; ".join(f"{k} {len(v)} frames, median {np.median(v):.2f} ms, max {max(v):.2f} ms"
                                     for k, v in kinds.items()))
    jobs = slam.job_times
    parts = {k: float(np.median([j[k] for j in jobs])) for k in jobs[0]}
    print(f"{tag} async MonoViSlam, the worker: {len(jobs)} jobs, median phases "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + " ms, the longest "
          + ", ".join(f"{k} {v:.1f}" for k, v in max(jobs, key=lambda j: j["total"]).items())
          + " ms; the VI BAs in order (kind, K, ms): " + ", ".join(f"{k} {n} {ms:.1f}" for k, n, ms in slam.vi_ba_times))

    slam, _rows, traj, out = async_run(drained=True)
    ia, ib = associate(traj[:, 0], lock_traj[:, 0])
    rms = float(np.sqrt(((traj[ia, 1:4] - lock_traj[ib, 1:4]) ** 2).sum(1).mean()))
    print(f"{tag} async MonoViSlam drained after every frame vs phase 8's lock-step run on the same draw: "
          f"{len(ia)} frames in both, positions {rms:.6f} m RMS apart (max "
          f"{np.linalg.norm(traj[ia, 1:4] - lock_traj[ib, 1:4], axis=1).max():.6f} m)")
    _check(slam.vi_ready and len(ia) >= len(lock_traj) - 1 and rms <= 0.01,
           f"drained async MonoViSlam departs from lock-step: {rms:.6f} m RMS over {len(ia)} frames")

    # the spin stress case: tests/test_stress.py::test_vi_fast_rotation_imu_bridge
    spin = synthetic.make_sequence(SPIN_FRAMES, cam=cam, dt=0.1, kind="spin", device=dev)
    spin_imu = synthetic.make_imu(SPIN_FRAMES, 0.1, hz=200.0, kind="spin", noise_g=0.002, noise_a=0.03,
                                  bias_g=np.array([0.002, -0.001, 0.0015], np.float32),
                                  bias_a=np.array([0.03, -0.02, 0.01], np.float32))
    sp = MonoViSlam(cam, device=dev, n_features=800, kf_max_interval=5, vi_init_min_time=2.5, vi_init_min_kfs=8)
    t0 = time.perf_counter()
    sp_rows = _feed_vi(cam, spin, spin_imu, sp, "MonoViSlam spin (lock-step)", launches)
    wall = time.perf_counter() - t0
    states = [r[0] for r in sp_rows]
    traj = sp.trajectory_tum()
    sel = traj[:, 0] >= 7.0
    m = ate_rmse(traj[sel, 0], traj[sel, 1:4], spin.timestamps, spin.c_w, with_scale=False) if sel.sum() else np.inf
    print(f"{tag} MonoViSlam lock-step on the spin sequence (tests/test_stress.py's, {SPIN_FRAMES} frames, a "
          f"~140 deg/s yaw excursion at 4-6 s, the biased noisy IMU, the port's own draw): states "
          f"{''.join(s[0] for s in states)}; VI ready {sp.vi_ready}; frames 38-61 "
          f"{''.join(s[0] for s in states[38:62])}; last 15: {states[-15:].count('OK')} OK; {int(sel.sum())} "
          f"frames after 7 s, their metric ATE {m:.4f} m; {wall:.2f} s; {_ba_split(sp, 'spin', ('local', 'vi_local'))}")
    _check(sp.vi_ready and any(s in ("IMU_ONLY", "LOST") for s in states[38:62]) and states[-15:].count("OK") >= 12
           and sel.sum() >= 10 and m < 0.6, "MonoViSlam misses tests/test_stress.py's spin contract")
    _check_main_thread_only("the spin run")

    # past VI init's refinement window: the laps with the IMU at the camera's
    # rate, lock-step, then async, where the tracker runs beside the worker
    laps, laps_imu = _vi_laps(cam, dev)
    lock = _vi_laps_run(cam, laps, laps_imu, tag, launches, async_mapping=False)
    run = _vi_laps_run(cam, laps, laps_imu, tag, launches)
    print(f"{tag} async MonoViSlam past the refinement window, on the laps at the camera's rate (reported, not "
          f"enforced): {run['ok']} of {VI_LAPS_FRAMES} frames OK (lock-step {lock['ok']}), final {run['final']} "
          f"(lock-step {lock['final']}), metric ATE {run['ate']:.4f} m (lock-step {lock['ate']:.4f}), Sim3 ATE "
          f"{run['sim3']:.4f} m (lock-step {lock['sim3']:.4f}); BAs skipped {run['skipped']}, keyframe decisions "
          f"under the 1.5 s gap {run['saturated']}")
    _check(lock["vi_ready"] and run["vi_ready"] and min(lock["cos"], run["cos"]) > 0.99,
           f"MonoViSlam on the laps: VI init and gravity (cos > 0.99): lock-step {lock['cos']}, async {run['cos']}")
    # the regime the run exists for: frames past the window begun beside a
    # running job, keyframes made during a VI BA's solve carried by its
    # write-back, frames tracked across a write-back
    _check(run["beside"] >= 1 and run["carried"] >= 1 and run["across"] >= 1,
           f"async MonoViSlam on the laps never ran beside its worker past the refinement window: {run}")
    return launches


def _k8_check(dev, vocabs: dict, descs: dict, tag: str) -> dict:
    """K8 against its plain twin on the card, on the same inputs: for each
    vocabulary, descriptor set and path (the histogram in shared memory, the
    main path's; in a scratch tensor, the large-tree path), the words
    torch.equal and the weights within 1e-6 relative, and a second call
    equal to the first. Then on the stock tree at K8_N descriptors (a
    keyframe's worth): exactly one device operation a call (the profiler),
    and the numbers of the kernels line: the worst weight error, the
    kernel's and the twin's device ms and the bound, bytes at the HBM rate
    or the popcounts this data needs at POPC_PER_S."""
    import numpy as np
    import torch

    from viorb_tpu_torch.bow import descend_cuda
    from viorb_tpu_torch.bow.descend_cuda import bow_descend_cuda
    from viorb_tpu_torch.bow.vocabulary import _descend_torch

    out = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for vname, vocab in vocabs.items():
        dv = vocab.device_arrays(dev)
        twin = dv._replace(centers_pm1=torch.from_numpy(vocab.centers_pm1).to(dev))
        for dname, (desc, valid) in descs.items():
            p_words, p_weights = _descend_torch(twin, desc.float() * 2 - 1, valid)
            for path in ("shared", "global"):
                words, weights = bow_descend_cuda(dv, desc, valid, path=path)
                again = bow_descend_cuda(dv, desc, valid, path=path)
                torch.cuda.synchronize()
                _check(torch.equal(words, again[0]) and torch.equal(weights, again[1]),
                       f"K8 ({path}) twice in a row differs on the {vname} tree, {dname}")
                _check(torch.equal(words, p_words), f"K8 ({path}) words != plain on the {vname} tree, {dname}")
                err = (weights - p_weights).abs()
                rel = float((err / p_weights.clamp(min=1e-30)).max()) if bool((p_weights > 0).any()) else 0.0
                _check(bool((err[p_weights == 0] == 0).all()) and rel <= 1e-6,
                       f"K8 ({path}) weights differ from plain on the {vname} tree, {dname}: {rel:.2e} relative")
                out["max_abs_err"] = max(out["max_abs_err"], float(err.max()) if err.numel() else 0.0)
                out["max_rel_err"] = max(out["max_rel_err"], rel)
            print(f"K8 == plain on the {vname} tree ({len(vocab.children)} nodes, k={vocab.k}, {vocab.n_words} "
                  f"words), {dname} ({desc.shape[0]} descriptors, {int(valid.sum())} valid), both paths: words "
                  f"torch.equal, weights within {out['max_rel_err']:.2e} relative so far, a second call equal")
    print(f"K8's shared-memory histogram holds up to {descend_cuda.shared_hist_max_words(dev)} words on this card; "
          f"a larger tree takes the global path (held above on every case)")
    vocab = vocabs["stock"]
    desc, valid = descs["a keyframe's features"]
    dv = vocab.device_arrays(dev)
    twin = dv._replace(centers_pm1=torch.from_numpy(vocab.centers_pm1).to(dev))
    ops, how = _kernels_per_call(lambda: bow_descend_cuda(dv, desc, valid)), "the profiler"
    if ops == 0:  # the profiler recorded no device activity: count the nodes of a captured call
        ops, how = _device_ops_in_graph(lambda: bow_descend_cuda(dv, desc, valid)), "the nodes of a captured graph"
    _check(ops == 1, f"K8: {ops} device operations a call ({how}), one expected")
    out["device_ops"], out["ops_counted_by"] = ops, how
    out["ms"] = _event_ms(lambda: bow_descend_cuda(dv, desc, valid), reps=200, device_only=True)
    out["global_ms"] = _event_ms(lambda: bow_descend_cuda(dv, desc, valid, path="global"), reps=200,
                                 device_only=True)
    out["plain_ms"] = _event_ms(lambda: _descend_torch(twin, desc.float() * 2 - 1, valid), reps=20,
                                device_only=True)
    # what this data needs: 8 popcounts for each valid child of every
    # non-leaf node a valid descriptor passes through; the bytes of the
    # nodes the walks visit (a visited non-leaf node's children row and its
    # children's packed centers, every visited node's is_leaf, the reached
    # leaves' word ids and idf), each read once, the descriptors and the
    # valid flags read once, the words and the weights written once
    d = desc.cpu().numpy().astype(np.float32) * 2 - 1
    rows = valid.cpu().numpy()
    node = np.zeros(len(d), np.int64)
    popc = 0
    visited = {0}
    for _ in range(8):
        leaf = vocab.is_leaf[node]
        ch = vocab.children[node]
        popc += int(8 * ((ch >= 0) & ~leaf[:, None] & rows[:, None]).sum())
        sim = np.einsum("nkd,nd->nk", vocab.centers_pm1[np.maximum(ch, 0)], d)
        sim[ch < 0] = -1e9
        node = np.where(leaf, node, ch[np.arange(len(d)), np.argmax(sim, 1)])
        visited.update(node[rows].tolist())
    visited = np.array(sorted(visited), np.int64)
    inner = visited[~vocab.is_leaf[visited]]
    reached = visited[vocab.is_leaf[visited]]
    k = vocab.children.shape[1]
    n_bytes = (desc.numel() + len(d) + len(inner) * 4 * k + 32 * int((vocab.children[inner] >= 0).sum())
               + len(visited) + 8 * len(reached) + 4 * len(d) + 4 * vocab.n_words)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, popc / POPC_PER_S
    out["bound_ms"], out["bound_by"] = max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
    print(f"{tag} K8 bow_descend, {len(d)} descriptors on the stock tree: device time kernel {out['ms'] * 1e3:.2f} us "
          f"(ONE launch of one {descend_cuda.CLUSTER_CTAS}-CTA cluster, {ops} device operation a call by {how}; "
          f"the global-histogram path {out['global_ms'] * 1e3:.2f} us), plain twin "
          f"{out['plain_ms'] * 1e3:.2f} us, bound {out['bound_ms'] * 1e3:.3f} us ({out['bound_by']}: {n_bytes} B, "
          f"{popc} popcounts)")
    return out


@contextlib.contextmanager
def _two_view_replay(draws):
    """MonoSlam's two-view RANSAC draws the reference's minimal sets, call by
    call (`draws`: (x1, valid, idx_h, idx_f) each), then its own."""
    import numpy as np
    import torch

    from viorb_tpu_torch.slam import mono as mono_module
    from viorb_tpu_torch.solvers.two_view import two_view_from_samples

    own = mono_module.two_view_init
    calls = iter(draws)
    log = []

    def two_view_init(x1, x2, valid, cam_, generator, n_hypotheses=256):
        ref = next(calls, None)
        if ref is None:
            log.append("own draw")
            return own(x1, x2, valid, cam_, generator, n_hypotheses)
        ref_x1, ref_valid, idx_h, idx_f = ref
        log.append(bool(np.array_equal(valid.cpu().numpy(), ref_valid)))
        return two_view_from_samples(x1, x2, valid, cam_, torch.from_numpy(idx_h).to(x1.device),
                                     torch.from_numpy(idx_f).to(x1.device))

    mono_module.two_view_init = two_view_init
    try:
        yield log
    finally:
        mono_module.two_view_init = own


def _loop_phase(cam, dev, tag: str) -> tuple:
    """Place recognition and loop closing on the card (module docstring,
    phase 9). The reference's two loop contracts compare two whole runs
    (with and without loop closing) of a package that is deterministic; so
    is the port (its BAs and essential graph sum by GEMMs, not float
    atomics), which the repeated MonoSlam and MonoViSlam loop runs show bit
    for bit.
    Returns ({path: K1 launches}, {path: K8 launches}, the K8 numbers of
    the kernels line)."""
    import os

    import numpy as np
    import torch

    from viorb_tpu_torch import launch_counts
    from viorb_tpu_torch.bow import default_vocabulary, train_vocabulary
    from viorb_tpu_torch.bow import descend_cuda
    from viorb_tpu_torch.eval.ate import associate, ate_rmse, umeyama_alignment
    from viorb_tpu_torch.features import fast_cuda
    from viorb_tpu_torch.features.extractor import OrbExtractor
    from viorb_tpu_torch.io import synthetic
    from viorb_tpu_torch.slam import loop_closing as lc_module
    from viorb_tpu_torch.slam.mono import MonoSlam
    from viorb_tpu_torch.slam.mono_vi import MonoViSlam
    from viorb_tpu_torch.slam.tracking_loop import (
        make_pipeline_track_core,
        make_streaming_track_core,
        make_vi_pipeline_core,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    with np.load(os.path.join(root, "tests", "torch_loop_golden.npz")) as z:
        gold = {k: z[k] for k in z.files}
    draws = {run: [tuple(gold[f"{run}_two_view{i}_{k}"] for k in ("x1", "valid", "idx_h", "idx_f"))
                   for i in range(int(gold[f"{run}_two_view_calls"]))] for run in ("mono", "vi")}
    for run in ("mono", "vi"):
        config = dict(gold[f"{run}_config"].tolist())
        _check(int(config["n_frames"]) == LOOP_FRAMES and int(config["n_features"]) == LOOP_CONFIG["n_features"]
               and int(config["kf_max_interval"]) == LOOP_CONFIG["kf_max_interval"]
               and float(config["noise_std"]) == LOOP_NOISE and config["kind"] == "circuit",
               f"the loop golden's {run} configuration is not this phase's: {config}")
    seq = synthetic.make_sequence(LOOP_FRAMES, cam=cam, dt=LOOP_DT, kind="circuit", noise_std=LOOP_NOISE, device=dev)
    imu = synthetic.make_imu(LOOP_FRAMES, LOOP_DT, hz=200.0, kind="circuit", noise_g=0.002, noise_a=0.03,
                             bias_g=np.array([0.002, -0.001, 0.0015], np.float32),
                             bias_a=np.array([0.03, -0.02, 0.01], np.float32))
    samples, prev = [], -np.inf
    for ts in seq.timestamps:
        sel = (imu.t > prev) & (imu.t <= ts)
        samples.append([(float(t), g, a) for t, g, a in zip(imu.t[sel], imu.gyro[sel], imu.acc[sel])])
        prev = ts

    # the vocabulary, as the reference's tests train it: the port's extractor
    # (600 features) on every 12th frame, k=8, depth 3
    t0 = time.perf_counter()
    ex = OrbExtractor(n_features=LOOP_VOCAB_FEATURES)
    descs = []
    for i in range(0, LOOP_FRAMES, LOOP_VOCAB_EVERY):
        f = ex.extract(seq.images[i], device=dev)
        descs.append(f.desc01[f.valid].cpu().numpy())
    vocab = train_vocabulary(np.concatenate(descs), k=8, depth=3)
    stock = default_vocabulary()
    print(f"{tag} loop: vocabulary trained on {sum(len(d) for d in descs)} descriptors of "
          f"{len(descs)} circuit frames: {len(vocab.children)} nodes, {vocab.n_words} words "
          f"({(time.perf_counter() - t0) * 1e3:.0f} ms, host numpy)")

    # ---- K8 against its plain twin, at a keyframe's shapes ---------------------
    f1000 = OrbExtractor(n_features=K8_N).extract(seq.images[LOOP_FRAMES // 2], device=dev)
    rand = torch.randint(0, 2, (K8_N, 256), dtype=torch.uint8, generator=torch.Generator().manual_seed(0)).to(dev)
    some_invalid = torch.arange(K8_N, device=dev) % 7 != 3
    rand5 = torch.randint(0, 2, (5 * K8_N, 256), dtype=torch.uint8, generator=torch.Generator().manual_seed(1)).to(dev)
    k8_sets = {
        "a keyframe's features": (f1000.desc01.contiguous(), f1000.valid),
        "random rows, every 7th invalid": (rand, some_invalid),
        "every row invalid": (rand, torch.zeros(K8_N, dtype=torch.bool, device=dev)),
        "no rows": (rand[:0], some_invalid[:0]),
        "one row": (rand[:1], some_invalid[:1]),
        "5 x random rows, every 7th invalid": (rand5, torch.arange(5 * K8_N, device=dev) % 7 != 3),
        "5 x random rows, every row invalid": (rand5, torch.zeros(5 * K8_N, dtype=torch.bool, device=dev)),
    }
    k8 = _k8_check(dev, {"stock": stock, "trained k=8 depth 3": vocab}, k8_sets, tag)

    k1_paths, k8_paths = {}, {}

    def counted(name, fn, cores):
        """fn() with the K1 and K8 counters set to 0 just before and read
        just after; K1 = the cores' graph launches + eager launches."""
        for c in cores:
            c.reset_counts()
        fast_cuda.LAUNCHES = fast_cuda.CELL_LAUNCHES = 0
        descend_cuda.LAUNCHES_K8 = descend_cuda.LAUNCHES_K8_GLOBAL = 0
        out = fn()
        k1_paths[name] = sum(c.launches()["CELL_LAUNCHES"] for c in cores) + fast_cuda.CELL_LAUNCHES
        k8_paths[name] = descend_cuda.LAUNCHES_K8
        _check(descend_cuda.LAUNCHES_K8_GLOBAL == 0, f"{name}: K8 took its global-histogram path on the stock tree")
        return out

    def pipe_cores(slam):
        cores = [make_pipeline_track_core(cam, slam.extractor)]
        if slam.streaming:
            cores.append(make_streaming_track_core(cam, slam.extractor))
        if isinstance(slam, MonoViSlam):
            cores += list(make_vi_pipeline_core(cam, slam.extractor, slam.ext, slam.imu_noise).graphs.values())
        return cores

    def timed(name, fn, times):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                times.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
        return wrapped

    def drive(slam, sequence, frames, vi=False, times=None, blank=(), paced=False):
        """Feed frames of `sequence`; per frame (state, n_tracked, n_kfs,
        loops closed, host ms, whether a mapping job ran)."""
        lc = slam.loop_closer
        if times is not None and lc is not None:
            for name in ("add_keyframe", "detect", "compute_sim3"):
                setattr(lc, name, timed(name, getattr(lc, name), times))
            lc.gba_fn = timed("post-loop GBA", lc.gba_fn, times)
        rows = []
        t_start = time.perf_counter()
        for i in frames:
            img = torch.zeros_like(sequence.images[i]) if i in blank else sequence.images[i]
            ts = float(sequence.timestamps[i])
            if paced:
                time.sleep(max(0.0, t_start + ts - time.perf_counter()))
            jobs = len(slam.job_times)
            t = time.perf_counter()
            info = slam.process_frame_vi(img, ts, samples[i]) if vi else slam.process_frame(img, ts)
            rows.append((info["state"], info["n_tracked"], info["n_kfs"], 0 if lc is None else lc.loops_closed,
                         (time.perf_counter() - t) * 1e3, len(slam.job_times) > jobs))
        return rows

    def gba_threads(slam):
        """The names of the threads each post-loop GBA of `slam` runs on,
        with whether the VI flavour ran, filled as they run."""
        ran, gba = [], slam.loop_closer.gba_fn

        def recorded(anchor, scale_by_kf=None):
            ran.append((threading.current_thread().name, getattr(slam, "vi_ready", False)))
            return gba(anchor, scale_by_kf)

        slam.loop_closer.gba_fn = recorded
        return ran

    def mono_run(close, times=None):
        slam = MonoSlam(cam, device=dev, vocabulary=vocab, enable_loop_closing=close, **LOOP_CONFIG)
        with _two_view_replay(draws["mono"]) as log:
            rows = drive(slam, seq, range(LOOP_FRAMES), times=times)
        _check(bool(log) and all(x is True for x in log if x != "own draw"),
               f"the replayed two-view draws met other matches: {log}")
        return slam, rows

    def tail_rmse(traj, t_close):
        ia, ib = associate(traj[:, 0], seq.timestamps)
        s_, r_, t_ = umeyama_alignment(traj[ia, 1:4], seq.c_w[ib], with_scale=True)
        err2 = ((seq.c_w[ib] - (s_ * traj[ia, 1:4] @ r_.T + t_)) ** 2).sum(1)
        return float(np.sqrt(err2[traj[ia, 0] >= t_close].mean()))

    # ---- lock-step MonoSlam without, then with loop closing -----------------
    slam_cores = pipe_cores(MonoSlam(cam, device=dev, **LOOP_CONFIG))
    base, base_rows = counted("MonoSlam, vocabulary, no loop closing", lambda: mono_run(False), slam_cores)
    slam, rows = counted("MonoSlam + loop closing", lambda: mono_run(True), slam_cores)
    traj, traj_b = slam.trajectory_tum(), base.trajectory_tum()
    ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)
    ate_b = ate_rmse(traj_b[:, 0], traj_b[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)
    t_close = seq.timestamps[int(0.8 * LOOP_FRAMES)]
    tail, tail_b = tail_rmse(traj, t_close), tail_rmse(traj_b, t_close)
    closed_at = next(i for i, r in enumerate(rows) if r[3] >= 1) if slam.loop_closer.loops_closed else -1
    print(f"{tag} MonoSlam lock-step on the {LOOP_FRAMES}-frame noisy circuit ({LOOP_CONFIG}), the reference's "
          f"two-view draw: {slam.loop_closer.loops_closed} loop(s) closed (first at frame {closed_at}, keyframe "
          f"{slam.loop_closer.last_loop_kf}; the reference's golden: keyframe {int(gold['mono_kf'])} -> "
          f"{int(gold['mono_cand'])}), Sim3 ATE {ate:.4f} m vs {ate_b:.4f} m without loop closing, globally "
          f"aligned tail RMSE {tail:.4f} vs {tail_b:.4f} m; final {rows[-1][:3]}; the reference's run ATE "
          f"{float(gold['mono_ate']):.4f} m")
    _check(slam.loop_closer.loops_closed >= 1 and ate <= ate_b and tail <= 0.8 * tail_b,
           f"tests/test_e2e_loop.py's contract: {slam.loop_closer.loops_closed} loops, ATE {ate:.4f} vs "
           f"{ate_b:.4f}, tail {tail:.4f} vs {tail_b:.4f}")
    _check(np.isfinite(traj).all() and traj.shape[1] == 8, "MonoSlam loop run: trajectory not finite or malformed")
    # the same run again with the loop closer's stages timed: the same bits
    times, ess_times = {}, {}
    graph_opt = lc_module.optimize_sim3_graph
    lc_module.optimize_sim3_graph = timed("essential graph", graph_opt, ess_times)
    try:
        slam, rows = counted("MonoSlam + loop closing, timed", lambda: mono_run(True, times), slam_cores)
    finally:
        lc_module.optimize_sim3_graph = graph_opt
    traj2 = slam.trajectory_tum()
    same = traj2.shape == traj.shape and np.array_equal(traj2, traj)
    print(f"{tag} MonoSlam + loop closing, run again with its stages timed: {slam.loop_closer.loops_closed} loop(s), "
          f"trajectory equal to the first run's bit for bit: {same}")
    _check(same, "MonoSlam's loop run is not reproducible: two runs on the same frames differ")
    n_jobs = len(slam.job_times)
    on_card = dev.type == "cuda"  # on the CPU every wrapper runs its plain version: nothing launches
    _check(not on_card or k8_paths["MonoSlam + loop closing, timed"] == n_jobs,
           f"K8 launches {k8_paths['MonoSlam + loop closing, timed']} for {n_jobs} mapping jobs: one a keyframe")
    loop_job = next((j for j in slam.job_times if "loop" in j), {})
    steady = lambda a, b: [r[4] for r in rows[a:b] if r[0] == "OK" and not r[5]]  # noqa: E731
    before, after = steady(5, closed_at), steady(closed_at + 1, LOOP_FRAMES)
    med = lambda x: float(np.median(x)) if x else float("nan")  # noqa: E731
    print(f"{tag} loop closing stages (host clock, synchronized): add_keyframe (K8 + pull) median "
          f"{med(times['add_keyframe']):.3f} ms over {len(times['add_keyframe'])}, detect median "
          f"{med(times['detect']):.3f} ms, compute_sim3 {', '.join(f'{x:.1f}' for x in times.get('compute_sim3', []))} "
          f"ms, essential graph ({len(slam.map.keyframes)} keyframes now, 40 iterations) "
          f"{', '.join(f'{x:.1f}' for x in ess_times.get('essential graph', []))} ms, post-loop GBA "
          f"{', '.join(f'{x:.1f}' for x in times.get('post-loop GBA', []))} ms; the loop keyframe's mapping job "
          + ", ".join(f"{k} {v:.1f}" for k, v in loop_job.items()) + f" ms; K8 launches {n_jobs} for {n_jobs} "
          f"keyframes; steady frame median {med(before):.3f} ms before the closure, {med(after):.3f} ms after")

    # ---- lock-step MonoViSlam with and without loop closing -----------------
    def vi_run(close, times=None):
        slam_ = MonoViSlam(cam, device=dev, vocabulary=vocab, enable_loop_closing=close, **LOOP_VI_CONFIG)
        with _two_view_replay(draws["vi"]):
            rows_ = counted(f"MonoViSlam{' + loop closing' if close else ', vocabulary, no loop closing'}",
                            lambda: drive(slam_, seq, range(LOOP_FRAMES), vi=True, times=times), pipe_cores(slam_))
        return slam_, rows_

    vi_times = {}
    vi_b, _ = vi_run(False)
    vi, vi_rows = vi_run(True, vi_times)
    traj, traj_b = vi.trajectory_tum(), vi_b.trajectory_tum()
    # the VI pair is a comparison of two runs only if a run is reproducible:
    # the VI BAs' IMU-edge sums are GEMMs, not float atomics
    traj2 = vi_run(True)[0].trajectory_tum()
    same = traj2.shape == traj.shape and np.array_equal(traj2, traj)
    print(f"{tag} MonoViSlam + loop closing, run again: trajectory equal to the first run's bit for bit: {same}")
    _check(same, "MonoViSlam's loop run is not reproducible: two runs on the same frames differ")
    m, m_b, s_, s_b = (ate_rmse(tr[:, 0], tr[:, 1:4], seq.timestamps, seq.c_w, with_scale=sc)
                       for sc, tr in ((False, traj), (False, traj_b), (True, traj), (True, traj_b)))
    g = np.asarray(vi.gravity if vi.gravity is not None else np.zeros(3), np.float64)
    cos = float(g @ synthetic.GRAVITY_W / max(np.linalg.norm(g) * 9.81, 1e-12))
    worst = 0.0
    for k in vi.kf_chain:
        kf = vi.map.keyframes.get(k)
        if kf is None or not (kf.nav and "state" in kf.nav):
            continue
        ns = kf.nav["state"]
        r_wc = np.asarray(ns.r) @ vi.r_bc
        c_w = np.asarray(ns.p) + np.asarray(ns.r) @ vi.p_bc
        worst = max(worst, float(np.abs(kf.r_cw - r_wc.T).max()), float(np.abs(kf.t_cw + r_wc.T @ c_w).max()))
    print(f"{tag} MonoViSlam lock-step on the noisy circuit with the biased 200 Hz IMU ({LOOP_VI_CONFIG}), the "
          f"reference's two-view draw: {vi.loop_closer.loops_closed} loop(s) (the golden: keyframe "
          f"{int(gold['vi_kf'])} -> {int(gold['vi_cand'])}), Sim3 ATE {s_:.4f} vs {s_b:.4f} m without, metric "
          f"{m:.4f} vs {m_b:.4f} m, gravity cos {cos:.5f}, NavState vs pose {worst:.2e}, VI post-loop GBA "
          f"{', '.join(f'{x:.1f}' for x in vi_times.get('post-loop GBA', []))} ms")
    _check(vi.vi_ready and vi_b.vi_ready and vi.loop_closer.loops_closed >= 1 and s_ <= max(1.15 * s_b, 0.02)
           and s_ <= 0.05 and m <= max(1.2 * m_b, 0.05) and worst <= 1e-4 and cos > 0.995,
           f"tests/test_e2e_vi_loop.py's contract: loops {vi.loop_closer.loops_closed}, sim3 {s_:.4f}/{s_b:.4f}, "
           f"metric {m:.4f}/{m_b:.4f}, NavState {worst:.2e}, cos {cos:.5f}")

    # ---- BoW relocalization -------------------------------------------------
    arc = synthetic.make_sequence(MAPIO_FRAMES, cam=cam, dt=0.1, device=dev)
    descs = []
    for i in (0, 10, 20):
        f = ex.extract(arc.images[i], device=dev)
        descs.append(f.desc01[f.valid].cpu().numpy())
    arc_vocab = train_vocabulary(np.concatenate(descs), k=8, depth=3)
    rel = MonoSlam(cam, device=dev, n_features=800, vocabulary=arc_vocab)
    rel_rows = counted("MonoSlam BoW relocalization (blackout)",
                       lambda: drive(rel, arc, range(RELOC_FRAMES), blank=RELOC_BLACKOUT), pipe_cores(rel))
    states = [r[0] for r in rel_rows]
    lost = "LOST" in states
    relocalized = lost and "OK" in states[states.index("LOST"):]
    ok_after = sum(s == "OK" for s in states[RELOC_BLACKOUT[-1] + 1:])
    print(f"{tag} MonoSlam BoW relocalization after frames {RELOC_BLACKOUT[0]}-{RELOC_BLACKOUT[-1]} go blank: "
          f"states {''.join(s[0] for s in states)}, {ok_after} frames OK after the blackout, the relocalizing "
          f"frame {max((r[4] for r in rel_rows[RELOC_BLACKOUT[-1] + 1:]), default=0):.1f} ms at most")
    _check(lost and relocalized and states[-1] == "OK" and ok_after >= 12,
           f"tests/test_relocalization.py's contract: {states}")

    build_dir = os.path.join(root, "build", "chip_smoke")
    os.makedirs(build_dir, exist_ok=True)
    map_path = os.path.join(build_dir, "stock_vocab_map.npz")
    mapper = MonoSlam(cam, device=dev, n_features=800, vocabulary=stock)
    counted("MonoSlam stock vocabulary, mapping run", lambda: drive(mapper, arc, range(MAPIO_FRAMES)),
            pipe_cores(mapper))
    _check(mapper.state == "OK", f"the stock-vocabulary mapping run ends {mapper.state}")
    mapper.save_map(map_path)
    fresh = MonoSlam(cam, device=dev, n_features=800, vocabulary=stock)
    counted("load_map with the stock vocabulary", lambda: fresh.load_map(map_path, localization_only=True), [])
    io_rows = counted("MonoSlam stock vocabulary, relocalization after load_map",
                      lambda: drive(fresh, arc, range(25, 40)), pipe_cores(fresh))
    io_states = [r[0] for r in io_rows]
    print(f"{tag} stock vocabulary ({stock.n_words} words), relocalization after load_map into a fresh MonoSlam: "
          f"states {''.join(s[0] for s in io_states)}; load_map put {len(fresh.loop_closer.db.bows)} keyframes "
          f"into the database with {k8_paths['load_map with the stock vocabulary']} K8 launches")
    _check(not on_card or k8_paths["load_map with the stock vocabulary"] == len(fresh.loop_closer.db.bows),
           "load_map: one K8 launch a keyframe")
    _check("OK" in io_states and io_states[-1] == "OK", f"tests/test_map_io.py's contract: {io_states}")

    # ---- the laps: 300 frames, two circuits, the stock vocabulary -----------
    laps = synthetic.make_sequence(LAPS_FRAMES, cam=cam, dt=0.1, kind="laps", noise_std=LOOP_NOISE, device=dev)
    lp = MonoSlam(cam, device=dev, n_features=600, kf_max_interval=6, vocabulary=stock, enable_loop_closing=True)
    t0 = time.perf_counter()
    lp_rows = counted(f"MonoSlam laps ({LAPS_FRAMES} frames, stock vocabulary)", lambda: drive(lp, laps, range(LAPS_FRAMES)),
                      pipe_cores(lp))
    lp_s = time.perf_counter() - t0
    lp.wait_mapping_idle()
    traj = lp.trajectory_tum()
    new_kfs = lp_rows[-1][2] - lp_rows[LAPS_REUSE_FROM][2]
    tracked = float(np.mean([r[1] for r in lp_rows[LAPS_REUSE_FROM:]]))
    s_laps = ate_rmse(traj[:, 0], traj[:, 1:4], laps.timestamps, laps.c_w, with_scale=True)
    n_pts = len(lp.map.active_point_ids())
    print(f"{tag} MonoSlam laps ({LAPS_FRAMES} frames, 600 features, a keyframe at least every 6, the stock "
          f"vocabulary): {lp.loop_closer.loops_closed} loop(s), {new_kfs} new keyframes after frame "
          f"{LAPS_REUSE_FROM}, mean tracked {tracked:.1f}, {len(traj)} trajectory frames, Sim3 ATE {s_laps:.4f} m, "
          f"{n_pts} points; {lp_s:.1f} s ({LAPS_FRAMES / lp_s:.1f} fps, host clock)")
    _check(lp.state == "OK" and lp.loop_closer.loops_closed >= 1 and new_kfs <= 15 and tracked >= 120
           and len(traj) >= 0.85 * LAPS_FRAMES and s_laps < 0.15 and n_pts > 1000,
           "tests/test_stress.py's laps contract")

    # ---- async MonoSlam with loop closing: the GBA in the loop job ------------
    asy = MonoSlam(cam, device=dev, vocabulary=vocab, enable_loop_closing=True, async_mapping=True, **LOOP_CONFIG)
    a_gba = gba_threads(asy)
    try:
        asy_rows = counted("MonoSlam async + loop closing (camera rate)",
                           lambda: drive(asy, seq, range(LOOP_FRAMES), paced=True), pipe_cores(asy))
        asy.wait_mapping_idle()
        traj = asy.trajectory_tum()
    finally:
        asy.shutdown()
    a_ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)
    ia, ib = associate(traj[:, 0], seq.timestamps)
    a_s, a_r, a_t = umeyama_alignment(traj[ia, 1:4], seq.c_w[ib], with_scale=True)
    a_err = np.linalg.norm(seq.c_w[ib] - (a_s * traj[ia, 1:4] @ a_r.T + a_t), axis=1)
    print(f"{tag} MonoSlam async with loop closing: frames more than 10 cm off after the run's Sim3 alignment "
          + (", ".join(f"{int(f)}: {e * 100:.0f} cm" for f, e in zip(ib, a_err) if e > 0.10) or "none"))
    # the tracker thread's longest frame beside the loop job on the worker:
    # the job holds the map lock from the BoW to the end of the closure, the
    # post-loop GBA included, so the tracker waits for the correction
    a_loop_ms = max((j["total"] for j in asy.job_times if "loop" in j), default=float("nan"))
    a_frame_ms = max(r[4] for r in asy_rows[5:])
    a_closed = next((i for i, r in enumerate(asy_rows) if r[3] >= 1), -1)
    print(f"{tag} MonoSlam async with loop closing, fed at the camera's 10 fps: {asy.loop_closer.loops_closed} "
          f"loop(s) (the tracker saw it closed at frame {a_closed}), post-loop GBAs on threads {a_gba}; final "
          f"{asy.state}, Sim3 ATE {a_ate:.4f} m; the loop job {a_loop_ms:.1f} ms on the worker, the "
          f"tracker's longest frame {a_frame_ms:.1f} ms (host clock), its frames "
          f"{a_closed - 3}-{a_closed + 3}: {', '.join(f'{r[4]:.1f}' for r in asy_rows[max(a_closed - 3, 0):a_closed + 4])} ms")
    _check(asy.loop_closer.loops_closed >= 1 and asy.state == "OK" and asy_rows[-1][0] == "OK"
           and a_gba and all(t == "viorb-mapping" for t, _vi in a_gba),
           "async MonoSlam with loop closing: the loop must close, its post-loop GBA run in the loop job on the "
           "mapping worker, the run end OK")
    # the threaded envelope of tests/test_streaming.py around the lock-step loop run
    _check(a_ate <= max(5.0 * ate, 0.20),
           f"async MonoSlam with loop closing: Sim3 ATE {a_ate:.4f} m against the threaded envelope max(5 x "
           f"{ate:.4f}, 0.20) m of the lock-step loop run")
    print(f"{tag} MonoSlam async with loop closing: {_ba_split(asy, 'async loop run')}; BAs skipped "
          f"{asy.ba_skipped}; the loop job's phases " + ", ".join(
              f"{k} {v:.1f}" for k, v in next((j for j in asy.job_times if "loop" in j), {}).items()) + " ms")
    _check_main_thread_only("async MonoSlam with loop closing")

    # ---- async MonoViSlam with loop closing: the VI post-loop GBA on the worker
    avi = MonoViSlam(cam, device=dev, vocabulary=vocab, enable_loop_closing=True, async_mapping=True,
                     **LOOP_VI_CONFIG)
    gba_ran = gba_threads(avi)
    try:
        with _two_view_replay(draws["vi"]):
            avi_rows = counted("MonoViSlam async + loop closing (camera rate)",
                               lambda: drive(avi, seq, range(LOOP_FRAMES), vi=True, paced=True), pipe_cores(avi))
        avi.wait_mapping_idle()
        avi._drain_tracker_rebase()
        traj = avi.trajectory_tum()
    finally:
        avi.shutdown()
    v_ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)
    v_loop_ms = max((j["total"] for j in avi.job_times if "loop" in j), default=float("nan"))
    v_closed = next((i for i, r in enumerate(avi_rows) if r[3] >= 1), -1)
    print(f"{tag} MonoViSlam async with loop closing, fed at the camera's 10 fps ({LOOP_VI_CONFIG}), the "
          f"reference's two-view draw: {avi.loop_closer.loops_closed} loop(s) (the tracker saw it closed at frame "
          f"{v_closed}), post-loop GBAs (thread, VI flavour) {gba_ran}; "
          f"final {avi.state}, Sim3 ATE {v_ate:.4f} m (envelope max(5 x {s_:.4f}, 0.20) m, the lock-step VI loop "
          f"run's); re-bases {avi.rebases}, BAs skipped {avi.ba_skipped}; the loop job {v_loop_ms:.1f} ms on the "
          f"worker, the tracker's longest frame {max(r[4] for r in avi_rows[5:]):.1f} ms (host clock), its frames "
          f"{v_closed - 3}-{v_closed + 3}: "
          + ", ".join(f"{r[4]:.1f}" for r in avi_rows[max(v_closed - 3, 0):v_closed + 4]) + " ms; the loop job's "
          "phases " + ", ".join(f"{k} {v:.1f}" for k, v in next((j for j in avi.job_times if "loop" in j), {}).items())
          + f" ms; the VI BAs (kind, K, ms) " + ", ".join(f"{k} {n} {ms:.1f}" for k, n, ms in avi.vi_ba_times)
          + f"; {_ba_split(avi, 'async VI loop run', ('local', 'vi_local'))}")
    _check(avi.vi_ready and avi.loop_closer.loops_closed >= 1 and avi.state == "OK" and avi_rows[-1][0] == "OK"
           and gba_ran and all(t == "viorb-mapping" and vi for t, vi in gba_ran),
           "async MonoViSlam with loop closing: the loop must close, its VI post-loop GBA run in the loop job on "
           "the mapping worker, the run end OK")
    _check(v_ate <= max(5.0 * s_, 0.20),
           f"async MonoViSlam with loop closing: Sim3 ATE {v_ate:.4f} m against the threaded envelope max(5 x "
           f"{s_:.4f}, 0.20) m of the lock-step VI loop run")
    # one K8 launch a job whose keyframe outlived the job's culling
    _check(not on_card or 0 < k8_paths["MonoViSlam async + loop closing (camera rate)"] <= len(avi.job_times),
           f"async VI loop run: K8 launches {k8_paths['MonoViSlam async + loop closing (camera rate)']} for "
           f"{len(avi.job_times)} mapping jobs")
    _check_main_thread_only("async MonoViSlam with loop closing")
    # streaming runs the same mapping job on the same worker: loop closing
    # and the threaded GBA ride along
    stm = MonoSlam(cam, device=dev, vocabulary=vocab, enable_loop_closing=True, streaming=True, **LOOP_CONFIG)
    s_gba = gba_threads(stm)
    try:
        stm_rows = counted("MonoSlam streaming + loop closing (camera rate)",
                           lambda: drive(stm, seq, range(LOOP_FRAMES), paced=True), pipe_cores(stm))
        stm.wait_mapping_idle()
        traj = stm.trajectory_tum()
    finally:
        stm.shutdown()
    s_ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)
    print(f"{tag} MonoSlam streaming with loop closing, fed at the camera's 10 fps: {stm.loop_closer.loops_closed} "
          f"loop(s), post-loop GBAs on threads {s_gba}; final "
          f"{stm.state}, {len(traj)} trajectory frames, Sim3 ATE {s_ate:.4f} m (envelope max(5 x {ate:.4f}, 0.20) "
          f"m); the longest dispatch "
          f"{max(r[4] for r in stm_rows[5:]):.1f} ms (host clock; the backlog gate holds the dispatcher while "
          f"{stm.mapping_backlog_limit} jobs are unfinished)")
    _check(all(t == "viorb-mapping" for t, _vi in s_gba) and len(traj) >= 0.8 * LOOP_FRAMES and stm.state == "OK",
           "streaming MonoSlam with loop closing: its post-loop GBA must run in the loop job on the mapping worker, "
           "it must keep 80 % of the frames and end OK")
    _check(s_ate <= max(5.0 * ate, 0.20),
           f"streaming MonoSlam with loop closing: Sim3 ATE {s_ate:.4f} m against tests/test_streaming.py's envelope "
           f"max(5 x {ate:.4f}, 0.20) m of the lock-step loop run")
    s_closed = next((i for i, r in enumerate(stm_rows) if r[3] >= 1), -1)
    print(f"{tag} MonoSlam streaming with loop closing: {_ba_split(stm, 'streaming loop run')}; the first jobs' "
          f"totals " + ", ".join(f"{j['total']:.1f}" for j in stm.job_times[:4]) + " ms; dispatches around the "
          f"closure (frames {s_closed - 3}-{s_closed + 3}): "
          + ", ".join(f"{r[4]:.1f}" for r in stm_rows[max(s_closed - 3, 0):s_closed + 4]) + " ms")
    _check_main_thread_only("streaming MonoSlam with loop closing")
    k8["main_path"] = "MonoSlam + loop closing"
    return k1_paths, k8_paths, k8


def _k9_check(cam, dev, seq, right, tag: str) -> dict:
    """K9 against its plain version on the card with torch.equal, at the
    stereo path's shapes: frame 0's pair (the left features' descriptor
    matches) and a case with keypoints on each image border and unmatched
    ur0 = -1 rows (flagged and not); its device time beside the plain
    version's, its bound (the bytes each row reads and writes, the f32
    operations of its seven SADs) and an empty launch. Returns the kernels
    line's numbers."""
    import ctypes

    import torch

    from viorb_tpu_torch.cuda_build import load_library
    from viorb_tpu_torch.features import fast_cuda
    from viorb_tpu_torch.features.extractor import OrbExtractor
    from viorb_tpu_torch.geometry.camera import undistort_points
    from viorb_tpu_torch.slam import stereo_cuda
    from viorb_tpu_torch.slam.kernels import match_stereo, refine_stereo_subpixel

    ex = OrbExtractor(n_features=STEREO_CONFIG["n_features"])
    img_l, img_r = seq.images[0], right[0]
    fl, fr = ex.extract(img_l, device=dev), ex.extract(img_r, device=dev)
    xy_l, xy_r = undistort_points(cam, fl.xy), undistort_points(cam, fr.xy)
    ur0, matched = match_stereo(xy_l, fl.descriptors_pm1(), fl.valid, fl.level, xy_r, fr.descriptors_pm1(), fr.valid,
                                fr.level, 0.5, cam.fx * STEREO_BASELINE / 0.1)
    h, w = img_l.shape
    k = 16
    bx = torch.stack([torch.cat([torch.zeros(k), torch.full((k,), w - 1.0), torch.linspace(0, w - 1, 2 * k)]),
                      torch.cat([torch.linspace(0, h - 1, 2 * k), torch.zeros(k), torch.full((k,), h - 1.0)])], 1)
    border = (torch.cat([bx, torch.tensor([[100.0, 60.0]]).repeat(8, 1)]).to(dev),
              torch.cat([(bx[:, 0] - 4.0).clamp(min=0), torch.full((8,), -1.0)]).to(dev),
              torch.cat([torch.ones(4 * k + 4, dtype=torch.bool), torch.zeros(4, dtype=torch.bool)]).to(dev))
    cases = {"frame 0's matches": (img_l, img_r, xy_l, ur0, matched), "border rows and ur0 = -1": (img_l, img_r, *border)}
    for name, args in cases.items():
        stereo_cuda.LAUNCHES_K9 = 0
        got = stereo_cuda.refine_stereo_subpixel_cuda(*args)
        want = refine_stereo_subpixel(*args)
        torch.cuda.synchronize()
        _check(got.is_cuda and stereo_cuda.LAUNCHES_K9 == 1, f"K9 on {name}: {stereo_cuda.LAUNCHES_K9} launches")
        _check(torch.equal(got, want), f"K9 != plain on {name}: max |d| {float((got - want).abs().max())}")
        print(f"K9 == plain (torch.equal) on {name}: {got.shape[0]} rows, {int(args[4].sum())} matched")
    n = xy_l.shape[0]
    args = cases["frame 0's matches"]
    ms = _event_ms(lambda: stereo_cuda.refine_stereo_subpixel_cuda(*args), reps=500, device_only=True)
    plain_ms = _event_ms(lambda: refine_stereo_subpixel(*args), reps=5, device_only=True)
    empty = load_library(fast_cuda.LIB_NAME).viorb_empty_launch
    empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    floor_ms = _event_ms(lambda: empty(stream), reps=1000, device_only=True)
    # each row reads its 11x11 patch and 11x17 strip, its xy, ur0 and flag,
    # and writes ur; each of 7 SADs takes a subtraction, an abs and an add a pixel
    n_bytes, n_ops = n * ((121 + 187) * 4 + 8 + 4 + 1 + 4), n * 7 * 121 * 3
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    print(f"{tag} K9 stereo SAD, {n} rows of a {w}x{h} pair, device time: kernel {ms * 1e3:.2f} us, plain "
          f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us ({bound_by}: {n_bytes} B, {n_ops} ops), "
          f"empty launch {floor_ms * 1e3:.2f} us")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, empty_ms=floor_ms, rows=n)


def _stereo_phase(cam, dev, tag: str) -> dict:
    """Stereo and RGB-D SLAM on the card, lock-step (module docstring,
    phase 10): K9 held to its plain version; tests/test_e2e_stereo.py's
    two contracts (the stereo depth of frame 0; the 40-frame arc, a warm-up
    run and a measured one), tests/test_e2e_rgbd.py's and
    tests/test_e2e_stereo_loop.py's (the 100-frame noisy circuit, the
    vocabulary trained as that test trains it, the loop closed with the
    scale pinned); each run's K1 launches = frames + right extractions, K9
    launches = right extractions, every local BA a replay of its graph (the
    stereo ones under "stereo_local"), frame ms by kind. Returns the
    kernels line's K1, K8 and K9 launches by path and K9's numbers."""
    import numpy as np
    import torch

    from viorb_tpu_torch.bow import descend_cuda, train_vocabulary
    from viorb_tpu_torch.eval.ate import ate_rmse
    from viorb_tpu_torch.features import fast_cuda
    from viorb_tpu_torch.features.extractor import OrbExtractor
    from viorb_tpu_torch.geometry.camera import undistort_points
    from viorb_tpu_torch.io import synthetic
    from viorb_tpu_torch.slam import stereo_cuda
    from viorb_tpu_torch.slam.kernels import match_stereo
    from viorb_tpu_torch.slam.mono import MonoSlam
    from viorb_tpu_torch.slam.rgbd import RgbdSlam
    from viorb_tpu_torch.slam.stereo import StereoSlam
    from viorb_tpu_torch.slam.tracking_loop import make_pipeline_track_core

    t_phase = time.perf_counter()
    seq, right = synthetic.make_stereo_sequence(STEREO_FRAMES, cam=cam, dt=STEREO_DT, baseline=STEREO_BASELINE,
                                                device=dev)
    k9 = _k9_check(cam, dev, seq, right, tag)
    k1, k8, k9_paths = {}, {}, {}

    def drive(label, slam, frames, step, stamps=None):
        """Every frame through `slam` with the K1, K8 and K9 counters set to
        0 just before; checks K1 = frames + right extractions and K9 = right
        extractions, except in a warm-up run (a core's first call warms up
        eagerly and captures) and in MonoSlam's run for comparison. With
        `stamps` (the frames' timestamps) each frame is fed at its time (the
        camera's rate) and a threaded run is drained and stopped at the end.
        Per frame (info, host ms, kind)."""
        core = make_pipeline_track_core(cam, slam.extractor)
        core.reset_counts()
        fast_cuda.LAUNCHES = fast_cuda.CELL_LAUNCHES = 0
        descend_cuda.LAUNCHES_K8 = descend_cuda.LAUNCHES_K8_GLOBAL = 0
        stereo_cuda.LAUNCHES_K9 = 0
        rows = []
        t_start = time.perf_counter()
        try:
            for i in frames:
                if stamps is not None:
                    time.sleep(max(0.0, t_start + float(stamps[i] - stamps[frames[0]]) - time.perf_counter()))
                kfs = slam.map._next_kf
                t0 = time.perf_counter()
                info = step(i)  # ends in a pull: the host clock is honest
                ms = (time.perf_counter() - t0) * 1e3
                kind = "init" if kfs == 0 else "keyframe" if slam.map._next_kf > kfs else "steady"
                rows.append((info, ms, kind))
            slam.wait_mapping_idle()
        finally:
            slam.shutdown()
        right_x = getattr(slam, "right_extractions", 0)
        n = core.launches()["CELL_LAUNCHES"] + fast_cuda.CELL_LAUNCHES
        print(f"{label}: K1 launches {n} ({core.launches()['CELL_LAUNCHES']} in {core.replays} graph replays + "
              f"{fast_cuda.CELL_LAUNCHES} eager) for {len(frames)} frames and {right_x} right extractions; "
              f"K9 launches {stereo_cuda.LAUNCHES_K9}; K8 launches {descend_cuda.LAUNCHES_K8}; "
              + _ba_split(slam, label, ("stereo_local",) if isinstance(slam, StereoSlam) else ("local",)))
        by_kind = {}
        for _, ms, kind in rows:
            by_kind.setdefault(kind, []).append(ms)
        print(f"{tag} {label}, host ms a frame by kind: " + ", ".join(
            f"{kind} x{len(v)} median {statistics.median(v):.2f} max {max(v):.2f}" for kind, v in by_kind.items()))
        if label.endswith("warm-up") or label.startswith("MonoSlam"):
            return [r[0] for r in rows]
        k1[label], k8[label], k9_paths[label] = n, descend_cuda.LAUNCHES_K8, stereo_cuda.LAUNCHES_K9
        _check(n == len(frames) + right_x and fast_cuda.LAUNCHES == 0,
               f"{label}: K1 launches {n} for {len(frames)} frames + {right_x} right extractions")
        _check(stereo_cuda.LAUNCHES_K9 == right_x, f"{label}: K9 launches {stereo_cuda.LAUNCHES_K9}, {right_x} pairs")
        _check(descend_cuda.LAUNCHES_K8_GLOBAL == 0, f"{label}: K8 took its global-histogram path")
        return [r[0] for r in rows]

    def metric(slam, sequence):
        traj = slam.trajectory_tum()
        ate = ate_rmse(traj[:, 0], traj[:, 1:4], sequence.timestamps, sequence.c_w, with_scale=False)
        span = np.linalg.norm(np.ptp(traj[:, 1:4], axis=0)) / np.linalg.norm(np.ptp(sequence.c_w, axis=0))
        _check(np.isfinite(traj).all() and traj.shape[1] == 8, "trajectory not finite or malformed")
        return traj, ate, span

    # tests/test_e2e_stereo.py: the stereo depth of frame 0
    slam = StereoSlam(cam, baseline=STEREO_BASELINE, device=dev, **STEREO_CONFIG)
    fr = slam._make_stereo_frame(seq.images[0], right[0], 0.0)
    ok = fr.depth > 0
    z_gt = synthetic.depth_at(cam, seq.r_wc[0], seq.c_w[0], synthetic.default_room(0), fr.xy[ok])
    rel = float(np.median(np.abs(fr.depth[ok] - z_gt) / z_gt))
    print(f"{tag} StereoSlam frame 0: {int(ok.sum())} stereo matches, median relative depth error {rel:.4f}")
    _check(ok.sum() > 200 and rel < 0.03, f"stereo depth on frame 0: {int(ok.sum())} matches, median error {rel:.4f}")

    # tests/test_e2e_stereo.py: the 40-frame arc, warm-up (the stereo BA's
    # graphs are captured at first use) and measured
    for label in ("StereoSlam warm-up", "StereoSlam"):
        slam = StereoSlam(cam, baseline=STEREO_BASELINE, device=dev, **STEREO_CONFIG)
        infos = drive(label, slam, range(STEREO_FRAMES),
                      lambda i: slam.process_frame_stereo(seq.images[i], right[i], float(seq.timestamps[i])))
    def stereo_contract(label, slam, infos):
        """tests/test_e2e_stereo.py's contract numbers of a run over the arc
        and whether they meet it."""
        n_ok = sum(r["state"] == "OK" for r in infos)
        traj, ate, span = metric(slam, seq)
        steady = traj[:, 0] >= 2.0
        ate_ss = ate_rmse(traj[steady, 0], traj[steady, 1:4], seq.timestamps, seq.c_w, with_scale=False)
        met = (infos[-1]["state"] == "OK" and n_ok > 0.9 * STEREO_FRAMES and ate < 0.09 and ate_ss < 0.02
               and 0.97 < span < 1.03)
        print(f"{tag} {label}, {STEREO_FRAMES} rendered {cam.width}x{cam.height} pairs at dt={STEREO_DT}: "
              f"{n_ok} frames OK, final {infos[-1]}, metric ATE {ate:.4f} m, from 2 s {ate_ss:.4f} m, scale ratio "
              f"{span:.4f}; stereo matches at the keyframes {[r['n_stereo'] for r in infos if r['n_stereo']]}; "
              f"tests/test_e2e_stereo.py's contract met: {met}")
        return n_ok, ate, met

    n_ok, stereo_ate, met = stereo_contract("StereoSlam lock-step", slam, infos)
    _check(met, "StereoSlam lock-step misses tests/test_e2e_stereo.py's contract")

    # what a keyframe adds in stereo: the pair's match (right extraction,
    # undistortion, match_stereo, K9, one pull) on the arc's last frame,
    # and its stages alone (CUDA events)
    fr = slam._make_frame(seq.images[-1], 0.0)
    img_l, img_r = seq.images[-1], right[-1]
    attach = []
    for _ in range(11):
        t0 = time.perf_counter()
        slam._attach_stereo(fr, img_l, img_r)  # ends in a pull
        attach.append((time.perf_counter() - t0) * 1e3)
    fr_r = slam.extractor.extract(img_r, device=dev)
    xy_r = undistort_points(cam, fr_r.xy)
    stage_ms = {
        "right extraction": _event_ms(lambda: slam.extractor.extract(img_r, device=dev), reps=10),
        "match_stereo": _event_ms(lambda: match_stereo(
            fr.xy_dev, fr.desc_pm1, fr.valid_dev, fr.level_dev, xy_r, fr_r.descriptors_pm1(), fr_r.valid,
            fr_r.level, slam.min_disparity, slam.bf / 0.1), reps=10),
    }
    print(f"{tag} StereoSlam, a keyframe's pair match (_attach_stereo: right extraction, undistortion, "
          f"match_stereo, K9, one pull): {statistics.median(attach[1:]):.2f} ms median of 10 (host clock); "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items()) + " (CUDA events)")
    # a steady frame against MonoSlam's on the same left images, same configuration
    mono = MonoSlam(cam, device=dev, **STEREO_CONFIG)
    drive("MonoSlam on the left images", mono, range(STEREO_FRAMES),
          lambda i: mono.process_frame(seq.images[i], float(seq.timestamps[i])))

    # the stereo local BA as StereoSlam replays it, graphed against eager
    stereo_ba = _graphed_ba_check(cam, dev, tag, bf=cam.fx * STEREO_BASELINE)

    # tests/test_e2e_rgbd.py
    rseq, depths = synthetic.make_sequence(STEREO_FRAMES, cam=cam, dt=STEREO_DT, device=dev, with_depth=True)
    slam = RgbdSlam(cam, device=dev, **RGBD_CONFIG)
    infos = drive("RgbdSlam", slam, range(STEREO_FRAMES),
                  lambda i: slam.process_frame_rgbd(rseq.images[i], depths[i], float(rseq.timestamps[i])))

    def rgbd_contract(label, slam, infos):
        """tests/test_e2e_rgbd.py's contract numbers and whether they meet it."""
        n_ok = sum(r["state"] == "OK" for r in infos)
        _, ate, _ = metric(slam, rseq)
        met = infos[0]["state"] == "OK" and n_ok > 0.9 * STEREO_FRAMES and infos[-1]["n_points"] > 300 and ate < 0.05
        print(f"{tag} {label}, {STEREO_FRAMES} frames: frame 0 {infos[0]['state']}, {n_ok} frames OK, "
              f"final {infos[-1]}, metric ATE {ate:.4f} m; tests/test_e2e_rgbd.py's contract met: {met}")
        return n_ok, ate, met

    n_ok, rgbd_ate, met = rgbd_contract("RgbdSlam lock-step", slam, infos)
    _check(met, "RgbdSlam lock-step misses tests/test_e2e_rgbd.py's contract")

    # the threaded modes, fed at the camera's 10 fps: async StereoSlam and
    # RgbdSlam, then a streaming StereoSlam, which the reference's stereo
    # entry runs as async (synchronous tracking beside the mapping worker)
    threaded = (
        ("StereoSlam async", dict(async_mapping=True), stereo_contract, stereo_ate),
        ("StereoSlam streaming", dict(streaming=True), stereo_contract, stereo_ate),
        ("RgbdSlam async", dict(async_mapping=True), rgbd_contract, rgbd_ate),
    )
    for label, mode, contract, lock_ate in threaded:
        if label.startswith("Stereo"):
            slam = StereoSlam(cam, baseline=STEREO_BASELINE, device=dev, **mode, **STEREO_CONFIG)
            frames_of, step = seq, lambda i: slam.process_frame_stereo(seq.images[i], right[i],
                                                                      float(seq.timestamps[i]))
        else:
            slam = RgbdSlam(cam, device=dev, **mode, **RGBD_CONFIG)
            frames_of, step = rseq, lambda i: slam.process_frame_rgbd(rseq.images[i], depths[i],
                                                                     float(rseq.timestamps[i]))
        names = set()
        run_job = slam._mapping_job

        def job(kf_id, run_job=run_job):
            names.add(threading.current_thread().name)
            return run_job(kf_id)

        slam._mapping_job = job
        _check(slam.async_mapping and not slam.streaming, f"{label}: the threaded flags must mean async mapping")
        infos = drive(label, slam, range(STEREO_FRAMES), step, stamps=frames_of.timestamps)
        n_ok, ate, met = contract(label, slam, infos)
        bound = max(5.0 * lock_ate, 0.20)
        print(f"{tag} {label} at the camera's rate: {n_ok} of {STEREO_FRAMES} frames OK, metric ATE {ate:.4f} m "
              f"against the threaded envelope {bound:.4f} m (max(5 x the lock-step run's {lock_ate:.4f}, 0.20)); "
              f"{len(slam.job_times)} mapping jobs on threads {sorted(names)}, no collector thread: "
              f"{slam._collector is None}; the lock-step contract met: {met}")
        _check(infos[-1]["state"] == "OK" and n_ok >= 0.8 * STEREO_FRAMES and ate <= bound,
               f"{label}: the run must end OK with >= 80 % of frames tracked and meet the threaded envelope")
        _check(names == {"viorb-mapping"} and slam.job_times and slam._collector is None
               and not any(t.name == "viorb-collector" for t in threading.enumerate()),
               f"{label}: every job on the mapping worker, no collector thread: {names}")
        _check_main_thread_only(label)

    # tests/test_e2e_stereo_loop.py: the noisy circuit, its vocabulary
    lseq, lright = synthetic.make_stereo_sequence(LOOP_FRAMES, cam=cam, dt=LOOP_DT, baseline=STEREO_BASELINE,
                                                  kind="circuit", noise_std=LOOP_NOISE, device=dev)
    ex = OrbExtractor(n_features=LOOP_VOCAB_FEATURES)
    descs = []
    for i in range(0, LOOP_FRAMES, LOOP_VOCAB_EVERY):
        f = ex.extract(lseq.images[i], device=dev)
        descs.append(f.desc01[f.valid].cpu().numpy())
    vocab = train_vocabulary(np.concatenate(descs), k=8, depth=3)
    slam = StereoSlam(cam, baseline=STEREO_BASELINE, device=dev, vocabulary=vocab, enable_loop_closing=True,
                      **STEREO_CONFIG)
    _check(slam.loop_closer.fix_scale, "StereoSlam must pin the loop Sim3's scale")
    lc, stages = slam.loop_closer, {}

    def timed(name, fn):  # the stage's host ms, the device drained before and after
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                stages.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
        return wrapped

    for name in ("compute_sim3", "correct"):
        setattr(lc, name, timed(name, getattr(lc, name)))
    lc.gba_fn = timed("post-loop GBA", lc.gba_fn)
    infos = drive("StereoSlam loop", slam, range(LOOP_FRAMES),
                  lambda i: slam.process_frame_stereo(lseq.images[i], lright[i], float(lseq.timestamps[i])))
    _, ate, span = metric(slam, lseq)
    print(f"{tag} StereoSlam with loop closing, {LOOP_FRAMES}-frame noisy circuit: "
          f"{sum(r['state'] == 'OK' for r in infos)} frames OK, {slam.loop_closer.loops_closed} loops closed "
          f"(fix_scale), metric ATE {ate:.4f} m, scale ratio {span:.4f}; {int(slam.map.pt_active.sum())} points; "
          f"loop stages, host ms: " + ", ".join(
              f"{k} x{len(v)} max {max(v):.1f}" for k, v in stages.items()))
    _check(slam.loop_closer.loops_closed >= 1 and ate < 0.05 and 0.97 < span < 1.03,
           f"StereoSlam misses tests/test_e2e_stereo_loop.py's contract: {slam.loop_closer.loops_closed} loops, "
           f"ATE {ate:.4f} m, ratio {span:.4f}")
    _check_main_thread_only("the stereo and RGB-D phase")
    print(f"{tag} stereo and RGB-D phase: {time.perf_counter() - t_phase:.1f} s of host time")
    return dict(k1=k1, k8=k8, k9=k9, k9_paths=k9_paths, stereo_ba=stereo_ba)


# ---- phase 11: the command line -------------------------------------------

CLI_VI_FRAMES, CLI_MONO_FRAMES, CLI_RGBD_FRAMES, CLI_RELOC_FRAMES = 60, 40, 20, 20
CLI_RGBD_FEATURES, CLI_STEREO_FEATURES, CLI_DEPTH_FACTOR = 800, 800, 5000.0

# A fresh interpreter that runs `python -m viorb_tpu_torch ARGS` (runpy, the
# module's own __main__), timing each MonoViSlam frame from the outside and
# counting the kernels' launches; it writes them as JSON to its first
# argument. The command line's own output is left as it is.
_CLI_CHILD = """
import json, runpy, sys, time
t_start = time.perf_counter()
stats_path = sys.argv.pop(1)
sys.argv[0] = "viorb_tpu_torch"
import chip_smoke
from viorb_tpu_torch.slam.mono_vi import MonoViSlam
rows = []
step = MonoViSlam.process_frame_vi
def timed(self, *args):
    t0 = time.perf_counter()
    info = step(self, *args)
    rows.append(((t0 - t_start) * 1e3, (time.perf_counter() - t0) * 1e3, info["state"], bool(self.vi_ready)))
    return info
MonoViSlam.process_frame_vi = timed
with chip_smoke._kernel_launches() as launches:
    runpy.run_module("viorb_tpu_torch", run_name="__main__", alter_sys=True)
with open(stats_path, "w") as f:
    json.dump({"frames": rows, "launches": launches, "off_main_thread": chip_smoke._off_main_thread(),
               "seconds": time.perf_counter() - t_start}, f)
"""


@contextlib.contextmanager
def _kernel_launches():
    """Yields a dict that holds, after the block, the launches of K1 (`k1`:
    the eager fused launches plus every tracking core's graph replays, less
    the eager warm-up calls of the captures made inside the block; `k1_single`,
    the per-level entry's), K8 (`k8`, `k8_global`) and K9 (`k9`) made inside
    it, with every counter set to 0 just before."""
    from viorb_tpu_torch.bow import descend_cuda
    from viorb_tpu_torch.cuda_graph import WARMUP_CALLS
    from viorb_tpu_torch.features import fast_cuda
    from viorb_tpu_torch.slam import stereo_cuda, tracking_loop

    def graphs():
        for core in list(tracking_loop._CORE_CACHE.values()):
            yield from (core.graphs.values() if hasattr(core, "graphs") else [core])

    before = {id(g): len(g.captured()) for g in graphs()}
    for g in graphs():
        g.reset_counts()
    fast_cuda.LAUNCHES = fast_cuda.CELL_LAUNCHES = 0
    descend_cuda.LAUNCHES_K8 = descend_cuda.LAUNCHES_K8_GLOBAL = 0
    stereo_cuda.LAUNCHES_K9 = 0
    out = {}
    yield out
    cell, single, warm = fast_cuda.CELL_LAUNCHES, fast_cuda.LAUNCHES, 0
    for g in graphs():
        cell += g.launches()["CELL_LAUNCHES"]
        single += g.launches()["LAUNCHES"]
        warm += WARMUP_CALLS * sum(c["CELL_LAUNCHES"] for c in g.captured()[before.get(id(g), 0):])
    out.update(k1=cell - warm, k1_single=single, k8=descend_cuda.LAUNCHES_K8,
               k8_global=descend_cuda.LAUNCHES_K8_GLOBAL, k9=stereo_cuda.LAUNCHES_K9)


def _cli_settings(cam, **extra) -> str:
    """A settings file of the reference's YAML schema for `cam`, with
    `extra` keys (a value that is an array becomes an opencv-matrix)."""
    import numpy as np

    lines = ["%YAML:1.0", f"Camera.fx: {cam.fx}", f"Camera.fy: {cam.fy}", f"Camera.cx: {cam.cx}",
             f"Camera.cy: {cam.cy}", "Camera.k1: 0.0", "Camera.k2: 0.0", "Camera.p1: 0.0", "Camera.p2: 0.0",
             f"Camera.width: {cam.width}", f"Camera.height: {cam.height}"]
    for key, value in extra.items():
        if isinstance(value, np.ndarray):
            lines += [f"{key}: !!opencv-matrix", f"   rows: {value.shape[0]}", f"   cols: {value.shape[1]}",
                      "   dt: f", "   data: [" + ", ".join(repr(float(v)) for v in value.ravel()) + "]"]
        else:
            lines.append(f"{key}: {value}")
    return "\n".join(lines) + "\n"


def _cli_trajectory_ok(path: str, min_rows: int, what: str):
    import numpy as np

    traj = np.loadtxt(path, ndmin=2)
    _check(traj.shape[0] >= min_rows and np.isfinite(traj).all(),
           f"{what}: {traj.shape[0]} trajectory rows (>= {min_rows} wanted), finite {np.isfinite(traj).all()}")
    return traj


def _cli_phase(cam, dev, tag: str) -> dict:
    """The port's command line on the card (module docstring, phase 11):
    dumps written under a temporary directory from the port's renderer
    (8-bit PNG images and 16-bit PNG depth through io/png.py, each
    dataset's text files), then `viorb_tpu_torch.run.main` in process
    (after a fresh `python -m viorb_tpu_torch` for the VI stream run), each
    run's kernel launches counted. Returns the kernels line's K1, K8 and K9
    launches by path."""
    import io as stdio
    import zlib
    import re
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from viorb_tpu_torch import cuda_graph
    from viorb_tpu_torch.bow import train_vocabulary
    from viorb_tpu_torch.eval.ate import ate_rmse
    from viorb_tpu_torch.features.extractor import OrbExtractor
    from viorb_tpu_torch.io import datasets, synthetic
    from viorb_tpu_torch.io.config import SlamConfig
    from viorb_tpu_torch.io.live import LivePublisher, LiveSource
    from viorb_tpu_torch.io.png import _chunks as png_chunks
    from viorb_tpu_torch.io.png import read_png, write_png
    from viorb_tpu_torch.io.stream import MsgSynchronizer, RealtimeRunner
    from viorb_tpu_torch.mapping.serialize import load_map
    from viorb_tpu_torch.run import main as cli_main
    from viorb_tpu_torch.slam.loop_closing import LoopCloser
    from viorb_tpu_torch.slam.mono import MonoSlam
    from viorb_tpu_torch.slam.mono_vi import MonoViSlam

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    k1, k8, k9 = {}, {}, {}
    tmp_dir = tempfile.TemporaryDirectory(prefix="viorb_cli_")
    tmp = tmp_dir.name

    def run_cli(label, argv, frames_processed, right_extractions=0, patch=None):
        """run.main(argv) in this process: its stderr kept and its summary
        lines printed; K1 = frames processed + right extractions checked
        (a function of the run's slam and stderr when not a number); no
        build, load or capture off the main thread; the threads stopped.
        Returns (slam, stderr, launches)."""
        err = stdio.StringIO()
        t0 = time.perf_counter()
        with _kernel_launches() as n, contextlib.redirect_stderr(err), (patch or contextlib.nullcontext()):
            slam = cli_main(argv + ["--device", str(dev)])
        wall = time.perf_counter() - t0
        text = err.getvalue()
        median = re.search(r"median track time: ([0-9.]+) ms", text)
        frames = frames_processed(slam, text) if callable(frames_processed) else frames_processed
        rx = right_extractions(slam) if callable(right_extractions) else right_extractions
        print(f"{tag} CLI {label}: {wall:.1f} s of host time, the CLI's median track time "
              f"{median.group(1) if median else '?'} ms; K1 {n['k1']} for {frames} frames + {rx} right "
              f"extractions, K8 {n['k8']}, K9 {n['k9']}; the CLI's last lines: "
              + " | ".join(text.strip().splitlines()[-3:]))
        k1[f"CLI {label}"], k8[f"CLI {label}"], k9[f"CLI {label}"] = n["k1"], n["k8"], n["k9"]
        if on_card:
            _check(n["k1"] == frames + rx and n["k1_single"] == 0,
                   f"CLI {label}: K1 launches {n['k1']} (single-image {n['k1_single']}) for {frames} frames + "
                   f"{rx} right extractions")
            _check(n["k8_global"] == 0, f"CLI {label}: K8 took its global-histogram path")
        _check_main_thread_only(f"CLI {label}")
        _check(slam._worker is None and slam._collector is None and cuda_graph.card_threads() == 0
               and not any(t.name == "viorb-stream-feeder" and t.is_alive() for t in threading.enumerate()),
               f"CLI {label}: threads left running")
        return slam, text, n

    def stream_counts(text):
        """(processed, frames, dropped) of a --stream run's summary line."""
        m = re.search(r"stream mode \w+: processed (\d+)/(\d+) frames, dropped (\d+)", text)
        _check(m is not None, "a --stream run printed no summary line")
        return int(m.group(1)), int(m.group(2)), int(m.group(3))

    def stream_processed(slam, text):
        """A lockstep run's frames processed: the IMU must have reached a
        frame's stamp for the synchronizer to release it."""
        n, frames, dropped = stream_counts(text)
        _check(dropped == 0 and n >= frames - 1, f"lockstep: processed {n} of {frames}, dropped {dropped}")
        return n

    # 1. the VI stream path as a fresh process: python -m viorb_tpu_torch
    out_t, out_k, stats = (os.path.join(tmp, f) for f in ("vi_traj.txt", "vi_kf.txt", "vi_stats.json"))
    cmd = [sys.executable, "-c", _CLI_CHILD, stats, "--dataset", "synthetic", "--vi", "--frames",
           str(CLI_VI_FRAMES), "--stream", "lockstep", "--out", out_t, "--out-kf", out_k]
    if not on_card:
        cmd += ["--device", str(dev)]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    child = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600,
                           env=dict(os.environ, PYTHONPATH=root))
    wall = time.perf_counter() - t0
    _check(child.returncode == 0, f"python -m viorb_tpu_torch --vi --stream lockstep exited {child.returncode}: "
           + child.stderr[-3000:])
    with open(stats) as f:
        st = json.load(f)
    traj = _cli_trajectory_ok(out_t, 50, "python -m viorb_tpu_torch --vi --stream lockstep")
    kf = np.loadtxt(out_k, ndmin=2)
    _check(kf.shape[0] >= 5 and kf.shape[1] == 17, f"the keyframe NavState file has shape {kf.shape}")
    rows = st["frames"]
    init = next(i for i, r in enumerate(rows) if r[2] == "OK")
    vi_init = next((i for i, r in enumerate(rows) if r[3]), None)
    steady = sorted(r[1] for r in rows[init + 2:])
    median = re.search(r"median track time: ([0-9.]+) ms", child.stderr)
    print(f"{tag} CLI python -m viorb_tpu_torch --dataset synthetic --vi --frames {CLI_VI_FRAMES} --stream lockstep, "
          f"a fresh process: wall {wall:.1f} s (the interpreter's own clock {st['seconds']:.1f} s), its first frame "
          f"began {rows[0][0]:.0f} ms after start (imports, rendering) and took {rows[0][1]:.1f} ms; the map's init "
          f"at frame {init}, {rows[init][1]:.1f} ms; frame {init + 1} (the tracking core's capture) "
          f"{rows[init + 1][1]:.1f} ms; VI init at frame {vi_init} "
          f"{rows[vi_init][1] if vi_init is not None else float('nan'):.1f} ms; later frames median "
          f"{statistics.median(steady):.1f} ms, max {steady[-1]:.1f} ms; the CLI's own median track time "
          f"{median.group(1) if median else '?'} ms; {traj.shape[0]} trajectory rows, {kf.shape[0]} keyframe "
          f"rows; K1 {st['launches']['k1']} for {len(rows)} frames; off the main thread {st['off_main_thread']}")
    for paths, key in ((k1, "k1"), (k8, "k8"), (k9, "k9")):
        paths["CLI python -m, synthetic --vi --stream lockstep"] = st["launches"][key]
    if on_card:
        _check(st["launches"]["k1"] == len(rows), f"the fresh process's K1 launches {st['launches']}, {len(rows)} frames")
    _check(not any(st["off_main_thread"].values()), f"the fresh process: {st['off_main_thread']} off the main thread")

    # 2. EuRoC VI from a dump of the same arc and IMU
    seq = synthetic.make_sequence(CLI_VI_FRAMES, cam=cam, dt=VI_DT, device=dev)
    imu = synthetic.make_imu(CLI_VI_FRAMES, VI_DT)
    euroc = os.path.join(tmp, "euroc")
    for d in ("mav0/cam0/data", "mav0/imu0"):
        os.makedirs(os.path.join(euroc, d))
    images = [synthetic.to_uint8(im).cpu().numpy() for im in seq.images]
    t_ns = [int(round(float(t) * 1e9)) for t in seq.timestamps]
    for img, t in zip(images, t_ns):
        write_png(os.path.join(euroc, f"mav0/cam0/data/{t}.png"), img, filter_type="adaptive")
    with open(os.path.join(euroc, "mav0/cam0/data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n" + "".join(f"{t},{t}.png\n" for t in t_ns))
    with open(os.path.join(euroc, "mav0/imu0/data.csv"), "w") as f:  # %.17g: each f32 sample read back exactly
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n" + "".join(
            f"{int(round(float(t) * 1e9))}," + ",".join(f"{float(v):.17g}" for v in (*g, *a)) + "\n"
            for t, g, a in zip(imu.t, imu.gyro, imu.acc)))
    euroc_cfg = os.path.join(tmp, "euroc.yaml")
    with open(euroc_cfg, "w") as f:
        f.write(_cli_settings(cam, **{"Camera.fps": 10.0, "Camera.Tbc": np.eye(4), "IMU.multiplyG": 0,
                                      "Camera.delaytoimu": 0, "test.VINSInitTime": 15.0,
                                      "ORBextractor.nFeatures": 1000}))
    loaded = datasets.load_euroc_mono(euroc)
    for (ts, img), want in zip(loaded, images):
        _check(img.dtype == np.float32 and np.array_equal(img, want.astype(np.float32)),
               f"the EuRoC loader's frame at {ts} differs from the uint8 image written")
    seen = {"dump": [], "live": []}  # per frame: (ts, image, samples) handed to process_frame_vi, and its info

    def recording(key, step):
        def wrapped(self, image, ts, samples):
            info = step(self, image, ts, samples)
            seen[key].append((ts, np.asarray(image), [(t, np.asarray(g), np.asarray(a)) for t, g, a in samples],
                              (info["state"], info["n_tracked"], info["n_kfs"])))
            return info
        return wrapped

    slam, _, _ = run_cli(
        "euroc --vi --stream lockstep", ["--dataset", "euroc", "--path", euroc, "--config", euroc_cfg, "--vi",
                                         "--stream", "lockstep", "--out", os.path.join(tmp, "euroc_traj.txt"),
                                         "--out-kf", os.path.join(tmp, "euroc_kf.txt")],
        stream_processed, patch=mock.patch.object(MonoViSlam, "process_frame_vi",
                                                  recording("dump", MonoViSlam.process_frame_vi)))
    dump_traj = slam.trajectory_tum()
    traj = _cli_trajectory_ok(os.path.join(tmp, "euroc_traj.txt"), 50, "CLI euroc --vi")
    kf = np.loadtxt(os.path.join(tmp, "euroc_kf.txt"), ndmin=2)
    _check(kf.shape[0] >= 5 and kf.shape[1] == 17, f"CLI euroc --vi: keyframe NavState file shape {kf.shape}")
    ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=False)
    print(f"{tag} CLI euroc --vi: {traj.shape[0]} rows, {kf.shape[0]} keyframes, VI ready {slam.vi_ready}, "
          f"metric ATE {ate:.4f} m")

    # the same frames and samples over the live TCP wire into a lockstep runner
    cfg = SlamConfig.from_yaml(euroc_cfg)
    it, ig, ia = datasets.load_euroc_imu(euroc)
    frames = list(loaded)
    live = MonoViSlam(cfg.camera, r_bc=cfg.r_bc, p_bc=cfg.p_bc, n_features=cfg.n_features,
                      local_window=cfg.local_window, vi_init_min_time=min(cfg.vins_init_time, 3.0), device=dev)
    pub = LivePublisher()
    sync = MsgSynchronizer(image_delay=cfg.image_delay_to_imu)
    box = {}

    def publish():
        pub.wait_subscriber(timeout=60.0)
        k = 0
        for ts, img in frames:
            while k < len(it) and it[k] <= ts + cfg.image_delay_to_imu:
                pub.send_imu(float(it[k]), ig[k], ia[k])
                k += 1
            pub.send_image(ts, img)
        pub.close()

    sender = threading.Thread(target=publish, name="cli-live-publisher")
    sender.start()
    source = LiveSource(*pub.address, sync).start()
    step = recording("live", MonoViSlam.process_frame_vi)
    with _kernel_launches() as n:
        done = RealtimeRunner(sync, lambda ts, img, s: step(live, img, float(ts), [(float(t), g, a) for t, g, a in s]),
                              mode="lockstep").run()
        live.wait_mapping_idle()
    sender.join(60.0)
    source.join(60.0)
    live.shutdown()
    _check(not sender.is_alive() and done == len(seen["dump"]),
           f"the live replay processed {done} frames, the dump run {len(seen['dump'])}")
    k1["CLI euroc dump over the live wire"], k8["CLI euroc dump over the live wire"] = n["k1"], n["k8"]
    k9["CLI euroc dump over the live wire"] = n["k9"]
    _check(not on_card or n["k1"] == done, f"the live replay's K1 launches {n} for {done} frames")
    live_traj = live.trajectory_tum()
    same_inputs = next((i for i, (a, b) in enumerate(zip(seen["dump"], seen["live"]))
                        if a[0] != b[0] or not np.array_equal(a[1], b[1]) or len(a[2]) != len(b[2])
                        or any(x[0] != y[0] or not np.array_equal(np.float32(x[1]), np.float32(y[1]))
                               or not np.array_equal(np.float32(x[2]), np.float32(y[2])) for x, y in zip(a[2], b[2]))),
                       None)
    _check(same_inputs is None, f"the live wire handed frame {same_inputs} over differently from the dump run")
    if dump_traj.shape == live_traj.shape and np.array_equal(dump_traj, live_traj):
        print(f"{tag} CLI euroc dump over LivePublisher -> LiveSource -> lockstep runner -> MonoViSlam: every input "
              f"equal to the dump run's, trajectory equal ({live_traj.shape[0]} rows, bit for bit)")
    else:
        first = next((i for i, (a, b) in enumerate(zip(seen["dump"], seen["live"])) if a[3] != b[3]), None)
        d = (np.abs(dump_traj - live_traj).max() if dump_traj.shape == live_traj.shape else float("nan"))
        print(f"{tag} CLI euroc dump over the live wire: every input equal to the dump run's, the trajectories "
              f"differ ({dump_traj.shape} vs {live_traj.shape}, max |d| {d:.3e}); the first frame whose outcome "
              f"differs: {first} ({seen['dump'][first][3] if first is not None else '-'} vs "
              f"{seen['live'][first][3] if first is not None else '-'}): with equal inputs, the card's run-to-run "
              f"difference")

    # 3. TUM RGB-D from a dump, with and without the DepthMapFactor line
    rseq, depths = synthetic.make_sequence(CLI_RGBD_FRAMES, cam=cam, dt=VI_DT, device=dev, with_depth=True)
    tum = os.path.join(tmp, "tum")
    os.makedirs(os.path.join(tum, "rgb"))
    os.makedirs(os.path.join(tum, "depth"))
    lines = []
    for i, (img, dep, ts) in enumerate(zip(rseq.images, depths, rseq.timestamps)):
        write_png(os.path.join(tum, f"rgb/{i:04d}.png"), synthetic.to_uint8(img).cpu().numpy(), filter_type="adaptive")
        write_png(os.path.join(tum, f"depth/{i:04d}.png"),
                  (dep * CLI_DEPTH_FACTOR).round().clamp(0, 65535).cpu().numpy().astype(np.uint16),
                  filter_type="adaptive")
        lines.append(f"{ts:.6f} rgb/{i:04d}.png {ts:.6f} depth/{i:04d}.png")
    with open(os.path.join(tum, "associations.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    trajs = {}
    for label, extra in (("tum --rgbd", {"DepthMapFactor": CLI_DEPTH_FACTOR}), ("tum --rgbd, no DepthMapFactor", {})):
        path = os.path.join(tmp, f"tum{len(trajs)}.yaml")
        with open(path, "w") as f:
            f.write(_cli_settings(cam, **{"Camera.fps": 10.0, "ORBextractor.nFeatures": CLI_RGBD_FEATURES, **extra}))
        slam, _, _ = run_cli(label, ["--dataset", "tum", "--rgbd", "--path", tum, "--config", path, "--out",
                                     os.path.join(tmp, "tum_traj.txt")], CLI_RGBD_FRAMES)
        traj = _cli_trajectory_ok(os.path.join(tmp, "tum_traj.txt"), 15, f"CLI {label}")
        trajs[label] = slam.trajectory_tum()
        ate = ate_rmse(traj[:, 0], traj[:, 1:4], rseq.timestamps, rseq.c_w, with_scale=False)
        print(f"{tag} CLI {label}: {traj.shape[0]} rows, final {slam.state}, metric ATE {ate:.4f} m to the "
              f"renderer's truth")
    a, b = trajs.values()
    _check(a.shape == b.shape and np.array_equal(a, b),
           "CLI tum --rgbd: the run without DepthMapFactor must read depth with TUM's 5000 and equal the run with it")

    # 4. KITTI stereo with loop closing from a dump of the stereo loop circuit,
    # then the saved map reloaded for localization over its first frames
    lseq, lright = synthetic.make_stereo_sequence(LOOP_FRAMES, cam=cam, dt=LOOP_DT, baseline=STEREO_BASELINE,
                                                  kind="circuit", noise_std=LOOP_NOISE, device=dev)
    kitti = os.path.join(tmp, "kitti")
    left_u8 = []
    for cam_dir, imgs in (("image_0", lseq.images), ("image_1", lright)):
        os.makedirs(os.path.join(kitti, cam_dir))
        for i, img in enumerate(imgs):
            u8 = synthetic.to_uint8(img).cpu().numpy()
            write_png(os.path.join(kitti, cam_dir, f"{i:06d}.png"), u8, filter_type="adaptive")
            if cam_dir == "image_0":
                left_u8.append(u8)
    with open(os.path.join(kitti, "times.txt"), "w") as f:
        f.write("".join(f"{t:.6e}\n" for t in lseq.timestamps))
    decode_ms = {}
    for what, path in (("a KITTI right image (752x480, 8-bit)", os.path.join(kitti, "image_1", "000000.png")),
                       ("a TUM depth image (752x480, 16-bit)", os.path.join(tum, "depth", "0000.png"))):
        with open(path, "rb") as f:
            kinds = np.bincount(np.frombuffer(zlib.decompress(b"".join(
                body for ctype, body in png_chunks(f.read(), path) if ctype == b"IDAT")), np.uint8)
                .reshape(cam.height, -1)[:, 0], minlength=5)
        reads = []
        for _ in range(20):
            t0 = time.perf_counter()
            read_png(path)
            reads.append((time.perf_counter() - t0) * 1e3)
        decode_ms[what] = statistics.median(reads)
        print(f"{tag} CLI io/png.py read of {what}, rows by filter type 0-4 {kinds.tolist()}: median "
              f"{decode_ms[what]:.3f} ms, min {min(reads):.3f} ms over 20 reads (the host's clock, warm file cache)")
    ex = OrbExtractor(n_features=LOOP_VOCAB_FEATURES)  # tests/test_e2e_stereo_loop.py's vocabulary, as phase 10
    descs = []
    for i in range(0, LOOP_FRAMES, LOOP_VOCAB_EVERY):
        feats = ex.extract(torch.from_numpy(left_u8[i]).to(dev), device=dev)
        descs.append(feats.desc01[feats.valid].cpu().numpy())
    vocab_path = os.path.join(tmp, "vocab.npz")
    train_vocabulary(np.concatenate(descs), k=8, depth=3).save(vocab_path)
    kitti_cfg = os.path.join(tmp, "kitti.yaml")
    with open(kitti_cfg, "w") as f:
        f.write(_cli_settings(cam, **{"Camera.fps": 10.0, "Camera.bf": cam.fx * STEREO_BASELINE, "ThDepth": 35.0,
                                      "ORBextractor.nFeatures": CLI_STEREO_FEATURES}))
    closures = []
    correct = LoopCloser.correct

    def record_scale(self, kf_id, cand_id, s12, *args, **kwargs):
        closures.append(float(s12))
        return correct(self, kf_id, cand_id, s12, *args, **kwargs)

    map_path, out_kitti = os.path.join(tmp, "kitti_map.npz"), os.path.join(tmp, "kitti_traj.txt")
    slam, _, n = run_cli("kitti --stereo --loop-closing", [
        "--dataset", "kitti", "--path", kitti, "--config", kitti_cfg, "--stereo", "--loop-closing", "--vocab",
        vocab_path, "--save-map", map_path, "--out-kitti", out_kitti, "--out", os.path.join(tmp, "k_tum.txt")],
        LOOP_FRAMES, right_extractions=lambda s: s.right_extractions,
        patch=mock.patch.object(LoopCloser, "correct", record_scale))
    rows = np.loadtxt(out_kitti, ndmin=2)
    tum_rows = slam.trajectory_tum()
    ate = ate_rmse(tum_rows[:, 0], tum_rows[:, 1:4], lseq.timestamps, lseq.c_w, with_scale=False)
    print(f"{tag} CLI kitti --stereo --loop-closing: {slam.loop_closer.loops_closed} loops closed, Sim3 scales "
          f"{closures}, {rows.shape[0]} KITTI rows of {rows.shape[1]} values for {tum_rows.shape[0]} tracked frames, "
          f"{slam.map._next_kf} keyframes made, {slam.right_extractions} right extractions, metric ATE {ate:.4f} m")
    _check(slam.loop_closer.loops_closed >= 1 and closures and all(s == 1.0 for s in closures),
           f"CLI kitti --stereo --loop-closing: {slam.loop_closer.loops_closed} loops, scales {closures}")
    _check(rows.shape == (tum_rows.shape[0], 12) and np.isfinite(rows).all(),
           f"the KITTI file holds {rows.shape}, {tum_rows.shape[0]} tracked frames")
    if on_card:
        _check(n["k9"] == slam.right_extractions and n["k8"] == slam.map._next_kf,
               f"CLI kitti: K9 {n['k9']} for {slam.right_extractions} right extractions, K8 {n['k8']} for "
               f"{slam.map._next_kf} keyframes")
    saved = load_map(map_path).kf_ids()
    short = os.path.join(tmp, "kitti_first")
    os.makedirs(short)
    for cam_dir in ("image_0", "image_1"):
        os.symlink(os.path.join(kitti, cam_dir), os.path.join(short, cam_dir))
    with open(os.path.join(short, "times.txt"), "w") as f:
        f.write("".join(f"{t:.6e}\n" for t in lseq.timestamps[:CLI_RELOC_FRAMES]))
    relocs = []
    relocalize = MonoSlam._relocalize

    def count_relocs(self, fr):
        relocs.append(relocalize(self, fr))
        return relocs[-1]

    slam, _, n = run_cli("kitti --stereo --load-map --localization-only", [
        "--dataset", "kitti", "--path", short, "--config", kitti_cfg, "--stereo", "--vocab", vocab_path,
        "--load-map", map_path, "--localization-only", "--out", os.path.join(tmp, "reloc.txt")],
        CLI_RELOC_FRAMES, right_extractions=lambda s: s.right_extractions,
        patch=mock.patch.object(MonoSlam, "_relocalize", count_relocs))
    reloc = np.loadtxt(os.path.join(tmp, "reloc.txt"), ndmin=2)
    print(f"{tag} CLI kitti --load-map --localization-only over the first {CLI_RELOC_FRAMES} frames: "
          f"{len(saved)} keyframes loaded, {reloc.shape[0]} frames tracked (first at t = {reloc[0, 0]:.3f} s), final "
          f"{slam.state}, keyframes after {len(slam.map.kf_ids())}, K8 {n['k8']}; relocalizations {len(relocs)} "
          f"({sum(relocs)} succeeded): a frame the pipeline core does not track against the reference "
          f"keyframe's local map relocalizes")
    _check(reloc.shape[0] >= 0.9 * CLI_RELOC_FRAMES and abs(reloc[0, 0] - lseq.timestamps[0]) < 1e-6
           and slam.state == "OK" and sorted(slam.map.kf_ids()) == sorted(saved),
           f"the reloaded map: {reloc.shape[0]} frames tracked, first at {reloc[0, 0]}, final {slam.state}, "
           f"keyframes {len(slam.map.kf_ids())} of {len(saved)}")
    _check(not on_card or n["k8"] == len(saved), f"--load-map: K8 {n['k8']} for {len(saved)} loaded keyframes")

    # the lockstep stream over more frames than the synchronizer's queue holds
    # (its max_images): the feeder waits for room, so no frame is dropped
    _check(LOOP_FRAMES > MsgSynchronizer().max_images, "the lockstep run must outnumber the synchronizer's queue")

    def all_processed(slam, text):
        n, frames, dropped = stream_counts(text)
        _check(dropped == 0 and n == frames == LOOP_FRAMES, f"lockstep over the circuit: processed {n} of {frames}, "
               f"dropped {dropped}")
        print(f"{tag} CLI kitti --stream lockstep: processed {n} of {frames} frames, dropped {dropped} (a queue of "
              f"{MsgSynchronizer().max_images})")
        return n

    run_cli("kitti --stream lockstep", ["--dataset", "kitti", "--path", kitti, "--config", kitti_cfg, "--stream",
                                        "lockstep", "--out", os.path.join(tmp, "kitti_mono.txt")], all_processed)

    # 5. mono streaming with the headless viewer; mono through the realtime stream
    viz = os.path.join(tmp, "viz")
    slam, _, _ = run_cli("synthetic --streaming --viz-dir", [
        "--dataset", "synthetic", "--frames", str(CLI_MONO_FRAMES), "--streaming", "--viz-dir", viz, "--out",
        os.path.join(tmp, "stream.txt")], CLI_MONO_FRAMES)
    _cli_trajectory_ok(os.path.join(tmp, "stream.txt"), int(0.8 * CLI_MONO_FRAMES), "CLI --streaming")
    pngs = sorted(os.listdir(viz))
    shapes = {f: read_png(os.path.join(viz, f)).shape for f in pngs}
    want = {"frame": (slam.cam.height + 12, slam.cam.width, 3), "map": (450, 990, 3)}
    _check(len([f for f in pngs if f.startswith("frame_")]) == CLI_MONO_FRAMES // 10 and "map_final.png" in pngs
           and all(shapes[f] == want[f.split("_")[0]] for f in pngs), f"the viewer wrote {shapes}")
    print(f"{tag} CLI --viz-dir: {len(pngs)} PNGs, each decoded by io/png.py to its shape: "
          f"{sorted(set(shapes.values()))}")

    def processed(slam, text):
        n, frames, dropped = stream_counts(text)
        _check(n + dropped == frames == CLI_MONO_FRAMES, f"realtime: processed {n} + dropped {dropped} != {frames}")
        print(f"{tag} CLI --stream realtime --replay-speed 1.0: processed {n} of {frames} frames, dropped {dropped} "
              f"(reported, not enforced)")
        return n

    run_cli("synthetic --stream realtime --replay-speed 1.0", [
        "--dataset", "synthetic", "--frames", str(CLI_MONO_FRAMES), "--stream", "realtime", "--replay-speed", "1.0",
        "--out", os.path.join(tmp, "realtime.txt")], processed)
    tmp_dir.cleanup()
    print(f"{tag} the command line phase: {time.perf_counter() - t_phase:.1f} s of host time")
    return dict(k1=k1, k8=k8, k9=k9)


# ---- phase 12: distributed bundle adjustment --------------------------------

DIST_K, DIST_M, DIST_R, DIST_ITERS = 12, 8192, 8, 10  # bench_scaling.py's problem
DIST_TIMEOUT = 300  # seconds a child process may take before it is killed


def _dist_problem(dev) -> dict:
    """bench_scaling.py's landmark-sharded BA problem, seeded as it seeds it:
    K = 12 poses 0.15 m apart, M = 8192 landmarks, each seen from R = 8
    random keyframes with 0.3 px noise, the points perturbed by 3 cm; the
    VI problem on the same landmarks, NavStates at the same poses and an
    11-edge chain of identity preintegrations (dt 0.5 s, every edge invalid:
    structure only, as bench_scaling.py has it). All on `dev`."""
    import numpy as np
    import torch

    from viorb_tpu_torch.geometry.camera import PinholeCamera
    from viorb_tpu_torch.imu import ImuNoise, NavState, PreintegratedImu
    from viorb_tpu_torch.optim.ba import BAObservations, ImuChain, ViBAState, VisionBAState
    from viorb_tpu_torch.optim.reprojection import Extrinsics

    cam = PinholeCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0)
    rng = np.random.default_rng(0)
    k, m, r = DIST_K, DIST_M, DIST_R
    pts = np.stack([rng.uniform(-4, 4, m), rng.uniform(-3, 3, m), rng.uniform(4, 10, m)], 1).astype(np.float32)
    t_k = np.stack([np.array([0.15 * i, 0, 0], np.float32) for i in range(k)])
    r_k = np.broadcast_to(np.eye(3, dtype=np.float32), (k, 3, 3)).copy()
    kf_idx = rng.integers(0, k, (m, r)).astype(np.int64)
    pc = pts[:, None, :] + t_k[kf_idx]
    uv = np.stack([cam.fx * pc[..., 0] / pc[..., 2] + cam.cx, cam.fy * pc[..., 1] / pc[..., 2] + cam.cy],
                  axis=-1).astype(np.float32)
    uv = uv + rng.normal(size=uv.shape).astype(np.float32) * 0.3
    p0 = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.03

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    obs = BAObservations(up(kf_idx), up(uv), torch.ones((m, r), device=dev), torch.ones((m, r), dtype=torch.bool,
                                                                                        device=dev))
    fixed = torch.zeros(k, dtype=torch.bool, device=dev)
    fixed[0] = True
    z = torch.zeros((k, 3), device=dev)
    nav = NavState(up(-t_k), z, up(r_k), z.clone(), z.clone(), z.clone(), z.clone())
    pre = PreintegratedImu.identity((k - 1,), device=dev)._replace(
        dt=torch.full((k - 1,), 0.5, device=dev), cov=(torch.eye(9, device=dev) * 1e-4).expand(k - 1, 9, 9).contiguous())
    noise = ImuNoise()
    chain = ImuChain(pre, torch.zeros(k - 1, dtype=torch.bool, device=dev),
                     up(np.r_[[1.0 / noise.gyro_bias_rw_var] * 3, [1.0 / noise.acc_bias_rw_var] * 3].astype(np.float32)
                        * np.float32(0.005)))
    return dict(cam=cam, obs=obs, fixed=fixed, vision=VisionBAState(up(r_k), up(t_k), up(p0)),
                vi=ViBAState(nav, up(p0)), ext=Extrinsics(torch.eye(3, device=dev), torch.zeros(3, device=dev)),
                chain=chain, gravity=torch.tensor([0.0, 0.0, -9.81], device=dev))


def _parallel_golden() -> dict:
    """tests/torch_parallel_golden.npz: tests/test_distributed_ba.py's two
    problems and the JAX package's distributed solves of them."""
    import numpy as np

    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_parallel_golden.npz"),
                 allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _timed_runs(fn, sync) -> Tuple[object, float]:
    """fn() once to warm up, then once more timed on the host clock between
    two drains of the card (`sync`); returns the second result and its ms."""
    fn()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def _distributed_child(argv) -> int:
    """One rank of phase 12 (`chip_smoke.py --distributed-child BACKEND WORLD
    RANK PORT OUT [DEVICE]`, DEVICE cuda:0 by default): joins the run through
    the port's own code (`initialize`, or `join_process_group` for a world of
    one, which `initialize` leaves alone; either binds the card), takes its
    landmark rows, runs the distributed vision and VI BAs once to warm up and
    once timed, then the distributed VI BA on tests/torch_parallel_golden.npz's
    VI problem (a live IMU chain), and writes its solved states and times to
    OUT (.npz)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from viorb_tpu_torch import interop
    from viorb_tpu_torch.imu.navstate import NavState
    from viorb_tpu_torch.optim.ba import ViBAState, VisionBAState
    from viorb_tpu_torch.optim.reprojection import Extrinsics
    from viorb_tpu_torch.parallel import (distributed_vi_ba, distributed_vision_ba, host_local_slice, initialize,
                                          landmark_mesh, shard_observations)
    from viorb_tpu_torch.parallel.multihost import join_process_group

    backend, world, rank, port, out = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    dev = torch.device(argv[5] if len(argv) > 5 else "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    coordinator = f"127.0.0.1:{port}"
    if world == 1:
        join_process_group(coordinator, 1, 0, backend)
    else:
        assert initialize(coordinator=coordinator, num_processes=world, process_id=rank, backend=backend)
    mesh = landmark_mesh(device="cpu" if dev.type == "cpu" else None)
    assert mesh.device == dev, (mesh.device, dev)  # the card the port bound
    prob = _dist_problem(dev)
    rows = host_local_slice(DIST_M, mesh)
    obs = shard_observations(prob["obs"], mesh)
    vis0, vi0 = prob["vision"], prob["vi"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    vis, vis_ms = _timed_runs(lambda: distributed_vision_ba(
        VisionBAState(vis0.r_cw, vis0.t_cw, vis0.points[rows]), obs, prob["cam"], prob["fixed"], mesh,
        iters=DIST_ITERS), sync)
    vi, vi_ms = _timed_runs(lambda: distributed_vi_ba(
        ViBAState(vi0.nav, vi0.points[rows]), obs, prob["cam"], prob["ext"], prob["chain"], prob["gravity"],
        prob["fixed"], mesh, iters=DIST_ITERS), sync)
    g = _parallel_golden()
    live_rows = host_local_slice(len(g["vi_points0"]), mesh)
    nav = {f: g[f"vi_nav0_{f}"] for f in NavState._fields}
    pre = {k[len("vi_pre_"):]: v for k, v in g.items() if k.startswith("vi_pre_")}
    live = distributed_vi_ba(
        interop.vi_ba_state_from_numpy(nav, g["vi_points0"][live_rows], device=dev),
        interop.ba_observations_from_numpy(*(g[f"vi_{f}"][live_rows] for f in ("kf_idx", "uv", "inv_sigma2", "valid")),
                                           device=dev), prob["cam"],
        Extrinsics(torch.eye(3, device=dev), torch.zeros(3, device=dev)),
        interop.imu_chain_from_numpy(pre, np.ones(len(g["vi_pre_dt"]), bool), g["vi_bias_info"], device=dev),
        torch.tensor(g["vi_gravity"], device=dev), torch.tensor(g["vi_fixed"], device=dev), mesh, iters=10)[0]
    np.savez(out, r_cw=vis[0].r_cw.cpu().numpy(), t_cw=vis[0].t_cw.cpu().numpy(),
             points=vis[0].points.cpu().numpy(), p=vi[0].nav.p.cpu().numpy(), v=vi[0].nav.v.cpu().numpy(),
             r=vi[0].nav.r.cpu().numpy(), vi_points=vi[0].points.cpu().numpy(), vision_ms=vis_ms, vi_ms=vi_ms,
             live_p=live.nav.p.cpu().numpy(), live_v=live.nav.v.cpu().numpy(), live_r=live.nav.r.cpu().numpy(),
             backend=dist.get_backend(), device=str(mesh.device), start=rows.start, stop=rows.stop)
    dist.destroy_process_group()
    return 0


def _distributed_phase(dev, tag: str, runs_of=(("nccl", 1), ("gloo", 2))) -> dict:
    """Distributed bundle adjustment on the card (module docstring, phase
    12): bench_scaling.py's problem solved by the port's single-device
    `vision_ba` / `vi_ba`, by `distributed_vision_ba` / `distributed_vi_ba`
    at world size 1 on NCCL in a child process, and by two gloo ranks on
    the one card in two child processes (`runs_of`: (backend, world size)
    each). Returns the phase's numbers."""
    import socket

    import numpy as np
    import torch

    from viorb_tpu_torch.optim.ba import _vi_cost, _vision_cost_and_chi2, vi_ba, vision_ba
    from viorb_tpu_torch.optim.robust import CHI2_MONO_2DOF
    from viorb_tpu_torch.parallel.distributed_ba import all_reduce_payload

    t_phase = time.perf_counter()
    prob = _dist_problem(dev)
    cam, obs, fixed = prob["cam"], prob["obs"], prob["fixed"]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    single_vis, vis_ms = _timed_runs(lambda: vision_ba(prob["vision"], obs, cam, fixed, iters=DIST_ITERS), sync)
    single_vi, vi_ms = _timed_runs(lambda: vi_ba(prob["vi"], obs, cam, prob["ext"], prob["chain"], prob["gravity"],
                                                 fixed, iters=DIST_ITERS), sync)
    # tests/test_distributed_ba.py's VI problem, whose IMU chain is live: the
    # single-device solve on the card, and the JAX package's distributed one
    from viorb_tpu_torch import interop
    from viorb_tpu_torch.imu.navstate import NavState
    from viorb_tpu_torch.optim.reprojection import Extrinsics

    g = _parallel_golden()
    live_single = vi_ba(
        interop.vi_ba_state_from_numpy({f: g[f"vi_nav0_{f}"] for f in NavState._fields}, g["vi_points0"], device=dev),
        interop.ba_observations_from_numpy(*(g[f"vi_{f}"] for f in ("kf_idx", "uv", "inv_sigma2", "valid")),
                                           device=dev), cam,
        Extrinsics(torch.eye(3, device=dev), torch.zeros(3, device=dev)),
        interop.imu_chain_from_numpy({k[len("vi_pre_"):]: v for k, v in g.items() if k.startswith("vi_pre_")},
                                     np.ones(len(g["vi_pre_dt"]), bool), g["vi_bias_info"], device=dev),
        torch.tensor(g["vi_gravity"], device=dev), torch.tensor(g["vi_fixed"], device=dev), iters=10)[0]
    live_single = {k: getattr(live_single.nav, k).cpu().numpy() for k in ("p", "v")}

    def free_port() -> int:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)

    def spawn(backend, world):
        """The ranks of one run, each a child process; every one is waited
        for with a timeout and killed if it outlives it."""
        port, outs = free_port(), [os.path.join(out_dir, f"dist_{backend}_{world}_{r}.npz") for r in range(world)]
        for o in outs:
            if os.path.exists(o):
                os.remove(o)
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--distributed-child", backend,
                                   str(world), str(r), str(port), outs[r], str(dev)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(world)]
        logs, t0 = [], time.perf_counter()
        try:
            for p in procs:
                logs.append(p.communicate(timeout=DIST_TIMEOUT)[0])
            wall[f"{backend} {world}"] = time.perf_counter() - t0
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            _check(p.returncode == 0, f"distributed BA, {backend} world {world}: rank {r} exited {p.returncode}:\n"
                                      f"{log[-3000:]}")
        return [dict(np.load(o)) for o in outs]

    def whole(ranks, key):  # the landmark rows of every rank, in rank order
        return torch.from_numpy(np.concatenate([x[key] for x in ranks])).to(dev)

    def costs(ranks):
        """The robust cost of the whole problem before and after, vision and
        VI, with the single-device cost functions."""
        from viorb_tpu_torch.optim.ba import ViBAState, VisionBAState

        r0 = ranks[0]
        vis = VisionBAState(torch.from_numpy(r0["r_cw"]).to(dev), torch.from_numpy(r0["t_cw"]).to(dev),
                            whole(ranks, "points"))
        nav = prob["vi"].nav._replace(p=torch.from_numpy(r0["p"]).to(dev), v=torch.from_numpy(r0["v"]).to(dev),
                                      r=torch.from_numpy(r0["r"]).to(dev))
        vi = ViBAState(nav, whole(ranks, "vi_points"))
        vi_cost = lambda st: float(_vi_cost(st, obs, cam, prob["ext"], prob["chain"], prob["gravity"],  # noqa: E731
                                            CHI2_MONO_2DOF)[0])
        return (float(_vision_cost_and_chi2(prob["vision"], obs, cam, CHI2_MONO_2DOF)[0]),
                float(_vision_cost_and_chi2(vis, obs, cam, CHI2_MONO_2DOF)[0]), vi_cost(prob["vi"]), vi_cost(vi))

    def apart(ranks):
        r0 = ranks[0]
        return {"r_cw": float(np.abs(r0["r_cw"] - single_vis[0].r_cw.cpu().numpy()).max()),
                "t_cw": float(np.abs(r0["t_cw"] - single_vis[0].t_cw.cpu().numpy()).max()),
                "p": float(np.abs(r0["p"] - single_vi[0].nav.p.cpu().numpy()).max()),
                "v": float(np.abs(r0["v"] - single_vi[0].nav.v.cpu().numpy()).max())}

    tol = {"r_cw": 1e-4, "t_cw": 1e-3, "p": 2e-3, "v": 1e-2}  # tests/test_distributed_ba.py's
    runs, wall = {}, {}
    for backend, world in runs_of:
        ranks = spawn(backend, world)
        label = f"{backend}, world size {world}"
        if world > 1:
            same = all(np.array_equal(ranks[0][k], x[k]) for x in ranks[1:]
                       for k in ("r_cw", "t_cw", "p", "v", "r", "live_p", "live_v", "live_r"))
            _check(same, f"distributed BA, {label}: the ranks' solved poses differ")
        # the live IMU chain: its system and cost are added once, after the
        # all-reduce (tests/test_torch_multihost.py's bounds against the
        # single-device solve; tests/test_distributed_ba.py's against the JAX
        # package's)
        live = {f"{k} vs the card's single-device solve": float(np.abs(ranks[0][f"live_{k}"] - live_single[k]).max())
                for k in ("p", "v")}
        live.update({f"{k} vs the JAX package's": float(np.abs(ranks[0][f"live_{k}"] - g[f"vi_dist_{k}"]).max())
                     for k in ("p", "v")})
        live_tol = dict(zip(live, (5e-4, 1e-3, 2e-3, 1e-2)))
        _check([(int(x["start"]), int(x["stop"])) for x in ranks]
               == [(r * DIST_M // world, (r + 1) * DIST_M // world) for r in range(world)],
               f"distributed BA, {label}: host_local_slice")
        d = apart(ranks)
        c = costs(ranks)
        on = str(ranks[0]["device"])
        runs[label] = dict(vision_ms=float(max(x["vision_ms"] for x in ranks)) / DIST_ITERS,
                           vi_ms=float(max(x["vi_ms"] for x in ranks)) / DIST_ITERS, apart=d, costs=c,
                           backend=str(ranks[0]["backend"]), live=live)
        print(f"{tag} distributed BA, {label} (tensors on {on}{', every rank on it' if world > 1 else ''}): "
              f"{'the ranks equal bit for bit' if world > 1 else 'one rank'}; against the single-device solve |dR| {d['r_cw']:.2e}, |dt| {d['t_cw']:.2e}, "
              f"VI |dp| {d['p']:.2e}, |dv| {d['v']:.2e}; cost vision {c[0]:.1f} -> {c[1]:.1f}, VI {c[2]:.1f} -> "
              f"{c[3]:.1f}; {runs[label]['vision_ms']:.3f} / {runs[label]['vi_ms']:.3f} ms an LM iteration "
              f"(vision / VI, host clock, the card drained and the ranks joined at both ends); the live-IMU VI "
              f"problem: " + ", ".join(f"|d{k}| {v:.2e}" for k, v in live.items()))
        _check(all(d[k] <= tol[k] for k in tol), f"distributed BA, {label}: outside tests/test_distributed_ba.py's "
                                                 f"tolerances of the single-device solve: {d}")
        _check(all(live[k] <= live_tol[k] for k in live), f"distributed BA, {label}: the live-IMU VI problem outside "
                                                          f"its bounds {live_tol}: {live}")
        _check(c[1] < c[0] and c[3] < c[2], f"distributed BA, {label}: the cost did not fall: {c}")
    pay_vis, pay_vi = all_reduce_payload(DIST_K, 6), all_reduce_payload(DIST_K, 15, vi=True)
    print(f"{tag} distributed BA at K={DIST_K} M={DIST_M} R={DIST_R}, {DIST_ITERS} iterations: single device "
          f"{vis_ms / DIST_ITERS:.3f} / {vi_ms / DIST_ITERS:.3f} ms an iteration (vision / VI); all-reduced an "
          f"iteration: the vision BA's [S | b | cost], ((K*D)^2 + K*D + 1) x 4 = {pay_vis - 4} B, the VI BA's "
          f"[S | b] {pay_vi - 4} B (it carries the accepted cost), each plus the candidate's 4 B cost; "
          f"NCCL refuses two ranks on one device, so the multi-rank NCCL path is not run here (it waits for a "
          f"machine with two or more GPUs); phase {time.perf_counter() - t_phase:.1f} s of host time, the child "
          f"processes' wall " + ", ".join(f"{k} {v:.1f} s" for k, v in wall.items()))
    return dict(single_ms=(vis_ms / DIST_ITERS, vi_ms / DIST_ITERS), runs=runs, payload=(pay_vis - 4, pay_vi - 4))

def _kernels_per_call(fn) -> int:
    """CUDA kernels (and device copies) one call of fn() launches, by the
    profiler; 0 when the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)


def _device_ops_in_graph(fn) -> int:
    """Device operations (graph nodes: kernels, memsets, copies) one call of
    fn() records into a CUDA graph, read with libcuda's cuGraphGetNodes."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up: the allocator's blocks exist before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    _check(rc == 0, f"cuGraphGetNodes failed: CUresult {rc}")
    return int(n.value)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    import numpy as np

    from unittest import mock

    from viorb_tpu_torch import default_device
    from viorb_tpu_torch.bow import descend_cuda
    from viorb_tpu_torch.cuda_build import build_info, find_nvcc, load_libraries, load_library
    from viorb_tpu_torch.cuda_graph import WARMUP_CALLS, GraphedFunction
    from viorb_tpu_torch.features import extractor as extractor_module
    from viorb_tpu_torch.features import fast_cuda
    from viorb_tpu_torch.features.extractor import OrbExtractor
    from viorb_tpu_torch.features.fast import (
        _fast_cells_pyramid_torch,
        _fast_score_map_torch,
        fast_cells_pyramid,
        fast_score_map,
        grid_topk_keypoints,
        topk_from_cells,
    )
    from viorb_tpu_torch.features.orb import EDGE_MARGIN
    from viorb_tpu_torch.features.pyramid import build_pyramid
    from viorb_tpu_torch.features.matching import hamming_matrix, match_with_mask, valid_gate
    from viorb_tpu_torch.geometry.camera import PinholeCamera, undistort_points
    from viorb_tpu_torch.geometry.so3 import normalize_rotation
    from viorb_tpu_torch.interop import (
        ba_observations_from_numpy,
        carry_from_numpy,
        vision_ba_state_from_numpy,
    )
    from viorb_tpu_torch.io import synthetic
    from viorb_tpu_torch.optim.ba import _vision_cost_and_chi2, vision_ba
    from viorb_tpu_torch.optim.pose_only import PoseObs, pose_optimization_tcw
    from viorb_tpu_torch.optim.robust import CHI2_MONO_2DOF
    from viorb_tpu_torch.slam import stereo_cuda
    from viorb_tpu_torch.slam.kernels import match_by_projection, triangulate_between
    from viorb_tpu_torch.slam.tracking_loop import (
        DeviceMap,
        TrackCarry,
        make_pipeline_track_core,
        make_streaming_track_core,
        make_tracking_step,
    )
    from viorb_tpu_torch.solvers.two_view import sample_minimal_sets, two_view_from_samples, two_view_init

    # ---- 1. report -------------------------------------------------------
    marks = [("start", time.perf_counter())]  # (phases ended, host clock) for the closing time line
    card = _card()
    tag = f"[{card}]"
    dev = default_device()
    nvcc = find_nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    print(card)  # as nvidia-smi gives it: name, power limit
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, nvcc {nvcc_version}")

    # ---- 2. build: one nvcc a source, all started together ----------------
    t_build = time.perf_counter()
    load_libraries([fast_cuda.LIB_NAME, descend_cuda.LIB_NAME, stereo_cuda.LIB_NAME])
    print(f"build, in parallel: {time.perf_counter() - t_build:.2f} s")
    for lib in (fast_cuda.LIB_NAME, descend_cuda.LIB_NAME, stereo_cuda.LIB_NAME):
        build_s, build_log = build_info(lib)
        print(f"build {lib}: {build_s:.2f} s")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # ---- 3. kernel vs plain on the card ---------------------------------
    cam = PinholeCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
    extractor = OrbExtractor(n_features=1000)
    r_wc, c_w = synthetic.make_trajectory(N_FRAMES, dt=0.1)
    planes = synthetic.stack_planes(synthetic.default_room(0))  # on the card by default
    frames = [
        synthetic.to_uint8(synthetic.render_frame(cam, r_wc[i], c_w[i], planes))
        for i in range(N_FRAMES)
    ]
    gen = torch.Generator().manual_seed(0)
    random_frame = torch.randint(0, 256, (cam.height, cam.width), generator=gen, dtype=torch.uint8)
    pyramids = {
        name: build_pyramid(frame.to(dev).float(), extractor.n_levels, extractor.scale_factor)
        # integer scores tie constantly: the random frame is the hard case for the argmax
        for name, frame in (("random", random_frame), ("rendered", frames[0]))
    }
    # every level exactly constant: all scores 0, so every cell's first maximum is index 0
    pyramids["constant"] = [torch.full(tuple(p.shape), 100.0, device=dev) for p in pyramids["random"]]
    fast_err = cells_err = 0.0
    for name, pyr in pyramids.items():
        for lvl, img in enumerate(pyr):
            got = fast_score_map(img)
            want = _fast_score_map_torch(img)
            torch.cuda.synchronize()
            _check(torch.equal(got, want), f"FAST kernel != plain on {name} level {lvl} {tuple(img.shape)}")
            fast_err = max(fast_err, float((got - want).abs().max()))
        got_best, got_arg, got_offs = fast_cells_pyramid(pyr, extractor.cell, EDGE_MARGIN)
        want_best, want_arg, want_offs = _fast_cells_pyramid_torch(pyr, extractor.cell, EDGE_MARGIN)
        torch.cuda.synchronize()
        _check(got_offs == want_offs and got_best.shape == want_best.shape,
               f"fused FAST cells: layout differs on the {name} pyramid")
        _check(torch.equal(got_best, want_best), f"fused FAST cells: cell_best != plain on the {name} pyramid")
        _check(torch.equal(got_arg, want_arg), f"fused FAST cells: cell_arg != plain on the {name} pyramid")
        if name == "constant":
            _check(not bool(got_arg.any()) and not bool(got_best.any()),
                   "fused FAST cells: a constant image must give score 0 at index 0 in every cell")
        else:
            _check(int((got_best > 0).sum()) > got_best.numel() // 4, f"{name} pyramid has too few corners")
        cells_err = max(cells_err, float((got_best - want_best).abs().max()),
                        float((got_arg - want_arg).abs().max()))
        print(f"FAST kernel == plain (torch.equal) on the {name} frame's 8 levels: score maps "
              + ", ".join(f"{tuple(p.shape)}" for p in pyr)
              + f"; fused cell_best and cell_arg of {got_offs[-1]} cells")

    # ---- 4. the slice ----------------------------------------------------
    dmap = synthetic.lift_features_to_map(
        extractor, cam, frames[0], r_wc[0], c_w[0], planes, capacity=MAP_SLOTS
    )
    n_map = int(dmap.valid.sum())
    _check(dmap.xyz.shape == (MAP_SLOTS, 3) and n_map > 500, f"map of {n_map} points")
    print(f"map: {n_map} valid points of {MAP_SLOTS} slots")
    step = make_tracking_step(cam, extractor)
    pipeline = make_pipeline_track_core(cam, extractor)
    streaming = make_streaming_track_core(cam, extractor)
    # The carry starts at frame 0's true pose, moving with the true
    # frame 0 -> 1 motion. (From rest, frame 1 settles on the far wall's
    # rotation/translation ambiguity: 0.64 m / 6.3 deg in the JAX reference
    # and the port alike.)
    r0, t0 = r_wc[0].T, -r_wc[0].T @ c_w[0]
    r1, t1 = r_wc[1].T, -r_wc[1].T @ c_w[1]
    vel_r = r1 @ r0.T
    carry0 = carry_from_numpy(r0, t0, vel_r, t1 - vel_r @ t0)  # on the card by default
    _check(carry0.r_cw.is_cuda and planes.textures.is_cuda and dmap.xyz.is_cuda,
           "entry points must default to the card")

    def predict(c: TrackCarry):
        return c.vel_r @ c.r_cw, c.vel_r @ c.t_cw + c.vel_t

    def advance(c: TrackCarry, r_new, t_new) -> TrackCarry:
        """What the pipeline's host does between frames, kept on the device
        here: the constant-velocity carry from a core's new pose."""
        r_new = normalize_rotation(r_new)
        v_r = r_new @ c.r_cw.T
        return TrackCarry(r_new, t_new, v_r, t_new - v_r @ c.t_cw)

    # how each core is driven over the arc: (carry, frame) -> (carry, call
    # arguments); results -> (carry, (r_cw, t_cw, inlier count))
    def run_step(fn, c, i):
        c, out = fn(c, frames[i], dmap)
        return c, out, (out.r_cw, out.t_cw, out.n_inliers)

    def run_pipeline(fn, c, i):
        out = fn(frames[i], *predict(c), *dmap)
        return advance(c, out[4], out[5]), out, (out[4], out[5], out[6].sum())

    def run_streaming(fn, c, i):
        c, out = fn(c, frames[i], *dmap)
        return c, out, (out[4], out[5], out[6].sum())

    cores = {
        "tracking step (LM 2x4)": (step, run_step),
        "pipeline core (LM 4x10)": (pipeline, run_pipeline),
        "streaming core (LM 4x10)": (streaming, run_streaming),
    }

    # The first call of a core warms up, captures and replays. It belongs to
    # set-up: the counts below are taken over the 15 tracked frames alone.
    for name, (core, run) in cores.items():
        t_cap = time.perf_counter()
        run(core, carry0, 1)
        torch.cuda.synchronize()
        captured = core.captured()
        print(f"{name}: warm-up + capture + first replay {time.perf_counter() - t_cap:.2f} s, "
              f"kernel launches in the graph {captured}")
        _check(captured == [{"LAUNCHES": 0, "CELL_LAUNCHES": 1, "LAUNCHES_K8": 0, "LAUNCHES_K8_GLOBAL": 0,
                             "LAUNCHES_K9": 0}],
               f"{name}: the captured graph must hold exactly one fused K1 launch, got {captured}")

    tracked, eager_inputs, graph_launches = {}, {}, {}
    for name, (core, run) in cores.items():
        core.reset_counts()
        fast_cuda.LAUNCHES = fast_cuda.CELL_LAUNCHES = 0
        carry, poses, outs_full = carry0, [], []
        for i in range(1, N_FRAMES):
            if i <= 3:
                eager_inputs.setdefault(name, []).append(carry)
            carry, out, pose = run(core, carry, i)
            poses.append(pose)
            if i <= 3:
                outs_full.append(out)
        torch.cuda.synchronize()  # the one pull: everything above was queued without a sync
        launches = core.launches()
        graph_launches[name] = launches["CELL_LAUNCHES"]
        _check(
            core.replays == N_FRAMES - 1 and launches == {"LAUNCHES": 0, "CELL_LAUNCHES": N_FRAMES - 1, "LAUNCHES_K8": 0,
                                                          "LAUNCHES_K8_GLOBAL": 0, "LAUNCHES_K9": 0}
            and fast_cuda.LAUNCHES == 0 and fast_cuda.CELL_LAUNCHES == 0,
            f"{name}: {core.replays} replays made {launches} launches through the graph and "
            f"{fast_cuda.CELL_LAUNCHES} + {fast_cuda.LAUNCHES} through the eager wrappers; expected "
            f"one fused launch a frame inside the graph and nothing else",
        )
        for i, (r_cw, t_cw, n_inl) in enumerate(poses, start=1):
            _check(r_cw.shape == (3, 3) and t_cw.shape == (3,), f"{name} frame {i}: pose shapes")
            _check(bool(torch.isfinite(r_cw).all() and torch.isfinite(t_cw).all()),
                   f"{name} frame {i}: pose not finite")
            n_inl = int(n_inl)
            pos, rot = _pose_errors(r_cw, t_cw, r_wc[i], c_w[i])
            print(f"{name} frame {i:2d}: inliers {n_inl:3d}  pose error {pos * 100:.2f} cm {rot:.3f} deg")
            _check(
                n_inl > MIN_INLIERS and pos < MAX_POS_ERR_M and rot < MAX_ROT_ERR_DEG,
                f"{name} frame {i}: {n_inl} inliers, {pos:.4f} m, {rot:.3f} deg",
            )
        print(f"{name}: tracked {N_FRAMES - 1} frames as one CUDA graph a frame: fused FAST + cell-argmax "
              f"launches {graph_launches[name]} (1 captured x {core.replays} replays), single-image FAST launches 0")
        tracked[name] = (poses, outs_full)
    outs = tracked["tracking step (LM 2x4)"][0]  # per frame (r_cw, t_cw, inlier count)
    cell_launches = sum(graph_launches.values())

    # replay against eager: the graph's outputs on frames 1-3 against the
    # eager function's on the same inputs (the same kernels in the same
    # order, so equal; a difference above 1e-6 fails)
    for name, (core, run) in cores.items():
        worst = 0.0
        for j, c_in in enumerate(eager_inputs[name]):
            _, want, _ = run(core.eager, c_in, j + 1)
            got = tracked[name][1][j]
            torch.cuda.synchronize()
            for a, b in zip(_leaves(got), _leaves(want)):
                _check(a.shape == b.shape and a.dtype == b.dtype, f"{name}: replay and eager outputs differ in shape")
                if not torch.equal(a, b):
                    worst = max(worst, float((a.double() - b.double()).abs().max()))
        print(f"{name}: graph replay vs eager on frames 1-3: "
              + ("torch.equal on every output" if worst == 0.0 else f"largest difference {worst:.3e}"))
        _check(worst <= 1e-6, f"{name}: graph replay differs from eager by {worst:.3e}")
    _check(fast_cuda.CELL_LAUNCHES == 3 * 3 and fast_cuda.LAUNCHES == 0,
           f"9 eager core calls made {fast_cuda.CELL_LAUNCHES} fused launches through the wrapper")

    # host syncs: 0 in a replay of each core (argument copies included), so a
    # core can be queued frame after frame; 0 in the eager pipeline core too
    for name, (core, run) in cores.items():
        syncs = _count_syncs(lambda: run(core, carry0, 1))
        print(f"{name}: host syncs in one graph replay: {len(syncs)}")
        for m in sorted(set(syncs)):
            print(f"  sync: {m}")
        _check(not syncs, f"{name}: a replay must not sync with the host")
    syncs = _count_syncs(lambda: run_pipeline(pipeline.eager, carry0, 1))
    print(f"pipeline core, eager: host syncs in one call: {len(syncs)}")
    _check(not syncs, f"the eager pipeline core (retry included) must not sync: {sorted(set(syncs))}")

    # the 15 px -> 30 px retry: a prediction yawed by 0.05 rad moves every
    # projection ~22 px, so 15 px finds fewer than 20 matches and 30 px
    # rescues the frame; the true prediction is served by 15 px. Either way
    # the core's selection equals a separate match at the radius the rule picks.
    yaw = 0.05
    r_yaw = torch.tensor([[np.cos(yaw), 0.0, np.sin(yaw)], [0.0, 1.0, 0.0], [-np.sin(yaw), 0.0, np.cos(yaw)]],
                         dtype=torch.float32, device=dev)
    r_pred1, t_pred1 = predict(carry0)
    for label, r_p, t_p, want_wide in (("displaced prediction", r_yaw @ r_pred1, r_yaw @ t_pred1, True),
                                       ("true prediction", r_pred1, t_pred1, False)):
        out = pipeline(frames[1], r_p, t_p, *dmap)
        feats_o, xy_o, fdesc_o, pf_o, nmatch_o, vis_o = out[0], out[1], out[2], out[3], out[8], out[7]
        narrow, wide = (
            match_by_projection(*dmap, r_p, t_p, xy_o, fdesc_o, feats_o.valid, cam, radius)
            for radius in (15.0, 30.0)
        )
        picked = wide if int(narrow[2]) < 20 else narrow
        print(f"retry, {label}: 15 px {int(narrow[2])} matches, 30 px {int(wide[2])}; the core reports "
              f"{int(nmatch_o)}, {int(out[6].sum())} inliers")
        _check((int(narrow[2]) < 20) == want_wide and int(wide[2]) >= 20,
               f"retry, {label}: 15 px gave {int(narrow[2])} matches, 30 px {int(wide[2])}")
        _check(torch.equal(pf_o, picked[0]) and int(nmatch_o) == int(picked[2]) and torch.equal(vis_o, picked[3]),
               f"retry, {label}: the core's selection is not the match at the radius the rule picks")
        _check(int(out[6].sum()) > MIN_INLIERS, f"retry, {label}: {int(out[6].sum())} inliers")

    # A capture while another thread works on the card, as a mapping thread
    # does beside the tracker: on a stream of its own it allocates tensors of
    # ever new sizes and launches the fused kernel eagerly until the capture
    # is done. The capture must succeed and hold its own launch and no other,
    # and every launch of the thread must arrive in the wrapper's counter.
    busy_core = GraphedFunction(extractor._extract)
    # drawn here: the card's default random generator belongs to a capture
    # while it runs, and a draw from another thread raises in that thread
    noise = torch.rand(64 + 16 * 27, 752, device=dev) * 255
    stop, made, thread_errors = threading.Event(), [0], []

    def mapping_thread():
        try:
            with torch.cuda.stream(torch.cuda.Stream(device=dev)):
                while not stop.is_set():
                    rows = 64 + 16 * (made[0] % 27)
                    image = noise[:rows] + float(made[0] % 5)
                    fast_cells_pyramid(build_pyramid(image, 3, extractor.scale_factor), extractor.cell, EDGE_MARGIN)
                    made[0] += 1
                torch.cuda.current_stream(dev).synchronize()
        except Exception as exc:  # re-raised below, on the main thread
            thread_errors.append(exc)

    fast_cuda.LAUNCHES = fast_cuda.CELL_LAUNCHES = 0
    worker = threading.Thread(target=mapping_thread)
    worker.start()
    while made[0] < 3 and worker.is_alive():
        time.sleep(0.001)
    made_before = made[0]
    feats_busy = busy_core(frames[1])
    made_during = made[0] - made_before
    stop.set()
    worker.join()
    torch.cuda.synchronize()
    if thread_errors:
        raise thread_errors[0]
    own = fast_cuda.CELL_LAUNCHES - made[0]  # the capturing thread's eager launches: its warm-up calls
    print(f"capture beside a busy thread: the thread made {made[0]} eager fused launches, {made_during} of them "
          f"during warm-up + capture + replay; the capture holds {busy_core.captured()}, the wrapper counted "
          f"{fast_cuda.CELL_LAUNCHES} = {made[0]} + {own} warm-up calls")
    _check(made_during > 0, "the second thread made no launch while the graph was captured")
    _check(busy_core.captured() == [{"LAUNCHES": 0, "CELL_LAUNCHES": 1, "LAUNCHES_K8": 0, "LAUNCHES_K8_GLOBAL": 0,
                                     "LAUNCHES_K9": 0}] and busy_core.replays == 1,
           f"a capture beside a busy thread must hold its own launch alone, got {busy_core.captured()}")
    _check(own == WARMUP_CALLS and fast_cuda.LAUNCHES == 0,
           f"launch counts beside a capture: {fast_cuda.CELL_LAUNCHES} counted, {made[0]} made by the thread")
    for field, a, b in zip(feats_busy._fields, feats_busy, extractor._extract(frames[1])):
        _check(torch.equal(a, b), f"capture beside a busy thread: FrameFeatures.{field} differs from eager")

    # frame 1's features through the kernel against the plain halves, both
    # on the card: every field identical
    feats_kernel = extractor._extract(frames[1])
    before = fast_cuda.CELL_LAUNCHES
    with mock.patch.object(extractor_module, "fast_cells_pyramid", _fast_cells_pyramid_torch):
        feats_plain = extractor._extract(frames[1])
    torch.cuda.synchronize()
    _check(fast_cuda.CELL_LAUNCHES == before and feats_plain.xy.is_cuda,
           "the plain halves must run on the card without the kernel")
    for field, a, b in zip(feats_kernel._fields, feats_kernel, feats_plain):
        _check(a.dtype == b.dtype and torch.equal(a, b), f"frame 1 FrameFeatures.{field}: kernel != plain halves")
    print(f"frame 1 FrameFeatures identical through the kernel and the plain halves "
          f"({int(feats_kernel.valid.sum())} valid of {extractor.capacity})")

    # the per-level entry points, driven on their own: frame 1's pyramid
    # through fast_score_map + grid_topk_keypoints, held to the fused path
    pyr1 = build_pyramid(frames[1].float(), extractor.n_levels, extractor.scale_factor)
    best1, arg1, offs1 = fast_cells_pyramid(pyr1, extractor.cell, EDGE_MARGIN)
    fast_cuda.LAUNCHES = fast_cuda.CELL_LAUNCHES = 0
    per_level = [
        grid_topk_keypoints(fast_score_map(img), extractor.level_quota[lvl], extractor.cell,
                            extractor.fast_min_threshold, EDGE_MARGIN)
        for lvl, img in enumerate(pyr1)
    ]
    torch.cuda.synchronize()
    fast_launches = fast_cuda.LAUNCHES
    _check(fast_launches == extractor.n_levels and fast_cuda.CELL_LAUNCHES == 0,
           f"per-level path: {fast_launches} single-image launches for {extractor.n_levels} levels")
    for lvl, got in enumerate(per_level):
        want = topk_from_cells(
            best1[offs1[lvl]:offs1[lvl + 1]], arg1[offs1[lvl]:offs1[lvl + 1]],
            pyr1[lvl].shape[1] // extractor.cell, extractor.level_quota[lvl], extractor.cell,
            extractor.fast_min_threshold,
        )
        for g, w in zip(got, want):
            _check(torch.equal(g, w), f"per-level path != fused path on level {lvl}")
    print(f"per-level path (fast_score_map + grid_topk_keypoints) == fused path on frame 1: "
          f"{fast_launches} single-image launches")

    # the CPU path (plain kernels, held to the JAX reference by the tests)
    # on the same state agrees with the card on the first frames
    cpu = torch.device("cpu")
    cpu_dmap = DeviceMap(*[x.to(cpu) for x in dmap])
    cpu_carry = type(carry0)(*[x.to(cpu) for x in carry0])
    for i in range(1, 4):
        cpu_carry, cpu_out = step(cpu_carry, frames[i].to(cpu), cpu_dmap)
        d_t = float((cpu_out.t_cw - outs[i - 1][1].cpu()).abs().max())
        d_r = float((cpu_out.r_cw - outs[i - 1][0].cpu()).abs().max())
        n_cpu, n_gpu = int(cpu_out.n_inliers), int(outs[i - 1][2])
        print(f"frame {i}: card vs CPU path |dt| {d_t:.2e} m |dR| {d_r:.2e} inliers {n_gpu}/{n_cpu}")
        _check(d_t <= 1e-3 and d_r <= 1e-3 and abs(n_cpu - n_gpu) <= 0.05 * n_cpu,
               f"frame {i}: card and CPU path disagree")

    cpu_out = pipeline(frames[1].to(cpu), *[x.to(cpu) for x in predict(carry0)], *cpu_dmap)
    gpu_r, gpu_t, gpu_n = tracked["pipeline core (LM 4x10)"][0][0]
    d_t = float((cpu_out[5] - gpu_t.cpu()).abs().max())
    d_r = float((cpu_out[4] - gpu_r.cpu()).abs().max())
    n_cpu, n_gpu = int(cpu_out[6].sum()), int(gpu_n)
    print(f"pipeline core frame 1: card vs CPU path |dt| {d_t:.2e} m |dR| {d_r:.2e} inliers {n_gpu}/{n_cpu}")
    _check(d_t <= 1e-3 and d_r <= 1e-3 and abs(n_cpu - n_gpu) <= 0.05 * n_cpu,
           "pipeline core frame 1: card and CPU path disagree")

    # ---- 5. the mapping functions, card against the port's CPU path ------
    # two-view initialization on descriptor matches between frames 0 and 8
    feats_a, feats_b = extractor._extract(frames[0]), extractor._extract(frames[INIT_FRAME])
    xy_a, xy_b = undistort_points(cam, feats_a.xy), undistort_points(cam, feats_b.xy)
    res = match_with_mask(
        hamming_matrix(feats_a.descriptors_pm1(), feats_b.descriptors_pm1()),
        valid_gate(feats_a.valid, feats_b.valid), max_dist=50.0, ratio=0.8, mutual=True,
    )
    tv_valid = res.idx >= 0
    tv_x1, tv_x2 = xy_a, xy_b[res.idx.clamp(min=0)]
    r_a, t_a = r_wc[0].T, -r_wc[0].T @ c_w[0]
    r_b, t_b = r_wc[INIT_FRAME].T, -r_wc[INIT_FRAME].T @ c_w[INIT_FRAME]
    r_rel = r_b @ r_a.T
    t_rel = t_b - r_rel @ t_a
    t_rel = t_rel / np.linalg.norm(t_rel)

    def init_errors(result):
        r = result.r_cw2.double().cpu().numpy()
        rot = np.degrees(np.linalg.norm(r @ r_rel.T.astype(np.float64) - np.eye(3)) / np.sqrt(2))
        direction = np.degrees(np.arccos(np.clip(result.t_cw2.double().cpu().numpy() @ t_rel, -1.0, 1.0)))
        return float(rot), float(direction)

    tv_gen = torch.Generator(device=dev).manual_seed(0)
    init = two_view_init(tv_x1, tv_x2, tv_valid, cam, tv_gen)
    rot, direction = init_errors(init)
    print(f"two_view_init, frames 0 and {INIT_FRAME}, {int(tv_valid.sum())} matches, 256 hypotheses: "
          f"success {bool(init.success)}, used_h {bool(init.used_h)}, {int(init.is_inlier.sum())} inliers, "
          f"rotation {rot:.3f} deg and translation direction {direction:.2f} deg off the ground truth")
    _check(init.r_cw2.is_cuda and bool(init.success) and int(init.is_inlier.sum()) > 100 and rot < 1.0
           and direction < 10.0, "two_view_init on the card: wrong outcome")
    # the same minimal sets through the card and the CPU path
    idx_h, idx_f = sample_minimal_sets(tv_valid, 256, torch.Generator(device=dev).manual_seed(1))
    on_card = two_view_from_samples(tv_x1, tv_x2, tv_valid, cam, idx_h, idx_f)
    on_cpu = two_view_from_samples(tv_x1.cpu(), tv_x2.cpu(), tv_valid.cpu(), cam, idx_h.cpu(), idx_f.cpu())
    d_r = float((on_card.r_cw2.cpu() - on_cpu.r_cw2).abs().max())
    d_t = float((on_card.t_cw2.cpu() - on_cpu.t_cw2).abs().max())
    overlap = int((on_card.is_inlier.cpu() & on_cpu.is_inlier).sum()) / max(int(on_cpu.is_inlier.sum()), 1)
    print(f"two_view_from_samples, same 256 + 256 minimal sets: card vs CPU path |dR| {d_r:.2e} |dt| {d_t:.2e}, "
          f"inlier overlap {overlap:.3f}, used_h {bool(on_card.used_h)}/{bool(on_cpu.used_h)}")
    _check(bool(on_card.success) and bool(on_cpu.success) and bool(on_card.used_h) == bool(on_cpu.used_h)
           and d_r <= 5e-3 and d_t <= 5e-2 and overlap >= 0.95, "two_view_from_samples: card and CPU path disagree")

    # triangulation between the two frames at their true poses
    sigma2_levels = torch.from_numpy(extractor.level_sigma2()).to(dev)
    tri_args = (
        torch.from_numpy(r_a).to(dev), torch.from_numpy(t_a).to(dev), xy_a, feats_a.level, feats_a.desc01, feats_a.valid,
        torch.from_numpy(r_b).to(dev), torch.from_numpy(t_b).to(dev), xy_b, feats_b.level, feats_b.desc01, feats_b.valid,
    )
    tri_idx, tri_x, tri_good = triangulate_between(*tri_args, cam, sigma2_levels)
    cpu_idx, cpu_x, cpu_good = triangulate_between(*[a.cpu() for a in tri_args], cam, sigma2_levels.cpu())
    both = tri_good.cpu() & cpu_good
    idx_same = float((tri_idx.cpu() == cpu_idx).float().mean())
    good_same = float((tri_good.cpu() == cpu_good).float().mean())
    d_x = float(((tri_x.cpu() - cpu_x)[both].abs() / cpu_x[both].abs().clamp(min=1.0)).max())
    print(f"triangulate_between, {extractor.capacity} x {extractor.capacity} features: {int((tri_idx >= 0).sum())} "
          f"matches, {int(tri_good.sum())} accepted; card vs CPU path: matches equal on {idx_same:.4f}, "
          f"acceptance on {good_same:.4f}, points within {d_x:.2e} (relative)")
    _check(int(tri_good.sum()) > 100 and idx_same >= 0.995 and good_same >= 0.99 and d_x <= 1e-3,
           "triangulate_between: card and CPU path disagree")

    # local bundle adjustment
    ba_obs_np, ba_state_np = _ba_problem()
    ba_obs, ba_state = ba_observations_from_numpy(**ba_obs_np), vision_ba_state_from_numpy(**ba_state_np)
    ba_fixed = torch.zeros(BA_K, dtype=torch.bool, device=dev)
    ba_fixed[:2] = True  # two fixed keyframes pin the gauge, scale included
    cost_before = float(_vision_cost_and_chi2(ba_state, ba_obs, cam, CHI2_MONO_2DOF)[0])
    ba_syncs = _count_syncs(lambda: vision_ba(ba_state, ba_obs, cam, ba_fixed, iters=BA_ITERS))
    ba_out, _ = vision_ba(ba_state, ba_obs, cam, ba_fixed, iters=BA_ITERS)
    cost_after = float(_vision_cost_and_chi2(ba_out, ba_obs, cam, CHI2_MONO_2DOF)[0])
    cpu_ba_out, _ = vision_ba(
        type(ba_state)(*[x.cpu() for x in ba_state]), type(ba_obs)(*[x.cpu() for x in ba_obs[:4]]), cam,
        ba_fixed.cpu(), iters=BA_ITERS,
    )
    d_r = float((ba_out.r_cw.cpu() - cpu_ba_out.r_cw).abs().max())
    d_t = float((ba_out.t_cw.cpu() - cpu_ba_out.t_cw).abs().max())
    print(f"vision_ba, K={BA_K} M={BA_M} R={BA_R}, {BA_ITERS} iterations: cost {cost_before:.1f} -> {cost_after:.1f}, "
          f"host syncs {len(ba_syncs)}; card vs CPU path |dR| {d_r:.2e} |dt| {d_t:.2e}")
    _check(ba_out.points.is_cuda and cost_after < 0.1 * cost_before, "vision_ba: the cost did not fall")
    _check(not ba_syncs, f"vision_ba must not sync with the host: {sorted(set(ba_syncs))}")
    _check(d_r <= 1e-3 and d_t <= 1e-3, "vision_ba: card and CPU path disagree")

    # the local BA as MonoSlam runs it: a window and its anchors padded to
    # the pose bucket (identity poses, fixed), one CUDA graph a bucket
    graph_ba = _graphed_ba_check(cam, dev, tag)

    # ---- 6. lock-step SLAM: MonoSlam at its defaults ---------------------
    marks.append(("1-5", time.perf_counter()))
    slam_launches = _slam_phase(cam, dev, tag)
    marks.append(("6", time.perf_counter()))

    # ---- 7. async mapping and streaming MonoSlam --------------------------
    threaded_launches, lock_ate = _threaded_slam_phase(cam, dev, tag)
    switch_launches = _dtype_switch_phase(cam, dev, tag, lock_ate)
    threaded_launches.update({f"MonoSlam {m}, dtype switch": n for m, n in switch_launches.items()})
    _async_ate_phase(cam, dev, tag)
    marks.append(("7", time.perf_counter()))

    # ---- 8. lock-step visual-inertial SLAM: MonoViSlam --------------------
    threaded_launches["MonoViSlam"], vi_traj = _vi_phase(cam, dev, tag)
    marks.append(("8 lock-step", time.perf_counter()))
    threaded_launches.update(_async_vi_phase(cam, dev, tag, vi_traj))
    marks.append(("8 async and spin", time.perf_counter()))

    # ---- 9. place recognition and loop closing ---------------------------
    loop_k1, loop_k8, k8 = _loop_phase(cam, dev, tag)
    marks.append(("9", time.perf_counter()))
    threaded_launches.update(loop_k1)

    # ---- 10. stereo and RGB-D ---------------------------------------------
    stereo = _stereo_phase(cam, dev, tag)
    marks.append(("10 stereo and RGB-D", time.perf_counter()))
    threaded_launches.update(stereo["k1"])
    loop_k8["StereoSlam loop"] = stereo["k8"]["StereoSlam loop"]

    # ---- 11. the command line ---------------------------------------------
    cli = _cli_phase(cam, dev, tag)
    marks.append(("11 the command line", time.perf_counter()))
    threaded_launches.update(cli["k1"])
    loop_k8.update(cli["k8"])
    stereo["k9_paths"].update(cli["k9"])
    print(f"K9 launches by path: {json.dumps(stereo['k9_paths'])}")
    print(f"K1 launches by path: {json.dumps({'tracking cores': cell_launches, 'MonoSlam': slam_launches, **threaded_launches})}")
    print(f"K8 launches by path: {json.dumps(loop_k8)}")

    # ---- 12. distributed bundle adjustment -------------------------------
    _distributed_phase(dev, tag)
    marks.append(("12 distributed BA", time.perf_counter()))

    # ---- 13. times -------------------------------------------------------
    pyr = pyramids["rendered"]
    kernel_ms, plain_ms = [], []
    for lvl, img in enumerate(pyr):
        k = _event_ms(lambda: fast_score_map(img), reps=200, device_only=True)
        p = _event_ms(lambda: _fast_score_map_torch(img), reps=20, device_only=True)
        kernel_ms.append(k)
        plain_ms.append(p)
        print(f"{tag} FAST level {lvl} {tuple(img.shape)}: device time kernel {k * 1e3:.2f} us, "
              f"plain {p * 1e3:.2f} us")
    fused_ms = _event_ms(lambda: fast_cells_pyramid(pyr, extractor.cell, EDGE_MARGIN),
                         reps=200, device_only=True)
    fused_plain_ms = _event_ms(lambda: _fast_cells_pyramid_torch(pyr, extractor.cell, EDGE_MARGIN),
                               reps=10, device_only=True)
    empty_launch = load_library(fast_cuda.LIB_NAME).viorb_empty_launch
    empty_launch.argtypes = [ctypes.c_void_p]
    empty_launch.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    _check(empty_launch(stream) == 0, "empty kernel launch failed")
    floor_ms = _event_ms(lambda: empty_launch(stream), reps=1000, device_only=True)
    score_call_us = sum(_host_us(lambda: fast_score_map(img), reps=200) for img in pyr)
    fused_call_us = _host_us(lambda: fast_cells_pyramid(pyr, extractor.cell, EDGE_MARGIN), reps=200)

    # the least the card could take: every input read once and every output
    # written once at the HBM rate, or the scored pixels' operations at the
    # f32 peak, whichever is longer (no step of the kernel depends on the data)
    pixels = sum(img.numel() for img in pyr)
    n_cells = got_offs[-1]
    scored_maps = sum((img.shape[0] - 6) * (img.shape[1] - 6) for img in pyr)
    scored_cells = sum(
        (min(h - EDGE_MARGIN, h // 16 * 16) - EDGE_MARGIN) * (min(w - EDGE_MARGIN, w // 16 * 16) - EDGE_MARGIN)
        for h, w in (img.shape for img in pyr)
    )
    score_bound_ms, score_bound_by = _bound(8 * pixels, FAST_OPS_PER_PIXEL * scored_maps)
    fused_bound_ms, fused_bound_by = _bound(4 * pixels + 12 * n_cells, FAST_OPS_PER_PIXEL * scored_cells)
    print(f"{tag} FAST score maps, 8 single-level launches, device time: kernel {sum(kernel_ms) * 1e3:.2f} us, "
          f"plain {sum(plain_ms) * 1e3:.2f} us, bound {score_bound_ms * 1e3:.2f} us ({score_bound_by}: "
          f"{8 * pixels} B, {FAST_OPS_PER_PIXEL * scored_maps} ops); wrapper calls back to back "
          f"{score_call_us:.1f} us of host time")
    print(f"{tag} FAST + cell argmax, all 8 levels in ONE launch, device time: kernel {fused_ms * 1e3:.2f} us, "
          f"plain {fused_plain_ms * 1e3:.2f} us, bound {fused_bound_ms * 1e3:.2f} us ({fused_bound_by}: "
          f"{4 * pixels + 12 * n_cells} B, {FAST_OPS_PER_PIXEL * scored_cells} ops); wrapper calls back to back "
          f"{fused_call_us:.1f} us of host time")
    print(f"{tag} empty kernel launch, back to back on the device: {floor_ms * 1e3:.2f} us")

    # per-stage inputs, frame by frame, so each stage is timed alone
    sigma2 = torch.from_numpy(extractor.level_sigma2()).to(dev)
    stage_in = []
    c = carry0
    for i in range(1, N_FRAMES):
        r_pred = c.vel_r @ c.r_cw
        t_pred = c.vel_r @ c.t_cw + c.vel_t
        feats = extractor._extract(frames[i])
        xy = undistort_points(cam, feats.xy)
        desc = feats.descriptors_pm1()
        pf, _, _, _ = match_by_projection(
            dmap.xyz, dmap.desc_pm1, dmap.valid, dmap.normal, dmap.dmin, dmap.dmax,
            r_pred, t_pred, xy, desc, feats.valid, cam, 15.0,
        )
        obs = PoseObs(dmap.xyz[pf.clamp(min=0)], xy, 1.0 / sigma2[feats.level], pf >= 0)
        stage_in.append((i, r_pred, t_pred, feats, xy, desc, obs))
        c, _ = step(c, frames[i], dmap)
    torch.cuda.synchronize()

    def extract_all():
        for i, *_ in stage_in:
            extractor._extract(frames[i])

    def match_all():
        for _, r_pred, t_pred, feats, xy, desc, _ in stage_in:
            match_by_projection(
                dmap.xyz, dmap.desc_pm1, dmap.valid, dmap.normal, dmap.dmin, dmap.dmax,
                r_pred, t_pred, xy, desc, feats.valid, cam, 15.0,
            )

    def lm_all():
        for _, r_pred, t_pred, _, _, _, obs in stage_in:
            pose_optimization_tcw(r_pred, t_pred, obs, cam, rounds=2, iters_per_round=4)

    n = len(stage_in)
    stages = {}
    for name, fn in (("extract", extract_all), ("match", match_all), ("pose_lm", lm_all)):
        runs = [_event_ms(fn, reps=1, warmup=1 if not stages else 0) / n for _ in range(3)]
        stages[name] = statistics.median(runs)
        print(f"{tag} {name}, eager: {stages[name]:.3f} ms/frame (median of 3 passes over {n} frames)")

    # Each core over the benchmark's replay: frames 1..15 in order, the
    # carry reset at each cycle, one sync at the end; eager and as a graph.
    order = list(range(1, N_FRAMES))
    frame_ids = [order[j % len(order)] for j in range(REPLAY_FRAMES)]

    def replay(fn, run, ids):
        c, last = carry0, None
        for j, i in enumerate(ids):
            if j % len(order) == 0:
                c = carry0
            c, _, last = run(fn, c, i)
        return last

    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    core_times = {}
    for name, (core, run) in cores.items():
        times = {}
        # eagerly a 4x10 core takes over 100 ms of host time a frame: two
        # cycles of the arc are enough for a time that moves x2 between runs
        for label, fn, ids in (("eager", core.eager, frame_ids[:EAGER_REPLAY_FRAMES]), ("graph", core, frame_ids)):
            replay(fn, run, order)  # warm-up: one cycle
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t_host = time.perf_counter()
            start.record()
            last = replay(fn, run, ids)
            end.record()
            n_last = int(last[2])  # the pull fences the whole chain
            wall_s = time.perf_counter() - t_host
            times[label] = start.elapsed_time(end) / len(ids)
            _check(n_last > MIN_INLIERS, f"{name}, {label}: replay ended with {n_last} inliers")
            print(f"{tag} {name}, {label}: {times[label]:.3f} ms/frame (CUDA events), "
                  f"{len(ids) / wall_s:.1f} fps (host clock, {len(ids)} frames)")
        core_times[name] = times

        # device busy share over one 15-frame cycle of the graphed core, and
        # where the device time goes
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_host = time.perf_counter()
            replay(core, run, order)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t_host) * 1e6
        # kernels only: the operators that launch them carry the same time
        device_ops = [
            e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
        ]
        busy_us = sum(dev_us(e) for e in device_ops)
        if busy_us > 0:
            print(f"{tag} {name}, graph: device busy {busy_us / window_us * 100:.1f} % of a {len(order)}-frame "
                  f"window ({busy_us / len(order) / 1e3:.3f} ms device time/frame, profiler on), "
                  f"{sum(e.count for e in device_ops) / len(order):.0f} kernels and copies a frame")
            for e in sorted(device_ops, key=dev_us, reverse=True)[:6]:
                print(f"  {dev_us(e) / len(order):9.1f} us/frame  x{e.count / len(order):6.1f}  {e.key[:100]}")
        else:
            print(f"{tag} {name}, graph: device busy share and kernels a frame: not measured "
                  f"(the profiler recorded no device time)")

    # the mapping functions, eagerly, as local mapping calls them
    ba_ms = _event_ms(lambda: vision_ba(ba_state, ba_obs, cam, ba_fixed, iters=BA_ITERS), reps=5, warmup=1) / BA_ITERS
    tri_ms = _event_ms(lambda: triangulate_between(*tri_args, cam, sigma2_levels), reps=20)
    init_ms = _event_ms(lambda: two_view_init(tv_x1, tv_x2, tv_valid, cam, tv_gen), reps=10)
    print(f"{tag} vision_ba K={BA_K} M={BA_M} R={BA_R}: {ba_ms:.3f} ms per LM iteration "
          f"({1e3 / ba_ms:.0f} iterations/s; 5 solves of {BA_ITERS} iterations)")
    print(f"{tag} triangulate_between, {extractor.capacity} x {extractor.capacity} features: {tri_ms:.3f} ms a call")
    print(f"{tag} two_view_init, {tv_x1.shape[0]} match slots, 256 hypotheses: {init_ms:.3f} ms a call")

    _check_main_thread_only("the whole run")
    marks.append(("13 times", time.perf_counter()))
    print(f"{tag} chip_smoke.py's host seconds by phase: " + ", ".join(
        f"{name} {t - t_prev:.1f}" for (_, t_prev), (name, t) in zip(marks, marks[1:]))
        + f"; {marks[-1][1] - marks[0][1]:.1f} s in all")
    print(json.dumps({"kernels": [
        {
            "name": "fast_score_map (K1, FAST-9 arc strength, one image a launch)",
            "route": "cuda",
            "source": "viorb_tpu_torch/csrc/fast_score.cu",
            "replaces": "viorb_tpu/features/fast_pallas.py:30",
            "path": "fast_score_map + grid_topk_keypoints over the 8 levels of frame 1",
            "launches": fast_launches,
            "max_abs_err": fast_err,
            "ms": sum(kernel_ms),
            "plain_ms": sum(plain_ms),
            "bound_ms": score_bound_ms,
            "bound_by": score_bound_by,
            "library_ms": None,
        },
        {
            "name": "fast_cells_pyramid (K1+K3 fused: FAST, border mask, per-cell max/argmax, 8 levels a launch)",
            "route": "cuda",
            "source": "viorb_tpu_torch/csrc/fast_score.cu",
            "replaces": "viorb_tpu/features/fast_pallas.py:30, viorb_tpu/features/fast.py:79",
            "path": f"make_tracking_step, make_pipeline_track_core and make_streaming_track_core, each one "
                    f"CUDA graph a frame, over {N_FRAMES - 1} frames each (launches in the capture x replays); "
                    f"MonoSlam lock-step, async and streaming over {SLAM_FRAMES} frames each, async and "
                    f"streaming with a float32 -> uint8 switch, MonoViSlam over {VI_FRAMES} frames, the loop "
                    f"phase's MonoSlam and MonoViSlam runs, StereoSlam (with the right images' extractions) and "
                    f"RgbdSlam over {STEREO_FRAMES} frames, lock-step and threaded, StereoSlam with loop closing over {LOOP_FRAMES}, "
                    f"and the command line's runs (phase 11) (graph replays + eager extractions)",
            "launches": cell_launches + slam_launches + sum(threaded_launches.values()),
            "launches_by_path": {"tracking cores": cell_launches, "MonoSlam": slam_launches, **threaded_launches},
            "max_abs_err": cells_err,
            "ms": fused_ms,
            "plain_ms": fused_plain_ms,
            "bound_ms": fused_bound_ms,
            "bound_by": fused_bound_by,
            "library_ms": None,
            "empty_launch_ms": floor_ms,
        },
        {
            "name": "bow_descend (K8, BoW vocabulary-tree descent by popcount + tf-idf histogram)",
            "route": "cuda",
            "source": "viorb_tpu_torch/csrc/bow_descend.cu",
            "replaces": "viorb_tpu/bow/vocabulary.py:148",
            "path": f"LoopCloser.add_keyframe in every mapping job of lock-step MonoSlam with loop closing over "
                    f"the {LOOP_FRAMES}-frame circuit (launches_by_path: every run of the loop phase and of the "
                    f"command line's)",
            "launches": loop_k8[k8["main_path"]],
            "launches_by_path": loop_k8,
            "max_abs_err": k8["max_abs_err"],
            "max_rel_err": k8["max_rel_err"],
            "ms": k8["ms"],
            "plain_ms": k8["plain_ms"],
            "bound_ms": k8["bound_ms"],
            "bound_by": k8["bound_by"],
            "library_ms": None,
            "device_ops_per_call": k8["device_ops"],
            "global_path_ms": k8["global_ms"],
            "empty_launch_ms": floor_ms,
        },
        {
            "name": "stereo_sad (K9, stereo sub-pixel refinement: 11x11 SAD over +-3 px, parabola)",
            "route": "cuda",
            "source": "viorb_tpu_torch/csrc/stereo_sad.cu",
            "replaces": "viorb_tpu/slam/kernels.py:324",
            "path": f"StereoSlam._attach_stereo at the initialization and each keyframe of lock-step StereoSlam "
                    f"over the {STEREO_FRAMES}-frame stereo arc (launches_by_path: the stereo phase's runs, the "
                    f"threaded ones too, and the command line's)",
            "launches": stereo["k9_paths"]["StereoSlam"],
            "launches_by_path": stereo["k9_paths"],
            "max_abs_err": 0.0,
            "ms": stereo["k9"]["ms"],
            "plain_ms": stereo["k9"]["plain_ms"],
            "bound_ms": stereo["k9"]["bound_ms"],
            "bound_by": stereo["k9"]["bound_by"],
            "library_ms": None,
            "rows": stereo["k9"]["rows"],
            "empty_launch_ms": stereo["k9"]["empty_ms"],
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-child"]:
        sys.exit(_distributed_child(sys.argv[2:]))
    sys.exit(main())
