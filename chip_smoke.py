#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's monocular tracking step on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. report the card (name, power limit), CUDA and nvcc versions;
  2. build the hand-written kernels from viorb_tpu_torch/csrc/ with nvcc
     (one library, two kernel entries);
  3. hold each kernel entry to its plain PyTorch version on the card, at
     the shapes the tracking step gives it, with torch.equal: the
     single-image FAST score map on 24 level images, and the fused
     pyramid-wide FAST + per-cell maximum/argmax on the pyramids of a
     random, a rendered and a constant frame;
  4. render a 16-frame 752x480 arc, build a 4096-slot map from frame 0 and
     track frames 1-15 with OrbExtractor(n_features=1000): every frame
     must have > 30 inliers and a pose within 3 cm / 0.5 deg of the
     renderer's ground truth, FAST + cell argmax must have been exactly
     one fused launch a frame and no single-image launch, frame 1's
     features must equal, field by field, those computed on the card
     through the plain halves, and the first frames must agree with the
     port's CPU path (which tests/test_torch_*.py hold to the JAX
     reference). Then the per-level entry points (fast_score_map +
     grid_topk_keypoints) are driven over frame 1's pyramid and held to
     the fused path;
  5. time the fused launch, the 8 single-level launches, their plain
     versions and an empty kernel launch (device time, host run ahead),
     the wrappers back to back on the host clock, the extract / match /
     pose-LM stages per frame, and the whole step over a 200-frame replay,
     with CUDA events after warm-up.

Prints one JSON line of kernels before the last line, and as the last line
{"ok": true, "device": {...}}. It needs the repository around it: run from
anywhere else, the package import fails.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
import warnings

N_FRAMES = 16  # frame 0 builds the map, frames 1-15 are tracked
MAP_SLOTS = 4096
REPLAY_FRAMES = 200
MAX_POS_ERR_M = 0.03
MAX_ROT_ERR_DEG = 0.5
MIN_INLIERS = 30

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")

    import numpy as np

    from unittest import mock

    from viorb_tpu_torch import default_device
    from viorb_tpu_torch.cuda_build import build_info, find_nvcc, load_library
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
    from viorb_tpu_torch.geometry.camera import PinholeCamera, undistort_points
    from viorb_tpu_torch.interop import carry_from_numpy
    from viorb_tpu_torch.io import synthetic
    from viorb_tpu_torch.optim.pose_only import PoseObs, pose_optimization_tcw
    from viorb_tpu_torch.slam.kernels import match_by_projection
    from viorb_tpu_torch.slam.tracking_loop import DeviceMap, make_tracking_step

    # ---- 1. report -------------------------------------------------------
    card = _card()
    tag = f"[{card}]"
    dev = default_device()
    nvcc = find_nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    print(card)  # as nvidia-smi gives it: name, power limit
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, nvcc {nvcc_version}")

    # ---- 2. build --------------------------------------------------------
    load_library(fast_cuda.LIB_NAME)
    build_s, build_log = build_info(fast_cuda.LIB_NAME)
    print(f"build {fast_cuda.LIB_NAME}: {build_s:.2f} s")
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

    fast_cuda.LAUNCHES = fast_cuda.CELL_LAUNCHES = 0
    carry, outs = carry0, []
    for i in range(1, N_FRAMES):
        carry, out = step(carry, frames[i], dmap)
        outs.append(out)
    torch.cuda.synchronize()
    cell_launches = fast_cuda.CELL_LAUNCHES
    _check(
        cell_launches == N_FRAMES - 1 and fast_cuda.LAUNCHES == 0,
        f"{N_FRAMES - 1} frames made {cell_launches} fused launches and "
        f"{fast_cuda.LAUNCHES} single-image launches; expected one fused launch a frame",
    )
    for i, out in enumerate(outs, start=1):
        _check(out.r_cw.shape == (3, 3) and out.t_cw.shape == (3,), f"frame {i}: pose shapes")
        _check(bool(torch.isfinite(out.r_cw).all() and torch.isfinite(out.t_cw).all()),
               f"frame {i}: pose not finite")
        n_inl = int(out.n_inliers)
        pos, rot = _pose_errors(out.r_cw, out.t_cw, r_wc[i], c_w[i])
        print(f"frame {i:2d}: inliers {n_inl:3d}  pose error {pos * 100:.2f} cm {rot:.3f} deg")
        _check(
            n_inl > MIN_INLIERS and pos < MAX_POS_ERR_M and rot < MAX_ROT_ERR_DEG,
            f"frame {i}: {n_inl} inliers, {pos:.4f} m, {rot:.3f} deg",
        )
    print(f"tracked {N_FRAMES - 1} frames: fused FAST + cell-argmax launches {cell_launches} "
          f"(1 per frame), single-image FAST launches 0")

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
        d_t = float((cpu_out.t_cw - outs[i - 1].t_cw.cpu()).abs().max())
        d_r = float((cpu_out.r_cw - outs[i - 1].r_cw.cpu()).abs().max())
        n_cpu, n_gpu = int(cpu_out.n_inliers), int(outs[i - 1].n_inliers)
        print(f"frame {i}: card vs CPU path |dt| {d_t:.2e} m |dR| {d_r:.2e} inliers {n_gpu}/{n_cpu}")
        _check(d_t <= 1e-3 and d_r <= 1e-3 and abs(n_cpu - n_gpu) <= 0.05 * n_cpu,
               f"frame {i}: card and CPU path disagree")

    # host syncs inside one step (0 means the step can be queued frame
    # after frame)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step(carry0, frames[1], dmap)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
    print(f"host syncs inside one step: {len(syncs)}")
    for s in sorted(set(syncs)):
        print(f"  sync: {s}")

    # ---- 5. times --------------------------------------------------------
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
        runs = [_event_ms(fn, reps=1, warmup=1 if not stages else 0) / n for _ in range(5)]
        stages[name] = statistics.median(runs)
        print(f"{tag} {name}: {stages[name]:.3f} ms/frame (median of 5 passes over {n} frames)")

    # the whole step, replayed as bench.py replays it: frames 1..15 in
    # order, the carry reset at each cycle, one sync at the end
    order = list(range(1, N_FRAMES))
    frame_ids = [order[j % len(order)] for j in range(REPLAY_FRAMES)]

    def replay():
        c, last = carry0, None
        for j, i in enumerate(frame_ids):
            if j % len(order) == 0:
                c = carry0
            c, last = step(c, frames[i], dmap)
        return last

    replay()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t_host = time.perf_counter()
    start.record()
    last = replay()
    end.record()
    n_last = int(last.n_inliers)  # the pull fences the whole chain
    wall_s = time.perf_counter() - t_host
    step_ms = start.elapsed_time(end) / REPLAY_FRAMES
    _check(n_last > MIN_INLIERS, f"replay ended with {n_last} inliers")
    print(f"{tag} tracking step: {step_ms:.3f} ms/frame (CUDA events), "
          f"{REPLAY_FRAMES / wall_s:.1f} fps (host clock, {REPLAY_FRAMES} frames)")

    # device busy share over one 15-frame cycle, and where the device time goes
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_host = time.perf_counter()
        c = carry0
        for i in order:
            c, _ = step(c, frames[i], dmap)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t_host) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    # kernels only: the operators that launch them carry the same time
    device_ops = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
    ]

    busy_us = sum(dev_us(e) for e in device_ops)
    if busy_us > 0:
        print(f"{tag} device busy {busy_us / window_us * 100:.1f} % of a {len(order)}-frame window "
              f"({busy_us / len(order) / 1e3:.3f} ms device time/frame, profiler on)")
        for e in sorted(device_ops, key=dev_us, reverse=True)[:10]:
            print(f"  {dev_us(e) / len(order):9.1f} us/frame  x{e.count / len(order):6.1f}  {e.key[:100]}")
        n_kernels = sum(e.count for e in device_ops) / len(order)
        print(f"{tag} kernels launched per frame: {n_kernels:.0f}")
    else:
        print(f"{tag} device busy share: not measured (profiler recorded no device time)")

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
            "path": f"make_tracking_step over {N_FRAMES - 1} frames",
            "launches": cell_launches,
            "max_abs_err": cells_err,
            "ms": fused_ms,
            "plain_ms": fused_plain_ms,
            "bound_ms": fused_bound_ms,
            "bound_by": fused_bound_by,
            "library_ms": None,
            "empty_launch_ms": floor_ms,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
