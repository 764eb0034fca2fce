"""The port's pipeline and streaming tracking cores against the JAX
reference's, frame by frame from the same state: the half-size rendered arc
(240x376), 300 features, a 1024-slot map, pose LM 4 x 10, 5 tracked frames,
a pyramid of 4 levels (tests/test_torch_tracking.py holds the 8-level
front end inside a core to the reference). The reference's core outputs on
these frames come from tests/torch_front_golden.npz
(tests/make_torch_goldens.py, set `front`): their live compiles took ~18 s
of this test's ~21 s on a CPU.
Also the 15 px -> 30 px retry (one frame whose prediction is displaced so
that both packages take the 30 px branch), the carry frozen on a blank
frame, the process-wide core cache, the launch counters' arithmetic through
a graph, and the LM's 6x6 solve against `torch.linalg.solve`.

Tolerances: per-frame pose within 2e-3 rad and 5e-3 m, inlier count within
5 % (the LM sums in another order; a pair near the window edge or a chi2
gate can flip). `pf` must agree on >= 99 % of the features whose
descriptors and positions are equal in both packages (at this size the
upper pyramid levels, which differ by matmul summation order, flip a few
descriptor bits): match decisions on equal descriptors are exact, but a
projection that differs in its last bit can move a pair across the window
edge.

One test per file: see tests/test_torch_fast.py."""

import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import torch

from make_torch_goldens import _CORE_FIELDS, _FEAT_FIELDS, CORE_LEVELS, FRONT_GOLDEN, TRACK_FRAMES, _yaw, load
from torch_port_scene import N_FEATURES, reference_map, render_scene
from viorb_tpu.features.extractor import FrameFeatures as RefFeatures
from viorb_tpu.features.extractor import OrbExtractor as RefExtractor
from viorb_tpu_torch import launch_counts
from viorb_tpu_torch.cuda_graph import GraphedFunction, _flatten, _unflatten
from viorb_tpu_torch.features import fast_cuda
from viorb_tpu_torch.features.extractor import OrbExtractor
from viorb_tpu_torch.interop import carry_from_numpy, device_map_from_numpy
from viorb_tpu_torch.optim.pose_only import _damped_step
from viorb_tpu_torch.slam.kernels import match_by_projection
from viorb_tpu_torch.slam.tracking_loop import (
    TrackCarry,
    make_pipeline_track_core,
    make_streaming_track_core,
    make_tracking_step,
)

torch.set_num_threads(1)

N_TRACKED = TRACK_FRAMES
N_LEVELS = CORE_LEVELS
CARRY_FIELDS = ("r_cw", "t_cw", "vel_r", "vel_t")


def _ref_out(gold, prefix, i=None):
    """A reference core output from the golden, laid out as the core's tuple
    (feats, xy, fdesc, pf, r_new, t_new, inlier, visible, nmatch / ok); the
    features are not kept."""
    take = (lambda k: gold[prefix + k]) if i is None else (lambda k: gold[prefix + k][i])
    last = "nmatch" if prefix + "nmatch" in gold else "ok"
    return (None, *[take(k) for k in _CORE_FIELDS], take(last))


def _rot_diff(r, r_ref):
    r_ref = np.asarray(r_ref, np.float64)
    return np.linalg.norm(np.asarray(r, np.float64) @ r_ref.T - np.eye(3)) / np.sqrt(2)


def _assert_frame_agrees(tag, out, ref):
    """out / ref: (feats, xy, fdesc, pf, r_new, t_new, inlier, visible, x)."""
    d_rot = _rot_diff(out[4].numpy(), ref[4])
    d_t = np.abs(out[5].numpy() - np.asarray(ref[5])).max()
    n_ref, n_out = int(np.asarray(ref[6]).sum()), int(out[6].sum())
    assert d_rot <= 2e-3 and d_t <= 5e-3, (tag, d_rot, d_t)
    assert n_ref > 30 and abs(n_out - n_ref) <= 0.05 * n_ref, (tag, n_out, n_ref)
    same = (out[2].numpy() == np.asarray(ref[2], np.float32)).all(1) & (
        out[1].numpy() == np.asarray(ref[1])
    ).all(1)
    assert same.mean() >= 0.5, (tag, same.mean())
    pf_ref = np.asarray(ref[3])
    assert (out[3].numpy()[same] == pf_ref[same]).mean() >= 0.99, tag
    assert (out[7].numpy() == np.asarray(ref[7])).mean() >= 0.995, tag


def _pipeline_core_matches_reference(scene, gold, dmap, core):
    _, r_wc, c_w, _, _, frames = scene
    r_pred, t_pred = r_wc[0].T, -r_wc[0].T @ c_w[0]
    for i in range(1, N_TRACKED + 1):
        ref = _ref_out(gold, "cores_pipe_", i - 1)
        out = core(frames[i], torch.from_numpy(r_pred), torch.from_numpy(t_pred), *dmap)
        _assert_frame_agrees(("pipeline", i), out, ref)
        assert int(out[8]) >= 20 and abs(int(out[8]) - int(ref[8])) <= 1
        # both packages go on from the reference's estimate
        r_pred, t_pred = np.array(ref[4]), np.array(ref[5])

    # the retry: a prediction yawed by 0.1 rad moves every projection ~22 px,
    # so 15 px finds fewer than 20 matches and 30 px rescues the frame
    r_off = _yaw(0.1) @ r_wc[1].T
    t_off = _yaw(0.1) @ (-r_wc[1].T @ c_w[1])
    ref = _ref_out(gold, "cores_retry_")
    out = core(frames[1], torch.from_numpy(r_off), torch.from_numpy(t_off), *dmap)
    feats, xy, fdesc = out[0], out[1], out[2]
    narrow = match_by_projection(*dmap, torch.from_numpy(r_off), torch.from_numpy(t_off),
                                 xy, fdesc, feats.valid, scene[0], 15.0)
    wide = match_by_projection(*dmap, torch.from_numpy(r_off), torch.from_numpy(t_off),
                               xy, fdesc, feats.valid, scene[0], 30.0)
    ref_narrow = int(gold["cores_retry_narrow_nmatch"])
    assert int(narrow[2]) < 20 and ref_narrow < 20, (int(narrow[2]), ref_narrow)
    assert int(wide[2]) > 50 and int(out[8]) == int(wide[2]) and torch.equal(out[3], wide[0])
    _assert_frame_agrees(("pipeline", "retry"), out, ref)
    assert abs(int(out[8]) - int(ref[8])) <= 1
    # ... and a frame that 15 px serves keeps the 15 px result
    r_ok, t_ok = torch.from_numpy(r_wc[1].T), torch.from_numpy(-r_wc[1].T @ c_w[1])
    out = core(frames[1], r_ok, t_ok, *dmap)
    narrow = match_by_projection(*dmap, r_ok, t_ok, out[1], out[2], out[0].valid, scene[0], 15.0)
    assert int(narrow[2]) >= 20 and torch.equal(out[3], narrow[0]) and int(out[8]) == int(narrow[2])


def _streaming_core_matches_reference(scene, gold, dmap, core):
    _, r_wc, c_w, _, _, frames = scene
    start = dict(
        r_cw=r_wc[0].T, t_cw=-r_wc[0].T @ c_w[0],
        vel_r=np.eye(3, dtype=np.float32), vel_t=np.zeros(3, np.float32),
    )
    carry = carry_from_numpy(**start, device="cpu")
    for i in range(1, N_TRACKED + 1):
        ref = _ref_out(gold, "cores_stream_", i - 1)
        ref_carry = [gold["cores_stream_carry_" + k][i - 1] for k in CARRY_FIELDS]
        carry, out = core(carry, frames[i], *dmap)
        _assert_frame_agrees(("streaming", i), out, ref)
        assert bool(out[8]) and bool(ref[8])
        for got, want in zip(carry, ref_carry):
            assert np.abs(got.numpy() - np.asarray(want)).max() <= 5e-3, ("carry", i)
        # the carried rotation is re-orthonormalized every frame
        assert np.abs(carry.r_cw.numpy() @ carry.r_cw.numpy().T - np.eye(3)).max() < 1e-5

    # a blank frame has no features: the core reports failure and the
    # carry stays exactly as it was, in both packages
    blank = np.full(frames[0].shape, 128, np.uint8)
    ref_frozen = [gold["cores_blank_carry_" + k] for k in CARRY_FIELDS]
    frozen, out = core(carry, torch.from_numpy(blank), *dmap)
    assert not bool(out[8]) and not bool(gold["cores_blank_ok"]) and int(out[6].sum()) == 0
    for got, was, ref_got, ref_was in zip(frozen, carry, ref_frozen, ref_carry):
        assert torch.equal(got, was)
        np.testing.assert_array_equal(np.asarray(ref_got), np.asarray(ref_was))


def _lm_solve_matches_linalg_solve():
    """The LM's damped 6x6 solve (`solve_ex`, which a CUDA graph can
    capture) against `torch.linalg.solve` of the same system in float64:
    1e-4 relative, f32 on a system whose rows differ by fx^2."""
    rng = np.random.default_rng(3)
    for lam in (1e-4, 1.0):
        J = rng.normal(size=(200, 2, 6)) * np.array([200.0, 200.0, 200.0, 900.0, 900.0, 900.0])
        H = np.einsum("nci,ncj->ij", J, J)
        g = H @ rng.normal(size=6)
        dx = _damped_step(
            torch.from_numpy(H.astype(np.float32)), torch.from_numpy(g.astype(np.float32)), torch.tensor(lam)
        )
        H64 = H.astype(np.float32).astype(np.float64)
        H64 = H64 + lam * np.diag(np.maximum(np.diag(H64), 1e-6)) + 1e-8 * np.eye(6)
        want = torch.linalg.solve(torch.from_numpy(H64), torch.from_numpy(g.astype(np.float32).astype(np.float64)))
        assert dx.dtype == torch.float32
        assert np.abs(dx.numpy() - want.numpy()).max() <= 1e-4 * np.abs(want.numpy()).max(), lam


def _graph_launch_counts_add_up():
    """Launches through graphs = launches in each capture x its replays; a
    launch the capturing thread records is not added to the wrappers'
    counters, one that another thread makes meanwhile is."""
    before = fast_cuda.CELL_LAUNCHES, fast_cuda.LAUNCHES
    other_thread = threading.Thread(target=lambda: [launch_counts.count("CELL_LAUNCHES") for _ in range(3)])
    with launch_counts.recording() as held:
        launch_counts.count("CELL_LAUNCHES")
        other_thread.start()
        other_thread.join()
        assert fast_cuda.CELL_LAUNCHES == before[0] + 3
        launch_counts.count("CELL_LAUNCHES")
    assert held == {"LAUNCHES": 0, "CELL_LAUNCHES": 2}
    launch_counts.count("LAUNCHES")  # outside a recording: straight into the counter
    assert (fast_cuda.CELL_LAUNCHES, fast_cuda.LAUNCHES) == (before[0] + 3, before[1] + 1)
    fast_cuda.CELL_LAUNCHES, fast_cuda.LAUNCHES = before

    g = GraphedFunction(lambda x: x)
    g._captures["a"] = SimpleNamespace(captured={"LAUNCHES": 0, "CELL_LAUNCHES": 1}, replays=15)
    g._captures["b"] = SimpleNamespace(captured={"LAUNCHES": 8, "CELL_LAUNCHES": 0}, replays=2)
    assert g.replays == 17 and g.launches() == {"LAUNCHES": 16, "CELL_LAUNCHES": 15}
    assert g.captured() == [{"LAUNCHES": 0, "CELL_LAUNCHES": 1}, {"LAUNCHES": 8, "CELL_LAUNCHES": 0}]
    g.reset_counts()
    assert g.replays == 0 and g.launches() == {"LAUNCHES": 0, "CELL_LAUNCHES": 0}


def _cores_are_cached_and_eager_on_cpu(cam):
    """One core per (kind, camera, extractor configuration) in the process;
    on CPU tensors the wrapper is the eager function."""
    a = make_pipeline_track_core(cam, OrbExtractor(n_features=N_FEATURES))
    b = make_pipeline_track_core(cam, OrbExtractor(n_features=N_FEATURES))
    assert a is b and isinstance(a, GraphedFunction) and callable(a.eager)
    assert make_pipeline_track_core(cam, OrbExtractor(n_features=N_FEATURES + 1)) is not a
    assert make_streaming_track_core(cam, OrbExtractor(n_features=N_FEATURES)) is not a
    assert make_tracking_step(cam, OrbExtractor(n_features=N_FEATURES)) is not a
    assert OrbExtractor(n_features=N_FEATURES).config_key() == RefExtractor(n_features=N_FEATURES).config_key()
    assert a.replays == 0 and a.launches() == {"LAUNCHES": 0, "CELL_LAUNCHES": 0} and a.captured() == []
    # the nest of (named) tuples a graph's static tensors are rebuilt into
    carry = TrackCarry(*[torch.full((2,), float(i)) for i in range(4)])
    leaves = []
    spec = _flatten((carry, (torch.zeros(1), carry.r_cw)), leaves)
    back = _unflatten(spec, iter(leaves))
    assert len(leaves) == 6 and isinstance(back[0], TrackCarry) and back[1][1] is carry.r_cw
    g = GraphedFunction(lambda c, x: (c._replace(t_cw=c.t_cw + x), x * 2))
    out = g(carry, torch.ones(2))
    assert torch.equal(out[0].t_cw, carry.t_cw + 1) and torch.equal(out[1], torch.full((2,), 2.0))


def test_tracking_cores_match_reference():
    scene = render_scene(N_TRACKED + 1)
    cam, r_wc, c_w, *_, frames = scene
    _cores_are_cached_and_eager_on_cpu(cam)
    _graph_launch_counts_add_up()
    extractor = OrbExtractor(n_features=N_FEATURES, n_levels=N_LEVELS)
    gold = load(FRONT_GOLDEN)
    # frame 0's features came out of the reference's pipeline core, run on an
    # empty map (tests/make_torch_goldens.py)
    feats0 = RefFeatures(*[jnp.asarray(gold["cores_feats0_" + k]) for k in _FEAT_FIELDS])
    dmap = device_map_from_numpy(**reference_map(r_wc[0], c_w[0], frames[0], feats=feats0), device="cpu")
    _pipeline_core_matches_reference(scene, gold, dmap, make_pipeline_track_core(cam, extractor))
    _streaming_core_matches_reference(scene, gold, dmap, make_streaming_track_core(cam, extractor))
