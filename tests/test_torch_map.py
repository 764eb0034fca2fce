"""The port's map store, its native helpers and its checkpoints against the
JAX package's (numpy on both sides; nothing is compiled by JAX).

One seeded operation log drives a MapStore of each package: keyframes,
single and batched points (past the initial capacity, so the SoA arrays
grow), observations, point merges, removals, the statistics refresh, the
covisibility weights, the local map and the BA problem. Every array and
every answer must be equal. The port's native `update_point_stats` is held
to the numpy loop that specifies it, and a map saved by either package
loads in the other, field for field.

One test per file: see tests/test_torch_fast.py."""

import numpy as np
import pytest

from viorb_tpu.mapping import map as ref_map
from viorb_tpu.mapping import serialize as ref_serialize
from viorb_tpu_torch import interop
from viorb_tpu_torch.mapping import map as port_map
from viorb_tpu_torch.mapping import serialize as port_serialize

N_KF = 20  # > MAX_OBS_PER_POINT (16): one point row overflows
N_FEAT = 120
INITIAL_POINTS = 64  # the log adds more: the point arrays must grow
# the native kernel works in f32, the numpy loop in f64 (as in test_native.py)
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6


def _rotation(rng):
    w = rng.normal(0, 0.2, 3)
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return (np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * (k @ k)).astype(np.float32)


def _keyframe_arrays(rng, i):
    return dict(
        timestamp=0.1 * i,
        r_cw=_rotation(rng),
        t_cw=rng.normal(0, 0.3, 3).astype(np.float32),
        xy=rng.uniform(0, 700, (N_FEAT, 2)).astype(np.float32),
        level=rng.integers(0, 8, N_FEAT).astype(np.int32),
        angle=rng.uniform(0, 6.28, N_FEAT).astype(np.float32),
        desc01=rng.integers(0, 2, (N_FEAT, 256)).astype(np.uint8),
        valid=rng.random(N_FEAT) > 0.1,
    )


def _run_log(mod, kf_arrays, seed=0):
    """Apply the operation log to a fresh MapStore of module `mod`; returns
    (store, the answers of its queries)."""
    rng = np.random.default_rng(seed)
    m = mod.MapStore(max_points=INITIAL_POINTS)
    answers = []
    for i, a in enumerate(kf_arrays):
        kf = mod.KeyFrameData(
            kf_id=-1, point_idx=np.full(N_FEAT, -1, np.int32),
            **{k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in a.items()},
        )
        kid = m.add_keyframe(kf)
        if i:
            kf.parent_kf = kid - 1
        # single points, observed by this keyframe and the previous ones
        for f in rng.choice(N_FEAT, 15, replace=False):
            if kf.point_idx[f] >= 0:
                continue
            xyz = rng.normal(0, 1, 3).astype(np.float32) + np.array([0, 0, 5], np.float32)
            p = m.add_point(xyz, kf.desc01[f], kid, int(f))
            for other in range(max(0, kid - 3), kid):
                g = int(rng.integers(0, N_FEAT))
                if m.keyframes[other].point_idx[g] < 0:
                    answers.append(m.add_observation(p, other, g))
        # a triangulated batch with the previous keyframe
        if i:
            nb = m.keyframes[kid - 1]
            f1 = np.nonzero(kf.point_idx < 0)[0][:20]
            f2 = np.nonzero(nb.point_idx < 0)[0][:20]
            n = min(len(f1), len(f2))
            xyz = (rng.normal(0, 1, (n, 3)) + [0, 0, 5]).astype(np.float32)
            answers.append(m.add_points_batch(xyz, kf.desc01[f1[:n]], kid, f1[:n].astype(np.int32),
                                              kid - 1, f2[:n].astype(np.int32)))
        active = m.active_point_ids()
        # merges, removals and orphaning
        for _ in range(3):
            a_, b_ = rng.choice(active, 2, replace=False)
            m.replace_point(int(a_), int(b_))
        active = m.active_point_ids()
        m.remove_point(int(rng.choice(active)))
        p = int(rng.choice(m.active_point_ids()))
        k = int(m.obs_kf[p][m.obs_kf[p] >= 0][0])
        m.remove_observation(p, k)
        answers.append(m.n_obs(p))
        m.update_point_stats(m.active_point_ids())
        answers.append(m.covisibility_weights(kid))
        answers.append(m.local_map_points([kid, max(0, kid - 1)]))
    # one point observed in every keyframe: its row overflows its slots
    p = int(m.active_point_ids()[0])
    for k in m.keyframes:
        answers.append(m.add_observation(p, k, int(np.nonzero(m.keyframes[k].point_idx < 0)[0][0])))
    answers.append(m.obs_overflow)
    window = sorted(m.keyframes)[-4:]
    answers.append(m.build_ba_problem(window, [0, 1], 256))
    # a smaller landmark cap than the window holds: priority by observations
    answers.append(m.build_ba_problem(window, [0], 16))
    return m, answers


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert a == b, where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype or a.dtype.kind == np.asarray(b).dtype.kind, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _assert_stores_equal(a, b, where):
    for f in port_serialize._PT_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{where}: {f}")
    assert (a._next_pt, a._free_pts, a._next_kf, a.max_points) == (
        b._next_pt, b._free_pts, b._next_kf, b.max_points), where
    assert sorted(a.keyframes) == sorted(b.keyframes), where
    for k, kf in a.keyframes.items():
        kf2 = b.keyframes[k]
        for f in ("r_cw", "t_cw", "xy", "level", "angle", "desc01", "valid", "point_idx"):
            np.testing.assert_array_equal(getattr(kf, f), getattr(kf2, f), err_msg=f"{where}: kf{k}.{f}")
        assert (kf.timestamp, kf.parent_kf, kf.prev_kf, kf.next_kf, kf.active) == (
            kf2.timestamp, kf2.parent_kf, kf2.prev_kf, kf2.next_kf, kf2.active), where


def _operation_log_matches_reference():
    rng = np.random.default_rng(7)
    kf_arrays = [_keyframe_arrays(rng, i) for i in range(N_KF)]
    ref, ref_answers = _run_log(ref_map, kf_arrays)
    port, port_answers = _run_log(port_map, kf_arrays)
    assert port.max_points > INITIAL_POINTS and port.obs_overflow > 0
    _assert_same(port_answers, ref_answers, "answers")
    _assert_stores_equal(port, ref, "after the log")
    return port, ref


def _native_stats_match_numpy(port):
    oracle = interop.map_store_from_arrays(port_serialize.map_arrays(port))
    pts = port.active_point_ids()
    for arr in (port.pt_desc01, port.pt_normal, port.pt_min_dist, port.pt_max_dist):
        arr[pts] = 0
    port.update_point_stats(pts)
    port_map.update_point_stats_numpy(oracle, pts)
    np.testing.assert_array_equal(port.pt_desc01[pts], oracle.pt_desc01[pts])
    for f in ("pt_normal", "pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(getattr(port, f)[pts], getattr(oracle, f)[pts],
                                   rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=f)


def _checkpoints_cross_load(port, ref, tmp_path):
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    extra = {"gravity": np.array([0.0, 9.81, 0.0]), "scale": np.float64(1.5)}
    ref_serialize.save_map(ref, ref_path, extra=extra)
    port_serialize.save_map(port, port_path, extra=extra)
    with np.load(ref_path) as z_ref, np.load(port_path) as z_port:
        assert sorted(z_ref.files) == sorted(z_port.files)
        for k in z_ref.files:
            np.testing.assert_array_equal(z_port[k], z_ref[k], err_msg=k)
            assert z_port[k].dtype == z_ref[k].dtype, k
    _assert_stores_equal(port_serialize.load_map(ref_path), ref, "reference checkpoint in the port")
    _assert_stores_equal(ref_serialize.load_map(port_path), port, "port checkpoint in the reference")
    for got, want in ((port_serialize.load_map_extra(ref_path), extra),
                      (ref_serialize.load_map_extra(port_path), extra)):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def _native_build_failure_raises(tmp_path):
    from viorb_tpu_torch import native

    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(str(bad), str(tmp_path / "libbad.so"))


def test_map_store_matches_reference(tmp_path):
    port, ref = _operation_log_matches_reference()
    _checkpoints_cross_load(port, ref, tmp_path)
    _native_stats_match_numpy(port)
    _native_build_failure_raises(tmp_path)
