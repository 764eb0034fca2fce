"""The port's stream front end and evaluation command lines against the JAX
reference's:
  * `MsgSynchronizer` (viorb_tpu_torch/io/stream.py) of both packages on
    the same scripted calls, the cases of tests/test_stream.py: waiting for
    the IMU, the image-to-IMU delay, the discontinuity reset, images only;
    every `get_synced` result (timestamp, image, samples) and the counters
    equal;
  * `RealtimeRunner` of both packages in lockstep and realtime mode, fed
    frame 0, then frames 1-3 while frame 0 is held inside the pipeline on
    a `threading.Event` (no sleeps): lockstep processes all four with the
    same samples, realtime frames 0 and 3 and drops 1 and 2, in both. The
    reference's runner runs on its own thread (`start` / `join`); the
    port's `run()` on the calling thread with the frames fed from another,
    as the port's CLI runs it;
  * the port's CLI feeder (`run._feed`) in lock-step over five times as
    many frames as the synchronizer's queue holds, frame 0 held in the
    pipeline until the queue is full: every frame is processed with its
    IMU samples and none is dropped (the reference's feeder does not wait
    for room, and drops all but the last `max_images`);
  * the live TCP wire (io/live.py) both ways over loopback: a publisher of
    either package feeds a source of the other, and the synchronized
    bundles equal what was sent;
  * `eval.ate.main` and `eval.gravity.main` of both packages print the same
    lines on the same files.

One test per file: see tests/test_torch_fast.py."""

import threading

import numpy as np
import pytest

from viorb_tpu.eval import ate as ref_ate
from viorb_tpu.eval import gravity as ref_gravity
from viorb_tpu.io import live as ref_live
from viorb_tpu.io import stream as ref_stream
from viorb_tpu_torch.eval import ate, gravity
from viorb_tpu_torch.io import live, stream

WAIT_S = 10.0  # a bound on every wait; nothing waits that long when the code is right


def _img(v=0):
    return np.full((4, 4), v, np.uint8)


def _z():
    return np.zeros(3)


# each case: calls on a synchronizer, ("get", timeout) returns what get_synced gives
SYNC_CASES = {
    "waits for the IMU": (dict(), [("image", 0.10, _img())] + [("get", 0.01)]
                          + [("imu", float(t), _z(), _z()) for t in np.arange(0.0, 0.09, 0.01)]
                          + [("get", 0.01), ("imu", 0.11, _z(), _z()), ("get", WAIT_S), ("get", 0.01)]),
    "image delay": (dict(image_delay=0.05), [("image", 0.10, _img()), ("imu", 0.12, _z(), _z()), ("get", 0.01),
                                             ("imu", 0.16, _z(), _z()), ("get", WAIT_S)]),
    "discontinuity": (dict(discontinuity_s=3.0), [("image", 0.0, _img()), ("imu", 0.1, _z(), _z()),
                                                  ("image", 10.0, _img(1)), ("get", 0.01), ("image", 10.1, _img(2)),
                                                  ("imu", 10.2, _z(), _z()), ("get", WAIT_S), ("get", WAIT_S)]),
    "images only": (dict(with_imu=False), [("image", 0.1, np.zeros((4, 4), np.float32)),
                                           ("image", 0.2, np.ones((4, 4), np.float32)), ("get", WAIT_S),
                                           ("get", WAIT_S), ("close",), ("get", WAIT_S)]),
}


def _script(module, kwargs, calls):
    s = module.MsgSynchronizer(**kwargs)
    out = []
    for call in calls:
        if call[0] == "image":
            s.add_image(*call[1:])
        elif call[0] == "imu":
            s.add_imu(*call[1:])
        elif call[0] == "close":
            s.close()
        else:
            out.append(s.get_synced(timeout=call[1]))
    return out, (s.n_discontinuities, s.n_dropped_images)


def _same_bundle(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    assert len(a[2]) == len(b[2])
    for x, y in zip(a[2], b[2]):
        assert x[0] == y[0]
        np.testing.assert_array_equal(x[1], y[1])
        np.testing.assert_array_equal(x[2], y[2])


def _synchronizers_agree():
    for name, (kwargs, calls) in SYNC_CASES.items():
        got, got_n = _script(stream, kwargs, calls)
        want, want_n = _script(ref_stream, kwargs, calls)
        assert got_n == want_n, name
        assert [g is None for g in got] == [w is None for w in want], name
        for g, w in zip(got, want):
            _same_bundle(g, w)
    # the reference test's outcomes, on the port's results
    got, _ = _script(stream, *SYNC_CASES["waits for the IMU"])
    assert got[:2] == [None, None] and got[2][0] == 0.10 and len(got[2][2]) == 9


def _runner(module, mode, on_calling_thread):
    """(frames processed, [(ts, samples) per processed frame], dropped)."""
    sync = module.MsgSynchronizer()
    entered = threading.Event()
    release = threading.Event()
    seen = []

    def proc(ts, image, samples):
        seen.append((ts, [s[0] for s in samples]))
        if ts == 0.0:
            entered.set()
            assert release.wait(WAIT_S), "frame 0 was never released"
        return {"state": "OK"}

    def feed():
        sync.add_imu(0.005, _z(), _z())
        sync.add_image(0.0, _img(0))
        assert entered.wait(WAIT_S), "frame 0 never reached the pipeline"
        for i in (1, 2, 3):
            sync.add_imu(0.1 * i - 0.05, _z(), _z())
            sync.add_imu(0.1 * i + 0.005, _z(), _z())
            sync.add_image(0.1 * i, _img(i))
        release.set()

    runner = module.RealtimeRunner(sync, proc, mode=mode)
    feeder = threading.Thread(target=feed)
    if on_calling_thread:
        feeder.start()
        closer = threading.Thread(target=lambda: (feeder.join(WAIT_S), _close_when_done(sync)))
        closer.start()
        n = runner.run()
        closer.join(WAIT_S)
        assert not closer.is_alive()
    else:
        runner.start()
        feeder.start()
        feeder.join(WAIT_S)
        _close_when_done(sync)
        n = runner.join(timeout=WAIT_S)
    assert not feeder.is_alive()
    return n, seen, sync.n_dropped_images


def _close_when_done(sync):
    """Close the stream once the runner has taken every queued image (the
    runner then returns): the frames that are processed do not depend on
    when the close comes."""
    with sync._lock:
        while sync._images:
            sync._lock.wait(0.01)
    sync.close()


def _runners_agree():
    fed = [0.0] + [0.1 * i for i in (1, 2, 3)]  # as feed() stamps them
    for mode, frames in (("lockstep", fed), ("realtime", [fed[0], fed[3]])):
        got = _runner(stream, mode, on_calling_thread=True)
        want = _runner(ref_stream, mode, on_calling_thread=False)
        assert got == want, (mode, got, want)
        assert got[0] == len(frames) and [ts for ts, _ in got[1]] == frames
        assert got[0] + got[2] == 4
    with pytest.raises(ValueError):
        stream.RealtimeRunner(stream.MsgSynchronizer(), lambda *a: {}, mode="sometimes")


def _lockstep_feeder_drops_nothing():
    from viorb_tpu_torch import run

    n_frames, cap = 20, 4
    ts = [0.125 * i for i in range(n_frames)]  # binary fractions: the IMU meets each stamp exactly
    imu_t = np.arange(0, 8 * n_frames) * 0.03125
    imu = (imu_t, np.zeros((len(imu_t), 3), np.float32), np.zeros((len(imu_t), 3), np.float32))
    sync = stream.MsgSynchronizer(max_images=cap)
    seen = []

    def proc(t, image, samples):
        if not seen:  # hold frame 0 until the feeder has filled the queue (or fed all)
            with sync._lock:
                while len(sync._images) < cap and not sync._closed:
                    assert sync._lock.wait(WAIT_S), "the feeder never filled the queue"
        seen.append((t, int(image[0, 0]), len(samples)))
        return {}

    stop = threading.Event()
    frames = [(t, _img(i)) for i, t in enumerate(ts)]
    feeder = threading.Thread(target=run._feed, args=(sync, frames, imu, 0.0, 0.0, True, stop))
    feeder.start()
    n = stream.RealtimeRunner(sync, proc, mode="lockstep").run()
    stop.set()
    feeder.join(WAIT_S)
    assert not feeder.is_alive()
    assert sync.n_dropped_images == 0 and n == n_frames
    assert seen == [(t, i, 1 if i == 0 else 4) for i, t in enumerate(ts)], seen


def _live_wire(pub_module, src_module, sync_module):
    pub = pub_module.LivePublisher()
    host, port = pub.address
    sync = sync_module.MsgSynchronizer()
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("src", src_module.LiveSource(host, port, sync).start()))
    t.start()
    pub.wait_subscriber(timeout=WAIT_S)
    t.join(WAIT_S)
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(0, 255, (24, 32)).astype(np.float32) for _ in range(3)]
    sent = []
    k = 0
    for i, img in enumerate(imgs):
        pub.send_image(0.1 * (i + 1), img)
        for _ in range(5):
            k += 1
            g, a = rng.normal(size=3), rng.normal(size=3)
            pub.send_imu(0.02 * k + 0.001, g, a)
            sent.append((0.02 * k + 0.001, g.astype(np.float32), a.astype(np.float32)))
    got = [sync.get_synced(timeout=WAIT_S) for _ in imgs]
    pub.close()
    box["src"].join(timeout=WAIT_S)
    assert box["src"].n_images == 3 and box["src"].n_imu == 15
    assert sync.get_synced(timeout=WAIT_S) is None  # BYE closes the stream
    samples = [s for g in got for s in g[2]]
    for i, (ts, img, _) in enumerate(got):
        assert ts == 0.1 * (i + 1)
        np.testing.assert_array_equal(img, imgs[i])
    for (t1, g1, a1), (t2, g2, a2) in zip(samples, sent):
        assert t1 == t2
        np.testing.assert_array_equal(g1, g2)
        np.testing.assert_array_equal(a1, a2)


def _eval_mains_agree(tmp_path, capsys):
    rng = np.random.default_rng(3)
    t = np.arange(30) * 0.1
    xyz = np.stack([np.sin(t), np.cos(t), t], 1)
    est = np.column_stack([t + 0.001, 2.0 * xyz + rng.normal(0, 0.01, xyz.shape), np.zeros((30, 3)), np.ones(30)])
    gt = np.column_stack([t, xyz, np.zeros((30, 3)), np.ones(30)])
    pe, pg = str(tmp_path / "e.txt"), str(tmp_path / "g.txt")
    np.savetxt(pe, est)
    np.savetxt(pg, gt)
    gw = str(tmp_path / "gw.txt")
    np.savetxt(gw, np.column_stack([t, rng.normal(0, 0.3, (30, 3)) + [0, 0, -9.81]]))
    q = "0.99,0.1,0.0,0.05"
    runs = [(ate, ref_ate, [pe, pg, "--scale"]), (ate, ref_ate, [pe, pg]),
            (ate, ref_ate, [pe, pg, "--max-dt", "0.0005"]),  # no association: both exit with the same message
            (gravity, ref_gravity, [gw]), (gravity, ref_gravity, [gw, "--q-wb", q, "--r-bc", "0,1,0,-1,0,0,0,0,1"])]
    for port, ref, argv in runs:
        outs = []
        for module in (port, ref):
            try:
                ret = module.main(argv)
            except SystemExit as e:
                ret = str(e)
            outs.append((ret, capsys.readouterr()))
        assert outs[0][1].out == outs[1][1].out and outs[0][1].err == outs[1][1].err, argv
        assert outs[0][0] == outs[1][0], argv


def test_stream_and_tools_match_reference(tmp_path, capsys):
    _synchronizers_agree()
    _runners_agree()
    _lockstep_feeder_drops_nothing()
    _live_wire(live, ref_live, ref_stream)
    _live_wire(ref_live, live, stream)
    _eval_mains_agree(tmp_path, capsys)
