"""The port's tracking step against the JAX reference's, frame by frame,
from the same state: a 240x376 rendered arc (camera scaled by 1/2), 300
features, a 1024-slot map lifted from frame 0 with ground-truth depth, and
5 tracked frames. Also the port's renderer, its map builder, and the rule
that the port never imports JAX.

The reference's 8-level extractor and tracking step outputs on these frames
come from tests/torch_front_golden.npz (tests/make_torch_goldens.py, set
`front`): their live compiles took ~20 s of this test's ~23 s on a CPU.
The map is lifted from the golden's frame-0 features by the reference's own
code, and the tolerances are the live test's.

One test per file: see tests/test_torch_fast.py."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from make_torch_goldens import _FEAT_FIELDS, FRONT_GOLDEN, TRACK_FRAMES, load
from torch_port_scene import MAP_SLOTS, N_FEATURES, REF_CAM, reference_map, render_scene
from viorb_tpu.features.extractor import FrameFeatures as RefFeatures
from viorb_tpu.io import synthetic as ref_synthetic
from viorb_tpu.slam import tracking_loop as ref_loop
from viorb_tpu_torch.features.extractor import OrbExtractor
from viorb_tpu_torch.interop import carry_from_numpy, device_map_from_numpy, features_from_numpy
from viorb_tpu_torch.io import synthetic
from viorb_tpu_torch.slam.tracking_loop import identity_carry, make_tracking_step

torch.set_num_threads(1)

N_TRACKED = TRACK_FRAMES


def _ref_features(gold, prefix):
    """The reference's FrameFeatures of frame 0 from the golden."""
    return RefFeatures(*[jnp.asarray(gold[prefix + k]) for k in _FEAT_FIELDS])


def _renderer_matches_reference(scene):
    cam, r_wc, c_w, rooms, planes, _ = scene
    ref_rooms = ref_synthetic.default_room(0)
    for p, q in zip(rooms, ref_rooms):
        np.testing.assert_array_equal(p.texture, q.texture)
    ref_r, ref_c = ref_synthetic.make_trajectory(N_TRACKED + 1, dt=0.1)
    np.testing.assert_array_equal(r_wc, ref_r)
    np.testing.assert_array_equal(c_w, ref_c)
    ref_img = ref_synthetic.render_frame(REF_CAM, ref_r[3], ref_c[3], ref_rooms)
    img = synthetic.render_frame(cam, r_wc[3], c_w[3], planes).numpy()
    # f32 ray-plane arithmetic in another order: <= 0.05 grey levels
    np.testing.assert_allclose(img, ref_img, rtol=0, atol=0.05)


def _steps_match_reference(scene, gold):
    """Per frame: pose within 2e-3 rad and 5e-3 m of the reference's step,
    inlier count within 5 %."""
    cam, r_wc, c_w, _, planes, frames = scene
    fields = reference_map(r_wc[0], c_w[0], frames[0], feats=_ref_features(gold, "track_feats0_"))
    start = dict(
        r_cw=r_wc[0].T, t_cw=-r_wc[0].T @ c_w[0],
        vel_r=np.eye(3, dtype=np.float32), vel_t=np.zeros(3, np.float32),
    )
    carry = carry_from_numpy(**start, device="cpu")
    dmap = device_map_from_numpy(**fields, device="cpu")
    step = make_tracking_step(cam, OrbExtractor(n_features=N_FEATURES))

    # the port's own map builder gives the same map from the same frame
    own = synthetic.lift_features_to_map(
        OrbExtractor(n_features=N_FEATURES), cam, frames[0], r_wc[0], c_w[0], planes,
        capacity=MAP_SLOTS,
    )
    np.testing.assert_array_equal(own.valid.numpy(), fields["valid"])
    np.testing.assert_allclose(own.xyz.numpy(), fields["xyz"], rtol=0, atol=1e-3)

    for i in range(1, N_TRACKED + 1):
        carry, out = step(carry, frames[i], dmap)
        ref_r = gold["track_r_cw"][i - 1].astype(np.float64)
        d_rot = np.linalg.norm(out.r_cw.numpy().astype(np.float64) @ ref_r.T - np.eye(3)) / np.sqrt(2)
        d_t = np.abs(out.t_cw.numpy() - gold["track_t_cw"][i - 1]).max()
        n_ref, n_out = int(gold["track_n_inliers"][i - 1]), int(out.n_inliers)
        assert d_rot <= 2e-3 and d_t <= 5e-3, (i, d_rot, d_t)
        assert abs(n_out - n_ref) <= 0.05 * n_ref and n_ref > 30, (i, n_out, n_ref)


def _interop_carries_reference_state(scene, gold):
    """The reference's features, carry and camera, moved through interop,
    are the same state on the port's side."""
    cam, *_, frames = scene
    assert tuple(cam) == tuple(REF_CAM)
    ref = _ref_features(gold, "track_feats0_")
    feats = features_from_numpy(*[np.asarray(x) for x in ref], device="cpu")
    np.testing.assert_array_equal(
        feats.descriptors_pm1().numpy(), np.asarray(ref.descriptors_pm1(jnp.float32))
    )
    np.testing.assert_array_equal(feats.level.numpy(), np.asarray(ref.level))
    for got, want in zip(identity_carry(device="cpu"), ref_loop.identity_carry()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# made unimportable in the subprocess: the GPU host has no JAX (nor the JAX
# package, which imports it), and the port's command line and I/O need no
# image or plotting library
_BLOCKED = ("jax", "jaxlib", "viorb_tpu", "matplotlib", "PIL", "yaml", "cv2", "torchvision")


def _port_imports_no_jax():
    """Every port module imports with JAX, the JAX package, matplotlib, PIL,
    yaml, cv2 and torchvision made unimportable: the GPU host has no JAX,
    and the port counts on none of the others there. The walk reaches the map store, its checkpoints and native
    helpers, the ATE, PnP, MonoSlam, the VI modules, the loop closing
    modules and the command line, its I/O, viewer and tools too, and the
    port reads its own vocabulary asset. Then the command line runs on the
    CPU over a two-frame TUM RGB-D dump written by io/png.py, with the
    viewer and every output on (what it drives needs none of the blocked
    packages), and without --device it raises on a host with no card."""
    code = (
        "import importlib.abc, sys\n"
        f"BLOCKED = {_BLOCKED!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ModuleNotFoundError(f'{name} is made unimportable here', name=name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import pkgutil, importlib, viorb_tpu_torch\n"
        "for m in pkgutil.walk_packages(viorb_tpu_torch.__path__, 'viorb_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'viorb_tpu.'))"
        " or m == 'viorb_tpu']\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "new = ['viorb_tpu_torch.' + m for m in ('mapping.map', 'mapping.serialize', 'native',\n"
        "       'eval.ate', 'solvers.pnp', 'slam.mono', 'io.synthetic', 'imu.types', 'imu.navstate',\n"
        "       'imu.preintegration', 'optim.imu_factors', 'slam.vi_init', 'slam.mono_vi', 'eval.gravity',\n"
        "       'geometry.sim3', 'solvers.sim3_solver', 'optim.sim3_refine', 'optim.pose_graph', 'bow',\n"
        "       'bow.vocabulary', 'bow.database', 'bow.descend_cuda', 'slam.loop_closing', 'run', '__main__',\n"
        "       'io.config', 'io.png', 'io.datasets', 'io.trajectory', 'io.stream', 'io.live', 'viz',\n"
        "       'viz.drawers', 'eval.plot_init', 'bow.build_asset')]\n"
        "from viorb_tpu_torch.bow import default_vocabulary\n"
        "assert default_vocabulary().n_words == 1000\n"
        "assert all(m in sys.modules for m in new), [m for m in new if m not in sys.modules]\n"
        "import os, tempfile, numpy as np\n"
        "from viorb_tpu_torch import run\n"
        "from viorb_tpu_torch.io.png import read_png, write_png\n"
        "tmp = tempfile.TemporaryDirectory()  # removed at exit, also after a failure\n"
        "d = tmp.name\n"
        "os.mkdir(d + '/rgb'); os.mkdir(d + '/depth')\n"
        "rng = np.random.default_rng(0)\n"
        "tex = rng.uniform(0, 255, (60, 94)).repeat(4, 0).repeat(4, 1)[:240, :376]\n"
        "for i in range(2):\n"
        "    write_png(f'{d}/rgb/{i}.png', np.roll(tex, i, 1).astype(np.uint8))\n"
        "    write_png(f'{d}/depth/{i}.png', np.full((240, 376), 10000, np.uint16))\n"
        "open(d + '/associations.txt', 'w').write('0.0 rgb/0.png 0.0 depth/0.png\\n0.1 rgb/1.png 0.1 depth/1.png\\n')\n"
        "open(d + '/s.yaml', 'w').write('%YAML:1.0\\nCamera.fx: 225.0\\nCamera.fy: 225.0\\nCamera.cx: 188.0\\n'\n"
        "    'Camera.cy: 120.0\\nCamera.width: 376\\nCamera.height: 240\\nORBextractor.nFeatures: 150\\n')\n"
        "argv = ['--dataset', 'tum', '--rgbd', '--path', d, '--config', d + '/s.yaml', '--out', d + '/t.txt',\n"
        "        '--out-kf', d + '/kf.txt', '--out-kitti', d + '/k.txt', '--save-map', d + '/m.npz',\n"
        "        '--viz-dir', d + '/viz', '--viz-every', '1']\n"
        "slam = run.main(argv + ['--device', 'cpu'])\n"
        "assert np.loadtxt(d + '/t.txt', ndmin=2).shape == (2, 8) and np.loadtxt(d + '/k.txt', ndmin=2).shape[1] == 12\n"
        "pngs = sorted(os.listdir(d + '/viz'))\n"
        "assert pngs == ['frame_00000.png', 'frame_00001.png', 'map_00000.png', 'map_final.png'], pngs\n"
        "assert all(read_png(d + '/viz/' + f).ndim == 3 for f in pngs) and os.path.exists(d + '/m.npz')\n"
        "import torch\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        run.main(argv)\n"
        "        raise AssertionError('the command line ran without --device on a host with no card')\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e), e\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "assert not bad, bad\n"
        "tmp.cleanup()\n"
        "print(len([m for m in sys.modules if m.startswith('viorb_tpu_torch')]))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=root,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


def test_tracking_step_matches_reference():
    _port_imports_no_jax()
    scene = render_scene(N_TRACKED + 1)
    gold = load(FRONT_GOLDEN)
    _renderer_matches_reference(scene)
    _interop_carries_reference_state(scene, gold)
    _steps_match_reference(scene, gold)
