"""The port's command line (`viorb_tpu_torch.run.main`) on the CPU against
the JAX reference's (`viorb_tpu.run.main`) on the same TUM RGB-D dump:
tests/make_torch_goldens.py's CLI_DOC (the half-size arc's first
CLI_CONFIG["n_frames"] frames, rendered on the CPU by the port's renderer,
rounded to uint8 images and uint16 depth at 5000 units a metre, written as
PNG with an associations file and a settings file), run with `--dataset
tum --rgbd ... --device cpu`. The reference's run is a committed golden
(tests/torch_cli_golden.npz), made from a dump written the same way: this
test first checks that its dump's integers have the golden's SHA-256, so
both runs read the same frames. Tolerances are tests/test_torch_rgbd.py's
(`test_torch_stereo.py::POS_TOL_M`, `ATE_FACTOR`): the trajectory file's
timestamps equal the golden's, every position within 5 mm of the
reference's, the metric ATE to the renderer's truth at most 1.1x the
reference's. The loaders hand the dump back exactly (uint8 -> f32, uint16
/ 5000). Then the same command without `--device` raises on a machine with
no CUDA device; the two parsers take the same flags with the same
defaults, choices and types, the port's `--device` apart; and its
argument errors exit as the reference's do, with the same message.

One test per file: see tests/test_torch_fast.py."""

import argparse
import os
from unittest import mock

import numpy as np
import pytest
import torch

from make_torch_goldens import CLI_CONFIG, CLI_GOLDEN, cli_argv, load, write_cli_dump
from test_torch_stereo import ATE_FACTOR, POS_TOL_M
from viorb_tpu import run as ref_run
from viorb_tpu_torch import run
from viorb_tpu_torch.eval.ate import ate_rmse
from viorb_tpu_torch.io.datasets import load_depth, load_tum_rgbd

torch.set_num_threads(1)


class _Parsed(Exception):
    pass


def _arguments(module) -> dict:
    """{dest: (flags, default, choices, type, nargs, const, metavar)} of the
    parser `module.main` builds (stopped before it parses)."""
    def stop(self, *args, **kwargs):
        raise _Parsed(self)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", stop), pytest.raises(_Parsed) as got:
        module.main([])
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs, a.const, a.metavar)
            for a in got.value.args[0]._actions}


def _same_command_line(capsys):
    port, ref = _arguments(run), _arguments(ref_run)
    assert set(port) - set(ref) == {"device"} and not set(ref) - set(port)
    assert {k: v for k, v in port.items() if k != "device"} == ref
    for argv in (["--dataset", "tum"], ["--localization-only"], ["--rgbd", "--vi"],
                 ["--rgbd", "--dataset", "euroc", "--path", "p"], ["--stream", "sometimes"]):
        errs = []
        for module in (run, ref_run):
            with pytest.raises(SystemExit) as e:
                module.main(argv)
            errs.append((e.value.code, capsys.readouterr().err.splitlines()[-1]))
        assert errs[0] == errs[1] and errs[0][0] == 2, (argv, errs)


def test_cli_matches_reference(tmp_path, capsys):
    gold = load(CLI_GOLDEN)
    dump = write_cli_dump(str(tmp_path))
    assert dump["digest"] == str(gold["digest"]), "the dump differs from the one the golden was made from"
    frames, depth_paths = load_tum_rgbd(str(tmp_path), str(tmp_path / "associations.txt"))
    for (_, img), want, p, dep in zip(frames, dump["images"], depth_paths, dump["depth16"]):
        np.testing.assert_array_equal(img, want.astype(np.float32))
        np.testing.assert_array_equal(load_depth(p, CLI_CONFIG["depth_factor"]),
                                      dep.astype(np.float32) / np.float32(CLI_CONFIG["depth_factor"]))

    out = str(tmp_path / "traj.txt")
    slam = run.main(cli_argv(str(tmp_path), out) + ["--device", "cpu"])
    assert slam.device.type == "cpu" and slam._worker is None and slam._collector is None
    traj, want = np.loadtxt(out), gold["traj"]
    seq = dump["seq"]
    np.testing.assert_array_equal(traj[:, 0], want[:, 0])
    d = np.linalg.norm(traj[:, 1:4] - want[:, 1:4], axis=1).max()
    ate = ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=False)
    print(f"CLI: {len(traj)} rows, positions within {d:.2e} m of the reference's, metric ATE {ate:.4f} m "
          f"(the reference's {float(gold['ate']):.4f} m)")
    assert d <= POS_TOL_M and ate <= ATE_FACTOR * float(gold["ate"]), (d, ate)
    np.testing.assert_allclose(np.linalg.norm(traj[:, 4:8], axis=1), 1.0, atol=1e-5)

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run.main(cli_argv(str(tmp_path), out))
    assert os.path.getsize(out) > 0
    _same_command_line(capsys)
