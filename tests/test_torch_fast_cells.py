"""The port's pyramid-wide FAST + per-cell maximum (`fast_cells_pyramid`)
and `topk_from_cells` against the JAX reference's `_fast_score_map_jnp` +
`grid_topk_keypoints`, level by level, on a small 3-level pyramid. All of
it is exact: mins, maxes, one subtraction, first-index argmax and a stable
sort, so the tolerance is none. On the CPU `fast_cells_pyramid` runs its
plain version; the fused CUDA kernel is held to that plain version on the
card by chip_smoke.py. Also the rule that entry points default to the card
and raise without one.

One test per file: see tests/test_torch_fast.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viorb_tpu_torch
from viorb_tpu.features.fast import _fast_score_map_jnp
from viorb_tpu.features.fast import grid_topk_keypoints as ref_topk
from viorb_tpu_torch.features.extractor import OrbExtractor
from viorb_tpu_torch.features.fast import (
    _cells_from_score,
    _fast_cells_pyramid_torch,
    cell_offsets,
    fast_cells_pyramid,
    grid_topk_keypoints,
    topk_from_cells,
)
from viorb_tpu_torch.features.fast_cuda import fast_cells_cuda
from viorb_tpu_torch.interop import carry_from_numpy
from viorb_tpu_torch.io import synthetic
from viorb_tpu_torch.slam.tracking_loop import identity_carry

torch.set_num_threads(1)

# one compiled program per shape instead of op-by-op dispatch
_ref_fast = jax.jit(_fast_score_map_jnp)
_ref_topk = jax.jit(ref_topk, static_argnums=(1,), static_argnames=("min_score", "border"))

SHAPES = [(96, 144), (80, 120), (67, 100)]
CELL, BORDER, MIN_SCORE = 16, 19, 7.0


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))  # tolerance: none


def _pyramid_cells_and_topk_identical_to_reference():
    # integer-valued pixels, as a uint8 camera frame gives: scores tie often
    rng = np.random.default_rng(11)
    images = [rng.integers(0, 256, s).astype(np.float32) for s in SHAPES]
    pyramid = [torch.from_numpy(img) for img in images]
    cell_best, cell_arg, offs = fast_cells_pyramid(pyramid, CELL, BORDER)
    assert offs == cell_offsets(SHAPES, CELL) == [0, 54, 89, 113]
    assert cell_best.dtype == torch.float32 and cell_arg.dtype == torch.int64
    assert cell_best.shape == cell_arg.shape == (offs[-1],)
    # a CPU pyramid goes to the plain version
    for got, want in zip((cell_best, cell_arg), _fast_cells_pyramid_torch(pyramid, CELL, BORDER)[:2]):
        assert torch.equal(got, want)
    for l, (img, (h, w)) in enumerate(zip(images, SHAPES)):
        score = _ref_fast(jnp.asarray(img))
        n_cells = offs[l + 1] - offs[l]
        # more slots than cells, so every cell's maximum and argmax shows
        # and the tail is zero padding; on level 0 also fewer
        for n_target in (n_cells + 3, 20)[: 2 if l == 0 else 1]:
            want = _ref_topk(score, n_target, min_score=MIN_SCORE, border=BORDER)
            got = topk_from_cells(
                cell_best[offs[l] : offs[l + 1]], cell_arg[offs[l] : offs[l + 1]],
                w // CELL, n_target, CELL, MIN_SCORE,
            )
            _assert_same(got, want)
            _assert_same(
                grid_topk_keypoints(
                    torch.from_numpy(np.array(score)), n_target, CELL, MIN_SCORE, BORDER
                ),
                want,
            )


def _tie_heavy_and_all_zero_maps_identical_to_reference():
    h, w = SHAPES[0]
    rng = np.random.default_rng(12)
    ties = (rng.integers(0, 4, (h, w)) * 4).astype(np.float32)  # scores in {0, 4, 8, 12}
    zeros = np.zeros((h, w), np.float32)
    n_target = (h // CELL) * (w // CELL) + 3  # level 0's compiled program again
    for score in (ties, zeros):
        want = _ref_topk(jnp.asarray(score), n_target, min_score=MIN_SCORE, border=BORDER)
        best, arg = _cells_from_score(torch.from_numpy(score), CELL, BORDER)
        _assert_same(topk_from_cells(best, arg, w // CELL, n_target, CELL, MIN_SCORE), want)
        _assert_same(
            grid_topk_keypoints(torch.from_numpy(score), n_target, CELL, MIN_SCORE, BORDER), want
        )
    assert not arg.any() and not best.any()  # all-zero cells: index 0
    # the first of equal maxima: cell (2, 3) holds 12 at in-cell (5, 9) and (5, 10)
    score = zeros.copy()
    score[2 * CELL + 5, 3 * CELL + 9 : 3 * CELL + 11] = 12.0
    score[2 * CELL + 7, 3 * CELL + 2] = 12.0
    best, arg = _cells_from_score(torch.from_numpy(score), CELL, BORDER)
    assert int(arg[2 * (w // CELL) + 3]) == 5 * CELL + 9 and float(best.max()) == 12.0


def _cuda_wrapper_refuses_what_the_kernel_does_not_take():
    # no quiet fallback to the plain version: each raises before any launch
    ok = [torch.zeros(s) for s in SHAPES]
    with pytest.raises(ValueError, match="CUDA tensor"):
        fast_cells_cuda(ok)
    with pytest.raises(ValueError, match="float32"):
        fast_cells_cuda([ok[0].double(), ok[1]])
    with pytest.raises(ValueError, match="contiguous"):
        fast_cells_cuda([torch.zeros(144, 96).T, ok[1]])
    with pytest.raises(ValueError, match="2-D"):
        fast_cells_cuda([torch.zeros(2, 32, 32)])
    with pytest.raises(ValueError, match="levels"):
        fast_cells_cuda(ok * 3)
    with pytest.raises(ValueError, match="16 px cells"):
        fast_cells_cuda(ok, cell=8)
    with pytest.raises(ValueError, match="border"):
        fast_cells_cuda(ok, border=2)


def _entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        assert viorb_tpu_torch.default_device().type == "cuda"
        assert identity_carry().r_cw.is_cuda
        return
    frame = np.zeros((64, 64), np.uint8)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    for call in (
        viorb_tpu_torch.default_device,
        identity_carry,
        lambda: carry_from_numpy(eye, zero, eye, zero),
        lambda: synthetic.stack_planes(synthetic.default_room(0)[:1]),
        lambda: OrbExtractor(n_features=50).extract(frame),
        lambda: OrbExtractor(n_features=50).extract(torch.from_numpy(frame)),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # asked for, the CPU is taken
    assert identity_carry(device="cpu").r_cw.device.type == "cpu"
    feats = OrbExtractor(n_features=50).extract(frame, device="cpu")
    assert feats.xy.device.type == "cpu" and not feats.valid.any()


def test_fast_cells_and_topk_match_reference():
    _pyramid_cells_and_topk_identical_to_reference()
    _tie_heavy_and_all_zero_maps_identical_to_reference()
    _cuda_wrapper_refuses_what_the_kernel_does_not_take()
    _entry_points_default_to_the_card_and_raise_without_one()
