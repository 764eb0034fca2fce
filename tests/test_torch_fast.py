"""The port's FAST score map and per-cell top-K selection against the JAX
reference (viorb_tpu/features/fast.py and the Pallas kernel in interpret
mode). Both are exact: scores are mins and maxes of differences, and ties
break to the lowest index on both sides. The CUDA kernel itself is held to
the plain version on the card by chip_smoke.py.

One test per file, as in every tests/test_torch_*.py: pytest-xdist's
--dist loadfile hands out the files with the most tests first, so a
one-test file runs after the JAX package's files and leaves their
schedule, which nearly fills the tier-1 time limit, as it was."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viorb_tpu.features.fast import _fast_score_map_jnp
from viorb_tpu.features.fast import grid_topk_keypoints as ref_topk
from viorb_tpu.features.fast_pallas import fast_score_map_pallas
from viorb_tpu_torch.features.fast import (
    _fast_score_map_torch,
    fast_score_map,
    grid_topk_keypoints,
)
from viorb_tpu_torch.features.fast_cuda import fast_score_map_cuda

torch.set_num_threads(1)

# one compiled program per shape instead of op-by-op dispatch
_ref_fast = jax.jit(_fast_score_map_jnp)
_ref_topk = jax.jit(ref_topk, static_argnums=(1,), static_argnames=("min_score", "border"))


def _image(h, w, seed):
    # integer-valued pixels, as a uint8 camera frame gives: scores tie often
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w)).astype(np.float32)


def _plain_fast_equals_reference_exactly(shape):
    img = _image(*shape, seed=shape[0])
    ref = np.asarray(_ref_fast(jnp.asarray(img)))
    out = _fast_score_map_torch(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(out, ref)  # tolerance: none, the ops are exact


def _plain_fast_equals_pallas_interpret_exactly():
    img = _image(64, 128, seed=1)
    ref = np.asarray(fast_score_map_pallas(jnp.asarray(img), interpret=True))
    out = _fast_score_map_torch(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(out, ref)


def _cpu_tensor_dispatches_to_plain_version():
    img = torch.from_numpy(_image(40, 60, seed=2))
    assert torch.equal(fast_score_map(img), _fast_score_map_torch(img))


def _cuda_wrapper_refuses_what_the_kernel_does_not_take():
    # no quiet fallback: the wrapper raises on a CPU tensor, and on a
    # wrong type before it would ever reach the device
    with pytest.raises(ValueError, match="CUDA tensor"):
        fast_score_map_cuda(torch.zeros(8, 8))
    with pytest.raises(ValueError):
        fast_score_map_cuda(torch.zeros(8, 8, dtype=torch.float64))


def _grid_topk_identical_to_reference(shape, n_target, levels):
    img = _image(*shape, seed=7)
    if levels is None:
        score = np.asarray(_ref_fast(jnp.asarray(img)))
        # the plain FAST on the same image: tolerance none
        np.testing.assert_array_equal(_fast_score_map_torch(torch.from_numpy(img)).numpy(), score)
    else:
        score = (img % levels).astype(np.float32) * 4.0
    want = _ref_topk(jnp.asarray(score), n_target, min_score=7.0, border=19)
    got = grid_topk_keypoints(torch.from_numpy(score.copy()), n_target, min_score=7.0, border=19)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fast_and_topk_match_reference():
    for shape in [(97, 130), (64, 128)]:
        _plain_fast_equals_reference_exactly(shape)
    _plain_fast_equals_pallas_interpret_exactly()
    _cpu_tensor_dispatches_to_plain_version()
    _cuda_wrapper_refuses_what_the_kernel_does_not_take()
    # the one full-size case, FAST and top-K both: a 752x480 frame and the
    # level-0 quota of OrbExtractor(1000)
    _grid_topk_identical_to_reference((480, 752), 217, None)
    # 120 slots for 104 cells: zero padding
    _grid_topk_identical_to_reference((134, 210), 120, None)
    # scores in {0, 4, 8, 12}: ties everywhere
    _grid_topk_identical_to_reference((97, 130), 30, 4)
