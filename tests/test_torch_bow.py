"""The port's bag of words (viorb_tpu_torch/bow/) against the JAX
reference's, on the same numpy inputs:

  * `train_vocabulary` (numpy in both) on 2000 clustered descriptors, k=8,
    depth 3: every array equal;
  * on that tree and on the stock tree (the port's own copy of
    assets/vocab.npz, which equals the reference's file byte for byte and
    `default_vocabulary()` array for array), 1000 descriptors with 10 %
    invalid rows, and again with every row invalid: the host `transform`
    equal in words, its BoW weights within 1e-6 relative; the device
    descent's plain twin (`transform_device` on CPU tensors; K8 on the card,
    chip_smoke.py) equal in words to the reference's `transform_device`,
    its weights within 1e-6 relative (f32 sums in another order);
  * `score` equal; save/load round trip equal;
  * `KeyframeDatabase.query` and `detect_loop_candidates` returning the same
    lists in the same order, scores within 1e-9 (the same host
    arithmetic), for a place revisited with noise and for an exclusion set.

One test per file: see tests/test_torch_fast.py."""

import filecmp

import jax.numpy as jnp
import numpy as np
import torch

from viorb_tpu import bow as ref_bow
from viorb_tpu.bow.build_asset import ASSET_PATH as REF_ASSET
from viorb_tpu_torch import bow
from viorb_tpu_torch.bow import ASSET_PATH

torch.set_num_threads(1)

REL = 1e-6


def _clustered(rng, protos, n, noise_bits=20):
    d = protos[rng.integers(0, len(protos), n)].copy()
    for i in range(n):
        d[i, rng.choice(256, noise_bits, replace=False)] ^= 1
    return d


def _same_bow(got, want, what):
    assert set(got) == set(want), what
    for w, v in want.items():
        assert abs(got[w] - v) <= REL * abs(v), (what, w, got[w], v)


def _transforms_match(voc, ref_voc, desc, valid, what):
    words, bow_h = voc.transform(desc, valid)
    ref_words, ref_bow_h = ref_voc.transform(desc, valid)
    np.testing.assert_array_equal(words, ref_words)
    _same_bow(bow_h, ref_bow_h, what + " host")
    dwords, dbow = voc.transform_device(torch.from_numpy(desc), torch.from_numpy(valid))
    ref_dwords, ref_dbow = ref_voc.transform_device(jnp.asarray(desc, jnp.float32) * 2 - 1, jnp.asarray(valid))
    assert dwords.dtype == torch.int32
    np.testing.assert_array_equal(dwords.numpy(), np.asarray(ref_dwords))
    np.testing.assert_array_equal(dwords.numpy(), words)
    _same_bow(dbow, ref_dbow, what + " device")
    return bow_h


def test_bow_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    protos = np.random.default_rng(1234).integers(0, 2, size=(512, 256)).astype(np.uint8)
    train = _clustered(rng, protos, 2000)
    voc = bow.train_vocabulary(train, k=8, depth=3)
    ref_voc = ref_bow.train_vocabulary(train, k=8, depth=3)
    for a, b in zip(voc, ref_voc):
        np.testing.assert_array_equal(a, b)

    # the stock tree: the port reads its own copy of the asset
    assert filecmp.cmp(ASSET_PATH, REF_ASSET, shallow=False)
    stock, ref_stock = bow.default_vocabulary(), ref_bow.default_vocabulary()
    for a, b in zip(stock, ref_stock):
        np.testing.assert_array_equal(a, b)
    assert stock.n_words == 1000 and stock.k == 10 and len(stock.children) == 1111

    desc = _clustered(rng, protos, 1000)
    valid = rng.random(1000) > 0.1
    for v, rv, name in ((voc, ref_voc, "trained"), (stock, ref_stock, "stock")):
        _transforms_match(v, rv, desc, valid, name)
        words, bow_none = v.transform_device(torch.from_numpy(desc), torch.zeros(1000, dtype=torch.bool))
        assert bool((words == -1).all()) and bow_none == {}, name

    # score, and a save/load round trip
    b1 = voc.transform(desc[:300])[1]
    b2 = voc.transform(_clustered(rng, protos, 300))[1]
    assert bow.BinaryVocabulary.score(b1, b2) == ref_bow.BinaryVocabulary.score(b1, b2)
    path = str(tmp_path / "voc.npz")
    voc.save(path)
    for a, b in zip(bow.BinaryVocabulary.load(path), ref_bow.BinaryVocabulary.load(path)):
        np.testing.assert_array_equal(a, b)

    # the keyframe database, fed the same BoWs
    db, ref_db = bow.KeyframeDatabase(voc), ref_bow.KeyframeDatabase(ref_voc)
    base = _clustered(rng, protos, 200)
    for i in range(10):
        d = base.copy() if i == 7 else _clustered(rng, protos, 200)
        if i == 7:
            for r in range(len(d)):
                d[r, rng.choice(256, 40, replace=False)] ^= 1
        b = voc.transform(d)[1]
        db.add(i, b)
        ref_db.add(i, b)
    db.remove(3)
    ref_db.remove(3)
    q = base.copy()
    for r in range(len(q)):
        q[r, rng.choice(256, 20, replace=False)] ^= 1
    qbow = voc.transform(q)[1]
    for got, want in (
        (db.query(qbow, exclude={9}), ref_db.query(qbow, exclude={9})),
        (db.query(qbow, max_results=5), ref_db.query(qbow, max_results=5)),
        (db.detect_loop_candidates(8, qbow, {6, 2}, 0.01), ref_db.detect_loop_candidates(8, qbow, {6, 2}, 0.01)),
    ):
        assert [k for k, _ in got] == [k for k, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=1e-9)
    assert db.query(qbow, exclude={9})[0][0] == 7
